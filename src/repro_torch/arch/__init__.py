"""The language-model architectures: parameter specs, layers and the
model's forward and decode step (pure-attention block kinds so far)."""
