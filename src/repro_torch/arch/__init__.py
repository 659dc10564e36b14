"""The language-model architectures: parameter specs, layers and the
model's forward and decode step (attention, MoE, Mamba2 and RWKV6 block
kinds)."""
