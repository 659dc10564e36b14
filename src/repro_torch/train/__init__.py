"""LM training: AdamW over a parameter tree and the step builders."""
from .optim import AdamWConfig, AdamWState, init_state, state_specs, apply_update  # noqa: F401
from .step import make_train_step, make_prefill_step, make_decode_step  # noqa: F401
