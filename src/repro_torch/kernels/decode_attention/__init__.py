from .ops import decode_attention, invocation_count, reset_invocation_count  # noqa: F401
