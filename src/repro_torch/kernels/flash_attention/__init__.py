from .ops import flash_attention, invocation_count, reset_invocation_count  # noqa: F401
