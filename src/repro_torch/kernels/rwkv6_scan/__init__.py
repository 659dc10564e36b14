from .ops import invocation_count, reset_invocation_count, wkv6_scan  # noqa: F401
