from .ops import invocation_count, reset_invocation_count, ssd_scan  # noqa: F401
