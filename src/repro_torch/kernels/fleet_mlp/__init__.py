from .ops import fleet_mlp, invocation_count, reset_invocation_count  # noqa: F401
