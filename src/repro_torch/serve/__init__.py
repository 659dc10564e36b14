from .engine import Request, ServeEngine  # noqa: F401
