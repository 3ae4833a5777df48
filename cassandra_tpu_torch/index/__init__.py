from .manager import IndexManager  # noqa: F401
