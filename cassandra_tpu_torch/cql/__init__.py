from .processor import QueryProcessor, Session  # noqa: F401
