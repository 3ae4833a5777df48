from .format import Descriptor, Component  # noqa: F401
from .writer import SSTableWriter  # noqa: F401
from .reader import SSTableReader  # noqa: F401
