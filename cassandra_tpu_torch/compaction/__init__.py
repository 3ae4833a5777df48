from .executor import (ActiveCompactions, CompactionExecutor,  # noqa: F401
                       CompactionProgress)
from .manager import CompactionManager  # noqa: F401
from .strategies import get_strategy  # noqa: F401
