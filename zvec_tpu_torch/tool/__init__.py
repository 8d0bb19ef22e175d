from .util import require_module

__all__ = ["require_module"]
