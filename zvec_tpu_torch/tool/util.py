"""Lazy import of an optional dependency (reference `python/zvec/tool/util.py`)."""

from __future__ import annotations

import importlib

__all__ = ["require_module"]


def require_module(name: str, hint: str = ""):
    """Import an optional module or raise a friendly error."""
    try:
        return importlib.import_module(name)
    except ImportError as e:
        extra = f" ({hint})" if hint else ""
        raise ImportError(
            f"optional dependency '{name}' is required for this feature{extra}; "
            f"install it to proceed"
        ) from e
