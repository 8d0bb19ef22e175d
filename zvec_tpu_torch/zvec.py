"""Lifecycle: init / create_and_open / open.

Parity with reference `python/zvec/zvec.py:29-226`: `init` is once-only,
None-valued args fall back to environment-derived defaults; `create_and_open`
creates a new collection at a path; `open` recovers an existing one.
"""

from __future__ import annotations

from typing import Optional

from .db.collection_impl import CollectionImpl
from .model.collection import Collection
from .model.param.param import CollectionOption
from .model.schema import CollectionSchema
from .typing.enum import LogLevel, LogType
from .utils.config import GlobalConfig

__all__ = ["create_and_open", "init", "open"]


def init(
    *,
    log_type: Optional[LogType] = LogType.CONSOLE,
    log_level: Optional[LogLevel] = LogLevel.WARN,
    log_dir: Optional[str] = "./logs",
    log_basename: Optional[str] = "zvec.log",
    log_file_size: Optional[int] = 2048,
    log_overdue_days: Optional[int] = 7,
    query_threads: Optional[int] = None,
    optimize_threads: Optional[int] = None,
    invert_to_forward_scan_ratio: Optional[float] = None,
    brute_force_by_keys_ratio: Optional[float] = None,
    memory_limit_mb: Optional[int] = None,
    mesh_devices: Optional[int] = None,
) -> None:
    """Initialize process-wide configuration. Once-only; raises RuntimeError on
    a second call. None args keep environment-derived defaults.
    `mesh_devices=N>1` raises NotImplementedError: sharding over several
    GPUs is not ported yet."""
    if mesh_devices is not None and mesh_devices > 1:
        raise NotImplementedError(
            "mesh_devices > 1 is not supported by zvec_tpu_torch yet"
        )
    GlobalConfig.instance().initialize(
        log_type=log_type,
        log_level=log_level,
        log_dir=log_dir,
        log_basename=log_basename,
        log_file_size=log_file_size,
        log_overdue_days=log_overdue_days,
        query_threads=query_threads,
        optimize_threads=optimize_threads,
        invert_to_forward_scan_ratio=invert_to_forward_scan_ratio,
        brute_force_by_keys_ratio=brute_force_by_keys_ratio,
        memory_limit_mb=memory_limit_mb,
        mesh_devices=mesh_devices,
    )


def create_and_open(
    path: str,
    schema: CollectionSchema,
    option: CollectionOption = CollectionOption(),
) -> Collection:
    """Create a new collection at `path` and open it."""
    impl = CollectionImpl.create_and_open(
        path, schema, read_only=option.read_only, enable_mmap=option.enable_mmap
    )
    return Collection(impl, option)


def open(
    path: str, option: CollectionOption = CollectionOption()
) -> Collection:
    """Open an existing collection, recovering from manifest + WAL."""
    impl = CollectionImpl.open(
        path, read_only=option.read_only, enable_mmap=option.enable_mmap
    )
    return Collection(impl, option)
