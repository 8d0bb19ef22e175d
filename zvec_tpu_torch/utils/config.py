"""GlobalConfig: process-wide configuration singleton.

Reference equivalent: `src/db/common/config.cc:33-135` — validated once at
init(), with cgroup-aware defaults (thread counts from CPU limit, memory limit
= cgroup limit x 0.8). Initialization is once-only.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from ..typing.enum import LogLevel, LogType

__all__ = ["GlobalConfig", "cgroup_cpu_limit", "cgroup_memory_limit_mb", "scores_by_keys"]


def cgroup_cpu_limit() -> int:
    """CPU count from cgroup v2/v1 limits, falling back to os.cpu_count()
    (reference `CgroupUtil::getCpuLimit`, `cgroup_util.h:42`)."""
    try:
        with open("/sys/fs/cgroup/cpu.max") as fh:  # cgroup v2
            quota, period = fh.read().split()
            if quota != "max":
                return max(1, int(int(quota) / int(period)))
    except (OSError, ValueError):
        pass
    try:  # cgroup v1
        with open("/sys/fs/cgroup/cpu/cpu.cfs_quota_us") as fh:
            quota = int(fh.read())
        with open("/sys/fs/cgroup/cpu/cpu.cfs_period_us") as fh:
            period = int(fh.read())
        if quota > 0:
            return max(1, quota // period)
    except (OSError, ValueError):
        pass
    return os.cpu_count() or 1


def cgroup_memory_limit_mb() -> int:
    """Memory limit in MB from cgroup, x0.8 (reference `config.cc:33-40`)."""
    for path in ("/sys/fs/cgroup/memory.max", "/sys/fs/cgroup/memory/memory.limit_in_bytes"):
        try:
            with open(path) as fh:
                raw = fh.read().strip()
            if raw != "max":
                limit = int(raw)
                if limit < (1 << 60):
                    return int(limit * 0.8 / (1 << 20))
        except (OSError, ValueError):
            continue
    try:
        import resource  # noqa: F401

        total = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        return int(total * 0.8 / (1 << 20))
    except (OSError, ValueError):
        return 4096


class GlobalConfig:
    _instance: Optional["GlobalConfig"] = None
    _init_lock = threading.Lock()

    def __init__(self):
        self.initialized = False
        self.log_type = LogType.CONSOLE
        self.log_level = LogLevel.WARN
        self.log_dir = "./logs"
        self.log_basename = "zvec.log"
        self.log_file_size = 2048
        self.log_overdue_days = 7
        self.query_threads = cgroup_cpu_limit()
        self.optimize_threads = cgroup_cpu_limit()
        self.invert_to_forward_scan_ratio = 0.9
        self.brute_force_by_keys_ratio = 0.1
        self.memory_limit_mb = cgroup_memory_limit_mb()
        # forward block format: 'ipc' (memory-mapped Arrow) or 'parquet'
        # (reference supports both, `mmap_forward_store.cc:41-71`)
        self.forward_file_format = "ipc"
        # collection-level mesh sharding: sealed segment codes placed with a
        # corpus sharding over this many devices; 0/1 = single device. The
        # analog of the reference's per-segment plan fan-out
        # (`query_planner.cc:344-448`).
        self.mesh_devices = 0


    @classmethod
    def instance(cls) -> "GlobalConfig":
        if cls._instance is None:
            with cls._init_lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance

    @classmethod
    def _reset_for_tests(cls) -> None:
        with cls._init_lock:
            cls._instance = None

    # int-typed knobs (bool and float rejected with TypeError — reference
    # semantics, `python/tests/detail/test_db_config.py:139-151,288-310`)
    _INT_KEYS = (
        "log_file_size",
        "log_overdue_days",
        "query_threads",
        "optimize_threads",
        "memory_limit_mb",
        "mesh_devices",
    )
    _FLOAT_KEYS = ("invert_to_forward_scan_ratio", "brute_force_by_keys_ratio")

    def initialize(self, **kwargs) -> None:
        with self._init_lock:
            if self.initialized:
                # repeated init() succeeds as a no-op after the first
                # successful call (reference `test_db_config.py:125-131`)
                return
            for key, value in kwargs.items():
                if value is None:
                    continue
                if not hasattr(self, key):
                    raise ValueError(f"unknown config key '{key}'")
                if key in self._INT_KEYS and (
                    isinstance(value, bool) or not isinstance(value, int)
                ):
                    raise TypeError(f"config key '{key}' must be an int")
                if key in self._FLOAT_KEYS and not isinstance(value, (int, float)):
                    raise TypeError(f"config key '{key}' must be a number")
                setattr(self, key, value)
            self._validate()
            self._init_logging()
            self.initialized = True

    def _validate(self) -> None:
        if self.query_threads < 1:
            raise ValueError("query_threads must be >= 1")
        if self.optimize_threads < 1:
            raise ValueError("optimize_threads must be >= 1")
        if not 0.0 <= self.invert_to_forward_scan_ratio <= 1.0:
            raise ValueError("invert_to_forward_scan_ratio must be in [0, 1]")
        if not 0.0 <= self.brute_force_by_keys_ratio <= 1.0:
            raise ValueError("brute_force_by_keys_ratio must be in [0, 1]")
        if self.memory_limit_mb <= 0:
            raise ValueError("memory_limit_mb must be > 0")
        if self.memory_limit_mb < 100:
            # reference MIN_MEMORY_LIMIT_BYTES = 100MB (RuntimeError there,
            # `test_db_config.py:133-137`)
            raise RuntimeError("memory_limit_mb must be >= 100 (MB)")
        if self.log_file_size <= 0:
            raise ValueError("log_file_size must be > 0")
        if self.log_overdue_days <= 0:
            raise ValueError("log_overdue_days must be > 0")
        if self.forward_file_format not in ("ipc", "parquet"):
            raise ValueError("forward_file_format must be 'ipc' or 'parquet'")
        if self.mesh_devices < 0:
            raise ValueError("mesh_devices must be >= 0")
        if not isinstance(self.log_level, LogLevel):
            self.log_level = LogLevel(self.log_level)
        if not isinstance(self.log_type, LogType):
            self.log_type = LogType(self.log_type)

    def _init_logging(self) -> None:
        logger = logging.getLogger("zvec_tpu_torch")
        level = {
            LogLevel.DEBUG: logging.DEBUG,
            LogLevel.INFO: logging.INFO,
            LogLevel.WARN: logging.WARNING,
            LogLevel.ERROR: logging.ERROR,
            LogLevel.FATAL: logging.CRITICAL,
        }[self.log_level]
        logger.setLevel(level)
        if self.log_type == LogType.FILE:
            from logging.handlers import RotatingFileHandler

            # the FILE sink always materializes log_dir (reference
            # `test_init_file_logger`), even when another handler already
            # exists on the logger (e.g. fresh GlobalConfig instances in
            # tests); dedup is by target file, not handler presence
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.abspath(os.path.join(self.log_dir, self.log_basename))
            if any(
                getattr(h, "baseFilename", None) == path for h in logger.handlers
            ):
                return
            handler = RotatingFileHandler(
                path,
                maxBytes=self.log_file_size * (1 << 20),
                backupCount=max(1, self.log_overdue_days),
            )
        else:
            if logger.handlers:
                return
            handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        logger.addHandler(handler)


def scores_by_keys(n_pass: int, n: int) -> bool:
    """Whether `n_pass` rows passing of a segment's `n` are few enough to
    score by keys, bypassing the index (the reference's brute force by keys,
    `doc_filter.cc:120-122`): at most `brute_force_by_keys_ratio` of them,
    and never fewer than one row."""
    return n_pass <= max(1, int(GlobalConfig.instance().brute_force_by_keys_ratio * n))
