"""ctypes binding for the native host library (native/zvec_host.cc).

Builds `libzvec_host.so` with g++ on first use if missing; every entry point
has a pure-Python fallback so the package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["native_lib", "crc32c", "wal_append_batch", "wal_scan"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "build", "libzvec_host.so")

_lib = None
_lib_lock = threading.Lock()
_tried = False


def native_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lib_lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_SO_PATH) and os.path.exists(
                os.path.join(_NATIVE_DIR, "Makefile")
            ):
                subprocess.run(
                    ["make", "-s"],
                    cwd=_NATIVE_DIR,
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            lib = ctypes.CDLL(_SO_PATH)
            lib.zvec_crc32c.restype = ctypes.c_uint32
            lib.zvec_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
            lib.zvec_wal_append_batch.restype = ctypes.c_int
            lib.zvec_wal_append_batch.argtypes = [
                ctypes.c_int,
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_uint64,
                ctypes.c_int,
            ]
            lib.zvec_wal_scan.restype = ctypes.c_int64
            lib.zvec_wal_scan.argtypes = [
                ctypes.c_char_p,
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_uint64,
            ]
            _lib = lib
        except (OSError, subprocess.SubprocessError):
            _lib = None
        return _lib


# ---------------- crc32c ----------------
_CRC32C_POLY = 0x82F63B78
_crc_table = None


def _py_crc_table():
    global _crc_table
    if _crc_table is None:
        table = np.zeros(256, dtype=np.uint32)
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (_CRC32C_POLY if crc & 1 else 0)
            table[i] = crc
        _crc_table = table
    return _crc_table


def crc32c(data: bytes) -> int:
    lib = native_lib()
    if lib is not None:
        return lib.zvec_crc32c(data, len(data))
    table = _py_crc_table()
    crc = 0xFFFFFFFF
    arr = np.frombuffer(data, dtype=np.uint8)
    for b in arr:
        crc = int(table[(crc ^ int(b)) & 0xFF]) ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---------------- WAL ----------------
def wal_append_batch(fd: int, payloads: Sequence[bytes], sync: bool = True) -> None:
    """Frame + append + fsync a batch of payloads to an open fd."""
    lib = native_lib()
    if lib is not None and payloads:
        blob = b"".join(payloads)
        lengths = (ctypes.c_uint64 * len(payloads))(*[len(p) for p in payloads])
        rc = lib.zvec_wal_append_batch(
            fd, blob, lengths, len(payloads), 1 if sync else 0
        )
        if rc != 0:
            raise OSError(f"native wal append failed: {rc}")
        return
    import struct

    for p in payloads:
        os.write(fd, struct.pack("<II", len(p), crc32c(p)) + p)
    if sync:
        os.fsync(fd)


def wal_scan(data: bytes) -> List[Tuple[int, int]]:
    """Validated (offset, length) pairs of intact records in a WAL region."""
    lib = native_lib()
    if lib is not None:
        cap = max(len(data) // 8, 1)
        offsets = (ctypes.c_uint64 * cap)()
        lengths = (ctypes.c_uint64 * cap)()
        n = lib.zvec_wal_scan(data, len(data), offsets, lengths, cap)
        return [(int(offsets[i]), int(lengths[i])) for i in range(n)]
    import struct

    out = []
    pos = 0
    size = len(data)
    while pos + 8 <= size:
        length, crc = struct.unpack_from("<II", data, pos)
        if pos + 8 + length > size:
            break
        payload = data[pos + 8 : pos + 8 + length]
        if crc32c(payload) != crc:
            break
        out.append((pos + 8, length))
        pos += 8 + length
    return out
