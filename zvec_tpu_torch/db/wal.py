"""Write-ahead log.

Per-segment durability point, as in the reference (`src/db/index/storage/wal/
wal_file.h:32-65`, `local_wal_file.cc`): every write op is appended + fsync'd
before being applied, replayed on open, and the file is removed after a
successful flush (`segment.cc:2160-2168`).

File layout: 8-byte magic header, then records:
  [u32 payload_len][u32 crc32c(payload)][payload bytes]
Framing, CRC32C and tail validation run in the native host library
(`native/zvec_host.cc`, the reference's `crc32c.cc`/`local_wal_file.cc`
equivalent) with a pure-Python fallback. A torn tail (partial record or CRC
mismatch) truncates replay at the last good record.
"""

from __future__ import annotations

import os
from typing import Iterator, List

from ..utils.native import wal_append_batch, wal_scan

__all__ = ["WalFile"]

_MAGIC = b"ZVWAL\x02\x00\x00"


class WalFile:
    def __init__(self, path: str, sync: bool = True):
        self.path = path
        self.sync = sync
        self._fh = None
        self._pending: List[bytes] = []

    # ---- write side ----
    def open_for_append(self) -> None:
        exists = os.path.exists(self.path) and os.path.getsize(self.path) > 0
        self._fh = open(self.path, "ab")
        if not exists:
            self._fh.write(_MAGIC)
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def append(self, payload: bytes) -> None:
        """Stage a record; durable after the next flush()/append_batch()."""
        if self._fh is None:
            self.open_for_append()
        self._pending.append(payload)

    def append_batch(self, payloads: List[bytes]) -> None:
        """Append a write batch and make it durable with a single fsync."""
        if self._fh is None:
            self.open_for_append()
        self._pending.extend(payloads)
        self.flush()

    def flush(self) -> None:
        if self._fh is None or not self._pending:
            if self._fh is not None:
                self._fh.flush()
                if self.sync:
                    os.fsync(self._fh.fileno())
            return
        self._fh.flush()  # any buffered python-side writes first
        wal_append_batch(self._fh.fileno(), self._pending, sync=self.sync)
        self._pending.clear()

    def close(self) -> None:
        if self._fh is not None:
            self.flush()
            self._fh.close()
            self._fh = None

    def remove(self) -> None:
        self.close()
        self._pending.clear()
        if os.path.exists(self.path):
            os.remove(self.path)

    # ---- read side ----
    def replay(self) -> Iterator[bytes]:
        """Yield every intact record; stop silently at a torn tail."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as fh:
            blob = fh.read()
        if blob[: len(_MAGIC)] != _MAGIC:
            return
        region = blob[len(_MAGIC) :]
        for offset, length in wal_scan(region):
            yield region[offset : offset + length]
