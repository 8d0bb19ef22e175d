"""DeleteStore: global tombstone set over doc_ids.

Reference equivalent: concurrent roaring bitmap + IndexFilter adapter
(`src/db/index/common/delete_store.h:27-110`). Difference on the card: instead
of bitmap intersection at scan time, the store materializes **dense
per-segment alive masks**; the collection ANDs one with the filter's rows
(`CollectionImpl._row_mask`) and the engine copies the result to the card,
where the scan kernels read it as a select (`core/interface.py::device_row_mask`).
"""

from __future__ import annotations

import os
from typing import Set

import numpy as np

__all__ = ["DeleteStore"]


class DeleteStore:
    def __init__(self):
        self._deleted: Set[int] = set()
        # bumped on every change: part of the key of a segment's cached row
        # mask (`CollectionImpl._row_mask`)
        self._version = 0

    def __len__(self) -> int:
        return len(self._deleted)

    @property
    def version(self) -> int:
        return self._version

    def mark(self, doc_id: int) -> None:
        if doc_id not in self._deleted:
            self._deleted.add(doc_id)
            self._version += 1

    def unmark(self, doc_id: int) -> None:
        if doc_id in self._deleted:
            self._deleted.discard(doc_id)
            self._version += 1

    def unmark_range(self, start: int, count: int) -> None:
        """Drop all tombstones in [start, start+count) (compaction cleanup)."""
        before = len(self._deleted)
        self._deleted = {d for d in self._deleted if not start <= d < start + count}
        if len(self._deleted) != before:
            self._version += 1

    def is_deleted(self, doc_id: int) -> bool:
        return doc_id in self._deleted

    def alive_mask(self, start: int, count: int) -> np.ndarray:
        """Dense bool mask (True = alive) for a segment's doc_id range.

        Reads are lock-free by design: snapshot the tombstone set with a
        GIL-atomic `set.copy()` before iterating — the python-level
        generator below yields between items, so iterating the LIVE set
        races concurrent `mark()` ('Set changed size during iteration',
        caught by the concurrency hammer)."""
        mask = np.ones(count, dtype=bool)
        if self._deleted:
            snap = self._deleted.copy()
            ids = np.fromiter(
                (d - start for d in snap if start <= d < start + count),
                dtype=np.int64,
            )
            if ids.size:
                mask[ids] = False
        return mask

    def deleted_in_range(self, start: int, count: int) -> int:
        snap = self._deleted.copy()  # GIL-atomic; see alive_mask
        return sum(1 for d in snap if start <= d < start + count)

    # ---- snapshots ----
    def snapshot(self, path: str) -> None:
        snap = self._deleted.copy()  # GIL-atomic; see alive_mask
        arr = np.fromiter(snap, dtype=np.int64, count=len(snap))
        arr.sort()
        tmp = path + ".tmp"
        np.save(tmp, arr, allow_pickle=False)
        # np.save appends .npy to paths without the suffix
        src = tmp if tmp.endswith(".npy") else tmp + ".npy"
        os.replace(src, path)

    @classmethod
    def load(cls, path: str) -> "DeleteStore":
        store = cls()
        if os.path.exists(path):
            arr = np.load(path, allow_pickle=False)
            store._deleted = set(int(x) for x in arr)
        return store
