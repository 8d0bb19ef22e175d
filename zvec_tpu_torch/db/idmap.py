"""IDMap: primary key (string) -> global doc_id.

Reference equivalent: RocksDB-backed `IdMap` (`src/db/index/common/id_map.h:28-75`).
Here it is a host-side hash map with Arrow IPC snapshots; incremental changes
between snapshots are recovered from the segment WAL replay, so the map itself
needs no log.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional

import pyarrow as pa
import pyarrow.ipc as ipc

__all__ = ["IdMap"]


class IdMap:
    def __init__(self):
        self._map: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._map)

    def has(self, pk: str) -> bool:
        return pk in self._map

    def get(self, pk: str) -> Optional[int]:
        return self._map.get(pk)

    def upsert(self, pk: str, doc_id: int) -> None:
        self._map[pk] = doc_id

    def bulk_upsert(self, pks: List[str], doc_id_start: int) -> None:
        """Assign consecutive doc_ids starting at `doc_id_start` (compaction remap)."""
        self._map.update(zip(pks, range(doc_id_start, doc_id_start + len(pks))))

    def remove(self, pk: str) -> None:
        self._map.pop(pk, None)

    def multi_get(self, pks: Iterable[str]) -> List[Optional[int]]:
        return [self._map.get(pk) for pk in pks]

    def items(self):
        return self._map.items()

    # ---- snapshots ----
    def snapshot(self, path: str) -> None:
        table = pa.table(
            {
                "pk": pa.array(list(self._map.keys()), type=pa.string()),
                "doc_id": pa.array(list(self._map.values()), type=pa.int64()),
            }
        )
        tmp = path + ".tmp"
        with ipc.new_file(tmp, table.schema) as writer:
            writer.write_table(table)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "IdMap":
        m = cls()
        if os.path.exists(path):
            with ipc.open_file(path) as reader:
                table = reader.read_all()
            pks = table.column("pk").to_pylist()
            ids = table.column("doc_id").to_pylist()
            m._map = dict(zip(pks, ids))
        return m
