"""VersionManager: MVCC-style manifest making flush/compaction atomic.

Reference equivalent: `src/db/index/common/version_manager.h:28-205` (protobuf
segment metas + CURRENT pointer). A `Version` is a JSON document listing the
persisted segments, the writing segment, id allocators, the schema, and the
delete-store snapshot suffix. Commit = write `version_<n>.json` + atomic
rename of `CURRENT`; readers always load a consistent world.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

__all__ = ["SegmentMeta", "Version", "VersionManager"]


class SegmentMeta:
    """One segment's manifest entry."""

    def __init__(
        self,
        segment_id: int,
        doc_id_start: int,
        doc_count: int = 0,
        state: str = "writing",  # writing | sealed
        indexes: Optional[Dict[str, Dict[str, Any]]] = None,  # field -> index descriptor
        gen: int = 0,  # checkpoint/WAL generation (writing segments only)
    ):
        self.segment_id = segment_id
        self.doc_id_start = doc_id_start
        self.doc_count = doc_count
        self.state = state
        self.indexes = indexes or {}
        # Crash-atomic flush: each flush writes ckpt_{gen+1}.arrow + rotates to
        # wal_{gen+1}.log, THEN commits a version with the bumped gen, THEN
        # deletes the gen-g files. A crash at any point leaves CURRENT pointing
        # at one self-consistent (checkpoint, WAL) pair — the WAL always holds
        # exactly the operations after its checkpoint (reference analog: WAL
        # dropped only after manifest commit, `segment.cc:2160-2168`).
        self.gen = gen

    @property
    def dirname(self) -> str:
        return f"seg_{self.segment_id}"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "segment_id": self.segment_id,
            "doc_id_start": self.doc_id_start,
            "doc_count": self.doc_count,
            "state": self.state,
            "indexes": self.indexes,
            "gen": self.gen,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SegmentMeta":
        return cls(
            d["segment_id"],
            d["doc_id_start"],
            d.get("doc_count", 0),
            d.get("state", "writing"),
            d.get("indexes", {}),
            d.get("gen", 0),
        )


class Version:
    def __init__(
        self,
        version_id: int,
        schema_dict: Dict[str, Any],
        segments: List[SegmentMeta],
        next_doc_id: int,
        next_segment_id: int,
        delete_snapshot: Optional[str] = None,
        idmap_snapshot: Optional[str] = None,
    ):
        self.version_id = version_id
        self.schema_dict = schema_dict
        self.segments = segments
        self.next_doc_id = next_doc_id
        self.next_segment_id = next_segment_id
        self.delete_snapshot = delete_snapshot
        self.idmap_snapshot = idmap_snapshot

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version_id": self.version_id,
            "schema": self.schema_dict,
            "segments": [s.to_dict() for s in self.segments],
            "next_doc_id": self.next_doc_id,
            "next_segment_id": self.next_segment_id,
            "delete_snapshot": self.delete_snapshot,
            "idmap_snapshot": self.idmap_snapshot,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Version":
        return cls(
            d["version_id"],
            d["schema"],
            [SegmentMeta.from_dict(s) for s in d.get("segments", [])],
            d["next_doc_id"],
            d["next_segment_id"],
            d.get("delete_snapshot"),
            d.get("idmap_snapshot"),
        )


class VersionManager:
    CURRENT = "CURRENT"

    def __init__(self, root: str):
        self.root = root

    def _version_path(self, version_id: int) -> str:
        return os.path.join(self.root, f"version_{version_id}.json")

    def has_current(self) -> bool:
        return os.path.exists(os.path.join(self.root, self.CURRENT))

    def commit(self, version: Version, keep: int = 3) -> None:
        """Persist a new version and atomically swing CURRENT to it."""
        path = self._version_path(version.version_id)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(version.to_dict(), fh, indent=1)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)

        cur = os.path.join(self.root, self.CURRENT)
        cur_tmp = cur + ".tmp"
        with open(cur_tmp, "w") as fh:
            fh.write(str(version.version_id))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(cur_tmp, cur)
        self._gc(version.version_id, keep)

    def load_current(self) -> Version:
        cur = os.path.join(self.root, self.CURRENT)
        with open(cur) as fh:
            version_id = int(fh.read().strip())
        with open(self._version_path(version_id)) as fh:
            return Version.from_dict(json.load(fh))

    def _gc(self, current_id: int, keep: int) -> None:
        for name in os.listdir(self.root):
            if name.startswith("version_") and name.endswith(".json"):
                try:
                    vid = int(name[len("version_") : -len(".json")])
                except ValueError:
                    continue
                if vid <= current_id - keep:
                    try:
                        os.remove(os.path.join(self.root, name))
                    except OSError:
                        pass
