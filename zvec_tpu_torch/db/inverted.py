"""Inverted scalar index: term -> posting rows, with selectivity estimation.

Reference equivalent: `src/db/index/column/inverted_column/` — RocksDB
term -> roaring-bitmap postings with order-preserving numeric key encoding for
range scans (`inverted_codec.h:38-104`), EQ/NE/range/IN/CONTAIN/LIKE-prefix
(+ reversed-string suffix under `enable_extended_wildcard`) operators, and
`evaluate_ratio` selectivity estimation feeding the planner
(`inverted_column_indexer.h:136,312-348`).

Host-side TPU-native shape: postings are sorted numpy row-id arrays grouped by
value; numeric range = two searchsorted calls over the sorted value column;
string prefix = searchsorted over sorted terms. The output is always a dense
row mask ready to fuse into the device kernel.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..typing.enum import DataType

__all__ = ["InvertedColumnIndex"]


class InvertedColumnIndex:
    """Immutable per-(sealed segment, column) inverted index."""

    def __init__(
        self,
        n_rows: int,
        data_type: DataType,
        enable_range_optimization: bool = False,
        enable_extended_wildcard: bool = False,
    ):
        self.n_rows = n_rows
        self.data_type = DataType(data_type)
        self.enable_range_optimization = enable_range_optimization
        self.enable_extended_wildcard = enable_extended_wildcard
        self._is_numeric = False
        # numeric: value-sorted rows
        self._sorted_vals: Optional[np.ndarray] = None
        self._rows_by_val: Optional[np.ndarray] = None
        # string/categorical/array-element: term -> sorted row ids
        self._postings: Dict[Any, np.ndarray] = {}
        self._sorted_terms: Optional[List[str]] = None
        self._sorted_terms_rev: Optional[List[str]] = None
        self._null_rows: np.ndarray = np.zeros(0, dtype=np.int64)

    # ---------------- build ----------------
    @classmethod
    def build(
        cls,
        values: np.ndarray,
        null_mask: np.ndarray,
        data_type: DataType,
        enable_range_optimization: bool = False,
        enable_extended_wildcard: bool = False,
    ) -> "InvertedColumnIndex":
        idx = cls(
            len(values), data_type, enable_range_optimization, enable_extended_wildcard
        )
        idx._null_rows = np.nonzero(null_mask)[0].astype(np.int64)
        dt = DataType(data_type)
        valid = ~null_mask

        if dt.is_array:
            post: Dict[Any, List[int]] = {}
            for row in np.nonzero(valid)[0]:
                items = values[row]
                if items is None:
                    continue
                for item in set(_as_terms(items)):
                    post.setdefault(item, []).append(row)
            idx._postings = {
                k: np.asarray(v, dtype=np.int64) for k, v in post.items()
            }
            if all(isinstance(k, str) for k in idx._postings):
                idx._sorted_terms = sorted(idx._postings.keys())
            return idx

        if dt in (
            DataType.INT32,
            DataType.INT64,
            DataType.UINT32,
            DataType.UINT64,
            DataType.FLOAT,
            DataType.DOUBLE,
            DataType.BOOL,
        ):
            idx._is_numeric = True
            rows = np.nonzero(valid)[0]
            vals = np.asarray(
                [values[r] for r in rows], dtype=np.float64
            )
            order = np.argsort(vals, kind="stable")
            idx._sorted_vals = vals[order]
            idx._rows_by_val = rows[order].astype(np.int64)
            return idx

        # strings
        post = {}
        for row in np.nonzero(valid)[0]:
            post.setdefault(values[row], []).append(row)
        idx._postings = {k: np.asarray(v, dtype=np.int64) for k, v in post.items()}
        idx._sorted_terms = sorted(idx._postings.keys())
        if enable_extended_wildcard:
            idx._sorted_terms_rev = sorted(t[::-1] for t in idx._postings.keys())
        return idx

    # ---------------- query ----------------
    def supports(self, op: str) -> bool:
        if self._is_numeric:
            return op in ("=", "!=", "<", "<=", ">", ">=", "IN", "NOT_IN")
        base = op in ("=", "!=", "IN", "NOT_IN", "CONTAIN_ALL", "CONTAIN_ANY",
                      "NOT_CONTAIN_ALL", "NOT_CONTAIN_ANY")
        if base:
            return True
        if op in ("LIKE",) and self._sorted_terms is not None:
            return True
        if op == "HAS_PREFIX" and self._sorted_terms is not None:
            return True
        if op == "HAS_SUFFIX" and self._sorted_terms is not None:
            return True
        return False

    def evaluate_ratio(self, op: str, value) -> float:
        """Cheap selectivity estimate (matched / total), feeding the
        invert_to_forward_scan_ratio planner rule (`optimizer.cc:66-95`)."""
        if self.n_rows == 0:
            return 0.0
        try:
            count = len(self.query(op, value))
        except (KeyError, TypeError, ValueError):
            return 1.0
        return count / self.n_rows

    def query(self, op: str, value) -> np.ndarray:
        """Row ids (sorted ascending) matching the predicate. NULL rows never
        match (SQL semantics)."""
        if self._is_numeric:
            return self._query_numeric(op, value)
        return self._query_terms(op, value)

    def _query_numeric(self, op: str, value) -> np.ndarray:
        sv, rows = self._sorted_vals, self._rows_by_val
        if op == "IN":
            parts = [self._query_numeric("=", v) for v in value]
            return _union(parts)
        if op == "NOT_IN":
            return self._complement(self._query_numeric("IN", value))
        v = float(value) if not isinstance(value, bool) else float(bool(value))
        if op == "=":
            lo = np.searchsorted(sv, v, "left")
            hi = np.searchsorted(sv, v, "right")
            return np.sort(rows[lo:hi])
        if op == "!=":
            return self._complement(self._query_numeric("=", value))
        if op == "<":
            return np.sort(rows[: np.searchsorted(sv, v, "left")])
        if op == "<=":
            return np.sort(rows[: np.searchsorted(sv, v, "right")])
        if op == ">":
            return np.sort(rows[np.searchsorted(sv, v, "right") :])
        if op == ">=":
            return np.sort(rows[np.searchsorted(sv, v, "left") :])
        raise ValueError(f"unsupported numeric op {op}")

    def _query_terms(self, op: str, value) -> np.ndarray:
        if op == "=":
            return self._postings.get(value, np.zeros(0, dtype=np.int64))
        if op == "!=":
            return self._complement(self._query_terms("=", value))
        if op in ("IN", "CONTAIN_ANY"):
            return _union([self._query_terms("=", v) for v in value])
        if op == "NOT_IN":
            return self._complement(self._query_terms("IN", value))
        if op == "CONTAIN_ALL":
            parts = [self._query_terms("=", v) for v in value]
            return _intersect(parts)
        if op == "NOT_CONTAIN_ANY":
            return self._complement(self._query_terms("CONTAIN_ANY", value))
        if op == "NOT_CONTAIN_ALL":
            return self._complement(self._query_terms("CONTAIN_ALL", value))
        if op == "LIKE":
            return self._query_like(value)
        if op == "HAS_PREFIX":
            # range scan over sorted terms (reference
            # `inverted_column_indexer_search.cc:797` get_bitmap_prefix)
            return self._prefix_rows(self._sorted_terms, value, rev=False)
        if op == "HAS_SUFFIX":
            # reversed-term range scan when available
            # (`inverted_column_indexer_search.cc:801` get_bitmap_suffix)
            if self._sorted_terms_rev is not None:
                return self._prefix_rows(self._sorted_terms_rev, value[::-1], rev=True)
            parts = [
                rows
                for term, rows in self._postings.items()
                if isinstance(term, str) and term.endswith(value)
            ]
            return _union(parts)
        raise ValueError(f"unsupported term op {op}")

    def _query_like(self, pattern: str) -> np.ndarray:
        # prefix: 'abc%' — range scan over sorted terms
        if (
            pattern.endswith("%")
            and "%" not in pattern[:-1]
            and "_" not in pattern
            and self._sorted_terms is not None
        ):
            prefix = pattern[:-1]
            return self._prefix_rows(self._sorted_terms, prefix, rev=False)
        # suffix: '%abc' — reversed-term range scan (extended wildcard)
        if (
            pattern.startswith("%")
            and "%" not in pattern[1:]
            and "_" not in pattern
            and self._sorted_terms_rev is not None
        ):
            suffix = pattern[1:][::-1]
            return self._prefix_rows(self._sorted_terms_rev, suffix, rev=True)
        # general LIKE: regex over terms (term dictionary is much smaller
        # than the row count)
        from .filter.expression import _like_to_regex

        regex = _like_to_regex(pattern)
        parts = [
            rows for term, rows in self._postings.items() if regex.match(term)
        ]
        return _union(parts)

    def _prefix_rows(self, terms: List[str], prefix: str, rev: bool) -> np.ndarray:
        import bisect

        lo = bisect.bisect_left(terms, prefix)
        hi = bisect.bisect_left(terms, prefix + "￿")
        parts = []
        for t in terms[lo:hi]:
            key = t[::-1] if rev else t
            parts.append(self._postings[key])
        return _union(parts)

    def _complement(self, rows: np.ndarray) -> np.ndarray:
        mask = np.ones(self.n_rows, dtype=bool)
        mask[rows] = False
        mask[self._null_rows] = False
        return np.nonzero(mask)[0].astype(np.int64)

    def mask(self, op: str, value) -> np.ndarray:
        m = np.zeros(self.n_rows, dtype=bool)
        m[self.query(op, value)] = True
        return m

    # ---------------- persistence ----------------
    def save(self, path: str) -> None:
        payload = {
            "n_rows": np.int64(self.n_rows),
            "data_type": np.int64(int(self.data_type)),
            "flags": np.asarray(
                [self.enable_range_optimization, self.enable_extended_wildcard],
                dtype=np.int8,
            ),
            "null_rows": self._null_rows,
            "is_numeric": np.int8(self._is_numeric),
        }
        if self._is_numeric:
            payload["sorted_vals"] = self._sorted_vals
            payload["rows_by_val"] = self._rows_by_val
        else:
            terms = list(self._postings.keys())
            payload["terms"] = np.asarray([str(t) for t in terms], dtype=object)
            payload["term_is_str"] = np.asarray(
                [isinstance(t, str) for t in terms], dtype=np.int8
            )
            for i, t in enumerate(terms):
                payload[f"post_{i}"] = self._postings[t]
        np.savez_compressed(path, **payload, allow_pickle=True)

    @classmethod
    def load(cls, path: str) -> "InvertedColumnIndex":
        data = np.load(path, allow_pickle=True)
        flags = data["flags"]
        idx = cls(
            int(data["n_rows"]),
            DataType(int(data["data_type"])),
            bool(flags[0]),
            bool(flags[1]),
        )
        idx._null_rows = data["null_rows"]
        idx._is_numeric = bool(data["is_numeric"])
        if idx._is_numeric:
            idx._sorted_vals = data["sorted_vals"]
            idx._rows_by_val = data["rows_by_val"]
        else:
            terms = data["terms"]
            is_str = data["term_is_str"]
            for i, t in enumerate(terms):
                key = str(t) if is_str[i] else _parse_term(str(t))
                idx._postings[key] = data[f"post_{i}"]
            if all(isinstance(k, str) for k in idx._postings):
                idx._sorted_terms = sorted(idx._postings.keys())
            if idx.enable_extended_wildcard and idx._sorted_terms is not None:
                idx._sorted_terms_rev = sorted(
                    t[::-1] for t in idx._postings.keys()
                )
        return idx


def _as_terms(items):
    for item in items:
        if isinstance(item, (np.generic,)):
            yield item.item()
        else:
            yield item


def _parse_term(s: str):
    try:
        return int(s)
    except ValueError:
        try:
            return float(s)
        except ValueError:
            return s


def _union(parts: List[np.ndarray]) -> np.ndarray:
    parts = [p for p in parts if p.size]
    if not parts:
        return np.zeros(0, dtype=np.int64)
    return np.unique(np.concatenate(parts))


def _intersect(parts: List[np.ndarray]) -> np.ndarray:
    if not parts:
        return np.zeros(0, dtype=np.int64)
    out = parts[0]
    for p in parts[1:]:
        out = np.intersect1d(out, p, assume_unique=True)
    return out
