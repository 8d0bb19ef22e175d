"""The system under test: zvec_tpu_torch driven through its public API.

Set-up builds the program's CUDA kernels (once per checkout), then
`create_and_open` -> `insert` (batches of the program's largest
write batch) -> `flush` -> `optimize()`, then the mix's warm-up calls; each
call of the window is one `Collection.batch_query(field, queries, topk,
filter, param, output_fields)`. Besides the answers, the harness reads the
program's own counters: `EngineStats.total_search_secs` of each segment's
engine, `hnsw_search.last_steps`, and `HnswEngine.build_times`.
"""

from __future__ import annotations

import time
from array import array
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .gen.calls import render

WRITE_BATCH = 1024  # the program's MAX_WRITE_BATCH_SIZE


def _enum_args(zt, kwargs: dict) -> dict:
    out = dict(kwargs)
    if "metric_type" in out:
        out["metric_type"] = zt.MetricType[out["metric_type"]]
    if "quantize_type" in out:
        out["quantize_type"] = zt.QuantizeType[out["quantize_type"]]
    return out


def _make(zt, spec: Optional[dict]):
    """A parameter object of the program from {"class": name, **kwargs}."""
    if spec is None:
        return None
    kwargs = {k: v for k, v in spec.items() if k != "class"}
    return getattr(zt, spec["class"])(**_enum_args(zt, kwargs))


class PortSystem:
    def __init__(self, config: dict, traffic: dict, workdir: Path, device: torch.device):
        import zvec_tpu_torch as zt

        self.zt, self.config, self.device = zt, config, device
        self.path = workdir / config["name"]
        self.field = config["vector_field"]
        self.topk = traffic["topk"]
        self.param = _make(zt, traffic.get("param"))
        self.output_fields = traffic.get("output_fields", [])
        self.col = None
        self._engines: List = []

    def _schema(self):
        zt, cfg = self.zt, self.config
        fields = [
            zt.FieldSchema(
                f["name"], zt.DataType[f["type"]],
                index_param=zt.InvertIndexParam() if f.get("invert") else None,
            )
            for f in cfg.get("fields", [])
        ]
        vector = zt.VectorSchema(
            self.field, zt.DataType[cfg["vector_type"]], cfg["dim"], _make(zt, cfg["index"])
        )
        return zt.CollectionSchema(cfg["name"], fields=fields, vectors=[vector])

    def setup(self, x: np.ndarray, fields: Dict[str, np.ndarray]) -> dict:
        """Create, fill and optimize the collection. Returns the seconds of
        each step and the index build's own phases."""
        zt = self.zt
        if self.device.type == "cuda":
            from zvec_tpu_torch.ops.flat_scan import build_kernels

            build_kernels()  # nvcc on a checkout's first run: set-up, not the index build
        t0 = time.perf_counter()
        self.col = zt.create_and_open(str(self.path), self._schema())
        names = list(fields)
        columns = [fields[n].tolist() for n in names]
        for lo in range(0, x.shape[0], WRITE_BATCH):
            hi = min(lo + WRITE_BATCH, x.shape[0])
            docs = [
                zt.Doc(id=str(i), vectors={self.field: x[i]},
                       fields={n: col[i] for n, col in zip(names, columns)})
                for i in range(lo, hi)
            ]
            failed = [s for s in self.col.insert(docs) if not s.ok()]
            if failed:
                raise RuntimeError(f"insert failed: {failed[0]}")
        t1 = time.perf_counter()
        self.col.flush()
        t2 = time.perf_counter()
        self.col.optimize()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t3 = time.perf_counter()
        segs = [s for s in self.col._impl._segments_snapshot() if s.doc_count > 0]
        self._engines = [s.engine_for(self.field) for s in segs]
        build_times = {}
        for eng in self._engines:
            for key, secs in getattr(eng, "build_times", {}).items():
                build_times[key] = build_times.get(key, 0.0) + secs
        return {"insert_s": t1 - t0, "flush_s": t2 - t1, "build_s": t3 - t2,
                "segments": len(segs), "build_times": build_times}

    def query(self, call, queries: np.ndarray):
        return self.col.batch_query(
            self.field, queries[call.lo : call.hi], topk=self.topk,
            filter=render(call.clauses), param=self.param, output_fields=self.output_fields,
        )

    @staticmethod
    def keep(docs):
        """What the comparison needs of a call's answers, in objects the
        garbage collector does not traverse: the pks joined into one string,
        the scores and the answers per query in arrays. (Lists of the Doc
        objects, or of their ids, kept over a window would make every full
        collection of the program's process walk millions of entries.)"""
        return ("\n".join([d.id for row in docs for d in row]),
                array("d", [d.score for row in docs for d in row]),
                array("l", [len(row) for row in docs]))

    def answers(self, kept, nq: int):
        """(pks (Q, k) int64, -1 where no answer, -2 where the pk is not a
        row number; scores (Q, k) float64, NaN where no answer)."""
        joined, scores, lens = kept
        ids = joined.split("\n") if joined else []
        lens = np.frombuffer(lens, dtype=np.int64) if len(lens) else np.zeros(0, np.int64)
        k = self.topk
        pks = np.full((nq, k), -1, np.int64)
        sc = np.full((nq, k), np.nan)
        rows = np.repeat(np.arange(len(lens)), lens)
        cols = np.arange(len(ids)) - np.repeat(np.cumsum(lens) - lens, lens)
        keep = (rows < nq) & (cols < k)
        text = np.array(ids, dtype=str)
        digits = np.char.isdigit(text)
        num = np.full(len(ids), -2, np.int64)
        num[digits] = text[digits].astype(np.int64)
        pks[rows[keep], cols[keep]] = num[keep]
        sc[rows[keep], cols[keep]] = np.frombuffer(scores, dtype=np.float64)[keep]
        return pks, sc

    def engine_secs(self) -> float:
        return sum(e.stats.total_search_secs for e in self._engines)

    @staticmethod
    def beam_steps() -> int:
        from zvec_tpu_torch.ops.hnsw import hnsw_search

        return int(hnsw_search.last_steps)

    @staticmethod
    def reset_beam_steps() -> None:
        from zvec_tpu_torch.ops.hnsw import hnsw_search

        hnsw_search.last_steps = 0

    def close(self) -> None:
        """Release the collection and its device state."""
        if self.col is not None:
            self.col._impl.close()
        self.col, self._engines = None, []
