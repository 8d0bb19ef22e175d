"""Recall of the sparse HNSW engine of both packages on one corpus, on the CPU.

    python tests/parity_sparse_recall.py [rows]     (default 20,000; ~6 min at 170,000)

Not a test (pytest does not collect it): a one-off check that takes minutes.
Both engines take the clustered signature build (forced) on documents of
`benchmarks/bench_sparse1m.py`'s generator (through `chip_smoke.py`'s copy) and
answer 64 queries at ef 32 / 64 / 128 / 256; recall@10 is read against a
torch.sparse product. From 160,000 rows on the build makes more than 128
clusters while the engine keeps at most 128 medoid entries, which is where
recall at a given ef falls in both packages alike.
"""

import os
import sys
import time
from pathlib import Path

os.environ["ZVEC_SPARSE_CLUSTERED"] = "1"  # the JAX engine's switch; the port's is an attribute
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from zvec_tpu.core import hnsw_sparse as jcore  # noqa: E402
from zvec_tpu.model.param.param import HnswIndexParam as JIndexParam  # noqa: E402
from zvec_tpu.model.param.param import HnswQueryParam as JQueryParam  # noqa: E402
from zvec_tpu_torch.core import hnsw_sparse as tcore  # noqa: E402
from zvec_tpu_torch.model.param.param import HnswIndexParam, HnswQueryParam  # noqa: E402

NQ, K = 64, 10


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20_000
    pools = cs.sparse_topic_model()
    idx, val = cs.sparse_make_rows(pools, n, cs.SP_NNZ_DOC, cs.SP_SEED + 1)
    rows = cs.sparse_rows_to_dicts(idx, val)
    q_idx, q_val = cs.sparse_make_rows(pools, NQ, cs.SP_NNZ_Q, cs.SP_SEED + 77, head_frac=0.25)
    queries = cs.sparse_rows_to_dicts(q_idx, q_val)
    _, exact = cs._sparse_oracle([(idx, val)], q_idx, q_val, torch.device("cpu"), K)

    def recall(ids):
        return float(np.mean([len(set(ids[r].tolist()) & set(exact[r].tolist())) for r in range(NQ)]) / K)

    for name, core, index_param, query_param in (
        ("zvec_tpu_torch", tcore, HnswIndexParam, HnswQueryParam),
        ("zvec_tpu", jcore, JIndexParam, JQueryParam),
    ):
        ip = core.MetricType.IP
        engine = core.SparseHnswEngine(ip, 0, index_param(ip, m=16, ef_construction=200))
        engine.bind_data(lambda: rows, lambda: 1)
        engine._force_clustered = True  # read by the port only
        t0 = time.perf_counter()
        engine._ensure_fresh()
        built = time.perf_counter() - t0
        got = {ef: round(recall(np.asarray(engine.search(queries, K, param=query_param(ef=ef))[1])), 4)
               for ef in (32, 64, 128, 256)}
        print(f"{name}: {n} rows, build {built:.1f} s on the CPU, recall@{K} by ef {got}", flush=True)


if __name__ == "__main__":
    main()
