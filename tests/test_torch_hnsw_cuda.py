"""HNSW ops on the card against the same ops on the CPU.

Marked `cuda`: without a card these skip. Run them on a GPU machine with
`python -m pytest tests/test_torch_hnsw_cuda.py -q`. The CPU side is held to
zvec_tpu by the other test_torch_hnsw_* files.

Tolerances: float32 sums run in another order on the card, so a dominance
test or a beam merge that sits within an ulp may flip; pruned rows must be
equal on at least 99% of nodes, beam id sets equal on at least 98% of
queries, and scores of equal rows within 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zvec_tpu_torch.core.hnsw import HnswEngine  # noqa: E402
from zvec_tpu_torch.model.param.param import HnswIndexParam  # noqa: E402
from zvec_tpu_torch.ops import hnsw as ops  # noqa: E402
from zvec_tpu_torch.ops.flat_scan import flat_scan_topk  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flat-scan kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_knn_build_step_launches_kernel(cuda, metric):
    n, knn_k, max_out = 8192, 127, 32
    x = np.random.default_rng(0).standard_normal((n, 24)).astype(np.float32)
    norms2 = (x**2).sum(1).astype(np.float32)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        adj = torch.full((n, max_out), -1, dtype=torch.int32, device=dev)
        before = flat_scan_topk.launches
        ops.knn_build_step(
            torch.arange(2048, device=dev), torch.from_numpy(x).to(dev),
            torch.from_numpy(norms2).to(dev), torch.ones(n, dtype=torch.int8, device=dev),
            adj, metric=MetricType[metric], knn_k=knn_k, max_out=max_out,
        )
        assert flat_scan_topk.launches == before + (1 if dev.type == "cuda" else 0)
        outs.append(adj[:2048].cpu().numpy())
    assert (outs[0] == outs[1]).all(axis=1).mean() >= 0.99


def test_engine_on_card_matches_cpu_beam(cuda):
    n, d = 20000, 32
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((200, d)).astype(np.float32)
    eng = HnswEngine(MetricType.L2, d, HnswIndexParam(MetricType.L2, m=12, ef_construction=100))
    eng.bind_data(lambda: x, lambda: 1)
    eng._ensure_fresh()
    assert eng._codes.is_cuda and eng._dev["l0"].is_cuda
    g = eng._dev
    kw = dict(metric=MetricType.L2, ef=64, topk=10, max_steps=128, num_levels=g["num_levels"],
              frontier=4, visited_bits=0, done_frac=1.0)

    def run(dev):
        t = lambda a: a.to(dev)  # noqa: E731
        return [a.cpu() for a in ops.hnsw_search(
            torch.from_numpy(q).to(dev), t(eng._codes), t(eng._norms), t(g["l0"]),
            [t(a) for a in g["upper_ids"]], [t(a) for a in g["upper_nbrs"]],
            [t(a) for a in g["upper_down"]], g["entry_rows"], None, 10_000, **kw,
        )]

    (cs, ci), (ps, pi) = run(cuda), run(torch.device("cpu"))
    same = (torch.sort(ci, 1).values == torch.sort(pi, 1).values).all(dim=1)
    assert float(same.float().mean()) >= 0.98
    assert torch.allclose(cs[same], ps[same], rtol=1e-4, atol=1e-4)
