"""HNSW ops on the card against the same ops on the CPU.

Marked `cuda`: without a card these skip. Run them on a GPU machine with
`python -m pytest tests/test_torch_hnsw_cuda.py -q`. The CPU side is held to
zvec_tpu by the other test_torch_hnsw_* files.

Tolerances: float32 sums run in another order on the card, so a dominance
test or a beam merge that sits within an ulp may flip; pruned rows must be
equal on at least 99% of nodes, beam id sets equal on at least 98% of
queries, and scores of equal rows within 1e-4. The bucket kNN's half-rows
must hold equal id sets on at least 99% of members, the grouped beam's
harvest equal (id, group) sets on at least 95% of queries.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zvec_tpu_torch.core.hnsw import HnswEngine  # noqa: E402
from zvec_tpu_torch.model.param.param import HnswIndexParam  # noqa: E402
from zvec_tpu_torch.ops import hnsw as ops  # noqa: E402
from zvec_tpu_torch.ops.flat_scan import flat_scan_topk  # noqa: E402
from zvec_tpu_torch.ops.runtime import DEVICE_ENV, device  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flat-scan kernel has no CPU mode")
    monkeypatch.setenv(DEVICE_ENV, "cuda")  # the card, asked for: a CPU test file of the same process asks for the CPU
    device.cache_clear()
    yield torch.device("cuda")
    device.cache_clear()


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


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_knn_build_step_repeats_bitwise(cuda, metric):
    """The build step above, five times on the card on the same inputs: the
    same adjacency bit for bit (K1, the merge kernel and the prune hold no
    atomics whose order moves)."""
    n, knn_k, max_out = 8192, 127, 32
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((n, 24)).astype(np.float32)).to(cuda)
    norms2 = (x * x).sum(1)
    outs = []
    for _ in range(5):
        adj = torch.full((n, max_out), -1, dtype=torch.int32, device=cuda)
        ops.knn_build_step(torch.arange(2048, device=cuda), x, norms2, torch.ones(n, dtype=torch.int8, device=cuda),
                           adj, metric=MetricType[metric], knn_k=knn_k, max_out=max_out)
        outs.append(adj)
    assert all(torch.equal(a, outs[0]) for a in outs[1:])


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


def _clustered(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((40, d)).astype(np.float32) * 4
    return (centers[rng.integers(0, 40, n)] + rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("codes", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_bucket_knn_all_on_card_matches_cpu(cuda, metric, codes):
    n, mp, kc, nb = 20000, 1024, 64, 12
    x = _clustered(n, 64, 2)
    rng = np.random.default_rng(3)
    perm = rng.permutation(n)[: nb * 700].reshape(nb, 700)
    rows = np.full((nb, mp), -1, np.int32)
    slot = np.zeros((nb, mp), np.int32)
    for b in range(nb):
        rows[b, :700] = perm[b]
        rows[b, 700:1000] = perm[(b + 1) % nb][:300]
        slot[b, 700:1000] = 1
    t = torch.from_numpy(x)
    t = {"fp32": t, "bf16": t.bfloat16(), "int8": (t * (127 / t.abs().max())).round().to(torch.int8)}[codes]
    norms2 = (t.float() ** 2).sum(1)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        cand = torch.full((n + 1, 2 * kc), -1, dtype=torch.int32, device=dev)
        ops.bucket_knn_all(torch.from_numpy(rows).to(dev), torch.from_numpy(slot).to(dev), cand,
                           t.to(dev), norms2.to(dev), metric=MetricType[metric], kc=kc)
        outs.append(cand[:n].cpu())
    for half in (slice(0, kc), slice(kc, 2 * kc)):
        a, b = (torch.sort(o[:, half], 1).values for o in outs)
        assert float((a == b).all(dim=1).float().mean()) >= 0.99
    assert int((outs[0][:, :kc] >= 0).any(1).sum()) == nb * 700


@pytest.mark.parametrize("codes", ["fp32", "bf16"])
def test_nn_descent_batch_on_card_matches_cpu(cuda, codes):
    n, m0, b = 20000, 32, 2048
    x = _clustered(n, 64, 4)
    rng = np.random.default_rng(5)
    t = torch.from_numpy(x)
    t = t.bfloat16() if codes == "bf16" else t
    norms2 = torch.from_numpy((x**2).sum(1))
    cand = torch.from_numpy(rng.integers(0, n, (n + 1, 64)).astype(np.int32))
    rows = torch.arange(2 * b).reshape(2, b)
    kw = dict(metric=MetricType.L2, max_out=m0)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        args = (t.to(dev), norms2.to(dev))
        fwd = torch.full((n + 1, m0), -1, dtype=torch.int32, device=dev)
        fwd[: 2 * b] = ops.merge_prune_batch_out(rows.to(dev), cand.to(dev), *args, **kw).reshape(-1, m0)
        out = ops.nn_descent_round(rows.to(dev), fwd, *args, expand=4, **kw)
        assert out.dtype == torch.int32 and out.device.type == dev.type
        outs.append((fwd.cpu(), out.cpu().reshape(-1, m0)))
    for a, c in zip(*outs):
        assert float((a[: 2 * b] == c[: 2 * b]).all(dim=1).float().mean()) >= 0.99


def test_grouped_beam_on_card_matches_cpu(cuda):
    n, d = 20000, 32
    rng = np.random.default_rng(6)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((64, d)).astype(np.float32)
    eng = HnswEngine(MetricType.L2, d, HnswIndexParam(MetricType.L2, m=12, ef_construction=100))
    eng.bind_data(lambda: x, lambda: 1)
    eng._ensure_fresh()
    g = eng._dev
    groups = torch.full((eng._codes.shape[0],), -1, dtype=torch.int32)
    groups[:n] = torch.from_numpy(rng.integers(0, 30, n).astype(np.int32))
    kw = dict(metric=MetricType.L2, ef=64, topk=1, max_steps=128, num_levels=g["num_levels"],
              frontier=4, done_frac=1.0, group_cap=64, group_topk=2)

    def run(dev):
        t = lambda a: a.to(dev)  # noqa: E731
        return [a.cpu() for a in ops.hnsw_search(
            torch.from_numpy(q).to(dev), t(eng._codes), t(eng._norms), t(g["l0"]),
            [t(a) for a in g["upper_ids"]], [t(a) for a in g["upper_nbrs"]],
            [t(a) for a in g["upper_down"]], g["entry_rows"], None, 10_000,
            group_codes=t(groups), **kw,
        )]

    on_card, on_cpu = run(cuda), run(torch.device("cpu"))
    assert len(on_card) == 5
    key = lambda out: torch.sort(out[3] * 64 + out[4], 1).values  # noqa: E731
    same = (key(on_card) == key(on_cpu)).all(dim=1)
    assert float(same.float().mean()) >= 0.95
    assert torch.allclose(on_card[2][same], on_cpu[2][same], rtol=1e-4, atol=1e-4)
    counts = torch.stack([(on_card[4] == c).sum(1) for c in range(30)], 1)
    assert int(counts.max()) <= 2
