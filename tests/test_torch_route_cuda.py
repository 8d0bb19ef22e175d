"""Routed HNSW traversal on the card.

Marked `cuda`: without a card these skip. The CPU side is held to zvec_tpu by
tests/test_torch_route.py.

- The routed beam (int8 and bf16 route tiers, the fp32 refine) on the card
  against the same beam on CPU copies of the engine's tensors: id sets equal
  outside near-ties (ids that differ score within 1e-4 of the row's k-th
  score; float32 sums run in another order on the card), scores of equal rows
  within 1e-4.
- A routed collection through the public API on the card: build, search,
  filter, group_by_query, a dense + sparse query, reopen. Scores within 1e-3
  of the exact float64 ones, recall@10 >= 0.9 against the exact oracle, the
  filter held, the reopened collection gives identical ids.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import zvec_tpu_torch as zt  # noqa: E402
from zvec_tpu_torch.core.hnsw import HnswEngine  # noqa: E402
from zvec_tpu_torch.ops import hnsw as ops  # noqa: E402
from zvec_tpu_torch.ops.runtime import DEVICE_ENV, device  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's engines run there")
    monkeypatch.setenv(DEVICE_ENV, "cuda")  # the card, asked for: a CPU test file of the same process asks for the CPU
    device.cache_clear()
    yield torch.device("cuda")
    device.cache_clear()


def _ties_only(cs, ci, ps, pi, rtol=1e-4):
    for r in range(ci.shape[0]):
        a = dict(zip(ci[r].tolist(), cs[r].tolist()))
        b = dict(zip(pi[r].tolist(), ps[r].tolist()))
        if a.keys() == b.keys():
            continue
        kth = float(ps[r].min())
        odd = [a[i] for i in a.keys() - b.keys()] + [b[i] for i in b.keys() - a.keys()]
        if any(abs(v - kth) > rtol * max(abs(kth), 1.0) for v in odd):
            return False
    return True


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_routed_beam_on_card_matches_cpu(cuda, mode):
    n, d = 20000, 32
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((128, d)).astype(np.float32)
    eng = HnswEngine(zt.MetricType.L2, d, zt.HnswIndexParam(
        zt.MetricType.L2, m=12, ef_construction=100, route_quantize=mode))
    eng.bind_data(lambda: x, lambda: 1)
    eng._ensure_fresh()
    rc, rn, dq = eng._route
    assert rc.is_cuda and rc.dtype == (torch.int8 if mode == "int8" else torch.bfloat16)
    g = eng._dev
    kw = dict(metric=zt.MetricType.L2, ef=64, topk=10, max_steps=128, num_levels=g["num_levels"],
              frontier=4, visited_bits=0, done_frac=1.0)

    def run(dev):
        t = lambda a: a.to(dev)  # noqa: E731
        return [a.cpu() for a in ops.hnsw_search(
            torch.from_numpy(q).to(dev), t(rc), t(rn), t(g["l0"]),
            [t(a) for a in g["upper_ids"]], [t(a) for a in g["upper_nbrs"]],
            [t(a) for a in g["upper_down"]], g["entry_rows"], None, 10_000, dq,
            t(eng._codes), t(eng._norms), **kw,
        )]

    (cs, ci), (ps, pi) = run(cuda), run(torch.device("cpu"))
    assert _ties_only(cs, ci, ps, pi)
    same = (torch.sort(ci, 1).values == torch.sort(pi, 1).values).all(dim=1)
    assert torch.allclose(cs[same], ps[same], rtol=1e-4, atol=1e-4)
    exact = -((x[ci.numpy()] - q[:, None, :]).astype(np.float64) ** 2).sum(-1)
    np.testing.assert_allclose(cs.numpy(), exact, rtol=0, atol=1e-3)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_routed_collection_on_card(cuda, tmp_path, mode):
    n, d = 12000, 24
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, d)).astype(np.float32)
    grp = rng.integers(0, 20, n)
    sp = [{int(t): 1.0 for t in rng.choice(300, 5, replace=False)} for _ in range(n)]
    qs = rng.standard_normal((16, d)).astype(np.float32)
    schema = zt.CollectionSchema(
        "routed",
        fields=[zt.FieldSchema("grp", zt.DataType.INT64)],
        vectors=[
            zt.VectorSchema("vec", zt.DataType.VECTOR_FP32, d, zt.HnswIndexParam(
                zt.MetricType.L2, m=12, ef_construction=100, route_quantize=mode)),
            zt.VectorSchema("sp", zt.DataType.SPARSE_VECTOR_FP32, 0, zt.FlatIndexParam(zt.MetricType.IP)),
        ],
    )
    path = str(tmp_path / "c")
    col = zt.create_and_open(path, schema)
    for lo in range(0, n, 1000):
        col.insert([zt.Doc(id=str(i), vectors={"vec": x[i], "sp": sp[i]}, fields={"grp": int(grp[i])})
                    for i in range(lo, min(lo + 1000, n))])
    col.optimize()
    col.flush()
    eng = next(s for s in col._impl._segments_snapshot() if s.doc_count > 0).engine_for("vec")
    assert eng._route is not None and eng._route[0].is_cuda and eng._codes.is_cuda
    param = zt.HnswQueryParam(ef=128, done_frac=1.0)
    res = col.batch_query("vec", qs, topk=10, output_fields=[], param=param)
    ids = np.array([[int(doc.id) for doc in r] for r in res])
    scores = np.array([[doc.score for doc in r] for r in res])
    d2 = ((x[None, :, :].astype(np.float64) - qs[:, None, :]) ** 2).sum(-1)
    exact = np.argsort(d2, axis=1)[:, :10]
    assert np.mean([len(set(ids[r]) & set(exact[r])) for r in range(16)]) / 10 >= 0.9
    np.testing.assert_allclose(scores, np.take_along_axis(d2, ids, 1), rtol=0, atol=1e-3)
    filt = col.query(zt.VectorQuery("vec", vector=qs[0], param=param), topk=10, filter="grp < 4",
                     output_fields=["grp"])
    assert len(filt) == 10 and all(doc.field("grp") < 4 for doc in filt)
    grouped = col.group_by_query(zt.VectorQuery("vec", vector=qs[0], param=param), group_by_field="grp",
                                 group_count=5, group_topk=2, output_fields=["grp"])
    groups = {}
    for doc in grouped:
        groups.setdefault(doc.field("grp"), []).append(doc.id)
    assert len(groups) == 5 and all(len(v) == 2 for v in groups.values())
    fused = col.query([zt.VectorQuery("vec", vector=qs[0], param=param), zt.VectorQuery("sp", vector={3: 1.0})],
                      topk=10, reranker=zt.RrfReRanker(topn=5))
    per = {f: col.query(zt.VectorQuery(f, vector=v, param=param if f == "vec" else None), topk=10)
           for f, v in (("vec", qs[0]), ("sp", {3: 1.0}))}
    assert [doc.id for doc in fused] == [doc.id for doc in zt.RrfReRanker(topn=5).rerank(per)]
    col._impl.close()
    col = zt.open(path)
    again = col.batch_query("vec", qs, topk=10, output_fields=[], param=param)
    assert np.array_equal(np.array([[int(doc.id) for doc in r] for r in again]), ids)
    col._impl.close()
