"""Routed HNSW traversal: zvec_tpu_torch against zvec_tpu on the CPU.

`route_quantize="int8"` / `"bf16"` on an fp32 index gives the beam a tier of
reduced-precision codes to walk; the working set is then re-ranked once
against the fp32 codes. Held to zvec_tpu:

- the route tier: int8 codes, scale and bias bitwise equal; bf16 codes
  bitwise equal (both round to nearest even); norms within 1e-6 relative;
- on one graph written by zvec_tpu and loaded by both engines (n = 3,000,
  d = 24, m = 12, efc = 80, 40 queries at ef = 64): the same id sets outside
  near-ties (ids that differ score within 1e-4 of the row's k-th score; the
  JAX engine scores int8 / bf16 gathers with its f32 operand split into bf16
  halves, the port in full float32, so traversal may part at near-ties), and
  scores within 1e-3 of the exact float64 scores of the ids returned;
- collections: group_by_query and a dense + sparse query on a routed field
  give the same answers in both packages (neither takes the in-beam group
  harvest or the fused pair when routed), a routed collection written by
  zvec_tpu opens in the port, and one written by the port reopens with its
  route rebuilt from the codes;
- quantized and hamming indexes, `auto` and `off` build no route tier.

The JAX engine's chunked-insertion build (`ZVEC_HNSW_BUILD=insert`) fails on
every fresh engine; a test pins that, which is why the port has no such build.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import zvec_tpu  # noqa: E402
import zvec_tpu_torch  # noqa: E402
from zvec_tpu.core.hnsw import HnswEngine as JaxHnsw  # noqa: E402
from zvec_tpu_torch.core.hnsw import HnswEngine as TorchHnsw  # noqa: E402

N, DIM, NQ, K, EF = 3000, 24, 40, 10, 64
PKGS = {"jax": zvec_tpu, "torch": zvec_tpu_torch}
MODES = ("int8", "bf16")
TIE_RTOL = 1e-4
SCORE_ATOL = 1e-3


def _data(n=N, d=DIM, nq=NQ, seed=21):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((nq, d)).astype(np.float32))


def _param(pkg, metric, **kw):
    return pkg.HnswIndexParam(pkg.MetricType[metric], m=12, ef_construction=80, **kw)


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """metric -> (data, queries, aux directory, aux descriptor), the graph
    built once by zvec_tpu with routing off."""
    cache = {}

    def get(metric):
        if metric not in cache:
            X, Qs = _data()
            eng = JaxHnsw(zvec_tpu.MetricType[metric], DIM, _param(zvec_tpu, metric))
            eng.bind_data(lambda: X, lambda: 1)
            d = tmp_path_factory.mktemp(f"route_{metric}")
            cache[metric] = (X, Qs, str(d), eng.dump_aux(str(d), "emb"))
        return cache[metric]

    return get


def _routed_pair(graphs, metric, mode):
    X, Qs, d, desc = graphs(metric)
    out = []
    for pkg, cls in ((zvec_tpu, JaxHnsw), (zvec_tpu_torch, TorchHnsw)):
        eng = cls(pkg.MetricType[metric], DIM, _param(pkg, metric, route_quantize=mode))
        eng.load_aux(d, desc)
        eng.bind_data(lambda: X, lambda: 1)
        eng._ensure_fresh()
        out.append(eng)
    return out, X, Qs


def _bits(a):
    """Raw bits of a route code table (bf16 has no numpy dtype of its own in torch)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def _exact(X, Qs, idx, metric):
    """float64 scores of the returned ids, in each metric's similarity form."""
    x = X.astype(np.float64)[np.clip(idx, 0, None)]
    q = Qs.astype(np.float64)[:, None, :]
    if metric == "L2":
        return -((x - q) ** 2).sum(-1)
    if metric == "IP":
        return (x * q).sum(-1)
    return (x * q).sum(-1) / (np.linalg.norm(x, axis=-1) * np.linalg.norm(q, axis=-1))


def _assert_ids_outside_ties(a, b):
    (sa, ia), (sb, ib) = a, b
    assert ia.shape == ib.shape
    for r in range(ia.shape[0]):
        da = dict(zip(ia[r].tolist(), sa[r].tolist()))
        db = dict(zip(ib[r].tolist(), sb[r].tolist()))
        if da.keys() == db.keys():
            continue
        kth = float(sa[r][ia[r] >= 0].min())
        odd = [da[i] for i in da.keys() - db.keys()] + [db[i] for i in db.keys() - da.keys()]
        assert all(abs(v - kth) <= TIE_RTOL * max(abs(kth), 1.0) for v in odd), f"row {r}"


def test_reference_insertion_build_fails_on_a_fresh_engine(monkeypatch):
    """zvec_tpu's chunked-insertion build hands the prune `self._codes` before
    `_rebuild` has set it (the graph is built first), so it fails on every
    fresh engine: the port leaves that build out."""
    monkeypatch.setenv("ZVEC_HNSW_BUILD", "insert")
    X, _ = _data(3000, 24, 2)
    p = zvec_tpu
    eng = JaxHnsw(p.MetricType.L2, 24, _param(p, "L2"))
    eng.bind_data(lambda: X, lambda: 1)
    with pytest.raises(TypeError, match="NoneType") as info:
        eng.search(X[:2], 5)
    last = info.traceback[-1]
    assert str(last.path).endswith("zvec_tpu/ops/hnsw.py") and last.lineno + 1 == 1081
    assert any(e.name == "_prune_batch" for e in info.traceback)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_route_tier_matches_jax(graphs, metric, mode):
    (je, te), _, _ = _routed_pair(graphs, metric, mode)
    (jc, jn, jd), (tc, tn, td) = je._route, te._route
    assert tc.dtype == (torch.int8 if mode == "int8" else torch.bfloat16)
    assert tc.shape == tuple(np.asarray(jc).shape)
    np.testing.assert_array_equal(_bits(tc), _bits(jc))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6, atol=0)
    if mode == "int8":
        assert td == (float(jd[0]), float(jd[1]))
    else:
        assert td is None and jd is None
    assert te.build_times["route"] >= 0.0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("metric,density", [("L2", None), ("IP", None), ("COSINE", None), ("L2", 0.3)])
def test_routed_search_matches_jax(graphs, metric, density, mode):
    (je, te), X, Qs = _routed_pair(graphs, metric, mode)
    mask = None if density is None else np.random.default_rng(4).random(N) < density
    kw = dict(ef=EF, done_frac=1.0)
    a = je.search(Qs, K, mask=mask, param=zvec_tpu.HnswQueryParam(**kw))
    b = te.search(Qs, K, mask=mask, param=zvec_tpu_torch.HnswQueryParam(**kw))
    np.testing.assert_array_equal(te._graph.l0, je._graph.l0)  # one graph
    _assert_ids_outside_ties(a, b)
    sims, idx = b
    assert (idx >= 0).all()
    if mask is not None:
        assert mask[idx].all()
    np.testing.assert_allclose(sims, _exact(X, Qs, idx, metric), rtol=0, atol=SCORE_ATOL)
    # the refine re-ranked the working set: the port's answer is its exact top-k
    assert (np.diff(sims, axis=1) <= 0).all()


def _fill(pkg, path, X, sp_rows, grp, mode):
    schema = pkg.CollectionSchema(
        "routed",
        fields=[pkg.FieldSchema("grp", pkg.DataType.INT64)],
        vectors=[
            pkg.VectorSchema("vec", pkg.DataType.VECTOR_FP32, X.shape[1], pkg.HnswIndexParam(
                pkg.MetricType.L2, m=8, ef_construction=60, route_quantize=mode)),
            pkg.VectorSchema("sp", pkg.DataType.SPARSE_VECTOR_FP32, 0,
                             pkg.FlatIndexParam(pkg.MetricType.IP)),
        ],
    )
    col = pkg.create_and_open(path, schema)
    for lo in range(0, len(X), 1000):
        col.insert([pkg.Doc(id=str(i), vectors={"vec": X[i], "sp": sp_rows[i]}, fields={"grp": int(grp[i])})
                    for i in range(lo, min(lo + 1000, len(X)))])
    col.optimize()
    col.flush()
    return col


def _collection_data(n=1500, d=16):
    rng = np.random.default_rng(31)
    X = rng.standard_normal((n, d)).astype(np.float32)
    sp = [{int(t): float(v) for t, v in zip(rng.choice(500, 6, replace=False), rng.random(6) + 0.1)}
          for _ in range(n)]
    return X, sp, rng.integers(0, 12, n), rng.standard_normal((4, d)).astype(np.float32)


def _answers(pkg, col, Qs):
    """Plain, filtered, grouped and dense + sparse answers of one collection."""
    p = pkg
    out = {}
    qp = p.HnswQueryParam(ef=48, done_frac=1.0)
    for r, q in enumerate(Qs):
        plain = col.query(p.VectorQuery("vec", vector=q, param=qp), topk=K)
        filt = col.query(p.VectorQuery("vec", vector=q, param=qp), topk=K, filter="grp < 3")
        grouped = col.group_by_query(p.VectorQuery("vec", vector=q, param=qp), group_by_field="grp",
                                     group_count=4, group_topk=2, output_fields=["grp"])
        fused = col.query(
            [p.VectorQuery("vec", vector=q, param=qp), p.VectorQuery("sp", vector={r: 1.0, 7 * r + 3: 0.5})],
            topk=K, reranker=p.RrfReRanker(topn=8),
        )
        out[r] = {
            "plain": [(d.id, d.score) for d in plain],
            "filtered": [d.id for d in filt],
            "grouped": [(d.fields["grp"], d.id) for d in grouped],
            "fused": [(d.id, round(d.score, 6)) for d in fused],
        }
    return out


@pytest.mark.parametrize("mode", ["int8"])
def test_routed_collection_written_by_jax_matches_port(tmp_path, mode):
    """A routed collection zvec_tpu wrote (its graph in hnsw_vec.npz) opens in
    both packages; plain, filtered, grouped and dense + sparse answers agree."""
    X, sp, grp, Qs = _collection_data()
    path = str(tmp_path / "c")
    col = _fill(zvec_tpu, path, X, sp, grp, mode)
    col._impl.close()
    got = {}
    for name, pkg in PKGS.items():
        col = pkg.open(path)
        assert col.schema.vectors[0].index_param.route_quantize == mode
        got[name] = _answers(pkg, col, Qs)
        seg = next(s for s in col._impl._segments_snapshot() if s.doc_count > 0)
        eng = seg.engine_for("vec")
        assert eng._loaded_aux is not None and eng._route is not None
        col._impl.close()
    for r in got["jax"]:
        a, b = got["jax"][r], got["torch"][r]
        assert [i for i, _ in a["plain"]] == [i for i, _ in b["plain"]], r
        np.testing.assert_allclose([s for _, s in b["plain"]], [s for _, s in a["plain"]], rtol=1e-4, atol=1e-4)
        for key in ("filtered", "grouped", "fused"):
            assert a[key] == b[key], (r, key)


@pytest.mark.parametrize("mode", MODES)
def test_routed_collection_reopens_in_port(tmp_path, mode):
    """The port builds, searches, flushes and reopens a routed collection; the
    graph file keeps the JAX package's keys, and the route is rebuilt from the
    codes on reopen."""
    X, sp, grp, Qs = _collection_data()
    path = tmp_path / "c"
    p = zvec_tpu_torch
    col = _fill(p, str(path), X, sp, grp, mode)
    before = _answers(p, col, Qs[:3])
    eng = next(s for s in col._impl._segments_snapshot() if s.doc_count > 0).engine_for("vec")
    assert eng._route is not None and "route" in eng.build_times
    assert eng.search_grouped(Qs, None, None, grp, 2, 64) is None  # no in-beam harvest when routed
    col._impl.close()
    aux = [f for f in path.rglob("hnsw_*.npz")]
    assert aux and not any("route" in k for f in aux for k in np.load(f).files)
    col = p.open(str(path))
    assert _answers(p, col, Qs[:3]) == before
    eng = next(s for s in col._impl._segments_snapshot() if s.doc_count > 0).engine_for("vec")
    assert eng._loaded_aux is not None and eng._route is not None
    col._impl.close()


@pytest.mark.parametrize(
    "metric,qtype,mode",
    [("L2", "INT8", "int8"), ("L2", "FP16", "bf16"), ("HAMMING", "UNDEFINED", "int8"),
     ("L2", "UNDEFINED", "auto"), ("L2", "UNDEFINED", "off")],
)
def test_route_knob_builds_no_tier(metric, qtype, mode):
    """As in zvec_tpu: routing applies to fp32 indexes with an explicit int8 /
    bf16 tier only; `auto` resolves to off."""
    rng = np.random.default_rng(5)
    if metric == "HAMMING":
        from zvec_tpu.ops.quantize import pack_bits

        X = pack_bits(rng.integers(0, 2, (1200, 64)).astype(np.uint8), 32)
    else:
        X = rng.standard_normal((1200, 16)).astype(np.float32)
    dim = 64 if metric == "HAMMING" else 16
    engines = []
    for pkg, cls in ((zvec_tpu, JaxHnsw), (zvec_tpu_torch, TorchHnsw)):
        eng = cls(pkg.MetricType[metric], dim, pkg.HnswIndexParam(
            pkg.MetricType[metric], m=8, ef_construction=40,
            quantize_type=pkg.QuantizeType[qtype], route_quantize=mode))
        eng.bind_data(lambda: X, lambda: 1)
        engines.append(eng)
    for eng in engines:
        eng._ensure_fresh()
        assert eng._route is None
    assert "route" not in engines[1].build_times
    _, idx = engines[1].search(X[:4], 3, param=zvec_tpu_torch.HnswQueryParam(ef=32, done_frac=1.0))
    assert idx[:, 0].tolist() == [0, 1, 2, 3]
