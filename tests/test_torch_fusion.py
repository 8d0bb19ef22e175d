"""Multi-vector queries and the rerankers: zvec_tpu_torch against zvec_tpu.

The rerankers of both packages fuse the same random result lists (with tied
scores and documents present in one field only): identical ids and order,
scores within 1e-6. Multi-vector queries over two dense fields and over a
dense + sparse pair run in both packages on the same documents; the cases are
those of `tests/test_query_executor.py` and `tests/test_fused_program.py`.
The port returns the four result tensors of a fused pair as they are, so
`test_packed_transfer_buffers_are_integer` (the packed transfer array of the
JAX package) has no counterpart here.
"""

import os
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import zvec_tpu  # noqa: E402
import zvec_tpu_torch  # noqa: E402
from zvec_tpu_torch.ops.flat_scan import flat_scan_topk  # noqa: E402

D = 8
N, DF, V = 3000, 24, 500  # the fused-pair collection of tests/test_fused_program.py


def _ids_scores(docs):
    return [d.id for d in docs], [d.score for d in docs]


def _assert_same_docs(jdocs, tdocs, rtol=1e-5):
    ji, js = _ids_scores(jdocs)
    ti, ts = _ids_scores(tdocs)
    assert ji == ti
    np.testing.assert_allclose(ts, js, rtol=rtol)


# ---------------------------------------------------------------- the rerankers


def _random_results(seed, pkg, fields=("a", "b", "c"), pool=40, depth=15):
    """Per-field result lists over a shared pool: scores rounded to one
    decimal (ties), most documents in some fields only."""
    rng = np.random.default_rng(seed)
    out = {}
    for f in fields:
        ids = rng.choice(pool, depth, replace=False)
        scores = np.sort(np.round(rng.random(depth) * 3, 1))
        out[f] = [pkg.Doc(id=f"d{i}", score=float(s), fields={"src": f}) for i, s in zip(ids, scores)]
    return out


def _rerankers(pkg):
    mt = pkg.MetricType
    return [
        pkg.RrfReRanker(topn=12),
        pkg.RrfReRanker(topn=50, rank_constant=1),
        pkg.WeightedReRanker(topn=12, metric=mt.L2, weights={"a": 2.0, "b": 0.5}),
        pkg.WeightedReRanker(topn=9, metric=mt.IP),
        pkg.WeightedReRanker(topn=30, metric=mt.COSINE, weights={"c": 3.0}),
    ]


@pytest.mark.parametrize("which", range(5))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rerankers_match_reference(seed, which):
    jr, tr = _rerankers(zvec_tpu)[which], _rerankers(zvec_tpu_torch)[which]
    jout = jr.rerank(_random_results(seed, zvec_tpu))
    tout = tr.rerank(_random_results(seed, zvec_tpu_torch))
    assert [d.id for d in jout] == [d.id for d in tout]  # ties fall alike
    np.testing.assert_allclose([d.score for d in tout], [d.score for d in jout], rtol=1e-6)
    # the Doc that comes back is the first one seen for its id
    assert [d.fields for d in jout] == [d.fields for d in tout]
    assert len(tout) <= tr.topn


def test_rrf_tie_order_is_first_seen():
    p = zvec_tpu_torch
    results = {
        "a": [p.Doc(id="x", score=0.1), p.Doc(id="y", score=0.2)],
        "b": [p.Doc(id="z", score=0.1), p.Doc(id="w", score=0.2)],
    }
    out = p.RrfReRanker(topn=4).rerank(results)
    # x and z tie (rank 0 each), y and w tie (rank 1 each): field order, then rank
    assert [d.id for d in out] == ["x", "z", "y", "w"]
    assert out[0].score == pytest.approx(1 / 61) and out[2].score == pytest.approx(1 / 62)
    assert p.RrfReRanker(topn=1, rank_constant=1).rerank({"a": [p.Doc(id="q", score=0.0)]})[0].score == 0.5
    assert p.RrfReRanker().rerank({"a": []}) == []


def test_reranker_properties_and_formulas():
    p = zvec_tpu_torch
    rrf = p.RrfReRanker(topn=3, rank_constant=7, rerank_field="f")
    assert (rrf.topn, rrf.rank_constant, rrf.rerank_field) == (3, 7, "f")
    w = p.WeightedReRanker(topn=4, metric=p.MetricType.IP, weights={"a": 2.0})
    assert w.weights == {"a": 2.0} and w.metric == p.MetricType.IP and w.topn == 4
    assert isinstance(rrf, p.ReRanker) and isinstance(w, zvec_tpu_torch.extension.RerankFunction)
    norm = p.WeightedReRanker._normalize_score
    for s in (0.0, 0.3, 2.5, 100.0):
        assert norm(s, p.MetricType.L2) == pytest.approx(1 - 2 * math.atan(s) / math.pi)
        assert norm(s, p.MetricType.IP) == pytest.approx(0.5 + math.atan(s) / math.pi)
        assert norm(s, p.MetricType.COSINE) == pytest.approx(1 - s / 2)
    with pytest.raises(ValueError):
        norm(1.0, p.MetricType.HAMMING)
    with pytest.raises(ValueError):
        p.RrfReRanker(topn=0)
    results = {
        "a": [p.Doc(id="d0", score=0.5), p.Doc(id="d1", score=1.5)],
        "b": [p.Doc(id="d1", score=0.2), p.Doc(id="d2", score=0.8)],
    }
    out = p.WeightedReRanker(topn=3, metric=p.MetricType.L2, weights={"a": 2.0, "b": 0.5}).rerank(results)
    n = lambda s: 1 - 2 * math.atan(s) / math.pi  # noqa: E731
    expect = {"d0": 2.0 * n(0.5), "d1": 2.0 * n(1.5) + 0.5 * n(0.2), "d2": 0.5 * n(0.8)}
    assert {d.id: d.score for d in out} == pytest.approx(expect, rel=1e-12)
    assert [d.id for d in out] == sorted(expect, key=expect.get, reverse=True)


def test_reranker_module_is_its_own_write():
    src = open(zvec_tpu_torch.extension.multi_vector_reranker.__file__).read()
    assert "heapq" not in src and "defaultdict" not in src
    assert zvec_tpu_torch.require_module("math") is math
    with pytest.raises(ImportError, match="optional dependency"):
        zvec_tpu_torch.tool.require_module("no_such_module_xyz", hint="a hint")


# ---------------------------------------------------------------- two dense fields


def _dense_schema(pkg, name):
    return pkg.CollectionSchema(
        f"qe_{name}",
        fields=[pkg.FieldSchema("tag", pkg.DataType.STRING)],
        vectors=[
            pkg.VectorSchema(f"v{i}", pkg.DataType.VECTOR_FP32, D, pkg.FlatIndexParam(pkg.MetricType.L2))
            for i in range(2)
        ],
    )


def _dense_pair(tmp_path, n=60):
    rng = np.random.default_rng(42)
    vecs = rng.standard_normal((n, 2, D)).astype(np.float32)
    cols = {}
    for name, pkg in (("jax", zvec_tpu), ("torch", zvec_tpu_torch)):
        col = pkg.create_and_open(str(tmp_path / name), _dense_schema(pkg, "mv"))
        col.insert([
            pkg.Doc(id=f"d{i}", fields={"tag": f"t{i % 4}"}, vectors={"v0": vecs[i, 0], "v1": vecs[i, 1]})
            for i in range(n)
        ])
        cols[name] = col
    queries = rng.standard_normal((5, 2, D)).astype(np.float32)
    return cols["jax"], cols["torch"], queries


def _groups(pkg, queries):
    return [[pkg.VectorQuery("v0", vector=q[0]), pkg.VectorQuery("v1", vector=q[1])] for q in queries]


def test_multi_vector_dense_dense_matches_reference(tmp_path):
    jc, tc, queries = _dense_pair(tmp_path)
    p = zvec_tpu_torch
    g = _groups(p, queries)
    with pytest.raises(ValueError):  # no reranker
        tc.query(g[0])
    with pytest.raises(ValueError):  # duplicate fields
        tc.query([p.VectorQuery("v0", vector=queries[0, 0]), p.VectorQuery("v0", vector=queries[0, 1])],
                 reranker=p.RrfReRanker())
    assert len(tc.query(g[0], reranker=p.RrfReRanker(topn=5))) == 5
    # the fused count follows the reranker's topn, not the per-field topk
    assert len(tc.query(g[1], topk=3, reranker=p.RrfReRanker(topn=4))) == 4
    assert 3 <= len(tc.query(g[1], topk=3, reranker=p.RrfReRanker(topn=50))) <= 6
    for make in (
        lambda pkg: pkg.RrfReRanker(topn=7),
        lambda pkg: pkg.WeightedReRanker(topn=7, weights={"v0": 2.0}),
    ):
        for jg, tg in zip(_groups(zvec_tpu, queries), g):
            _assert_same_docs(jc.query(jg, topk=8, reranker=make(zvec_tpu)), tc.query(tg, topk=8, reranker=make(p)))
    # a single-field query with an RRF reranker returns the field's own list
    one = tc.query([g[0][0]], topk=4, reranker=p.RrfReRanker())
    assert _ids_scores(one) == _ids_scores(tc.query(g[0][0], topk=4))
    jc._impl.close()
    tc._impl.close()


def test_batch_fused_query_dense_dense(tmp_path):
    jc, tc, queries = _dense_pair(tmp_path)
    p = zvec_tpu_torch
    g = _groups(p, queries)
    for rr in (p.RrfReRanker(topn=7), p.WeightedReRanker(topn=7, weights={"v0": 2.0})):
        batched = tc.batch_fused_query(g, topk=8, reranker=rr)
        serial = [tc.query(x, topk=8, reranker=rr) for x in g]
        for b, s in zip(batched, serial):
            assert [d.id for d in b] == [d.id for d in s]
            assert [d.score for d in b] == pytest.approx([d.score for d in s])
    rr = p.RrfReRanker(topn=6)
    batched = tc.batch_fused_query(g, topk=6, filter="tag = 't1'", reranker=rr)
    reference = jc.batch_fused_query(_groups(zvec_tpu, queries), topk=6, filter="tag = 't1'",
                                     reranker=zvec_tpu.RrfReRanker(topn=6))
    for b, j in zip(batched, reference):
        _assert_same_docs(j, b)
        assert all(int(d.id[1:]) % 4 == 1 for d in b)
    jc._impl.close()
    tc._impl.close()


def test_query_concurrency_env(tmp_path, monkeypatch):
    monkeypatch.setenv("ZVEC_QUERY_CONCURRENCY", "2")
    jc, tc, queries = _dense_pair(tmp_path)
    p = zvec_tpu_torch
    assert tc._querier._concurrency == 2
    threaded = tc.query(_groups(p, queries)[0], reranker=p.RrfReRanker(topn=10))
    monkeypatch.setenv("ZVEC_QUERY_CONCURRENCY", "1")
    tc._refresh()
    serial = tc.query(_groups(p, queries)[0], reranker=p.RrfReRanker(topn=10))
    assert _ids_scores(threaded) == _ids_scores(serial)
    jc._impl.close()
    tc._impl.close()


# ---------------------------------------------------------------- dense + sparse


def _fused_data():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((N, DF)).astype(np.float32)
    SV = []
    for _ in range(N):
        dims = rng.choice(V, 5, replace=False)
        SV.append({int(t): float(rng.random() + 0.1) for t in dims})
    return X, SV


def _mk(pkg, path, X, SV, dense_param=None):
    schema = pkg.CollectionSchema(
        "fusecol",
        fields=[pkg.FieldSchema("price", pkg.DataType.FLOAT)],
        vectors=[
            pkg.VectorSchema("dense", pkg.DataType.VECTOR_FP32, DF,
                             dense_param or pkg.FlatIndexParam(pkg.MetricType.L2)),
            pkg.VectorSchema("sparse", pkg.DataType.SPARSE_VECTOR_FP32, 0,
                             pkg.FlatIndexParam(pkg.MetricType.IP)),
        ],
    )
    col = pkg.create_and_open(str(path), schema)
    for lo in range(0, N, 1000):
        col.insert([
            pkg.Doc(id=str(i), fields={"price": float(i)}, vectors={"dense": X[i], "sparse": SV[i]})
            for i in range(lo, lo + 1000)
        ])
    col.optimize()
    return col


@pytest.fixture(scope="module")
def fused_flat(tmp_path_factory):
    X, SV = _fused_data()
    root = tmp_path_factory.mktemp("fused_flat")
    jc = _mk(zvec_tpu, root / "j", X, SV)
    tc = _mk(zvec_tpu_torch, root / "t", X, SV)
    yield jc, tc, X, SV
    jc._impl.close()
    tc._impl.close()


def _spy(col):
    """Count the calls of fused_pair_dispatch that took the fused path."""
    impl = col._impl
    calls = {"n": 0, "none": 0}
    orig = type(impl).fused_pair_dispatch.__get__(impl)

    def wrapper(*a, **kw):
        fin = orig(*a, **kw)
        calls["n" if fin is not None else "none"] += 1
        return fin

    impl.fused_pair_dispatch = wrapper
    return calls


def _pair(pkg, qd, qs):
    return [pkg.VectorQuery("dense", vector=qd), pkg.VectorQuery("sparse", vector=qs)]


def test_fused_single_call_matches_per_field_oracle(fused_flat):
    jc, tc, X, SV = fused_flat
    p = zvec_tpu_torch
    calls = _spy(tc)
    before = flat_scan_topk.launches
    rng = np.random.default_rng(9)
    qd = rng.standard_normal(DF).astype(np.float32)
    qs = {int(t): 1.0 for t in rng.choice(V, 5, replace=False)}
    res = tc.query(_pair(p, qd, qs), topk=10, reranker=p.RrfReRanker())
    assert calls == {"n": 1, "none": 0}, "the flat + sparse pair must take the fused path"
    assert flat_scan_topk.launches == before  # the dense half is the blockwise scan
    d2 = ((X - qd) ** 2).sum(1)
    dense_top = [str(i) for i in np.argsort(d2)[:10]]
    sp = np.array([sum(SV[i].get(t, 0.0) * w for t, w in qs.items()) for i in range(N)])
    sparse_top = [str(i) for i in np.argsort(-sp, kind="stable")[:10]]
    rrf = {}
    for ranked in (dense_top, sparse_top):
        for rank, i in enumerate(ranked):
            rrf[i] = rrf.get(i, 0) + 1 / (60 + rank + 1)
    assert [h.id for h in res] == sorted(rrf, key=lambda k: -rrf[k])[:10]
    # the fused pair equals the port's reranker over its own per-field answers
    per_field = {
        "dense": tc.query(p.VectorQuery("dense", vector=qd), topk=10),
        "sparse": tc.query(p.VectorQuery("sparse", vector=qs), topk=10),
    }
    assert _ids_scores(p.RrfReRanker().rerank(per_field)) == _ids_scores(res)
    # and the reference package's answer, with the weighted reranker too
    _assert_same_docs(jc.query(_pair(zvec_tpu, qd, qs), topk=10, reranker=zvec_tpu.RrfReRanker()), res)
    jw = zvec_tpu.WeightedReRanker(topn=8, metric=zvec_tpu.MetricType.IP, weights={"sparse": 2.0})
    tw = p.WeightedReRanker(topn=8, metric=p.MetricType.IP, weights={"sparse": 2.0})
    _assert_same_docs(jc.query(_pair(zvec_tpu, qd, qs), topk=10, reranker=jw),
                      tc.query(_pair(p, qd, qs), topk=10, reranker=tw))
    del tc._impl.fused_pair_dispatch


def test_fused_filtered_matches_reference(fused_flat):
    jc, tc, X, SV = fused_flat
    p = zvec_tpu_torch
    calls = _spy(tc)
    rng = np.random.default_rng(4)
    qd = rng.standard_normal(DF).astype(np.float32)
    qs = {int(t): 1.0 for t in rng.choice(V, 5, replace=False)}
    res = tc.query(_pair(p, qd, qs), topk=5, filter="price < 1000", reranker=p.RrfReRanker(),
                   output_fields=["price"])
    assert calls["n"] == 1
    assert res and all(d.fields["price"] < 1000 for d in res)
    d2 = ((X - qd) ** 2).sum(1)
    dense_top = [str(i) for i in np.argsort(np.where(np.arange(N) < 1000, d2, np.inf))[:5]]
    assert {h.id for h in res} >= set(dense_top[:2])
    _assert_same_docs(
        jc.query(_pair(zvec_tpu, qd, qs), topk=5, filter="price < 1000", reranker=zvec_tpu.RrfReRanker()), res
    )
    del tc._impl.fused_pair_dispatch


def test_fused_batch_engages_once(fused_flat):
    jc, tc, X, SV = fused_flat
    p = zvec_tpu_torch
    calls = _spy(tc)
    pairs = [_pair(p, X[i] + 0.01, SV[i]) for i in range(6)]
    out = tc.batch_fused_query(pairs, topk=5, reranker=p.RrfReRanker())
    assert calls == {"n": 1, "none": 0}  # ONE fused dispatch for the whole batch
    assert len(out) == 6
    for i, docs in enumerate(out):
        assert docs[0].id == str(i)  # a self-query tops both fields
    serial = [tc.query(g, topk=5, reranker=p.RrfReRanker()) for g in pairs]
    reference = jc.batch_fused_query([_pair(zvec_tpu, X[i] + 0.01, SV[i]) for i in range(6)], topk=5,
                                     reranker=zvec_tpu.RrfReRanker())
    for b, s, j in zip(out, serial, reference):
        assert _ids_scores(b) == _ids_scores(s)
        _assert_same_docs(j, b)
    del tc._impl.fused_pair_dispatch


def test_fused_hnsw_dense_engages_and_matches(tmp_path):
    """HNSW dense + flat sparse: `HnswEngine.fused_sparse_dispatch` runs the
    beam and the sparse scan together; filtered, the rescan keeps the answer."""
    X, SV = _fused_data()
    p = zvec_tpu_torch
    tc = _mk(p, tmp_path / "t", X, SV, dense_param=p.HnswIndexParam(p.MetricType.L2, m=16, ef_construction=80))
    jc = _mk(zvec_tpu, tmp_path / "j", X, SV,
             dense_param=zvec_tpu.HnswIndexParam(zvec_tpu.MetricType.L2, m=16, ef_construction=80))
    calls = _spy(tc)
    from zvec_tpu_torch.core.hnsw import HnswEngine

    beams = []
    orig = HnswEngine.fused_sparse_dispatch

    def spy(self, *a, **kw):
        out = orig(self, *a, **kw)
        beams.append(out is not None)
        return out

    HnswEngine.fused_sparse_dispatch = spy
    try:
        qd = (X[77] + 0.005).astype(np.float32)
        qs = SV[77]
        res = tc.query(_pair(p, qd, qs), topk=5, reranker=p.RrfReRanker())
        assert calls["n"] == 1 and beams == [True]
        assert res[0].id == "77"
        _assert_same_docs(jc.query(_pair(zvec_tpu, qd, qs), topk=5, reranker=zvec_tpu.RrfReRanker()), res)
        res_f = tc.query(_pair(p, qd, qs), topk=5, filter="price >= 1000", reranker=p.RrfReRanker(),
                         output_fields=["price"])
        assert calls["n"] == 2 and beams == [True, True]
        assert res_f and all(d.fields["price"] >= 1000 for d in res_f)
        d2 = ((X - qd) ** 2).sum(1)
        want = str(np.argsort(np.where(np.arange(N) >= 1000, d2, np.inf))[0])
        assert any(d.id == want for d in res_f)
        # a linear query param has no plain beam: the pair falls back to per-field dispatch
        lin = [p.VectorQuery("dense", vector=qd, param=p.HnswQueryParam(ef=64, is_linear=True)),
               p.VectorQuery("sparse", vector=qs)]
        res_l = tc.query(lin, topk=5, reranker=p.RrfReRanker())
        assert beams[-1] is False and calls["none"] == 1 and res_l[0].id == "77"
    finally:
        HnswEngine.fused_sparse_dispatch = orig
    tc._impl.close()
    jc._impl.close()


def test_fused_pair_fallbacks(tmp_path):
    """What the fused path refuses, as the reference does: a sparse engine
    that is not the flat one (a sealed HNSW sparse field) and mismatched
    batches; the query still answers through per-field dispatch."""
    p = zvec_tpu_torch
    rng = np.random.default_rng(5)
    n = 1200
    X = rng.standard_normal((n, D)).astype(np.float32)
    SV = [{int(t): float(rng.random() + 0.1) for t in rng.choice(300, 6, replace=False)} for _ in range(n)]
    schema = p.CollectionSchema(
        "fallbacks",
        vectors=[
            p.VectorSchema("dense", p.DataType.VECTOR_FP32, D, p.FlatIndexParam(p.MetricType.L2)),
            p.VectorSchema("sparse", p.DataType.SPARSE_VECTOR_FP32, 0,
                           p.HnswIndexParam(p.MetricType.IP, m=8, ef_construction=60)),
        ],
    )
    col = p.create_and_open(str(tmp_path / "c"), schema)
    for lo in range(0, n, 600):
        col.insert([p.Doc(id=str(i), vectors={"dense": X[i], "sparse": SV[i]}) for i in range(lo, lo + 600)])
    calls = _spy(col)
    res = col.query(_pair(p, X[5], SV[5]), topk=5, reranker=p.RrfReRanker())
    assert calls == {"n": 1, "none": 0}  # the writing segment scans both fields flat
    col.optimize()
    res2 = col.query(_pair(p, X[5], SV[5]), topk=5, reranker=p.RrfReRanker())
    assert calls == {"n": 1, "none": 1}  # sealed: the sparse field is a graph engine
    assert res[0].id == res2[0].id == "5"
    assert col._impl.fused_pair_dispatch("dense", X[:2], "sparse", SV[:3], 5) is None
    col._impl.close()
