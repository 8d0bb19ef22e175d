"""Collection-level mesh sharding through the public API, in both packages.

The cases of `tests/test_mesh_collection.py` run through zvec_tpu (its
8-device virtual CPU mesh) and zvec_tpu_torch (8 corpus shards on the CPU) on
the same documents and queries: the same ids, scores within 1e-4, and the
reference test's own oracle checks. Two more: a sharded `hnsw_*.npz` /
`hnsw_sparse_*.npz` written by either package loads in the other without a
build, and `group_by_query` and a dense + sparse query under the mesh give
the reference's answers (its fallbacks: no in-beam harvest, no fused pair).
Shards stay under 8,192 rows, where both packages build identical graphs.
"""

import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import zvec_tpu  # noqa: E402
import zvec_tpu_torch  # noqa: E402
from zvec_tpu.utils.config import GlobalConfig as JConfig  # noqa: E402
from zvec_tpu_torch.utils.config import GlobalConfig as TConfig  # noqa: E402

PKGS = {"jax": zvec_tpu, "torch": zvec_tpu_torch}
S = 8
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def mesh8():
    for cfg in (JConfig, TConfig):
        cfg.instance().mesh_devices = S
    yield
    for cfg in (JConfig, TConfig):
        cfg.instance().mesh_devices = 0


def _fill(pkg, path, vectors, n, fields=None, prefix="pk", batch=1000):
    """A collection of n docs: `vectors` maps a field to (data, dtype name,
    dim, index param factory), `fields` an int64 field to its values."""
    p = pkg
    schema = p.CollectionSchema(
        "meshcol",
        fields=[p.FieldSchema(f, p.DataType.INT64) for f in (fields or {})],
        vectors=[
            p.VectorSchema(name, getattr(p.DataType, dt), dim, param(p))
            for name, (_, dt, dim, param) in vectors.items()
        ],
    )
    col = p.create_and_open(path, schema)
    for lo in range(0, n, batch):
        col.insert([
            p.Doc(
                id=f"{prefix}{i}",
                vectors={name: v[0][i] for name, v in vectors.items()},
                fields={f: int(vals[i]) for f, vals in (fields or {}).items()},
            )
            for i in range(lo, min(lo + batch, n))
        ])
    col.flush()
    col.optimize()
    return col


def _pair(tmp, name, *args, **kw):
    return {k: _fill(pkg, str(tmp / f"{name}_{k}"), *args, **kw) for k, pkg in PKGS.items()}


def _engine(col, field):
    eng = col._impl._segments_snapshot()[0].engine_for(field)
    eng._ensure_fresh()
    return eng


def _both(pair, fn):
    """fn(pkg, col) -> list of Docs in each package: the same ids, scores
    within TOL. Returns the port's ids."""
    out = {k: fn(PKGS[k], col) for k, col in pair.items()}
    ids = {k: [d.id for d in docs] for k, docs in out.items()}
    assert ids["torch"] == ids["jax"]
    np.testing.assert_allclose(
        [d.score for d in out["torch"]], [d.score for d in out["jax"]], rtol=TOL, atol=TOL
    )
    return ids["torch"]


def _dense(metric, **kw):
    return lambda p: p.FlatIndexParam(getattr(p.MetricType, metric), **kw)


def _hnsw(metric, m=16, efc=100, **kw):
    return lambda p: p.HnswIndexParam(getattr(p.MetricType, metric), m=m, ef_construction=efc, **kw)


def _ix(ids):
    return {int(i[2:]) for i in ids}


def _ef(ef):
    return lambda p: p.HnswQueryParam(ef=ef)


def _batch_same(pair, Q, param=None, field="emb"):
    """batch_query in both packages (`param(pkg)` its query param): the same
    ids per row, scores within TOL. One call per package: the JAX package
    compiles a sharded program per call."""
    got = {}
    for k, col in pair.items():
        p = PKGS[k]
        got[k] = col.batch_query(field, Q, topk=10, output_fields=[], param=param and param(p))
    for a, b in zip(got["jax"], got["torch"]):
        assert [d.id for d in a] == [d.id for d in b]
        np.testing.assert_allclose([d.score for d in b], [d.score for d in a], rtol=TOL, atol=TOL)
    return got["torch"]


# ---------------- FLAT ----------------


@pytest.fixture(scope="module")
def flat_l2(tmp_path_factory):
    """L2 FLAT over 4,000 x 16 beside a sparse FLAT field and an int64 `tag`."""
    rng = np.random.default_rng(1)
    n, d = 4000, 16
    X = rng.standard_normal((n, d)).astype(np.float32)
    sp = [{int(t): float(rng.random() + 0.1) for t in rng.choice(300, 6, replace=False)} for _ in range(n)]
    vectors = {
        "emb": (X, "VECTOR_FP32", d, _dense("L2")),
        "sp": (sp, "SPARSE_VECTOR_FP32", 0, _dense("IP")),
    }
    pair = _pair(tmp_path_factory.mktemp("flat"), "flat", vectors, n, {"tag": np.arange(n) % 7})
    return pair, X, sp


def test_sharded_flat_collection_matches_oracle(flat_l2):
    pair, X, _ = flat_l2
    Q = np.random.default_rng(2).standard_normal((4, X.shape[1])).astype(np.float32)
    docs = _batch_same(pair, Q)
    d2 = ((Q[:, None, :] - X[None]) ** 2).sum(-1)
    for row, dd in zip(docs, d2):
        assert _ix([d.id for d in row]) == set(np.argsort(dd, kind="stable")[:10].tolist())
        scores = [d.score for d in row]  # L2: squared distance ascending
        assert scores == sorted(scores)


def test_sharded_flat_engine_is_actually_sharded(tmp_path):
    rng = np.random.default_rng(3)
    n, d = 3000, 16
    X = rng.standard_normal((n, d)).astype(np.float32)
    pair = _pair(tmp_path, "ip", {"emb": (X, "VECTOR_FP32", d, _dense("IP"))}, n)
    assert len(_engine(pair["jax"], "emb")._codes.sharding.device_set) == S
    st = _engine(pair["torch"], "emb")._st
    assert len(st.codes) == S and st.mesh.shape["corpus"] == S
    assert [c.shape[0] for c in st.codes] == [st.n_pad // S] * S and st.n_pad == 8192
    q = rng.standard_normal(d).astype(np.float32)
    ids = _both(pair, lambda p, c: c.query(p.VectorQuery("emb", vector=q), topk=5))
    assert _ix(ids) == set(np.argsort(-(X @ q), kind="stable")[:5].tolist())


def test_sharded_filtered_query(flat_l2):
    pair, X, _ = flat_l2
    q = np.random.default_rng(4).standard_normal(X.shape[1]).astype(np.float32)
    ids = _both(pair, lambda p, c: c.query(p.VectorQuery("emb", vector=q), topk=10, filter="tag = 3"))
    elig = np.flatnonzero(np.arange(len(X)) % 7 == 3)
    d2 = ((X - q) ** 2).sum(1)
    assert _ix(ids) == set(elig[np.argsort(d2[elig], kind="stable")[:10]].tolist())


def test_sharded_delete_and_requery(tmp_path):
    rng = np.random.default_rng(5)
    n, d = 2000, 16
    X = rng.standard_normal((n, d)).astype(np.float32)
    pair = _pair(tmp_path, "del", {"emb": (X, "VECTOR_FP32", d, _dense("L2"))}, n)
    q = rng.standard_normal(d).astype(np.float32)
    first = _both(pair, lambda p, c: c.query(p.VectorQuery("emb", vector=q), topk=3))
    for col in pair.values():
        col.delete(first)
    second = _both(pair, lambda p, c: c.query(p.VectorQuery("emb", vector=q), topk=3))
    assert not set(first) & set(second)


@pytest.mark.parametrize("qt_name", ["INT8", "INT4"])
def test_sharded_quantized_flat(tmp_path, qt_name):
    rng = np.random.default_rng(6)
    n, d = 4096, 16
    X = (rng.standard_normal((n, d)) * 1.5).astype(np.float32)
    param = lambda p: p.FlatIndexParam(p.MetricType.L2, quantize_type=getattr(p.QuantizeType, qt_name))  # noqa: E731
    pair = _pair(tmp_path, "q", {"emb": (X, "VECTOR_FP32", d, param)}, n)
    q = rng.standard_normal(d).astype(np.float32)
    # refined by default: against the exact fp32 oracle
    ids = _both(pair, lambda p, c: c.query(p.VectorQuery("emb", vector=q), topk=10))
    assert len(_ix(ids) & set(np.argsort(((X - q) ** 2).sum(1))[:10].tolist())) >= 9
    # raw quantized scores: against the oracle over the engine's dequantized codes
    st = _engine(pair["torch"], "emb")._st
    codes = torch.cat(st.codes).numpy()
    if st.int4_packed:
        from zvec_tpu_torch.ops.quantize import unpack_int4

        codes = unpack_int4(codes, d)
    deq = codes[:n].astype(np.float32) * st.dequant[0] + st.dequant[1]
    from zvec_tpu.model.param.param import FlatQueryParam as JFlatQueryParam
    from zvec_tpu_torch.model.param.param import FlatQueryParam as TFlatQueryParam

    fqp = {zvec_tpu: JFlatQueryParam, zvec_tpu_torch: TFlatQueryParam}
    ids = _both(pair, lambda p, c: c.query(
        p.VectorQuery("emb", vector=q, param=fqp[p](is_using_refiner=False)), topk=10))
    assert len(_ix(ids) & set(np.argsort(((deq - q) ** 2).sum(1))[:10].tolist())) >= 9


# ---------------- HNSW ----------------


def _recall(docs, gt, strip=2):
    return sum(len({int(d.id[strip:]) for d in row} & set(g.tolist())) for row, g in zip(docs, gt)) / gt.size


@pytest.fixture(scope="module")
def hnsw_l2(tmp_path_factory):
    """L2 HNSW over 2,000 x 16 (8 shards of 256 rows, the last 208) beside a
    sparse FLAT field and an int64 `tag`."""
    rng = np.random.default_rng(7)
    n, d = 2000, 16
    X = rng.standard_normal((n, d)).astype(np.float32)
    sp = [{int(t): float(rng.random() + 0.1) for t in rng.choice(300, 6, replace=False)} for _ in range(n)]
    vectors = {
        "emb": (X, "VECTOR_FP32", d, _hnsw("L2")),
        "sp": (sp, "SPARSE_VECTOR_FP32", 0, _dense("IP")),
    }
    tmp = tmp_path_factory.mktemp("hnsw")
    return _pair(tmp, "h", vectors, n, {"tag": np.arange(n) % 7}), X, sp


def test_sharded_hnsw_collection_recall(hnsw_l2):
    pair, X, _ = hnsw_l2
    je, te = _engine(pair["jax"], "emb"), _engine(pair["torch"], "emb")
    assert je._dev.get("sharded") and te._dev.get("sharded") and len(te._codes) == S
    assert [len(g.upper_ids) for g in te._shard_graphs] == [len(g.upper_ids) for g in je._shard_graphs]
    Q = np.random.default_rng(8).standard_normal((8, X.shape[1])).astype(np.float32)
    docs = _batch_same(pair, Q, _ef(64))
    d2 = ((Q[:, None, :] - X[None]) ** 2).sum(-1)
    assert _recall(docs, np.argsort(d2, axis=1)[:, :10]) >= 0.95
    top = docs[0][0]
    assert abs(top.score - d2[0][int(top.id[2:])]) < 1e-2


def test_sharded_hnsw_filtered_and_reopen(hnsw_l2, tmp_path):
    pair, X, _ = hnsw_l2
    q = X[33] + 0.01
    ids = _both(pair, lambda p, c: c.query(
        p.VectorQuery("emb", vector=q, param=p.HnswQueryParam(ef=32)), topk=5, filter="tag = 3"))
    cand = np.flatnonzero(np.arange(len(X)) % 7 == 3)
    assert _ix(ids) == set(cand[np.argsort(((X[cand] - q) ** 2).sum(1))[:5]].tolist())
    # reopen: the shard graphs load from the graph file, no build, and the
    # filtered answer stays the one the JAX package gave
    p = zvec_tpu_torch
    shutil.copytree(pair["torch"].path, str(tmp_path / "re"))
    col = p.open(str(tmp_path / "re"))
    eng = _engine(col, "emb")
    assert eng._dev.get("sharded") and eng._shard_graphs is not None
    assert "forward_knn" not in eng.build_times
    again = col.query(p.VectorQuery("emb", vector=q, param=p.HnswQueryParam(ef=32)), topk=5, filter="tag = 3")
    assert [d.id for d in again] == ids
    assert col.query(p.VectorQuery("emb", vector=q), topk=3)[0].id == "pk33"
    col._impl.close()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_sharded_graph_files_load_across_packages(hnsw_l2, sparse_hnsw, tmp_path, writer, reader):
    """A sharded hnsw_*.npz and hnsw_sparse_*.npz written by one package
    load in the other: the same per-shard graphs and entries, no build, and
    in the port the same ids as its own collection."""
    pkg = PKGS[reader]
    for (pair, *_), field, ef in ((hnsw_l2, "emb", 48), (sparse_hnsw, "sv", 48)):
        path = str(tmp_path / f"{field}_{writer}")
        shutil.copytree(pair[writer].path, path)
        col = pkg.open(path)
        eng, src = _engine(col, field), _engine(pair[writer], field)
        assert int(eng._loaded_aux["shards"]) == S
        if field == "emb":
            assert [np.array_equal(a.l0, b.l0) for a, b in zip(eng._shard_graphs, src._shard_graphs)] == [True] * S
        else:
            assert np.array_equal(np.asarray(eng._aux_l0), np.asarray(src._aux_l0))
            assert np.array_equal(np.asarray(eng._aux_entries), np.asarray(src._aux_entries))
        if reader == "torch":
            assert "forward_knn" not in eng.build_times
        if reader == "torch":
            # the same graphs as the port's own collection: the same ids
            # (which the JAX package's matched in the tests above)
            q = hnsw_l2[1][:4] if field == "emb" else sparse_hnsw[1][:4]
            got, want = (c.batch_query(field, q, topk=10, output_fields=[], param=pkg.HnswQueryParam(ef=ef))
                         for c in (col, pair["torch"]))
            assert [[d.id for d in r] for r in got] == [[d.id for d in r] for r in want]
        col._impl.close()


def test_group_by_and_dense_sparse_under_the_mesh(hnsw_l2, flat_l2):
    """A sharded HNSW engine has no in-beam harvest and no fused pair (the
    caller deepens plain searches, and runs the two fields one after the
    other before the reranker); a sharded FLAT collection takes the same
    fallbacks, and its group_by_query and dense + sparse answers are the
    reference's."""
    hpair, hX, hsp = hnsw_l2
    te = _engine(hpair["torch"], "emb")
    assert te.search_grouped(hX[:2], None, None, np.zeros(len(hX), np.int32), 2, 64) is None
    assert te.fused_sparse_dispatch(hX[:2], None, None, 10, None) is None
    assert hpair["torch"]._impl.fused_pair_dispatch("emb", hX[:2], "sp", hsp[:2], 10) is None
    pair, X, sp = flat_l2
    assert pair["torch"]._impl.fused_pair_dispatch("emb", X[:2], "sp", sp[:2], 10) is None
    rng = np.random.default_rng(9)
    for r in range(2):
        q = rng.standard_normal(X.shape[1]).astype(np.float32)
        got = {}
        for k, col in pair.items():
            p = PKGS[k]
            grouped = col.group_by_query(p.VectorQuery("emb", vector=q), group_by_field="tag",
                                         group_count=4, group_topk=2, output_fields=["tag"])
            fused = col.query([p.VectorQuery("emb", vector=q), p.VectorQuery("sp", vector=sp[r])],
                              topk=10, reranker=p.RrfReRanker(topn=8))
            got[k] = ([(d.fields["tag"], d.id) for d in grouped], [(d.id, round(d.score, 6)) for d in fused])
        assert got["torch"] == got["jax"], r
        assert len(got["torch"][0]) == 8


@pytest.mark.parametrize("metric", ["IP", "COSINE"])
def test_sharded_hnsw_ip_and_cosine_metric(tmp_path, metric):
    rng = np.random.default_rng(10)
    n, d = 2000, 16
    X = rng.standard_normal((n, d)).astype(np.float32)
    pair = _pair(tmp_path, metric, {"emb": (X, "VECTOR_FP32", d, _hnsw(metric))}, n)
    Q = rng.standard_normal((4, d)).astype(np.float32)
    docs = _batch_same(pair, Q, _ef(64))
    if metric == "IP":
        sims = Q @ X.T
        top = docs[0][0]
        assert abs(top.score - sims[0, int(top.id[2:])]) < 1e-2
    else:
        sims = (Q @ X.T) / (np.linalg.norm(Q, axis=1)[:, None] * np.linalg.norm(X, axis=1)[None])
        top = docs[0][0]
        assert abs(top.score - (1.0 - sims[0, int(top.id[2:])])) < 1e-3
    assert _recall(docs, np.argsort(-sims, axis=1)[:, :10]) >= 0.9


def test_sharded_hnsw_empty_shards_no_phantom_hits(tmp_path):
    """1,030 rows over 8 shards (R = 256): shards 5-7 are empty, and every
    real IP score is negative, so only the validity mask keeps the padding
    rows' zero scores out."""
    rng = np.random.default_rng(11)
    n, d = 1030, 16
    X = (rng.standard_normal((n, d)) + 5.0).astype(np.float32)
    pair = _pair(tmp_path, "ph", {"emb": (X, "VECTOR_FP32", d, _hnsw("IP", m=8, efc=50))}, n)
    te = _engine(pair["torch"], "emb")
    assert te._dev["shards"][5:] == [None] * 3 and te._dev["R"] == 256
    q = -np.ones(d, np.float32)
    ids = _both(pair, lambda p, c: c.query(p.VectorQuery("emb", vector=q, param=p.HnswQueryParam(ef=64)), topk=10))
    assert len(ids) == 10 and all(0 <= i < n for i in _ix(ids))
    assert int(ids[0][2:]) == int(np.argmax(X @ q))


def test_sharded_hnsw_int8(tmp_path):
    rng = np.random.default_rng(12)
    n, d = 2000, 16
    X = rng.standard_normal((n, d)).astype(np.float32)
    param = lambda p: p.HnswIndexParam(p.MetricType.L2, m=16, ef_construction=100, quantize_type=p.QuantizeType.INT8)  # noqa: E731
    pair = _pair(tmp_path, "i8", {"emb": (X, "VECTOR_FP32", d, param)}, n)
    assert _engine(pair["torch"], "emb")._dequant is not None
    Q = rng.standard_normal((4, d)).astype(np.float32)
    docs = _batch_same(pair, Q, _ef(64))
    d2 = ((Q[:, None, :] - X[None]) ** 2).sum(-1)
    assert _recall(docs, np.argsort(d2, axis=1)[:, :10]) >= 0.8


# ---------------- IVF ----------------


def test_sharded_ivf_collection_recall(tmp_path):
    rng = np.random.default_rng(13)
    n, d = 6000, 24
    X = rng.standard_normal((n, d)).astype(np.float32)
    param = lambda p: p.IVFIndexParam(p.MetricType.L2, n_list=64, n_iters=5)  # noqa: E731
    pair = _pair(tmp_path, "ivf", {"emb": (X, "VECTOR_FP32", d, param)}, n, prefix="v")
    je, te = _engine(pair["jax"], "emb"), _engine(pair["torch"], "emb")
    assert je._smesh is not None and te._smesh is not None
    assert sum(c.shape[0] for c in te._lists_codes) % S == 0 and len(te._lists_codes) == S
    Q = rng.standard_normal((4, d)).astype(np.float32)
    got = {}
    for k, col in pair.items():
        got[k] = col.batch_query("emb", Q, topk=10, output_fields=[], param=PKGS[k].IVFQueryParam(nprobe=16))
    for a, b in zip(got["jax"], got["torch"]):
        assert [x.id for x in a] == [x.id for x in b]
        np.testing.assert_allclose([x.score for x in b], [x.score for x in a], rtol=TOL, atol=TOL)
    gt = np.argsort(((Q[:, None, :] - X[None]) ** 2).sum(-1), axis=1)[:, :10]
    assert _recall(got["torch"], gt, strip=1) >= 0.9
    # the exact scan over the padded, sharded lists
    lin = {}
    for k, col in pair.items():
        qp = PKGS[k].IVFQueryParam(nprobe=16)
        qp.is_linear = True
        lin[k] = [x.id for x in col.batch_query("emb", Q, topk=10, output_fields=[], param=qp)[0]]
    assert lin["torch"] == lin["jax"] == [f"v{i}" for i in gt[0]]


# ---------------- sparse ----------------


def _sparse_dot(r, q):
    return sum(v * q.get(k, 0.0) for k, v in r.items())


def test_sharded_sparse_flat_matches_oracle(tmp_path):
    rng = np.random.default_rng(14)
    n, vocab, nnz = 2000, 500, 12
    rows = [{int(t): float(rng.random() + 0.1) for t in rng.choice(vocab, nnz, replace=False)} for _ in range(n)]
    pair = _pair(tmp_path, "sp", {"sv": (rows, "SPARSE_VECTOR_FP32", 0, _dense("IP"))}, n, prefix="s")
    assert _engine(pair["jax"], "sv")._smesh is not None
    te = _engine(pair["torch"], "sv")
    assert te._smesh is not None and len(te._doc_idx) == S
    q = {int(t): float(rng.random() + 0.1) for t in rng.choice(vocab, nnz, replace=False)}
    ids = _both(pair, lambda p, c: c.query(p.VectorQuery("sv", vector=q), topk=10))
    oracle = sorted(range(n), key=lambda i: -_sparse_dot(rows[i], q))[:10]
    assert {int(i[1:]) for i in ids} == set(oracle)


@pytest.fixture(scope="module")
def sparse_hnsw(tmp_path_factory):
    """Sparse HNSW over 1,200 docs: shards of 512 rows, the third 176, five empty."""
    rng = np.random.default_rng(15)
    n, vocab, nnz = 1200, 400, 10
    rows = [{int(t): float(rng.random() + 0.1) for t in rng.choice(vocab, nnz, replace=False)} for _ in range(n)]
    param = _hnsw("IP", m=16, efc=100)
    pair = _pair(tmp_path_factory.mktemp("sph"), "sph", {"sv": (rows, "SPARSE_VECTOR_FP32", 0, param)},
                 n, prefix="h", batch=1024)
    return pair, rows


def test_sharded_sparse_hnsw_recall(sparse_hnsw):
    pair, rows = sparse_hnsw
    te = _engine(pair["torch"], "sv")
    assert te._smesh is not None and te._l0 is not None and len(te._l0) == S
    je = _engine(pair["jax"], "sv")
    assert np.array_equal(np.asarray(te._aux_entries), np.asarray(je._aux_entries))
    rng = np.random.default_rng(16)
    qs = [{int(t): float(rng.random() + 0.1) for t in rng.choice(400, 10, replace=False)} for _ in range(4)]
    docs = _batch_same(pair, qs, _ef(96), field="sv")
    hits = 0
    for row, q in zip(docs, qs):
        oracle = set(sorted(range(len(rows)), key=lambda i: -_sparse_dot(rows[i], q))[:10])
        hits += len({int(d.id[1:]) for d in row} & oracle)
    assert hits / 40 >= 0.85
