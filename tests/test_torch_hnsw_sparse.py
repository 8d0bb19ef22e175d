"""The sparse graph engine: zvec_tpu_torch against zvec_tpu.

The beam runs in both packages on one graph and entry set (built by zvec_tpu,
handed over as numpy): same ids, scores within 1e-5 relative. The builds run in
both packages on the same rows: `_reverse_merge_l0` is identical on identical
input; sparse scores sum in another order than XLA's, and lexical data has many
near-ties, so whole graphs are compared row by row as neighbour sets (exact
build: at least 99% of the rows equal; clustered build, whose k-means buckets
come from signatures that differ in the last bit: at least 95%, with the
teleport slots and the medoid entries identical). Each package loads the graph
file the other wrote.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import jax.numpy as jnp  # noqa: E402

import zvec_tpu  # noqa: E402
import zvec_tpu_torch  # noqa: E402
from zvec_tpu.core import hnsw_sparse as jcore  # noqa: E402
from zvec_tpu.model.param.param import HnswIndexParam as JIndexParam  # noqa: E402
from zvec_tpu.model.param.param import HnswQueryParam as JQueryParam  # noqa: E402
from zvec_tpu.ops.hnsw_sparse import hnsw_sparse_search as jax_beam  # noqa: E402
from zvec_tpu_torch.core import hnsw_sparse as tcore  # noqa: E402
from zvec_tpu_torch.model.param.param import HnswIndexParam, HnswQueryParam  # noqa: E402
from zvec_tpu_torch.ops.hnsw_sparse import hnsw_sparse_search  # noqa: E402
from zvec_tpu_torch.ops.kmeans import lloyd  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402

RTOL = 1e-5


def random_sparse(rng, vocab=800, nnz=16):
    dims = rng.choice(vocab, nnz, replace=False)
    return {int(d): float(rng.random() + 0.1) for d in dims}


def sparse_dot(a, b):
    return sum(a[k] * b[k] for k in set(a) & set(b))


def t(a):
    return torch.from_numpy(np.array(a))


def _engine(core, param_cls, rows, m, efc):
    ip = core.MetricType.IP
    eng = core.SparseHnswEngine(ip, 0, param_cls(ip, m=m, ef_construction=efc))
    eng.bind_data(lambda: rows, lambda: 1)
    return eng


def row_set_share(a: np.ndarray, b: np.ndarray) -> float:
    """Share of rows whose neighbour sets are equal."""
    return float((np.sort(a, axis=1) == np.sort(b, axis=1)).all(axis=1).mean())


# ------------------------------------------------------------- the exact build


@pytest.fixture(scope="module")
def exact_pair():
    """n = 3,000 random rows through both exact builds."""
    rng = np.random.default_rng(0)
    rows = [random_sparse(rng) for _ in range(3000)]
    queries = [random_sparse(rng) for _ in range(24)]
    je = _engine(jcore, JIndexParam, rows, 12, 100)
    te = _engine(tcore, HnswIndexParam, rows, 12, 100)
    je._ensure_fresh()
    te._ensure_fresh()
    return rows, queries, je, te


def test_exact_build_rows_equal_as_sets(exact_pair):
    _, _, je, te = exact_pair
    assert te.build_info == {"clustered": False}
    assert {"pad_rows", "forward_knn", "reverse_merge"} <= set(te.build_times)
    jl0, tl0 = je._aux_l0, te._aux_l0
    assert jl0.shape == tl0.shape == (3000, 24)
    assert row_set_share(jl0, tl0) >= 0.99
    np.testing.assert_array_equal(np.asarray(je._entries), te._entries.numpy())
    np.testing.assert_array_equal(np.asarray(je._doc_idx), te._doc_idx.numpy())
    np.testing.assert_array_equal(np.asarray(je._doc_val), te._doc_val.numpy())
    assert te._l0.shape == je._l0.shape and te._vocab == je._vocab


def test_reverse_merge_l0_identical():
    rng = np.random.default_rng(1)
    n, k, m0 = 400, 9, 8
    fwd_i = rng.integers(-1, n, (n, k)).astype(np.int32)
    fwd_s = np.round(rng.random((n, k)), 1).astype(np.float32)  # plenty of equal scores
    fwd_i[5] = 5  # self edges only
    np.testing.assert_array_equal(
        jcore._reverse_merge_l0(fwd_i, fwd_s, n, m0), tcore._reverse_merge_l0(fwd_i, fwd_s, n, m0)
    )


@pytest.mark.parametrize(
    "ef,frontier,masked,budget",
    [(32, 1, False, 10000), (80, 4, False, 10000), (32, 4, True, 10000), (80, 1, True, 10000),
     (80, 4, False, 150)],
)
def test_beam_matches_on_reference_graph(exact_pair, ef, frontier, masked, budget):
    """Both beams on the graph, entries and padded rows of the JAX engine."""
    _, queries, je, te = exact_pair
    q_idx, q_val = je._queries_from_rows(queries)
    n_pad = je._doc_idx.shape[0]
    mask = np.zeros(n_pad, bool)
    mask[:3000] = np.random.default_rng(2).random(3000) > 0.6 if masked else True
    args = [np.asarray(a) for a in (je._doc_idx, je._doc_val, je._l0, je._entries)]
    kw = dict(ef=ef, topk=10, max_steps=ef + 64, vocab=je._vocab, frontier=frontier)
    js, ji = jax_beam(
        jnp.asarray(q_idx), jnp.asarray(q_val), *(jnp.asarray(a) for a in args),
        jnp.asarray(mask), jnp.int32(budget), **kw,
    )
    ts, ti = hnsw_sparse_search(t(q_idx), t(q_val), *(t(a) for a in args), t(mask), budget, **kw)
    assert ti.dtype == torch.int64 and hnsw_sparse_search.last_steps > 0
    ji, ti = np.asarray(ji)[:24], ti.numpy()[:24]
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_allclose(ts.numpy()[:24], np.asarray(js)[:24], rtol=RTOL)
    if masked:
        assert mask[ti[ti >= 0]].all()
    if budget < 1000:
        assert hnsw_sparse_search.last_steps < 20  # the scan budget ended the beams early
    # without a mask tensor the beam keeps every row it scores
    if not masked and budget > 1000:
        ns, ni = hnsw_sparse_search(t(q_idx), t(q_val), *(t(a) for a in args), None, budget, **kw)
        np.testing.assert_array_equal(ni.numpy()[:24], ti)


def test_engine_search_matches_and_recall(exact_pair):
    rows, queries, je, te = exact_pair
    js, ji = je.search(queries, 10, param=JQueryParam(ef=150))
    ts, ti = te.search(queries, 10, param=HnswQueryParam(ef=150))
    # the two graphs differ on a few near-tied rows: compare the answers by recall
    hits = both = 0
    for r, q in enumerate(queries):
        oracle = np.array([sparse_dot(q, d) for d in rows])
        expect = set(np.argsort(-oracle, kind="stable")[:10].tolist())
        hits += len(set(ti[r].tolist()) & expect)
        both += len(set(ti[r].tolist()) & set(ji[r].tolist()))
    assert hits / 240 >= 0.8 and both / 240 >= 0.95
    # is_linear takes the exact scan
    ls, li = te.search(queries, 10, param=HnswQueryParam(ef=150, is_linear=True))
    for r, q in enumerate(queries):
        oracle = np.array([sparse_dot(q, d) for d in rows])
        np.testing.assert_allclose(ls[r], np.sort(oracle)[::-1][:10], rtol=RTOL)


def test_small_corpus_scans_exactly():
    rng = np.random.default_rng(3)
    docs = [random_sparse(rng) for _ in range(200)]
    q = random_sparse(rng)
    te = _engine(tcore, HnswIndexParam, docs, 8, 200)
    _, idx = te.search([q], 5)
    oracle = np.array([sparse_dot(q, d) for d in docs])
    assert set(idx[0]) == set(np.argsort(-oracle, kind="stable")[:5])
    assert te._l0 is None and te.dump_aux("/nonexistent", "f") == {}


def test_filtered_disjoint_region_rescans():
    """`tests/test_hnsw_sparse.py::test_sparse_hnsw_filtered_disjoint_region`:
    the filter keeps only rows that share no term with the query's
    neighbourhood; the deficient query must get the exact filtered top-k."""
    n = 3000
    docs = []
    for i in range(n):
        base = 0 if i < n // 2 else 100
        dims = (np.arange(4) * 7 + i) % 100 + base
        docs.append({int(d): float(1.0 + (i % 5) * 0.1) for d in dims})
    mask = np.zeros(n, dtype=bool)
    mask[n // 2 :] = True
    q = docs[3]
    te = _engine(tcore, HnswIndexParam, docs, 8, 60)
    je = _engine(jcore, JIndexParam, docs, 8, 60)
    ts, ti = te.search([q], 5, mask=mask, param=HnswQueryParam(ef=50))
    js, ji = je.search([q], 5, mask=mask, param=JQueryParam(ef=50))
    got = ti[0][ti[0] >= 0]
    assert len(got) == 5 and set(got) <= set(np.flatnonzero(mask))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=RTOL)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_graph_file_loads_across_packages(exact_pair, tmp_path, writer):
    rows, queries, je, te = exact_pair
    src = je if writer == "jax" else te
    desc = src.dump_aux(str(tmp_path), "sv")
    assert desc == {"file": "hnsw_sparse_sv.npz", "type": "hnsw_sparse", "m": 12}
    assert set(np.load(tmp_path / desc["file"]).files) == {"n", "l0"}
    if writer == "jax":
        dst = _engine(tcore, HnswIndexParam, rows, 12, 100)
        param = HnswQueryParam(ef=60)
    else:
        dst = _engine(jcore, JIndexParam, rows, 12, 100)
        param = JQueryParam(ef=60)
    dst.load_aux(str(tmp_path), desc)
    dst._ensure_fresh()
    np.testing.assert_array_equal(dst._aux_l0, src._aux_l0)
    if writer == "jax":
        assert "forward_knn" not in dst.build_times  # loaded, not built
    # one graph, one entry rule: both packages now answer alike
    src_param = JQueryParam(ef=60) if writer == "jax" else HnswQueryParam(ef=60)
    s1, i1 = src.search(queries, 10, param=src_param)
    s2, i2 = dst.search(queries, 10, param=param)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=RTOL)


def test_sharded_graph_file_is_rebuilt(exact_pair, tmp_path):
    """A file from a mesh-sharded layout holds shard-local ids: not loaded."""
    rows, _, _, te = exact_pair
    np.savez_compressed(
        tmp_path / "hnsw_sparse_sv.npz", n=np.int64(3000), shards=np.int64(4),
        l0=np.zeros((3072, 24), np.int32), entries=np.zeros(128, np.int32),
    )
    dst = _engine(tcore, HnswIndexParam, rows, 12, 100)
    dst.load_aux(str(tmp_path), {"file": "hnsw_sparse_sv.npz"})
    dst._ensure_fresh()
    assert "forward_knn" in dst.build_times
    np.testing.assert_array_equal(dst._aux_l0, te._aux_l0)


# --------------------------------------------------------- the clustered build


def _topic_rows():
    """The data of `tests/test_hnsw_sparse.py::test_clustered_signature_build_recall`."""
    rng = np.random.default_rng(3)
    n, v, topics, nnz = 6000, 20000, 30, 24
    pools = [rng.choice(v, 200, replace=False) for _ in range(topics)]

    def make_row(tp):
        terms = rng.choice(pools[tp], nnz, replace=False)
        return dict(zip(terms.tolist(), (rng.random(nnz) + 0.2).astype(float).tolist()))

    rows = [make_row(tp) for tp in rng.integers(0, topics, n)]
    qrows = [make_row(tp) for tp in rng.integers(0, topics, 25)]
    dense = np.zeros((n, v), np.float32)
    for i, r in enumerate(rows):
        dense[i, list(r)] = list(r.values())
    qd = np.zeros((len(qrows), v), np.float32)
    for i, r in enumerate(qrows):
        qd[i, list(r)] = list(r.values())
    exp = np.argsort(-(qd @ dense.T), axis=1)[:, :10]
    return rows, qrows, exp


def _recall(idx, exp):
    return sum(len(set(idx[i][idx[i] >= 0].tolist()) & set(exp[i].tolist())) for i in range(len(exp))) / exp.size


@pytest.fixture(scope="module")
def clustered_pair():
    rows, qrows, exp = _topic_rows()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZVEC_SPARSE_CLUSTERED", "1")
        je = _engine(jcore, JIndexParam, rows, 16, 200)
        je._ensure_fresh()
    te = _engine(tcore, HnswIndexParam, rows, 16, 200)
    te._force_clustered = True
    calls = lloyd.calls
    te._ensure_fresh()
    assert lloyd.calls == calls + 1
    return rows, qrows, exp, je, te


def test_clustered_build_against_reference(clustered_pair):
    _, _, _, je, te = clustered_pair
    info = te.build_info
    assert info["clustered"] and info["K"] == 64 and info["kc"] == 32 and info["mp"] % 128 == 0
    assert {"signatures", "kmeans", "assign_top2", "bucket_pack", "bucket_knn", "rescore",
            "expansion_round", "reverse_merge", "medoids"} <= set(te.build_times)
    jl0, tl0 = je._aux_l0, te._aux_l0
    assert jl0.shape == tl0.shape == (6000, 32)
    np.testing.assert_array_equal(jl0[:, -2:], tl0[:, -2:])  # teleport slots, one rng stream
    assert row_set_share(jl0[:, :-2], tl0[:, :-2]) >= 0.95
    np.testing.assert_array_equal(np.asarray(je._entry_hint), te._entry_hint)
    np.testing.assert_array_equal(np.asarray(je._entries), te._entries.numpy())


def test_kmeans_assignments_identical_on_shared_signatures(clustered_pair):
    """The signature k-means and the top-2 spill of both packages, fed the
    same (JAX-made) signatures, the rng draws of the build."""
    from zvec_tpu.ops.hnsw import assign_top2_blocked as j_assign
    from zvec_tpu.ops.kmeans import lloyd as j_lloyd
    from zvec_tpu.ops.sparse import sparse_signatures as j_sig
    from zvec_tpu_torch.ops.hnsw import assign_top2_blocked

    _, _, _, je, te = clustered_pair
    n = 6000
    sig = j_sig(je._doc_idx, je._doc_val, 256)[:n]
    rng = np.random.default_rng(0x5BA5)
    sub = sig[rng.choice(n, n, replace=False)]
    seeds = sig[rng.choice(n, 64, replace=False)]
    jc, _ = j_lloyd(jnp.asarray(sub), jnp.asarray(seeds), iters=6, block=n)
    tc, _ = lloyd(t(sub), t(seeds), iters=6, block=n)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    ja = np.asarray(j_assign(jnp.asarray(sig), jc, block=16384))[:n]
    ta = assign_top2_blocked(t(sig), tc, block=16384).numpy()
    np.testing.assert_array_equal(ja, ta)


def test_bucket_knn_ip_ignores_norms():
    """`bucket_knn_all` on fp32 (N, 256) rows with IP: the norms it is handed
    play no part, and each half-row holds the bucket's exact top-kc by dot."""
    from zvec_tpu_torch.ops.hnsw import bucket_knn_all

    rng = np.random.default_rng(5)
    n, kc = 300, 8
    sig = rng.standard_normal((n, 256)).astype(np.float32)
    rows_bkt = np.full((2, 160), -1, np.int32)
    rows_bkt[0, :150] = np.arange(150)
    rows_bkt[1, :160] = np.arange(140, 300)
    slot = np.zeros((2, 160), np.int32)
    slot[1, :10] = 1  # rows 140..149 are spill members of the second bucket
    outs = []
    for norms in ((sig * sig).sum(1), np.zeros(n, np.float32)):
        cand = torch.full((n + 1, 2 * kc), -1, dtype=torch.int32)
        bucket_knn_all(t(rows_bkt), t(slot), cand, t(sig), t(norms), metric=MetricType.IP, kc=kc)
        outs.append(cand[:n].numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    dots = sig @ sig.T
    np.fill_diagonal(dots, -np.inf)
    for i in (0, 77, 145, 299):
        members = np.arange(150) if i < 140 else np.arange(140, 300)
        half = outs[0][i, kc:] if 140 <= i < 150 else outs[0][i, :kc]
        best = members[np.argsort(-dots[i, members], kind="stable")[:kc]]
        assert set(half.tolist()) == set(best.tolist())
    assert (outs[0][145, :kc] >= 0).all() and (outs[0][145, kc:] >= 0).all()  # both halves filled


def test_rescore_topk_on_reference_candidates(clustered_pair):
    """The exact rescoring of both packages on one candidate table: own edges
    plus those of the two best neighbours, repeats and self included."""
    _, _, _, je, te = clustered_pair
    l0 = je._aux_l0[:, :-2]
    cand = np.concatenate([l0, l0[np.clip(l0[:, 0], 0, None)], l0[:, :3], np.arange(6000)[:, None]], axis=1)
    cand = cand.astype(np.int32)
    ji, js = je._rescore_topk_batched(cand, 33)
    ti, ts = te._rescore_topk_batched(cand, 33)
    assert ti.shape == (6000, 33) and ti.dtype == np.int32
    assert ((ti >= 0) == (ji >= 0)).all()
    assert row_set_share(ji, ti) >= 0.99
    same = (ji == ti).all(axis=1)
    assert same.mean() >= 0.9
    np.testing.assert_allclose(ts[same], js[same], rtol=RTOL)
    rows = np.arange(6000)[:, None]
    assert not (ti == rows).any()  # the node itself is dropped
    srt = np.sort(ti, axis=1)
    assert not ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()  # and repeats
    # fewer candidates than k: the rest of the row stays empty
    fi, fs = te._rescore_topk_batched(cand[:50, :5], 33)
    assert fi.shape == (50, 33) and (fi[:, 5:] == -1).all()


def test_clustered_recall_survives_dump_and_load(clustered_pair, tmp_path):
    rows, qrows, exp, je, te = clustered_pair
    _, idx = te.search(qrows, 10, param=HnswQueryParam(ef=80))
    assert _recall(idx, exp) >= 0.9
    desc = te.dump_aux(str(tmp_path), "f")
    assert set(np.load(tmp_path / desc["file"]).files) == {"n", "l0", "entries"}
    calls = lloyd.calls
    # the port's file in a fresh port engine and in the JAX engine
    te2 = _engine(tcore, HnswIndexParam, rows, 16, 200)
    te2.load_aux(str(tmp_path), desc)
    _, idx2 = te2.search(qrows, 10, param=HnswQueryParam(ef=80))
    assert lloyd.calls == calls and "kmeans" not in te2.build_times
    np.testing.assert_array_equal(idx2, idx)
    np.testing.assert_array_equal(te2._entries.numpy(), te._entries.numpy())
    je2 = _engine(jcore, JIndexParam, rows, 16, 200)
    je2.load_aux(str(tmp_path), desc)
    _, jidx2 = je2.search(qrows, 10, param=JQueryParam(ef=80))
    np.testing.assert_array_equal(np.asarray(jidx2), idx)
    # the JAX engine's file in the port
    jdesc = je.dump_aux(str(tmp_path), "j")
    te3 = _engine(tcore, HnswIndexParam, rows, 16, 200)
    te3.load_aux(str(tmp_path), jdesc)
    _, idx3 = te3.search(qrows, 10, param=HnswQueryParam(ef=80))
    _, jidx = je.search(qrows, 10, param=JQueryParam(ef=80))
    np.testing.assert_array_equal(idx3, np.asarray(jidx))
    assert _recall(idx3, exp) >= 0.9
    # a loaded engine writes its medoid entries out again
    again = te3.dump_aux(str(tmp_path), "k")
    np.testing.assert_array_equal(np.load(tmp_path / again["file"])["entries"], np.asarray(je._entry_hint))


def test_size_rule_picks_clustered_build(monkeypatch):
    rng = np.random.default_rng(6)
    rows = [random_sparse(rng, vocab=3000) for _ in range(1500)]
    te = _engine(tcore, HnswIndexParam, rows, 8, 60)
    te._ensure_fresh()
    assert te.build_info == {"clustered": False} and te._entry_hint is None
    monkeypatch.setattr(tcore, "_CLUSTERED_AUTO_ROWS", 1200)
    te2 = _engine(tcore, HnswIndexParam, rows, 8, 60)
    te2._ensure_fresh()
    assert te2.build_info["clustered"] and te2.build_info["K"] == 64
    assert te2._entry_hint is not None and len(te2._entry_hint) <= 128
    assert (te2._aux_l0[:, -2:] == te._aux_l0[:, -2:]).mean() < 0.1  # no teleports below 2,048 rows
    assert te2._aux_l0.shape == (1500, 16)


# --------------------------------------------------------- through the collection


def _hnsw_schema(pkg):
    return pkg.CollectionSchema(
        "col_sh",
        vectors=[
            pkg.VectorSchema(
                "sv", pkg.DataType.SPARSE_VECTOR_FP32, 0,
                pkg.HnswIndexParam(pkg.MetricType.IP, m=8, ef_construction=80),
            )
        ],
        max_doc_count_per_segment=1500,
    )


@pytest.fixture(scope="module")
def collection_docs():
    rng = np.random.default_rng(42)
    return [random_sparse(rng) for _ in range(1600)]


def _fill(pkg, path, docs):
    c = pkg.create_and_open(str(path), _hnsw_schema(pkg))
    for s in range(0, 1600, 800):
        c.insert([pkg.Doc(id=f"s{i}", vectors={"sv": docs[i]}) for i in range(s, s + 800)])
    return c


def test_sparse_hnsw_through_collection(tmp_path, collection_docs):
    """`tests/test_hnsw_sparse.py::test_sparse_hnsw_through_collection` on the
    port, then the reopened collection and the same collection in zvec_tpu."""
    p, docs = zvec_tpu_torch, collection_docs
    c = _fill(p, tmp_path / "sh", docs)
    assert "sv" in c._impl.segments[0].meta.indexes
    assert isinstance(c._impl.segments[0]._engines["sv"], tcore.SparseHnswEngine)
    hits = 0
    answers = []
    for qi in range(8):
        res = c.query(p.VectorQuery("sv", vector=docs[qi], param=p.HnswQueryParam(ef=120)), topk=10)
        oracle = np.array([sparse_dot(docs[qi], d) for d in docs])
        expect = {f"s{i}" for i in np.argsort(-oracle, kind="stable")[:10]}
        hits += len({r.id for r in res} & expect)
        answers.append([r.id for r in res])
    assert hits / 80 >= 0.75
    c.optimize()
    c.flush()
    c._impl.close()

    c2 = p.open(str(tmp_path / "sh"))
    eng = c2._impl.segments[0]._engines["sv"]
    assert isinstance(eng, tcore.SparseHnswEngine)
    res = c2.query(p.VectorQuery("sv", vector=docs[3]), topk=3)
    assert res[0].id == "s3"
    assert eng._loaded_aux is not None and "forward_knn" not in eng.build_times
    c2._impl.close()

    # the reference package opens the port's collection and its graph files
    jc = zvec_tpu.open(str(tmp_path / "sh"))
    jeng = jc._impl.segments[0]._engines["sv"]
    assert jeng._loaded_aux is not None
    res = jc.query(zvec_tpu.VectorQuery("sv", vector=docs[3]), topk=3)
    assert res[0].id == "s3"
    jc._impl.close()


def test_port_opens_reference_sparse_hnsw_collection(tmp_path, collection_docs):
    docs = collection_docs
    jc = _fill(zvec_tpu, tmp_path / "j", docs)
    jc.optimize()
    jc.flush()
    expect = [
        [(d.id, d.score) for d in jc.query(
            zvec_tpu.VectorQuery("sv", vector=docs[qi], param=zvec_tpu.HnswQueryParam(ef=120)), topk=10)]
        for qi in range(6)
    ]
    jc._impl.close()
    p = zvec_tpu_torch
    c = p.open(str(tmp_path / "j"))
    engines = [s._engines["sv"] for s in c._impl.segments]
    for qi, exp in enumerate(expect):
        got = c.query(p.VectorQuery("sv", vector=docs[qi], param=p.HnswQueryParam(ef=120)), topk=10)
        assert [d.id for d in got] == [e[0] for e in exp]
        np.testing.assert_allclose([d.score for d in got], [e[1] for e in exp], rtol=RTOL)
    assert all(e._loaded_aux is not None and "forward_knn" not in e.build_times for e in engines)
    c._impl.close()


def test_smoke_script_keeps_the_sparse_benchmark_generator():
    """`chip_smoke.py` carries its own copy of the topic-model generator of
    `benchmarks/bench_sparse1m.py` (the script imports nothing from before the
    port): the same pools, rows, queries and dicts, draw for draw."""
    import chip_smoke
    from benchmarks import bench_sparse1m as ref

    assert (chip_smoke.SP_VOCAB, chip_smoke.SP_TOPICS, chip_smoke.SP_NNZ_DOC, chip_smoke.SP_NNZ_Q,
            chip_smoke.SP_SEED, chip_smoke.SP_CHUNK) == (ref.VOCAB, ref.TOPICS, ref.NNZ_DOC, ref.NNZ_Q,
                                                         ref.SEED, 1 << 17)
    pools, rpools = chip_smoke.sparse_topic_model(), ref._topic_model()
    assert len(pools) == len(rpools) == 256
    for a, b in zip(pools, rpools):
        np.testing.assert_array_equal(a, b)
    for count, nnz, seed, frac in ((700, 96, ref.SEED + 1, 0.3), (300, 96, ref.SEED + 1 + (1 << 17), 0.3),
                                   (64, 16, ref.SEED + 77, 0.25)):
        idx, val = chip_smoke.sparse_make_rows(pools, count, nnz, seed, head_frac=frac)
        ridx, rval = ref._make_rows(rpools, count, nnz, seed, head_frac=frac)
        np.testing.assert_array_equal(idx, ridx)
        np.testing.assert_array_equal(val, rval)
        assert chip_smoke.sparse_rows_to_dicts(idx, val) == ref.rows_to_dicts(ridx, rval)
    # the topic a row was drawn from is read back from its tail terms
    rng = np.random.default_rng(ref.SEED + 77)
    topics = rng.integers(0, ref.TOPICS, 64)
    np.testing.assert_array_equal(chip_smoke._sparse_topics(pools, idx), topics)
