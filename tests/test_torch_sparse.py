"""Sparse ops and the sparse FLAT engine: zvec_tpu_torch against zvec_tpu.

The same rows and queries, made with numpy from a seed, go through the JAX
function (on the CPU backend) and its counterpart in the port on
`torch.device("cpu")`. Host helpers (padding, pruning, query arrays) must give
identical arrays. Device scores sum over a row's slots in another order than
XLA's, so scores agree within 1e-5 relative and ids are compared as sets where
the boundary scores tie within 1e-5 relative; `_densify_queries` adds at most
one non-zero per slot and is bitwise equal. Then the cases of
`tests/test_sparse.py` that concern sparse fields go through the port's public
API, and a collection written by either package opens in the other.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import jax.numpy as jnp  # noqa: E402

import zvec_tpu  # noqa: E402
import zvec_tpu_torch  # noqa: E402
from zvec_tpu.core.sparse_flat import SparseFlatEngine as JaxFlat  # noqa: E402
from zvec_tpu.ops import sparse as jops  # noqa: E402
from zvec_tpu_torch.core.sparse_flat import SparseFlatEngine as TorchFlat  # noqa: E402
from zvec_tpu_torch.ops import sparse as tops  # noqa: E402

RTOL = 1e-5
PACKAGES = {"jax": zvec_tpu, "torch": zvec_tpu_torch}


def random_sparse(rng, vocab=500, nnz=12):
    dims = rng.choice(vocab, nnz, replace=False)
    return {int(d): float(rng.random() + 0.1) for d in dims}


def sparse_dot(a, b):
    return sum(a[k] * b[k] for k in set(a) & set(b))


def make_arrays(seed, n, p, vocab, nq=9, pq=8):
    """Padded doc and query arrays with pads, built directly (rows sorted)."""
    rng = np.random.default_rng(seed)

    def rows(count, width):
        idx = np.full((count, width), -1, np.int32)
        val = np.zeros((count, width), np.float32)
        for i in range(count):
            m = int(rng.integers(0, width + 1))
            idx[i, :m] = np.sort(rng.choice(vocab, m, replace=False))
            val[i, :m] = rng.random(m).astype(np.float32) + 0.1
        return idx, val

    return rows(n, p) + rows(nq, pq)


def assert_same_topk(js, ji, ts, ti, rtol=RTOL):
    """Scores within rtol; per row the same ids, except ids whose score lies
    within rtol of the row's last valid score (a near-tie at the boundary)."""
    js, ji, ts, ti = (np.asarray(a) for a in (js, ji, ts, ti))
    assert js.shape == ts.shape and ji.shape == ti.shape
    valid = ji >= 0
    assert ((ti >= 0) == valid).all()
    np.testing.assert_allclose(ts[valid], js[valid], rtol=rtol, atol=1e-6)
    for r in range(ji.shape[0]):
        a, b = set(ji[r][valid[r]].tolist()), set(ti[r][valid[r]].tolist())
        if a == b:
            continue
        kth = js[r][valid[r]].min()
        score = dict(zip(ji[r].tolist(), js[r].tolist())) | dict(zip(ti[r].tolist(), ts[r].tolist()))
        assert all(abs(score[i] - kth) <= rtol * abs(kth) for i in a ^ b), (r, a ^ b)


def t(a):
    return torch.from_numpy(np.array(a))


def budget_param(budget):
    """`filtering_budget` is read off the query param by name; no param class
    of either package declares it."""
    return SimpleNamespace(filtering_budget=budget)


# ---------------------------------------------------------------- host helpers


def test_pad_sparse_rows_identical():
    rng = np.random.default_rng(0)
    rows = [random_sparse(rng, vocab=900, nnz=int(rng.integers(1, 40))) for _ in range(50)]
    rows += [None, {}, random_sparse(rng, vocab=5000, nnz=300)]  # None, empty, over the 256 cap
    rows.append({7: -3.0, 2: 0.5, 11: 0.25})  # negative values keep their magnitude order
    ji, jv, jvocab = jops.pad_sparse_rows(rows)
    ti, tv, tvocab = tops.pad_sparse_rows(rows)
    assert ji.shape == (54, 256) and jvocab == tvocab
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_array_equal(jv, tv)
    # a small cap makes most rows go over it
    for cap in (4, 16):
        a, b = jops.pad_sparse_rows(rows, max_nnz=cap), tops.pad_sparse_rows(rows, max_nnz=cap)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]
    e = tops.pad_sparse_rows([None, {}])
    np.testing.assert_array_equal(e[0], jops.pad_sparse_rows([None, {}])[0])
    assert e[0].shape == (2, 1) and e[2] == 1


def test_prune_sparse_query_identical():
    q = {1: 1.0, 2: -0.5, 3: 0.05, 9: 0.1}
    for budget in (0.0, 0.1, 0.5, 2.0):
        assert tops.prune_sparse_query(q, budget) == jops.prune_sparse_query(q, budget)
    assert tops.prune_sparse_query({}, 0.3) == {}
    assert tops.prune_sparse_query(q, 0.1) == {1: 1.0, 2: -0.5, 9: 0.1}


@pytest.mark.parametrize("budget", [0.0, 0.4])
def test_prep_query_arrays_identical(budget):
    rng = np.random.default_rng(1)
    queries = [random_sparse(rng, nnz=int(rng.integers(1, 30))) for _ in range(11)] + [{}, None]
    queries.append(random_sparse(rng, vocab=3000, nnz=600))  # past the 512-slot query cap
    je, te = JaxFlat(), TorchFlat()
    ja = je._prep_query_arrays(queries, budget_param(budget))
    ta = te._prep_query_arrays(queries, budget_param(budget))
    for a, b in zip(ja, ta):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ta[0].shape[0] == 32  # 14 queries pad to the 32 bucket
    if budget == 0.0:
        assert ta[0].shape[1] == 512  # the cap on a query's slots


# ---------------------------------------------------------------- device ops


def test_densify_queries_bitwise():
    _, _, qi, qv = make_arrays(2, 4, 4, vocab=64, nq=6, pq=8)
    # padding lands on slot 0 while term 0 is a real term of query 0, and a
    # dim outside the vocabulary is dropped (it clips to the last slot)
    qi[0, :3], qv[0, :3] = [0, 5, -1], [0.75, 0.5, 9.0]
    qi[1, :2], qv[1, :2] = [63, 200], [0.25, 4.0]
    jd = np.asarray(jops._densify_queries(jnp.asarray(qi), jnp.asarray(qv), 64))
    td = tops._densify_queries(t(qi), t(qv), 64).numpy()
    np.testing.assert_array_equal(jd, td)
    assert td[0, 0] == 0.75 and td[1, 63] == 0.25


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,topk", [(1000, 10), (777, 33), (40, 64)])
def test_sparse_ip_topk_matches(n, topk, masked):
    di, dv, qi, qv = make_arrays(3 + n, n, 12, vocab=300)
    mask = np.random.default_rng(4).random(n) > 0.4 if masked else None
    if n == 40:
        di[10:] = -1  # k > rows that can score: the rest of the row is -1
        mask = np.arange(n) < 10 if masked else None
    k = min(topk, n)
    js, ji = jops.sparse_ip_topk(
        jnp.asarray(qi), jnp.asarray(qv), jnp.asarray(di), jnp.asarray(dv),
        None if mask is None else jnp.asarray(mask), topk=k, vocab=384, block_size=256,
    )
    ts, ti = tops.sparse_ip_topk(
        t(qi), t(qv), t(di), t(dv), None if mask is None else t(mask),
        topk=k, vocab=384, block_size=256,
    )
    assert_same_topk(js, ji, ts, ti)
    if mask is not None:
        got = ti.numpy()
        assert mask[got[got >= 0]].all()


def test_sparse_ip_topk_block_size_independent():
    """Ties included: rows repeat, so equal scores must go to the lower row
    whatever the block size."""
    di, dv, qi, qv = make_arrays(5, 300, 10, vocab=200)
    di, dv = np.tile(di, (3, 1))[:811], np.tile(dv, (3, 1))[:811]  # not a block multiple
    mask = np.random.default_rng(6).random(811) > 0.2
    outs = [
        tops.sparse_ip_topk(t(qi), t(qv), t(di), t(dv), t(mask), topk=20, vocab=256, block_size=b)
        for b in (64, 256, 8192)
    ]
    for s, i in outs[1:]:
        assert torch.equal(i, outs[0][1])
        assert torch.equal(s, outs[0][0])
    ids = outs[0][1].numpy()
    sims = outs[0][0].numpy()
    tied = sims[:, 1:] == sims[:, :-1]
    assert tied.any() and (ids[:, 1:][tied] > ids[:, :-1][tied]).all()


def test_sparse_ip_rows_matches():
    di, dv, qi, qv = make_arrays(7, 500, 12, vocab=300, nq=16)
    pick = np.random.default_rng(8).integers(0, 500, (16, 24))
    js = jops.sparse_ip_rows(
        jnp.asarray(qi), jnp.asarray(qv), jnp.asarray(di[pick]), jnp.asarray(dv[pick]), vocab=384
    )
    ts = tops.sparse_ip_rows(t(qi), t(qv), t(di[pick]), t(dv[pick]), vocab=384)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=1e-6)


def test_signature_chunk_matches_and_repeats():
    di, dv, _, _ = make_arrays(9, 600, 40, vocab=20000)
    js = np.asarray(jops._signature_chunk(jnp.asarray(di), jnp.asarray(dv), sig_dims=256))
    ts = tops._signature_chunk(t(di), t(dv), sig_dims=256).numpy()
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-6)
    again = tops._signature_chunk(t(di), t(dv), sig_dims=256).numpy()
    np.testing.assert_array_equal(ts, again)
    # chunked over the corpus: the same rows whatever the chunk
    whole = tops.sparse_signatures(t(di), t(dv), 256, chunk=128)
    np.testing.assert_array_equal(whole, ts)
    np.testing.assert_allclose(whole, jops.sparse_signatures(jnp.asarray(di), jnp.asarray(dv), 256), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- the engine


def _engines(docs):
    je, te = JaxFlat(), TorchFlat()
    je.bind_data(lambda: docs, lambda: 1)
    te.bind_data(lambda: docs, lambda: 1)
    return je, te


def test_flat_engine_matches_reference_engine():
    rng = np.random.default_rng(10)
    docs = [random_sparse(rng) for _ in range(700)] + [None, {}]
    queries = [random_sparse(rng) for _ in range(7)]
    je, te = _engines(docs)
    assert_same_topk(*je.search(queries, 10), *te.search(queries, 10))
    assert te._doc_idx.shape == (1024, 12) and te._vocab == je._vocab
    mask = rng.random(len(docs)) > 0.5
    js, ji = je.search(queries, 10, mask=mask)
    ts, ti = te.search(queries, 10, mask=mask)
    assert_same_topk(js, ji, ts, ti)
    assert ti.dtype == np.int64 and mask[ti[ti >= 0]].all()
    # exact against a dict oracle
    for r, q in enumerate(queries):
        oracle = np.array([sparse_dot(q, d or {}) for d in docs])
        np.testing.assert_allclose(ts[r], np.sort(np.where(mask, oracle, -np.inf))[::-1][:10], rtol=RTOL)
    # one dict is one query
    s1, i1 = te.search(queries[0], 3)
    assert i1.shape == (1, 3)


def test_flat_engine_filtering_budget():
    rng = np.random.default_rng(11)
    docs = [random_sparse(rng) for _ in range(300)]
    queries = [{**random_sparse(rng), 7: 0.01, 9: 0.02} for _ in range(4)]
    je, te = _engines(docs)
    js, ji = je.search(queries, 8, param=budget_param(0.3))
    ts, ti = te.search(queries, 8, param=budget_param(0.3))
    assert_same_topk(js, ji, ts, ti)
    full = te.search(queries, 8)[0]
    assert not np.allclose(full, ts)  # the budget did drop weight


def test_flat_engine_empty_and_k_over_n():
    je, te = _engines([])
    s, i = te.search([{1: 1.0}], 4)
    assert np.isneginf(s).all() and (i == -1).all() and i.shape == (1, 4)
    rng = np.random.default_rng(12)
    docs = [random_sparse(rng) for _ in range(6)]
    je, te = _engines(docs)
    js, ji = je.search([random_sparse(rng)], 10)
    ts, ti = te.search([random_sparse(np.random.default_rng(13))], 10)
    assert ti.shape == (1, 10) and (ti[0, 6:] == -1).all() and np.isneginf(ts[0, 6:]).all()
    q = random_sparse(rng)
    assert_same_topk(*je.search([q], 10), *te.search([q], 10))


# ---------------------------------------------------------------- public API


def _sparse_schema(pkg, index_param=None):
    return pkg.CollectionSchema(
        "col_sp",
        fields=[pkg.FieldSchema("tag", pkg.DataType.STRING)],
        vectors=[
            pkg.VectorSchema(
                "sv", pkg.DataType.SPARSE_VECTOR_FP32, 0,
                index_param or pkg.FlatIndexParam(pkg.MetricType.IP),
            )
        ],
    )


def _fill(pkg, path, docs_sparse):
    c = pkg.create_and_open(str(path), _sparse_schema(pkg))
    c.insert(
        [
            pkg.Doc(id=f"s{i}", vectors={"sv": docs_sparse[i]}, fields={"tag": f"t{i % 3}"})
            for i in range(len(docs_sparse))
        ]
    )
    return c


def test_sparse_through_collection(tmp_path):
    """`tests/test_sparse.py::test_sparse_through_collection` on the port."""
    p = zvec_tpu_torch
    rng = np.random.default_rng(42)
    docs_sparse = [random_sparse(rng) for _ in range(100)]
    c = _fill(p, tmp_path / "sp", docs_sparse)
    q = random_sparse(rng)
    res = c.query(p.VectorQuery("sv", vector=q), topk=5)
    oracle = np.array([sparse_dot(q, d) for d in docs_sparse])
    expect = [f"s{i}" for i in np.argsort(-oracle, kind="stable")[:5]]
    assert [r.id for r in res] == expect
    assert res[0].score == pytest.approx(oracle.max(), rel=1e-5)

    res = c.query(p.VectorQuery("sv", vector=q), topk=5, filter="tag = 't1'")
    allowed = [i for i in range(100) if i % 3 == 1]
    expect = [f"s{i}" for i in sorted(allowed, key=lambda i: -oracle[i])[:5]]
    assert [r.id for r in res] == expect

    d = c.fetch("s7")["s7"]
    assert d.vector("sv") == {int(k): pytest.approx(v) for k, v in docs_sparse[7].items()}

    # the same answers as the reference package on the same documents
    jc = _fill(zvec_tpu, tmp_path / "spj", docs_sparse)
    for flt in (None, "tag = 't2'"):
        a = jc.query(zvec_tpu.VectorQuery("sv", vector=q), topk=7, filter=flt)
        b = c.query(p.VectorQuery("sv", vector=q), topk=7, filter=flt)
        assert [r.id for r in a] == [r.id for r in b]
        np.testing.assert_allclose([r.score for r in b], [r.score for r in a], rtol=RTOL)
    c._impl.close()
    jc._impl.close()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_sparse_flat_collection_opens_across_packages(tmp_path, writer, reader):
    w, r = PACKAGES[writer], PACKAGES[reader]
    rng = np.random.default_rng(14)
    docs_sparse = [random_sparse(rng) for _ in range(120)]
    queries = [random_sparse(rng) for _ in range(5)]
    c = _fill(w, tmp_path / "x", docs_sparse)
    c.optimize()
    c.flush()
    expect = [[(d.id, d.score) for d in c.query(w.VectorQuery("sv", vector=q), topk=6)] for q in queries]
    c._impl.close()
    c2 = r.open(str(tmp_path / "x"))
    for q, exp in zip(queries, expect):
        got = c2.query(r.VectorQuery("sv", vector=q), topk=6)
        assert [d.id for d in got] == [e[0] for e in exp]
        np.testing.assert_allclose([d.score for d in got], [e[1] for e in exp], rtol=RTOL)
    assert c2.fetch("s3")["s3"].vector("sv") == {
        int(k): pytest.approx(v) for k, v in docs_sparse[3].items()
    }
    c2._impl.close()
