"""IVF: zvec_tpu_torch against zvec_tpu on the same numpy inputs.

- k-means: `kmeanspp_seed` gives identical seeds from one `rng`; `lloyd`,
  `stratified_train` and `assign_top2_blocked` give identical assignments
  and centroids within 1e-4 (float32 sums in another order) on clustered
  data, where no point sits on a tie.
- `ivf_probe_core` against the JAX probe on the same lists, for L2 / IP /
  COSINE x fp32 / fp16 / int8 / packed int4 (odd D), with a filter mask, a
  scan budget and the dummy-list mask: the same id sets and sorted scores
  within 1e-4.
- `IvfEngine`: both packages load one `ivf_*.npz` written by zvec_tpu,
  build identical lists and return the same ids for each search path;
  engines trained apart reach the same recall.
- The cases of `tests/test_ivf.py`, run on the port.
"""

import logging
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import jax.numpy as jnp  # noqa: E402

import zvec_tpu  # noqa: E402
import zvec_tpu.core.ivf as jivf  # noqa: E402
import zvec_tpu.ops.hnsw as jhnsw  # noqa: E402
import zvec_tpu.ops.kmeans as jkm  # noqa: E402
import zvec_tpu_torch  # noqa: E402
import zvec_tpu_torch.core.ivf as tivf  # noqa: E402
import zvec_tpu_torch.ops.hnsw as thnsw  # noqa: E402
import zvec_tpu_torch.ops.kmeans as tkm  # noqa: E402
from zvec_tpu.ops.quantize import encode, pack_int4, train_quantizer  # noqa: E402

RTOL = ATOL = 1e-4
PKGS = {"jax": zvec_tpu, "torch": zvec_tpu_torch}


def _clustered(n, d, n_centers, seed, nq=16, scale=5.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * scale
    asn = rng.integers(0, n_centers, n)
    X = (centers[asn] + rng.standard_normal((n, d))).astype(np.float32)
    Q = (centers[rng.integers(0, n_centers, nq)] + rng.standard_normal((nq, d))).astype(np.float32)
    return X, Q, asn


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _oracle(X, Q, k, metric="L2"):
    s = -((Q[:, None, :] - X[None, :, :]) ** 2).sum(-1) if metric == "L2" else Q @ X.T
    return np.argsort(-s, axis=1, kind="stable")[:, :k]


def _recall(idx, expect):
    return sum(len(set(i[i >= 0]) & set(e)) for i, e in zip(idx, expect)) / expect.size


def _assert_same_sets(sj, ij, st, it):
    """Same id set per row, sorted scores within RTOL/ATOL."""
    sj, ij, st, it = (np.asarray(a) for a in (sj, ij, st, it))
    assert ij.shape == it.shape
    for r in range(ij.shape[0]):
        assert set(ij[r].tolist()) == set(it[r].tolist()), r
    fin = np.isfinite(sj) & (sj > -1e30)
    assert (fin == (np.isfinite(st) & (st > -1e30))).all()
    assert np.allclose(np.sort(np.where(fin, sj, 0), 1), np.sort(np.where(fin, st, 0), 1),
                       rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- k-means


@pytest.mark.parametrize("n,k", [(3000, 40), (20000, 24)])  # whole set; 16,384-row subsample
def test_kmeanspp_seed_identical(n, k):
    X, _, _ = _clustered(n, 12, 8, seed=1)
    a = jkm.kmeanspp_seed(X, k, np.random.default_rng(5))
    b = tkm.kmeanspp_seed(X, k, np.random.default_rng(5))
    assert np.array_equal(a, b)


@pytest.mark.parametrize("block", [65536, 1000])  # one block; 5 blocks and a remainder
def test_lloyd_parity(block):
    X, _, _ = _clustered(4500, 16, 12, seed=2)
    seeds = jkm.kmeanspp_seed(X, 12, np.random.default_rng(3))
    cj, aj = jkm.lloyd(jnp.asarray(X), jnp.asarray(seeds), iters=6, block=block)
    calls = tkm.lloyd.calls
    ct, at = tkm.lloyd(_t(X), _t(seeds), iters=6, block=block)
    assert tkm.lloyd.calls == calls + 1
    assert np.array_equal(np.asarray(aj), at.numpy())
    assert np.allclose(np.asarray(cj), ct.numpy(), rtol=RTOL, atol=ATOL)
    assert np.array_equal(tkm.assign(_t(X), ct, block=block).numpy(), at.numpy())


def test_lloyd_keeps_empty_clusters():
    X, _, _ = _clustered(800, 8, 4, seed=4)
    seeds = np.concatenate([X[:4], np.full((1, 8), 1e4, np.float32)])  # the last is nobody's
    ct, at = tkm.lloyd(_t(X), _t(seeds), iters=3)
    cj, _ = jkm.lloyd(jnp.asarray(X), jnp.asarray(seeds), iters=3)
    assert (at.numpy() != 4).all()
    assert np.array_equal(ct[4].numpy(), seeds[4])
    assert np.allclose(np.asarray(cj), ct.numpy(), rtol=RTOL, atol=ATOL)


def test_stratified_train_parity():
    X, _, _ = _clustered(5000, 8, 40, seed=6)
    cj = jkm.stratified_train(X, 300, np.random.default_rng(7))
    ct = tkm.stratified_train(X, 300, np.random.default_rng(7))
    assert ct.shape == (300, 8) and np.isfinite(ct).all()
    assert np.allclose(cj, ct, rtol=RTOL, atol=ATOL)
    # the centroids cover the data (the case of tests/test_ivf.py)
    d = ((X[:500, None, :] - ct[None, :, :]) ** 2).sum(-1).min(1)
    assert d.mean() < ((X[:500]) ** 2).sum(1).mean()


@pytest.mark.parametrize("n", [4096, 5000])  # divides the block; a remainder of 904 rows
def test_assign_top2_blocked_parity(n):
    X, _, _ = _clustered(n, 20, 30, seed=8)
    C = jkm.kmeanspp_seed(X, 48, np.random.default_rng(9))
    aj = np.asarray(jhnsw.assign_top2_blocked(jnp.asarray(X), jnp.asarray(C), block=1024))
    at = thnsw.assign_top2_blocked(_t(X), _t(C), block=1024)
    assert at.dtype == torch.int32 and at.shape == (n, 2)
    assert np.array_equal(aj, at.numpy())
    d2 = ((X[:, None, :] - C[None, :, :]) ** 2).sum(-1)
    assert np.array_equal(np.argsort(d2, axis=1, kind="stable")[:, :2], at.numpy())
    assert np.array_equal(tkm.assign_top2(_t(X), _t(C)).numpy(), at.numpy())


def test_kmeans_converges():
    rng = np.random.default_rng(42)
    centers = np.array([[0, 0], [10, 0], [0, 10]], dtype=np.float32)
    pts = np.concatenate(
        [c + rng.standard_normal((100, 2)).astype(np.float32) * 0.5 for c in centers]
    )
    seeds = tkm.kmeanspp_seed(pts, 3, rng)
    cents, asn = tkm.lloyd(_t(pts), _t(seeds), iters=10)
    for c in centers:
        assert np.min(np.linalg.norm(cents.numpy() - c, axis=1)) < 0.5
    counts = np.bincount(asn.numpy(), minlength=3)
    assert (np.abs(counts - 100) <= 5).all()


# ---------------------------------------------------------------- probe

K_LISTS, L, NQ = 12, 40, 16


def _lists(d, qtype, metric, seed=10):
    """Padded lists from numpy, encoded with zvec_tpu's quantizer: (centroids,
    codes, norms, ids, dequant, queries, n)."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((K_LISTS, d)).astype(np.float32) * 3
    occ = rng.integers(L // 2, L + 1, K_LISTS)
    occ[3] = 0  # an empty list
    rows = cents[np.repeat(np.arange(K_LISTS), L)] + rng.standard_normal((K_LISTS * L, d))
    rows = rows.astype(np.float32)
    if metric == "COSINE" and qtype != "fp32":
        rows = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    rows[5] = 0.0  # a zero-norm row: cosine scores it 1.0
    ids = np.full((K_LISTS, L), -1, np.int32)
    n = 0
    for c in range(K_LISTS):
        ids[c, : occ[c]] = np.arange(n, n + occ[c])
        n += occ[c]
    qp = None
    if qtype == "fp32":
        codes, deq = rows, rows
    elif qtype == "fp16":
        codes = rows.astype(np.float16)
        deq = codes.astype(np.float32)
    else:
        qt = zvec_tpu.QuantizeType.INT8 if qtype == "int8" else zvec_tpu.QuantizeType.INT4
        qp = train_quantizer(rows, qt)
        codes = encode(rows, qt, qp)
        deq = codes.astype(np.float32) * qp.scale + qp.bias
    norms = (deq**2).sum(1).reshape(K_LISTS, L).astype(np.float32)
    codes = codes.reshape(K_LISTS, L, d)
    norms[ids < 0] = 0.0
    if qtype == "int4":
        codes = pack_int4(codes.reshape(K_LISTS * L, d)).reshape(K_LISTS, L, -1)
    dequant = None if qp is None else (float(np.float32(qp.scale)), float(np.float32(qp.bias)))
    q = (cents[rng.integers(0, K_LISTS, NQ)] + rng.standard_normal((NQ, d))).astype(np.float32)
    q[0] = 0.0  # a zero query: every cosine score is 1.0
    return cents, codes, norms, ids, dequant, q, n


@pytest.mark.parametrize("variant", ["plain", "mask", "max_scan", "cent_valid"])
@pytest.mark.parametrize("qtype", ["fp32", "fp16", "int8", "int4"])
@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_ivf_probe_core_parity(metric, qtype, variant):
    d = 33 if qtype == "int4" else 32
    cents, codes, norms, ids, dequant, q, n = _lists(d, qtype, metric)
    rng = np.random.default_rng(11)
    mask = rng.random(n) < 0.4 if variant == "mask" else None
    cent_valid = np.arange(K_LISTS) % 4 != 1 if variant == "cent_valid" else None
    kw = dict(nprobe=5, topk=25, int4_packed=qtype == "int4",
              max_scan=50 if variant == "max_scan" else 0)
    sj, ij = jivf.ivf_probe_core(
        jnp.asarray(q), jnp.asarray(cents), jnp.asarray(codes), jnp.asarray(norms),
        jnp.asarray(ids), None if mask is None else jnp.asarray(mask),
        None if dequant is None else (jnp.float32(dequant[0]), jnp.float32(dequant[1])),
        metric=zvec_tpu.MetricType[metric],
        cent_valid=None if cent_valid is None else jnp.asarray(cent_valid), **kw,
    )
    st, it = tivf.ivf_probe_core(
        _t(q), _t(cents), _t(codes), _t(norms), _t(ids),
        None if mask is None else _t(mask), dequant,
        metric=zvec_tpu_torch.MetricType[metric],
        cent_valid=None if cent_valid is None else _t(cent_valid), **kw,
    )
    assert it.dtype == torch.int32 and it.shape == (NQ, 25)
    _assert_same_sets(sj, ij, st.numpy(), it.numpy())
    if mask is not None:
        got = it.numpy()
        assert mask[got[got >= 0]].all()


def test_ivf_probe_max_scan_oracle():
    """Scan-budget semantics against a hand-computed oracle
    (`ivf_searcher.cc:222-237`: probe centroids in proximity order WHILE
    total_scan < max_scan_count; a list that starts under budget is scanned
    in full)."""
    d, lc = 4, 3
    cents = np.array([[1, 0, 0, 0], [2, 0, 0, 0], [3, 0, 0, 0], [4, 0, 0, 0]], np.float32)
    codes = np.stack([
        np.array([[1.0, i * 0.01, 0, 0] for i in range(lc)], np.float32) * (c + 1)
        for c in range(4)
    ])
    ids = np.arange(12, dtype=np.int32).reshape(4, lc)
    ids[1, 2] = -1  # occupancy: [3, 2, 3, 3]
    norms = (codes**2).sum(-1)
    norms[1, 2] = 0.0
    q = np.zeros((1, d), np.float32)

    def probe(max_scan):
        _, i = tivf.ivf_probe_core(
            _t(q), _t(cents), _t(codes), _t(norms), _t(ids), None, None,
            metric=zvec_tpu_torch.MetricType.L2, nprobe=4, topk=12, max_scan=max_scan,
        )
        i = i.numpy()[0]
        return set(i[i >= 0].tolist())

    all_ids = {int(v) for v in ids.ravel() if v >= 0}
    assert probe(0) == all_ids  # unbounded
    assert probe(100) == all_ids  # non-binding
    assert probe(4) == {0, 1, 2, 3, 4}  # list 1 starts at 3 < 4: scanned in full
    assert probe(3) == {0, 1, 2}  # list 1 starts at 3 >= 3: stop
    assert probe(1) == {0, 1, 2}  # the first list is always scanned


def test_dedupe_topk_keeps_first():
    sims = np.array([[5, 4, 4, 3, 2, 1]], np.float32)
    idx = np.array([[7, 7, -1, 9, 7, 3]], np.int64)
    s, i = tivf._dedupe_topk(sims, idx, 3)
    sj, ij = jivf._dedupe_topk(sims, idx, 3)
    assert i.tolist() == ij.tolist() == [[7, 9, 3]]
    assert np.array_equal(s, sj) and s.dtype == np.float32


# ---------------------------------------------------------------- engine: one trained state

D_ENG = 25  # odd: int4 packs a phantom nibble
ENGINE_CFGS = {
    # name: (metric, quantize, use_soar, n, n_list)
    "l2": ("L2", "UNDEFINED", False, 4000, 32),
    "l2_soar": ("L2", "UNDEFINED", True, 4000, 32),
    "ip": ("IP", "UNDEFINED", False, 4000, 32),
    "cosine_soar": ("COSINE", "UNDEFINED", True, 4000, 32),
    "fp16_l2": ("L2", "FP16", False, 4000, 32),
    "int8_l2_soar": ("L2", "INT8", True, 4000, 32),
    "int4_cosine": ("COSINE", "INT4", False, 4000, 32),
    "small": ("L2", "UNDEFINED", False, 600, 16),  # under the brute-force threshold
    "skewed": ("L2", "UNDEFINED", True, 8000, 64),  # virtual sublists, extra probes
}


def _engine_data(name):
    _, _, _, n, _ = ENGINE_CFGS[name]
    if name == "skewed":
        rng = np.random.default_rng(12)
        big = rng.standard_normal((6000, D_ENG)).astype(np.float32) * 0.05
        far = rng.standard_normal((63, D_ENG)).astype(np.float32) * 2
        rest = far[rng.integers(0, 63, 2000)] + rng.standard_normal((2000, D_ENG)) * 0.3
        X = np.concatenate([big, rest]).astype(np.float32)
        Q = np.concatenate([big[:8], rest[:8]]) + 0.01
        return X, Q.astype(np.float32), (np.arange(n) >= 6000).astype(np.int64)
    return _clustered(n, D_ENG, 8, seed=13)


def _make_engine(pkg, name):
    metric, qtype, soar, _, n_list = ENGINE_CFGS[name]
    mod = jivf if pkg is zvec_tpu else tivf
    param = pkg.IVFIndexParam(pkg.MetricType[metric], n_list=n_list, n_iters=6,
                              use_soar=soar, quantize_type=pkg.QuantizeType[qtype])
    return mod.IvfEngine(pkg.MetricType[metric], D_ENG, param)


@pytest.fixture(scope="module")
def shared_state(tmp_path_factory):
    """Per config: a zvec_tpu engine trains and writes `ivf_emb.npz`; fresh
    engines of both packages load that one file. Also gives the number of
    `lloyd` calls the port made while loading (0: no training)."""
    cache = {}

    def get(name):
        if name not in cache:
            X, Q, grp = _engine_data(name)
            root = tmp_path_factory.mktemp(name)
            writer = _make_engine(zvec_tpu, name)
            writer.bind_data(lambda: X, lambda: 1)
            desc = writer.dump_aux(str(root), "emb")
            engines = {}
            calls = tkm.lloyd.calls
            for key, pkg in PKGS.items():
                eng = _make_engine(pkg, name)
                eng.load_aux(str(root), desc)
                eng.bind_data(lambda: X, lambda: 1)
                eng._ensure_fresh()
                engines[key] = eng
            cache[name] = (X, Q, grp, engines, tkm.lloyd.calls - calls)
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(ENGINE_CFGS))
def test_engine_loads_jax_trained_state(shared_state, name):
    X, _, _, eng, lloyd_calls = shared_state(name)
    je, te = eng["jax"], eng["torch"]
    assert lloyd_calls == 0 and "kmeans" not in te.build_times
    assert np.array_equal(np.asarray(je._lists_ids), te._lists_ids.numpy())
    assert np.array_equal(je._flat_ids, te._flat_ids)
    assert je._extra_probes == te._extra_probes
    assert np.array_equal(np.asarray(je._centroids), te._centroids.numpy())
    assert np.allclose(np.asarray(je._lists_norms), te._lists_norms.numpy(), rtol=RTOL, atol=ATOL)
    codes_j = np.asarray(je._lists_codes)
    assert codes_j.dtype == te._lists_codes.numpy().dtype
    assert np.array_equal(codes_j, te._lists_codes.numpy())
    for k in ("n", "centroids", "assign_rows", "assign_lists", "qparams"):
        assert np.array_equal(je._trained[k], te._trained[k]), k
    if name == "skewed":
        assert te._extra_probes > 0
        assert te._lists_ids.numel() < 3.5 * len(X)  # no padding blow-up


SEARCH_CASES = [
    # (config, query param kwargs, filter, is_linear)
    ("l2", {"nprobe": 4}, None, False),
    ("l2", {"nprobe": 4}, "group", False),  # probed lists hold no allowed row: safety net
    ("l2", {"nprobe": 32, "max_scan_count": 1}, None, False),
    ("l2", {"nprobe": 32, "max_scan_ratio": 0.3}, None, False),
    ("l2", {"nprobe": 1}, None, True),
    ("l2_soar", {"nprobe": 4}, None, False),
    ("l2_soar", {"nprobe": 3}, "half", False),
    ("l2_soar", {"nprobe": 2}, None, True),
    ("ip", {"nprobe": 6}, None, False),
    ("ip", {"nprobe": 6}, "half", False),
    ("cosine_soar", {"nprobe": 5}, None, False),
    ("cosine_soar", {"nprobe": 5}, "group", False),
    ("fp16_l2", {"nprobe": 4}, None, False),
    ("int8_l2_soar", {"nprobe": 4}, None, False),  # refine by default
    ("int8_l2_soar", {"nprobe": 4, "is_using_refiner": False}, None, False),
    ("int8_l2_soar", {"nprobe": 4}, "group", False),
    ("int4_cosine", {"nprobe": 4}, None, False),
    ("int4_cosine", {"nprobe": 4, "is_using_refiner": False}, None, False),
    ("int4_cosine", {"nprobe": 4, "is_using_refiner": False}, None, True),
    ("small", {"nprobe": 1}, None, False),  # brute force under 1000 rows
    ("small", {"nprobe": 1}, "half", False),
    ("skewed", {"nprobe": 4}, None, False),
]


@pytest.mark.parametrize("case", range(len(SEARCH_CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(SEARCH_CASES)])
def test_engine_search_parity(shared_state, case):
    name, kw, flt, linear = SEARCH_CASES[case]
    X, Q, grp, eng, _ = shared_state(name)
    mask = None
    if flt == "group":
        mask = grp == 1
    elif flt == "half":
        mask = np.arange(len(X)) % 2 == 0
    out = {}
    for key, pkg in PKGS.items():
        param = pkg.IVFQueryParam(**kw)
        param.is_linear = linear
        out[key] = eng[key].search(Q, 10, mask=mask, param=param)
    (sj, ij), (st, it) = out["jax"], out["torch"]
    assert it.dtype == np.int64 and it.shape == (len(Q), 10)
    _assert_same_sets(sj, ij, st, it)
    if mask is not None:
        assert mask[it[it >= 0]].all()
        # the safety net: a row never comes back short of what the filter allows
        assert ((it >= 0).sum(1) == min(10, int(mask.sum()))).all()


@pytest.mark.parametrize("soar", [False, True])
def test_trained_apart_reach_the_same_recall(soar):
    """n_list auto at 4,096 rows is 256: the stratified path."""
    X, Q, _ = _clustered(4096, 16, 24, seed=14, nq=32)
    expect = _oracle(X, Q, 10)
    rec = {}
    for key, pkg in PKGS.items():
        mod = jivf if pkg is zvec_tpu else tivf
        eng = mod.IvfEngine(pkg.MetricType.L2, 16,
                            pkg.IVFIndexParam(pkg.MetricType.L2, n_iters=4, use_soar=soar))
        eng.bind_data(lambda: X, lambda: 1)
        _, idx = eng.search(Q, 10, param=pkg.IVFQueryParam(nprobe=8))
        assert eng._trained["centroids"].shape[0] == 256
        rec[key] = _recall(idx, expect)
    assert abs(rec["jax"] - rec["torch"]) <= 0.01, rec
    assert rec["torch"] >= 0.8


# ---------------------------------------------------------------- tests/test_ivf.py on the port


def _torch_engine(n_list, metric="L2", **kw):
    p = zvec_tpu_torch
    return tivf.IvfEngine(p.MetricType[metric], kw.pop("d"),
                          p.IVFIndexParam(p.MetricType[metric], n_list=n_list, **kw))


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_ivf_recall(metric):
    rng = np.random.default_rng(42)
    xs = rng.standard_normal((4000, 16)).astype(np.float32)
    qs = rng.standard_normal((10, 16)).astype(np.float32)
    eng = _torch_engine(64, metric, d=16, n_iters=8)
    eng.bind_data(lambda: xs, lambda: 1)
    _, idx = eng.search(qs, 10, param=zvec_tpu_torch.IVFQueryParam(nprobe=16))
    assert _recall(idx, _oracle(xs, qs, 10, metric)) >= 0.7


def test_ivf_nprobe_monotone_and_soar_spill():
    rng = np.random.default_rng(42)
    xs = rng.standard_normal((4000, 16)).astype(np.float32)
    qs = rng.standard_normal((10, 16)).astype(np.float32)
    expect = _oracle(xs, qs, 10)
    eng = _torch_engine(64, d=16)
    eng.bind_data(lambda: xs, lambda: 1)

    def recall(e, nprobe):
        return _recall(e.search(qs, 10, param=zvec_tpu_torch.IVFQueryParam(nprobe=nprobe))[1], expect)

    r2, r16, r64 = recall(eng, 2), recall(eng, 16), recall(eng, 64)
    assert r2 <= r16 + 0.05 and r16 <= r64 + 0.02
    assert r64 >= 0.99  # nprobe = n_list: exact
    soar = _torch_engine(64, d=16, use_soar=True)
    soar.bind_data(lambda: xs, lambda: 1)
    assert recall(soar, 4) >= recall(eng, 4) - 0.05  # a spill is never much worse
    assert len(soar._trained["assign_rows"]) > len(xs)


def test_ivf_int4_packed_and_small_corpus():
    rng = np.random.default_rng(42)
    xs = rng.standard_normal((4000, 32)).astype(np.float32)
    qs = rng.standard_normal((5, 32)).astype(np.float32)
    eng = _torch_engine(32, d=32, quantize_type=zvec_tpu_torch.QuantizeType.INT4)
    eng.bind_data(lambda: xs, lambda: 1)
    _, idx = eng.search(qs, 10, param=zvec_tpu_torch.IVFQueryParam(nprobe=8))
    assert eng._lists_codes.shape[-1] == 16 and eng._int4_packed
    assert _recall(idx, _oracle(xs, qs, 10)) >= 0.5
    small = rng.standard_normal((200, 8)).astype(np.float32)
    eng = _torch_engine(16, d=8)
    eng.bind_data(lambda: small, lambda: 1)
    _, idx = eng.search(qs[:3, :8], 5, param=zvec_tpu_torch.IVFQueryParam(nprobe=1))
    assert (np.sort(idx, 1) == np.sort(_oracle(small, qs[:3, :8], 5), 1)).all()


def test_ivf_skewed_cluster_warns_and_stays_exact(caplog):
    X, Q, _ = _engine_data("skewed")
    eng = _torch_engine(64, d=D_ENG, n_iters=5)
    eng.bind_data(lambda: X, lambda: 1)
    with caplog.at_level(logging.WARNING, logger="zvec_tpu_torch"):
        eng._ensure_fresh()
    assert eng._extra_probes > 8 and "worst list splits" in caplog.text
    assert eng._lists_ids.numel() < 3.5 * len(X)
    _, idx = eng.search(Q[:1], 10, param=zvec_tpu_torch.IVFQueryParam(nprobe=8))
    assert len(set(idx[0]) & set(_oracle(X, Q[:1], 10)[0])) >= 8


def test_ivf_max_scan_count_engine():
    rng = np.random.default_rng(42)
    n = 4000
    xs = rng.standard_normal((n, 16)).astype(np.float32)
    qs = rng.standard_normal((16, 16)).astype(np.float32)
    eng = _torch_engine(64, d=16)
    eng.bind_data(lambda: xs, lambda: 1)
    P = zvec_tpu_torch.IVFQueryParam
    _, full = eng.search(qs, 10, param=P(nprobe=64))
    _, same = eng.search(qs, 10, param=P(nprobe=64, max_scan_count=n))
    assert np.array_equal(full, same)
    _, cut = eng.search(qs, 10, param=P(nprobe=64, max_scan_count=1))  # floored at 1000 rows
    assert (cut >= 0).any()
    expect = _oracle(xs, qs, 10)
    assert _recall(cut, expect) < _recall(full, expect) - 0.05
    _, cut_r = eng.search(qs, 10, param=P(nprobe=64, max_scan_ratio=0.0001))
    assert np.array_equal(cut, cut_r)


def test_ivf_max_scan_param_validation():
    with pytest.raises(ValueError):
        zvec_tpu_torch.IVFQueryParam(max_scan_count=-1)
    with pytest.raises(ValueError):
        zvec_tpu_torch.IVFQueryParam(max_scan_ratio=1.5)


def test_ivf_quantized_with_filter_through_collection(tmp_path):
    """IVF int8 + a filter over two segments, then flush and reopen."""
    p = zvec_tpu_torch
    d = 16
    schema = p.CollectionSchema(
        "ivf",
        fields=[p.FieldSchema("grp", p.DataType.INT64)],
        vectors=[p.VectorSchema("e", p.DataType.VECTOR_FP32, d,
                                p.IVFIndexParam(p.MetricType.L2, n_list=32,
                                                quantize_type=p.QuantizeType.INT8))],
        max_doc_count_per_segment=2000,
    )
    c = p.create_and_open(str(tmp_path / "ivf"), schema)
    xs = np.random.default_rng(42).standard_normal((2100, d)).astype(np.float32)
    for s in range(0, 2100, 700):
        c.insert([p.Doc(id=f"v{i}", vectors={"e": xs[i]}, fields={"grp": i % 4})
                  for i in range(s, min(s + 700, 2100))])
    assert "e" in c._impl.segments[0].meta.indexes
    hits = 0
    allowed = np.array([i for i in range(2100) if i % 4 == 1])
    for qi in range(8):
        res = c.query(p.VectorQuery("e", vector=xs[qi], param=p.IVFQueryParam(nprobe=12)),
                      topk=5, filter="grp = 1")
        dmat = ((xs[qi][None] - xs[allowed]) ** 2).sum(1)
        hits += len({r.id for r in res} & {f"v{allowed[j]}" for j in np.argsort(dmat)[:5]})
        assert all(int(r.id[1:]) % 4 == 1 for r in res)
    assert hits / 40 >= 0.5
    c.flush()
    c._impl.close()
    c2 = p.open(str(tmp_path / "ivf"))
    res = c2.query(p.VectorQuery("e", vector=xs[3], param=p.IVFQueryParam(nprobe=32)), topk=3)
    assert res[0].id == "v3"
    c2._impl.close()


def test_ivf_filtered_cross_cluster_safety_net(tmp_path):
    """The filter excludes every probed list's cluster: the deficient-query
    rescan over all lists returns the exact filtered top-k."""
    p = zvec_tpu_torch
    n, d, k = 6000, 24, 5
    rng = np.random.default_rng(42)
    centers = rng.standard_normal((4, d)).astype(np.float32) * 6
    asn = np.arange(n) % 4
    X = (centers[asn] + rng.standard_normal((n, d))).astype(np.float32)
    schema = p.CollectionSchema(
        "col_iv", fields=[p.FieldSchema("g", p.DataType.INT32)],
        vectors=[p.VectorSchema("v", p.DataType.VECTOR_FP32, d, p.IVFIndexParam(p.MetricType.L2))],
    )
    col = p.create_and_open(str(tmp_path / "col"), schema)
    for lo in range(0, n, 1000):
        col.insert([p.Doc(id=str(i), fields={"g": int(asn[i])}, vectors={"v": X[i]})
                    for i in range(lo, lo + 1000)])
    col.flush()
    col.optimize()
    q = (centers[0] + 0.3 * rng.standard_normal(d)).astype(np.float32)
    hits = col.query(p.VectorQuery("v", vector=q, param=p.IVFQueryParam(nprobe=8)),
                     topk=k, filter="g = 1", output_fields=["g"])
    ok = np.flatnonzero(asn == 1)
    d2 = ((X[ok] - q) ** 2).sum(1)
    assert {h.id for h in hits} == {str(i) for i in ok[np.argsort(d2)[:k]]}
    assert all(h.fields["g"] == 1 for h in hits)
    col._impl.close()
