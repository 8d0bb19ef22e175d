"""HNSW build parity: zvec_tpu_torch's graph build against zvec_tpu's.

Unit parity of the prune pieces (identical ids), the host-layer build
(n <= 8,192: the adjacency equals zvec_tpu's exactly), and the device-branch
build (n = 12,000, so layer 0 runs `knn_build_step` with the flat scan's
plain version on the CPU): at least 99% of L0 rows identical, the same
levels and entry point, and recall@10 within 0.01 of zvec_tpu's at each ef.
Float32 sums in another order may flip a dominance test that sits within
an ulp, which is why the device branch is held to 99% of rows.
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
from zvec_tpu.core import hnsw as jcore  # noqa: E402
from zvec_tpu.ops import hnsw as jops  # noqa: E402
from zvec_tpu_torch.core import hnsw as tcore  # noqa: E402
from zvec_tpu_torch.ops import hnsw as tops  # noqa: E402
from zvec_tpu_torch.ops.runtime import NEG_INF  # noqa: E402

DIM = 16


def _naive_keep(pair, sims, valid, max_out):
    b, c = sims.shape
    want = np.zeros((b, c), bool)
    for bi in range(b):
        kept = []
        for i in range(c):
            if not valid[bi, i] or len(kept) >= max_out:
                continue
            if all(pair[bi, i, j] < sims[bi, i] for j in kept):
                want[bi, i] = True
                kept.append(i)
    return want


@pytest.mark.parametrize(
    "c,max_out,chunk", [(37, 8, 16), (16, 4, 16), (5, 3, 16), (200, 50, 16), (48, 8, 7)]
)
def test_prune_keep_matches_jax_and_naive(c, max_out, chunk):
    rng = np.random.default_rng(42)
    b = 9
    pair = rng.normal(size=(b, c, c)).astype(np.float32)
    pair = (pair + pair.transpose(0, 2, 1)) / 2
    sims = -np.sort(-rng.normal(size=(b, c)).astype(np.float32), axis=1)
    valid = rng.random((b, c)) > 0.2
    sims[~valid] = NEG_INF
    pair[0, 3, 1] = pair[0, 1, 3] = sims[0, 3]  # exact tie pins the >= rule
    got = tops._prune_keep(
        torch.from_numpy(pair), torch.from_numpy(sims), torch.from_numpy(valid),
        max_out, chunk=chunk,
    ).numpy()
    ref = np.asarray(
        jops._prune_keep(jnp.asarray(pair), jnp.asarray(sims), jnp.asarray(valid),
                         max_out, chunk=chunk)
    )
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _naive_keep(pair, sims, valid, max_out))


def _codes(n, metric, seed=7):
    X = np.random.default_rng(seed).standard_normal((n, DIM)).astype(np.float32)
    return X, (X**2).sum(1).astype(np.float32)


def _scored_candidates(X, norms2, rows, c, metric):
    """Top-c candidates per row (self included), desc by similarity."""
    from zvec_tpu_torch.ops.distance import similarity_matrix

    sims = similarity_matrix(
        torch.from_numpy(X[rows]), torch.from_numpy(X), metric, torch.from_numpy(norms2)
    ).numpy()
    order = np.argsort(-sims, axis=1, kind="stable")[:, :c]
    ids = order.astype(np.int32)
    ids[:, -3:] = -1  # padding slots
    s = np.take_along_axis(sims, order, 1).astype(np.float32)
    s[:, -3:] = NEG_INF
    return ids, s


PRUNE_CASES = [
    ("L2", 1.0, 0.0),
    ("IP", 1.0, 0.0),
    ("COSINE", 1.0, 0.0),
    ("L2", 1.2, 0.0),
    ("COSINE", 1.0, 1.1),
    ("L2", 1.0, 1.2),
]


@pytest.mark.parametrize("metric,alpha,backfill", PRUNE_CASES)
def test_prune_scored_matches_jax(metric, alpha, backfill):
    X, norms2 = _codes(600, metric)
    rows = np.arange(0, 600, 17, dtype=np.int32)
    mt = zvec_tpu_torch.MetricType[metric]
    ids, sims = _scored_candidates(X, norms2, rows, 48, mt)
    kw = dict(max_out=12, alpha=alpha, backfill_alpha=backfill)
    got = tops.prune_scored(
        torch.from_numpy(rows).long(), torch.from_numpy(ids).long(), torch.from_numpy(sims),
        torch.from_numpy(X), torch.from_numpy(norms2), metric=mt, **kw,
    ).numpy()
    ref = np.asarray(jops.prune_scored(
        jnp.asarray(rows), jnp.asarray(ids), jnp.asarray(sims), jnp.asarray(X),
        jnp.asarray(norms2), metric=zvec_tpu.MetricType[metric], **kw,
    ))
    np.testing.assert_array_equal(got, ref)
    assert not (got == rows[:, None]).any()  # self-matches are dropped


@pytest.mark.parametrize("metric,alpha,backfill", PRUNE_CASES)
def test_merge_prune_step_matches_jax(metric, alpha, backfill):
    n = 600
    X, norms2 = _codes(n, metric, seed=8)
    rng = np.random.default_rng(9)
    rows = np.arange(5, n, 13, dtype=np.int32)
    cand = rng.integers(-1, n, (len(rows), 40)).astype(np.int32)
    cand[:, 20:25] = cand[:, 0:5]  # mutual fwd/rev edges repeat ids
    cand[:, 30] = rows  # self
    kw = dict(max_out=10, alpha=alpha, backfill_alpha=backfill)
    adj = torch.full((n, 10), -1, dtype=torch.int32)
    tops.merge_prune_step(
        torch.from_numpy(rows).long(), torch.from_numpy(cand), torch.from_numpy(X),
        torch.from_numpy(norms2), adj, metric=zvec_tpu_torch.MetricType[metric], **kw,
    )
    ref = np.asarray(jops.merge_prune_step(
        jnp.asarray(rows), jnp.asarray(cand), jnp.asarray(X), jnp.asarray(norms2),
        jnp.full((n, 10), -1, jnp.int32), metric=zvec_tpu.MetricType[metric], **kw,
    ))
    np.testing.assert_array_equal(adj.numpy(), ref)
    got = adj.numpy()[rows]
    for r in got:  # no repeated id survives
        r = r[r >= 0]
        assert len(r) == len(set(r.tolist()))


def test_knn_build_step_scan_routes_agree():
    """The fused flat scan (plain on the CPU) and the blockwise scan give the
    same pruned rows, and a CPU run launches no kernel."""
    from zvec_tpu_torch.ops.flat_scan import flat_scan_topk

    n, knn_k, max_out = 4096, 31, 16
    X, norms2 = _codes(n, "L2", seed=10)
    mask = torch.ones(n, dtype=torch.int8)
    rows = torch.arange(0, 512)
    outs = []
    before = flat_scan_topk.launches
    for use_kernel in (True, False):
        adj = torch.full((n, max_out), -1, dtype=torch.int32)
        tops.knn_build_step(
            rows, torch.from_numpy(X), torch.from_numpy(norms2), mask, adj,
            metric=zvec_tpu_torch.MetricType.L2, knn_k=knn_k, max_out=max_out,
            use_kernel=use_kernel,
        )
        outs.append(adj[:512].numpy())
    assert flat_scan_topk.launches == before
    np.testing.assert_array_equal(outs[0], outs[1])
    assert (outs[0] >= 0).all()


def test_reverse_candidates_match_jax():
    rng = np.random.default_rng(11)
    for n, m, cap in ((500, 12, 8), (200, 6, 16), (64, 4, 4)):
        adj = rng.integers(0, n, (n, m)).astype(np.int32)
        adj[rng.random((n, m)) < 0.15] = -1
        got = tcore._reverse_candidates(adj, cap)
        np.testing.assert_array_equal(got, jcore._reverse_candidates(adj, cap))
        np.testing.assert_array_equal(got, tcore._reverse_candidates_argsort(adj, cap))
    empty = np.full((32, 5), -1, np.int32)
    np.testing.assert_array_equal(tcore._reverse_candidates(empty, 4), np.full((32, 4), -1, np.int32))


def _build_pair(metric, n, seed, **kw):
    X = np.random.default_rng(seed).standard_normal((n, DIM)).astype(np.float32)
    out = []
    for pkg, mod in ((zvec_tpu, jcore), (zvec_tpu_torch, tcore)):
        eng = mod.HnswEngine(
            pkg.MetricType[metric], DIM,
            pkg.HnswIndexParam(pkg.MetricType[metric], m=8, ef_construction=60, **kw),
        )
        eng.bind_data(lambda: X, lambda: 1)
        eng._ensure_fresh()
        out.append(eng)
    return X, out


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_host_layer_build_is_exact(metric):
    _, (je, te) = _build_pair(metric, 2500, 12)
    jg, tg = je._graph, te._graph
    np.testing.assert_array_equal(tg.levels, jg.levels)
    assert tg.entry_point == jg.entry_point
    np.testing.assert_array_equal(tg.l0, jg.l0)
    assert len(tg.upper_nbrs) == len(jg.upper_nbrs) > 0
    for a, b in zip(tg.upper_nbrs, jg.upper_nbrs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_device_branch_build_matches_jax(metric):
    X, (je, te) = _build_pair(metric, 12000, 13)
    jg, tg = je._graph, te._graph
    np.testing.assert_array_equal(tg.levels, jg.levels)
    assert tg.entry_point == jg.entry_point
    same_rows = (tg.l0 == jg.l0).all(axis=1).mean()
    assert same_rows >= 0.99, same_rows
    assert set(te.build_times) == {"forward_knn", "reverse", "merge", "upper_levels"}

    Qs = np.random.default_rng(14).standard_normal((60, DIM)).astype(np.float32)
    from zvec_tpu_torch.ops.distance import similarity_matrix

    sims = similarity_matrix(
        torch.from_numpy(Qs), torch.from_numpy(X), zvec_tpu_torch.MetricType[metric]
    ).numpy()
    gt = np.argsort(-sims, axis=1, kind="stable")[:, :10]

    def recall(idx):
        return np.mean([len(set(idx[i]) & set(gt[i])) / 10 for i in range(len(Qs))])

    for ef in (32, 64, 128):
        _, ji = je.search(Qs, 10, param=zvec_tpu.HnswQueryParam(ef=ef))
        _, ti = te.search(Qs, 10, param=zvec_tpu_torch.HnswQueryParam(ef=ef))
        assert abs(recall(ti) - recall(ji)) <= 0.01, (ef, recall(ti), recall(ji))
        assert recall(ti) >= 0.85


def test_clustered_build_option_is_admitted():
    """`clustered_build=True` builds (tests/test_torch_hnsw_clustered.py holds
    the build to zvec_tpu's); below 4,096 rows it is the host build."""
    X = np.random.default_rng(15).standard_normal((300, DIM)).astype(np.float32)
    out = []
    for kw in ({"clustered_build": True}, {}):
        _, (_, te) = _build_pair("L2", 300, 15, **kw)
        out.append(te)
        assert te.build_info == {} and "bucket_knn" not in te.build_times
        _, idx = te.search(X[:3], 1)
        assert idx[:, 0].tolist() == [0, 1, 2]
    np.testing.assert_array_equal(out[0]._graph.l0, out[1]._graph.l0)


@pytest.mark.parametrize(
    "kw,knob",
    [
        ({"route_quantize": "int8"}, "route_quantize"),
        ({"route_quantize": "bf16"}, "route_quantize"),
    ],
)
def test_unported_build_options_raise(kw, knob):
    """Once refused by the port, an explicit route tier now builds and routes
    as in zvec_tpu: the same graph, the same route codes, the same answers
    (tests/test_torch_route.py holds it to zvec_tpu at length)."""
    X = np.random.default_rng(15).standard_normal((300, DIM)).astype(np.float32)
    out = []
    for pkg, core in ((zvec_tpu, jcore), (zvec_tpu_torch, tcore)):
        eng = core.HnswEngine(pkg.MetricType.L2, DIM, pkg.HnswIndexParam(
            pkg.MetricType.L2, m=8, ef_construction=40, brute_force_threshold=1, **kw))
        eng.bind_data(lambda: X, lambda: 1)
        assert getattr(eng, knob) == kw[knob]
        out.append((eng, eng.search(X[:8], 5, param=pkg.HnswQueryParam(ef=16, done_frac=1.0))))
    (je, (js, ji)), (te, (ts, ti)) = out
    np.testing.assert_array_equal(te._graph.l0, je._graph.l0)
    codes = te._route[0]
    codes = codes.view(torch.int16) if codes.dtype == torch.bfloat16 else codes
    jc = np.asarray(je._route[0])
    np.testing.assert_array_equal(codes.numpy(), jc.view(np.int16) if jc.dtype.itemsize == 2 else jc)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)
    assert ti[:, 0].tolist() == list(range(8))


def test_route_quantize_ignored_on_quantized_index():
    """As in zvec_tpu, routing only applies to fp32 indexes."""
    X = np.random.default_rng(16).standard_normal((300, DIM)).astype(np.float32)
    p = zvec_tpu_torch
    eng = tcore.HnswEngine(
        p.MetricType.L2, DIM,
        p.HnswIndexParam(p.MetricType.L2, m=8, ef_construction=40,
                         quantize_type=p.QuantizeType.INT8, route_quantize="int8"),
    )
    eng.bind_data(lambda: X, lambda: 1)
    _, idx = eng.search(X[:3], 1)
    assert idx[:, 0].tolist() == [0, 1, 2]
