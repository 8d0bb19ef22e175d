"""The clustered HNSW build: zvec_tpu_torch against zvec_tpu on the CPU.

The same numpy inputs, made from a seed, go through each JAX function (on the
CPU test mesh, where `approx_max_k` is exact) and its counterpart in the
port. Tolerances:

- `_exact_dots`: int8 x int8 equal; bf16 x bf16 within 1e-6 of the sum of
  |a_i b_i| (exact products, float32 sums in another order); f32 x bf16 within
  1e-5 of that sum (zvec_tpu splits the f32 side into bf16 hi + lo halves,
  the port multiplies in full float32).
- `assign_top2_blocked` on bf16 / int8 rows: the same two centroids on at
  least 99.5% of rows; on every row the chosen centroids' distances (float64
  oracle) agree within 1e-5 relative, so only near-ties may swap.
- `bucket_knn_all`: the candidate table is unsorted by contract, so each
  half-row is compared as an id set: equal on at least 99% of half-rows, and
  on every half-row the sorted similarities of the chosen ids (float64
  oracle) agree within 1e-5 relative (near-ties at the top-kc boundary).
- `merge_prune_batch_out`, `merge_prune_chunk_out`, `nn_descent_round`:
  identical ids.
- `_clustered_candidates` with one shared set of centroids: the bucket_knn
  rule above over the whole table.
- the forced build (`clustered_build=True`, n = 6,000, d = 32, each package
  training its own k-means): the same levels, L0 rows identical on at least
  99% of nodes with fp32 codes; recall@10 >= 0.9 at ef = 80 for the fp32,
  bf16 and int8-cosine builds (the floor of zvec_tpu's own tests).
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
from zvec_tpu_torch.ops.flat_scan import flat_scan_topk  # noqa: E402

N, D = 6000, 32
METRICS = ["L2", "IP", "COSINE"]


def _clustered_data(n=N, d=D, nq=40, seed=42):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((30, d)).astype(np.float32) * 4
    x = (centers[rng.integers(0, 30, n)] + rng.standard_normal((n, d))).astype(np.float32)
    q = (centers[rng.integers(0, 30, nq)] + rng.standard_normal((nq, d))).astype(np.float32)
    return x, q


def _as_codes(x, kind):
    """(torch codes, jax codes, float32 numpy values of the codes)."""
    if kind == "fp32":
        return torch.from_numpy(x), jnp.asarray(x), x
    if kind == "bf16":
        t = torch.from_numpy(x).bfloat16()
        vals = t.float().numpy()
        return t, jnp.asarray(vals).astype(jnp.bfloat16), vals
    c = np.clip(np.rint(x * (127.0 / np.abs(x).max())), -127, 127).astype(np.int8)
    return torch.from_numpy(c), jnp.asarray(c), c.astype(np.float32)


def _oracle_sims(a, b, metric):
    """float64 similarity of rows a (.., D) to rows b (.., D), broadcast."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    dots = (a * b).sum(-1)
    if metric == "IP":
        return dots
    if metric == "L2":
        return -((a - b) ** 2).sum(-1)
    den = np.sqrt((a * a).sum(-1)) * np.sqrt((b * b).sum(-1))
    return np.where(den > 0, dots / np.where(den > 0, den, 1.0), 1.0)


# ---------------------------------------------------------------- _exact_dots
@pytest.mark.parametrize("subs", ["bd,bcd->bc", "md,nd->mn", "bcd,bed->bce"])
@pytest.mark.parametrize("kinds", [("bf16", "bf16"), ("int8", "int8"), ("fp32", "bf16"), ("bf16", "fp32")])
def test_exact_dots_matches_jax(subs, kinds):
    rng = np.random.default_rng(1)
    shapes = {"bd": (7, D), "bcd": (7, 9, D), "md": (11, D), "nd": (13, D), "bed": (7, 9, D)}
    ins = subs.split("->")[0].split(",")
    a = rng.standard_normal(shapes[ins[0]]).astype(np.float32)
    b = rng.standard_normal(shapes[ins[1]]).astype(np.float32)
    (ta, ja, va), (tb, jb, vb) = _as_codes(a, kinds[0]), _as_codes(b, kinds[1])
    got = tops._exact_dots(subs, ta, tb).numpy()
    ref = np.asarray(jops._exact_dots(subs, ja, jb))
    assert got.dtype == np.float32 and got.shape == ref.shape
    if kinds == ("int8", "int8"):
        np.testing.assert_array_equal(got, ref)
        return
    scale = np.einsum(subs, np.abs(va), np.abs(vb))
    tol = 1e-6 if kinds == ("bf16", "bf16") else 1e-5
    assert (np.abs(got - ref) <= tol * scale).all()


# -------------------------------------------------------- assign_top2_blocked
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_assign_top2_on_reduced_rows_matches_jax(kind):
    rng = np.random.default_rng(2)
    n, k = 3000, 37
    x, _ = _clustered_data(n, seed=3)
    tc, jc, vals = _as_codes(x, kind)
    cents = vals[rng.choice(n, k, replace=False)] + 0.1 * rng.standard_normal((k, D)).astype(np.float32)
    got = tops.assign_top2_blocked(tc, torch.from_numpy(cents), block=1024).numpy()
    ref = np.asarray(jops.assign_top2_blocked(jc, jnp.asarray(cents), block=1024))
    assert got.shape == ref.shape == (n, 2) and got.dtype == np.int32
    assert (got == ref).all(axis=1).mean() >= 0.995
    d2 = ((vals[:, None, :].astype(np.float64) - cents[None].astype(np.float64)) ** 2).sum(-1)
    dg, dr = np.take_along_axis(d2, got.astype(np.int64), 1), np.take_along_axis(d2, ref.astype(np.int64), 1)
    assert (np.abs(dg - dr) <= 1e-5 * np.abs(dr)).all()
    assert (got[:, 0] != got[:, 1]).all()


# ------------------------------------------------------------- bucket_knn_all
def _buckets(n, nb, mp, prim, spill, rng):
    """nb buckets of mp slots: `prim` primary members, `spill` spill members
    (primary members of the next bucket), the rest pads; a row is in one
    bucket at most once."""
    perm = rng.permutation(n)[: nb * prim].reshape(nb, prim)
    rows = np.full((nb, mp), -1, np.int32)
    slot = np.zeros((nb, mp), np.int32)
    for b in range(nb):
        rows[b, :prim] = perm[b]
        rows[b, prim : prim + spill] = perm[(b + 1) % nb][:spill]
        slot[b, prim : prim + spill] = 1
        order = rng.permutation(prim + spill)  # primary and spill members interleave
        rows[b, : prim + spill] = rows[b, order]
        slot[b, : prim + spill] = slot[b, order]
    return rows, slot


def _assert_tables_agree(got, ref, vals, metric, kc):
    """Half-rows as id sets (see the module docstring)."""
    n = got.shape[0]
    same = 0
    for half in (0, 1):
        g, r = got[:, half * kc : (half + 1) * kc], ref[:, half * kc : (half + 1) * kc]
        assert ((g >= 0).sum(1) == (r >= 0).sum(1)).all()
        gs, rs = np.sort(g, axis=1), np.sort(r, axis=1)
        eq = (gs == rs).all(axis=1)
        same += int(eq.sum())
        for i in np.flatnonzero(~eq):
            ok = g[i] >= 0
            sg = np.sort(_oracle_sims(vals[i], vals[g[i][ok]], metric))
            sr = np.sort(_oracle_sims(vals[i], vals[r[i][r[i] >= 0]], metric))
            assert np.allclose(sg, sr, rtol=1e-5, atol=1e-5), i
    assert same >= 0.99 * 2 * n, same / (2 * n)


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("metric", METRICS)
def test_bucket_knn_all_matches_jax(metric, kind):
    rng = np.random.default_rng(4)
    n, kc, mp = 700, 32, 256
    x, _ = _clustered_data(n, seed=5)
    rows, slot = _buckets(n, 4, mp, 150, 80, rng)
    x[rows[0, 3]] = 0.0  # a zero-norm member (the COSINE rule scores it 1.0)
    tc, jc, vals = _as_codes(x, kind)
    norms2 = (vals * vals).sum(1).astype(np.float32)
    cand = torch.full((n + 1, 2 * kc), -1, dtype=torch.int32)
    out = tops.bucket_knn_all(
        torch.from_numpy(rows), torch.from_numpy(slot), cand, tc, torch.from_numpy(norms2),
        metric=zvec_tpu_torch.MetricType[metric], kc=kc,
    )
    assert out is cand  # updated in place
    ref = np.asarray(jops.bucket_knn_all(
        jnp.asarray(rows), jnp.asarray(slot), jnp.full((n + 1, 2 * kc), -1, jnp.int32),
        jc, jnp.asarray(norms2), metric=zvec_tpu.MetricType[metric], kc=kc,
    ))
    got = cand.numpy()
    _assert_tables_agree(got[:n], ref[:n], vals, metric, kc)
    in_primary = np.zeros(n, bool)
    in_primary[rows[slot == 0][rows[slot == 0] >= 0]] = True
    assert (got[:n][~in_primary, :kc] == -1).all()  # rows in no bucket stay empty
    assert (got[:n][in_primary, :kc] >= 0).all()
    member = got[:n][rows[0, 0]]
    assert rows[0, 0] not in member.tolist()  # no self-match


# ---------------------------------------------------- the three prune callers
PRUNE_KW = [
    ("L2", 1.0, 0.0),
    ("IP", 1.0, 0.0),
    ("COSINE", 1.0, 0.0),
    ("L2", 1.2, 1.1),
]


def _prune_inputs(seed, n=900, c=48):
    x, _ = _clustered_data(n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    cand = rng.integers(-1, n, (n + 1, c)).astype(np.int32)
    cand[:, 20:24] = cand[:, 0:4]  # repeated ids
    cand[:n, 30] = np.arange(n)  # self
    cand[n] = -1
    rows_mat = np.arange(3 * 128, dtype=np.int32).reshape(3, 128)
    rows_mat[2, -5:] = rows_mat[2, -6]  # a padded tail repeats a row
    return x, (x * x).sum(1).astype(np.float32), cand, rows_mat


def _kw(pkg, metric, alpha, backfill, max_out):
    return dict(metric=pkg.MetricType[metric], max_out=max_out, alpha=alpha, backfill_alpha=backfill)


@pytest.mark.parametrize("metric,alpha,backfill", PRUNE_KW)
def test_merge_prune_batch_out_matches_jax(metric, alpha, backfill):
    x, norms2, cand, rows_mat = _prune_inputs(6)
    got = tops.merge_prune_batch_out(
        torch.from_numpy(rows_mat).long(), torch.from_numpy(cand), torch.from_numpy(x),
        torch.from_numpy(norms2), **_kw(zvec_tpu_torch, metric, alpha, backfill, 12),
    )
    ref = np.asarray(jops.merge_prune_batch_out(
        jnp.asarray(rows_mat), jnp.asarray(cand), jnp.asarray(x), jnp.asarray(norms2),
        **_kw(zvec_tpu, metric, alpha, backfill, 12),
    ))
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 128, 12)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("metric,alpha,backfill", PRUNE_KW)
def test_merge_prune_chunk_out_matches_jax(metric, alpha, backfill):
    x, norms2, cand, rows_mat = _prune_inputs(7)
    cand_mat = cand[rows_mat]
    got = tops.merge_prune_chunk_out(
        torch.from_numpy(rows_mat).long(), torch.from_numpy(cand_mat), torch.from_numpy(x),
        torch.from_numpy(norms2), **_kw(zvec_tpu_torch, metric, alpha, backfill, 12),
    )
    ref = np.asarray(jops.merge_prune_chunk_out(
        jnp.asarray(rows_mat), jnp.asarray(cand_mat), jnp.asarray(x), jnp.asarray(norms2),
        **_kw(zvec_tpu, metric, alpha, backfill, 12),
    ))
    np.testing.assert_array_equal(got.numpy(), ref)
    # the same body as merge_prune_step
    adj = torch.full((900, 12), -1, dtype=torch.int32)
    tops.merge_prune_step(
        torch.from_numpy(rows_mat[0]).long(), torch.from_numpy(cand_mat[0]), torch.from_numpy(x),
        torch.from_numpy(norms2), adj, **_kw(zvec_tpu_torch, metric, alpha, backfill, 12),
    )
    np.testing.assert_array_equal(adj[rows_mat[0]].numpy(), got[0].numpy())


@pytest.mark.parametrize("expand", [1, 2, 4])
@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_nn_descent_round_matches_jax(metric, expand):
    x, norms2, cand, rows_mat = _prune_inputs(8)
    n, m0 = 900, 16
    # a first graph to refine: the forward prune of random candidates
    fwd = np.full((n + 1, m0), -1, np.int32)
    all_rows = np.arange(n + 124, dtype=np.int32).clip(max=n - 1).reshape(8, 128)
    fwd[all_rows.reshape(-1)] = tops.merge_prune_batch_out(
        torch.from_numpy(all_rows).long(), torch.from_numpy(cand), torch.from_numpy(x),
        torch.from_numpy(norms2), **_kw(zvec_tpu_torch, metric, 1.0, 0.0, m0),
    ).numpy().reshape(-1, m0)
    fwd[::7, -3:] = -1  # short rows expand to the dump row
    got = tops.nn_descent_round(
        torch.from_numpy(rows_mat).long(), torch.from_numpy(fwd), torch.from_numpy(x),
        torch.from_numpy(norms2), expand=expand, **_kw(zvec_tpu_torch, metric, 1.0, 0.0, m0),
    )
    ref = np.asarray(jops.nn_descent_round(
        jnp.asarray(rows_mat), jnp.asarray(fwd), jnp.asarray(x), jnp.asarray(norms2),
        expand=expand, **_kw(zvec_tpu, metric, 1.0, 0.0, m0),
    ))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not (got.numpy() == rows_mat[:, :, None]).any()


def test_prune_callers_keep_reduced_codes_exact():
    """bf16 and int8 codes go through the shared prune body in their own
    dtype and give what their float32 values give."""
    x, _, cand, rows_mat = _prune_inputs(9)
    for kind in ("bf16", "int8"):
        tc, _, vals = _as_codes(x, kind)
        norms2 = torch.from_numpy((vals * vals).sum(1).astype(np.float32))
        kw = _kw(zvec_tpu_torch, "L2", 1.0, 0.0, 12)
        a = tops.merge_prune_batch_out(torch.from_numpy(rows_mat).long(), torch.from_numpy(cand), tc, norms2, **kw)
        b = tops.merge_prune_batch_out(
            torch.from_numpy(rows_mat).long(), torch.from_numpy(cand), torch.from_numpy(vals), norms2, **kw
        )
        assert torch.equal(a, b)


# ------------------------------------------------------ _clustered_candidates
def _engine(pkg, mod, metric, x, m=16, efc=200, **kw):
    eng = mod.HnswEngine(
        pkg.MetricType[metric], x.shape[1],
        pkg.HnswIndexParam(pkg.MetricType[metric], m=m, ef_construction=efc, **kw),
    )
    eng.bind_data(lambda: x, lambda: 1)
    return eng


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_clustered_candidates_with_shared_centroids(metric, monkeypatch):
    x, _ = _clustered_data()
    norms2 = (x * x).sum(1).astype(np.float32)
    n, kc = N, 32
    k = max(64, n // 1250)
    # the same centroids for both: the port's k-means on the shared draws
    rng = np.random.default_rng(0xC111)
    sub = x[rng.choice(n, n, replace=False)]
    seeds = x[rng.choice(n, k, replace=False)]
    from zvec_tpu_torch.ops.kmeans import lloyd

    cents = lloyd(torch.from_numpy(sub), torch.from_numpy(seeds), iters=6, block=n)[0].numpy()
    seen = {}

    def jax_lloyd(data, seed_rows, iters, block):
        seen["jax"] = (np.asarray(data), np.asarray(seed_rows), iters, block)
        return jnp.asarray(cents), None

    def torch_lloyd(data, seed_rows, iters, block):
        seen["torch"] = (data.numpy(), seed_rows.numpy(), iters, block)
        return torch.from_numpy(cents), None

    monkeypatch.setattr("zvec_tpu.ops.kmeans.lloyd", jax_lloyd)
    monkeypatch.setattr(tcore, "lloyd", torch_lloyd)
    je = _engine(zvec_tpu, jcore, metric, x)
    te = _engine(zvec_tpu_torch, tcore, metric, x)
    ref = np.asarray(je._clustered_candidates(x, jnp.asarray(x), jnp.asarray(norms2), n, kc=kc))
    times, info = {}, {}
    got = te._clustered_candidates(
        x, torch.from_numpy(x), torch.from_numpy(norms2), n, kc=kc, times=times, info=info
    ).numpy()
    # the draws are the same, draw for draw
    for a, b in zip(seen["jax"], seen["torch"]):
        np.testing.assert_array_equal(a, b)
    assert seen["torch"][2:] == (6, n)
    assert got.shape == ref.shape == (n + 1, 2 * kc) and got.dtype == np.int32
    _assert_tables_agree(got[:n], ref[:n], x, metric, kc)
    assert set(times) == {"kmeans", "assign_top2", "bucket_pack", "bucket_knn"}
    assert info["K"] == k and info["kc"] == kc and info["mp"] % 128 == 0 and info["dropped"] >= 0


# ------------------------------------------------------------ the whole build
def _recall(eng, pkg, x, q, metric, ef=80):
    _, idx = eng.search(q, 10, param=pkg.HnswQueryParam(ef=ef))
    sims = _oracle_sims(q[:, None, :], x[None, :, :], metric)
    gt = np.argsort(-sims, axis=1, kind="stable")[:, :10]
    return np.mean([len(set(idx[i].tolist()) & set(gt[i].tolist())) / 10 for i in range(len(q))])


CLUSTERED_PHASES = {
    "kmeans", "assign_top2", "bucket_pack", "bucket_knn", "forward_prune",
    "nn_descent", "reverse", "merge", "upper_levels",
}


def test_forced_clustered_build_matches_jax():
    x, q = _clustered_data()
    je = _engine(zvec_tpu, jcore, "L2", x, clustered_build=True)
    te = _engine(zvec_tpu_torch, tcore, "L2", x, clustered_build=True)
    launches = flat_scan_topk.launches
    rj, rt = _recall(je, zvec_tpu, x, q, "L2"), _recall(te, zvec_tpu_torch, x, q, "L2")
    jg, tg = je._graph, te._graph
    np.testing.assert_array_equal(tg.levels, jg.levels)
    assert tg.entry_point == jg.entry_point
    assert (tg.l0 == jg.l0).all(axis=1).mean() >= 0.99
    for a, b in zip(tg.upper_nbrs, jg.upper_nbrs):  # host layers: exact
        np.testing.assert_array_equal(a, b)
    assert rt >= 0.9 and abs(rt - rj) <= 0.01, (rt, rj)
    assert set(te.build_times) == CLUSTERED_PHASES
    assert te.build_info["clustered"] is True and te.build_info["codes"] == "float32"
    assert flat_scan_topk.launches == launches  # the clustered path runs no flat scan


@pytest.mark.parametrize(
    "codes,metric,quantize", [("bf16", "L2", None), ("bf16", "COSINE", None), ("int8", "COSINE", "INT8"), ("int8", "L2", None)]
)
def test_forced_build_codes_recall(codes, metric, quantize):
    x, q = _clustered_data()
    kw = {"quantize_type": zvec_tpu_torch.QuantizeType[quantize]} if quantize else {}
    te = _engine(zvec_tpu_torch, tcore, metric, x, clustered_build=True, **kw)
    te._build_codes = codes
    assert _recall(te, zvec_tpu_torch, x, q, metric) >= 0.9
    assert te.build_info["clustered"] is True
    assert te.build_info["codes"] == {"bf16": "bfloat16", "int8": "int8"}[codes]
    assert set(te.build_times) == CLUSTERED_PHASES
    if quantize:  # search codes are the index's own: symmetric int8 for cosine
        assert te._codes.dtype == torch.int8 and te._dequant[1] == 0.0
    else:
        assert te._codes.dtype == torch.float32


def test_forced_layer_of_4096_to_8192_rows_stays_off_host(monkeypatch):
    x, _ = _clustered_data(5000, seed=11)
    te = _engine(zvec_tpu_torch, tcore, "L2", x, m=8, efc=60, clustered_build=True)
    host_layers = []
    orig = tcore.HnswEngine._knn_layer_host
    monkeypatch.setattr(
        tcore.HnswEngine, "_knn_layer_host",
        lambda self, data, *a, **k: host_layers.append(len(data)) or orig(self, data, *a, **k),
    )
    te._ensure_fresh()
    assert te.build_info["clustered"] is True
    assert host_layers and max(host_layers) < 4096  # upper levels only


@pytest.mark.parametrize("setting", [False, None])
def test_cpu_and_clustered_build_false_take_exact_build(setting):
    """Without a CUDA device the size rule never fires, whatever the size;
    `clustered_build=False` forces the exact build everywhere."""
    x, _ = _clustered_data(9000, seed=12)
    te = _engine(zvec_tpu_torch, tcore, "L2", x, m=8, efc=60, clustered_build=setting)
    te._ensure_fresh()
    assert te.build_info == {"clustered": False, "codes": "float32"}
    assert set(te.build_times) == {"forward_knn", "reverse", "merge", "upper_levels"}


@pytest.mark.parametrize("setting,clustered", [(None, True), (False, False)])
def test_size_rule_with_threshold_patched_small(setting, clustered, monkeypatch):
    """Above the row threshold on a CUDA device the clustered build is taken
    without being asked for, with bf16 build codes; `False` still wins."""
    monkeypatch.setattr(tcore, "_CLUSTERED_AUTO_ROWS", 8500)
    monkeypatch.setattr(tcore, "_on_card", lambda: True)
    x, q = _clustered_data(9000, seed=12)
    te = _engine(zvec_tpu_torch, tcore, "L2", x, m=8, efc=60, clustered_build=setting)
    assert _recall(te, zvec_tpu_torch, x, q, "L2") >= 0.9
    assert te.build_info["clustered"] is clustered
    assert te.build_info["codes"] == ("bfloat16" if clustered else "float32")
    assert ("bucket_knn" in te.build_times) is clustered


def test_size_rule_below_threshold_keeps_exact_build(monkeypatch):
    monkeypatch.setattr(tcore, "_on_card", lambda: True)
    x, _ = _clustered_data(9000, seed=12)
    te = _engine(zvec_tpu_torch, tcore, "L2", x, m=8, efc=60)
    te._ensure_fresh()
    assert te.build_info == {"clustered": False, "codes": "float32"}


def test_int8_build_rule_follows_index_and_size(monkeypatch):
    """An INT8 index whose bf16 codes would pass the byte limit builds on
    symmetric int8 codes; a smaller one on bf16."""
    monkeypatch.setattr(tcore, "_CLUSTERED_AUTO_ROWS", 5000)
    monkeypatch.setattr(tcore, "_on_card", lambda: True)
    n = 9000  # above the host-layer size
    x, q = _clustered_data(n, seed=13)
    for limit, want in ((n * D * 2 - 1, "int8"), (n * D * 2, "bfloat16")):
        monkeypatch.setattr(tcore, "_INT8_BUILD_BYTES", limit)
        te = _engine(zvec_tpu_torch, tcore, "COSINE", x, quantize_type=zvec_tpu_torch.QuantizeType.INT8)
        assert _recall(te, zvec_tpu_torch, x, q, "COSINE") >= 0.9
        assert te.build_info["codes"] == want


def test_hnsw_index_param_has_no_new_field():
    """The build-code override is a private engine attribute, not a parameter."""
    ours = vars(zvec_tpu_torch.HnswIndexParam(zvec_tpu_torch.MetricType.L2))
    theirs = vars(zvec_tpu.HnswIndexParam(zvec_tpu.MetricType.L2))
    assert set(ours) == set(theirs)


def test_smoke_script_keeps_the_benchmark_generator():
    """`chip_smoke.py` carries its own copy of the clustered generator of
    `benchmarks/h2h.py` (the script imports nothing from before the port)."""
    import chip_smoke
    from benchmarks.h2h import make_data

    for n, dim, nq in ((3000, 16, 50), (400_000, 8, 7)):  # 32 centres, then n // 10,000
        x, q = chip_smoke.make_clustered(n, dim, nq)
        rx, rq = make_data("clustered", n, dim, nq=nq)
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(q, rq)
        assert x.dtype == np.float32 and q.shape == (nq, dim)
