"""Parity of the port's fused flat scan with the JAX Pallas kernel.

The same numpy inputs go through `zvec_tpu.ops.flat_pallas.flat_scan_topk`
(Pallas interpret mode on the CPU mesh) and
`zvec_tpu_torch.ops.flat_scan.flat_scan_topk` (CPU tensors, so its plain
stage one). Every case of tests/test_flat_pallas.py is covered, plus fp16
codes against a numpy oracle.

Tolerances: fp32 codes must give the same id set per query and scores within
rtol = atol = 1e-4 (float32 sums in another order). int8 / int4 codes use the
JAX test's own bar, >= K-1 overlap and top-1 score within 1e-3, because the
TPU kernel scores those codes through bf16.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from zvec_tpu.ops.flat_pallas import flat_scan_topk as jax_scan  # noqa: E402
from zvec_tpu.ops.quantize import pack_int4  # noqa: E402
from zvec_tpu.typing import MetricType as JMetric  # noqa: E402
from zvec_tpu_torch.ops import flat_scan as port  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402

N, D, Q, K = 4096, 64, 16, 10
METRICS = ["L2", "IP", "COSINE"]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    X = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((Q, D)).astype(np.float32)
    mask = (rng.random(N) > 0.3).astype(np.int8)
    return X, q, mask


def _norms(X, metric):
    sq = (X.astype(np.float32) ** 2).sum(1)
    if metric == "COSINE":
        return np.sqrt(sq).astype(np.float32)
    if metric == "IP":
        return np.zeros(len(X), np.float32)
    return sq.astype(np.float32)


def _both(q, codes, norms, mask, metric, topk, dequant=None, int4_dim=None):
    js, ji = jax_scan(
        jnp.asarray(q), jnp.asarray(codes), jnp.asarray(norms), jnp.asarray(mask),
        metric=JMetric[metric], topk=topk, dequant=dequant, int4_dim=int4_dim,
    )
    ts, ti = port.flat_scan_topk(
        torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(norms),
        torch.from_numpy(mask), metric=MetricType[metric], topk=topk,
        dequant=dequant, int4_dim=int4_dim,
    )
    return (np.asarray(js), np.asarray(ji)), (ts.numpy(), ti.numpy())


def _assert_same(jax_out, port_out):
    (js, ji), (ts, ti) = jax_out, port_out
    assert ti.dtype == np.int64 and ts.dtype == np.float32
    for r in range(ji.shape[0]):
        assert set(ti[r].tolist()) == set(ji[r].tolist()), r
    assert np.allclose(ts, js, rtol=1e-4, atol=1e-4)


def _assert_close_quantized(jax_out, port_out, k):
    (js, ji), (ts, ti) = jax_out, port_out
    for r in range(ji.shape[0]):
        assert len(set(ti[r].tolist()) & set(ji[r].tolist())) >= k - 1, r
    assert np.allclose(ts[:, 0], js[:, 0], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("metric", METRICS)
def test_exact_topk_all_metrics(data, metric):
    X, q, mask = data
    _assert_same(*_both(q, X, _norms(X, metric), mask, metric, K))


def test_fewer_than_k_survivors(data):
    X, q, _ = data
    mask = np.zeros(N, np.int8)
    mask[:3] = 1
    jax_out, port_out = _both(q, X, _norms(X, "L2"), mask, "L2", K)
    _assert_same(jax_out, port_out)
    ti = port_out[1]
    assert (np.sort(ti[:, :3], 1) == np.arange(3)).all()
    assert (ti[:, 3:] == -1).all()


def test_tile_8192_group64():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((8192, 32)).astype(np.float32)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    mask = (rng.random(8192) > 0.2).astype(np.int8)
    assert port.pick_tile(8192, K) == 8192
    _assert_same(*_both(q, X, _norms(X, "L2"), mask, "L2", K))


def test_topk_128_build_shape():
    rng = np.random.default_rng(13)
    X = rng.standard_normal((3072, 16)).astype(np.float32)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    mask = np.ones(3072, np.int8)
    assert port.pick_tile(3072, 128) == 1024
    _assert_same(*_both(q, X, _norms(X, "L2"), mask, "L2", 128))


def test_cosine_zero_norm_rows_rank_top():
    rng = np.random.default_rng(17)
    X = rng.standard_normal((2048, 16)).astype(np.float32)
    X[5] = 0.0
    X[1500] = 0.0
    q = rng.standard_normal((3, 16)).astype(np.float32)
    mask = np.ones(2048, np.int8)
    jax_out, port_out = _both(q, X, _norms(X, "COSINE"), mask, "COSINE", K)
    _assert_same(jax_out, port_out)
    ts, ti = port_out
    for r in range(3):
        assert {5, 1500} <= set(ti[r].tolist())
        assert ts[r, 0] == pytest.approx(1.0)


def _int8_codes(X):
    lo, hi = float(X.min()), float(X.max())
    scale, bias = (hi - lo) / 254.0, (hi + lo) / 2.0
    codes = np.clip(np.round((X - bias) / scale), -127, 127).astype(np.int8)
    return codes, codes.astype(np.float32) * scale + bias, (scale, bias)


def _int4_codes(X):
    lo, hi = float(X.min()), float(X.max())
    scale, bias = (hi - lo) / 14.0, (hi + lo) / 2.0
    codes = np.clip(np.round((X - bias) / scale), -7, 7).astype(np.int8)
    return codes, codes.astype(np.float32) * scale + bias, (scale, bias)


@pytest.mark.parametrize("metric", METRICS)
def test_int8_dequant_epilogue(data, metric):
    X, q, mask = data
    codes, deq, dequant = _int8_codes(X)
    _assert_close_quantized(
        *_both(q, codes, _norms(deq, metric), mask, metric, K, dequant=dequant), K
    )


@pytest.mark.parametrize("metric", METRICS)
def test_int4_packed_planes(data, metric):
    X, q, mask = data
    codes, deq, dequant = _int4_codes(X)
    packed = pack_int4(codes)
    assert packed.shape == (N, D // 2)
    _assert_close_quantized(
        *_both(q, packed, _norms(deq, metric), mask, metric, K,
               dequant=dequant, int4_dim=D),
        K,
    )


def test_int4_packed_odd_dim():
    rng = np.random.default_rng(23)
    n, d = 2048, 17
    codes = rng.integers(-7, 8, size=(n, d)).astype(np.int8)
    q = rng.standard_normal((4, d)).astype(np.float32)
    mask = np.ones(n, np.int8)
    scale, bias = 0.31, -0.05
    deq = codes.astype(np.float32) * scale + bias
    packed = pack_int4(codes)
    assert packed.shape == (n, (d + 1) // 2)
    jax_out, port_out = _both(
        q, packed, _norms(deq, "L2"), mask, "L2", K, dequant=(scale, bias), int4_dim=d
    )
    _assert_close_quantized(jax_out, port_out, K)
    # the port scores int4 in float32, so it is exact against the oracle
    oracle = -(((q**2).sum(1)[:, None]) + _norms(deq, "L2")[None, :] - 2 * q @ deq.T)
    exp_i = np.argsort(-oracle, axis=1)[:, :K]
    for r in range(4):
        assert set(port_out[1][r].tolist()) == set(exp_i[r].tolist())


@pytest.mark.parametrize("metric", METRICS)
def test_fp16_codes_against_oracle(data, metric):
    """fp16 codes (true fp16 in the port, bf16 on the TPU): exact top-k of
    the fp16-rounded data, scores within 1e-4."""
    X, q, mask = data
    X16 = X.astype(np.float16)
    Xr = X16.astype(np.float32)
    norms = _norms(Xr, metric)
    ts, ti = port.flat_scan_topk(
        torch.from_numpy(q), torch.from_numpy(X16), torch.from_numpy(norms),
        torch.from_numpy(mask), metric=MetricType[metric], topk=K,
    )
    if metric == "L2":
        sims = -((q**2).sum(1)[:, None] + norms[None, :] - 2 * q @ Xr.T)
    elif metric == "IP":
        sims = q @ Xr.T
    else:
        sims = (q @ Xr.T) / (np.sqrt((q**2).sum(1))[:, None] * norms[None, :])
    sims = np.where(mask[None, :] != 0, sims, -np.inf)
    exp_i = np.argsort(-sims, axis=1)[:, :K]
    exp_s = np.take_along_axis(sims, exp_i, axis=1)
    for r in range(Q):
        assert set(ti[r].tolist()) == set(exp_i[r].tolist())
    assert np.allclose(ts.numpy(), exp_s, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", METRICS)
def test_stage1_plain_matches_jax_kernel_stage1(data, metric):
    """Stage one alone: the port's plain version keeps the Pallas kernel's
    (tile, k, Q) contract — same group keys (1e-4) and group ids."""
    from jax.experimental import pallas as pl

    from zvec_tpu.ops import flat_pallas as fp

    X, q, mask = data
    norms = _norms(X, metric)
    tile = port.pick_tile(N, K)
    ts, ti = port.flat_scan_stage1(
        torch.from_numpy(q), torch.from_numpy(X), torch.from_numpy(norms),
        torch.from_numpy(mask), metric=MetricType[metric], topk=K,
    )
    # the JAX kernel body on the same tile, through pallas_call directly
    if metric == "L2":
        qside = (q**2).sum(1, keepdims=True)
        knorm = norms
    elif metric == "COSINE":
        qside = np.sqrt((q**2).sum(1, keepdims=True))
        knorm = np.where(norms > 0, 1.0 / np.where(norms > 0, norms, 1.0), 0.0)
    else:
        qside = np.zeros((Q, 1), np.float32)
        knorm = norms
    n_tiles = N // tile
    spec = lambda shape, im: pl.BlockSpec(shape, im)  # noqa: E731
    js, ji = pl.pallas_call(
        fp._kernel(JMetric[metric], K, None, tile // 128, False),
        grid=(n_tiles,),
        in_specs=[
            spec((Q, D), lambda t: (0, 0)),
            spec((Q, 1), lambda t: (0, 0)),
            spec((Q, 1), lambda t: (0, 0)),
            spec((tile, D), lambda t: (t, 0)),
            spec((1, tile), lambda t: (0, t)),
            spec((1, tile), lambda t: (0, t)),
        ],
        out_specs=[
            spec((1, K, Q), lambda t: (t, 0, 0)),
            spec((1, K, Q), lambda t: (t, 0, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((n_tiles, K, Q), jnp.float32),
            jax.ShapeDtypeStruct((n_tiles, K, Q), jnp.int32),
        ],
        interpret=True,
    )(
        jnp.asarray(q), jnp.asarray(qside.astype(np.float32)),
        jnp.asarray(q.sum(1, keepdims=True)), jnp.asarray(X),
        jnp.asarray(knorm.astype(np.float32).reshape(1, N)),
        jnp.asarray(mask.reshape(1, N)),
    )
    assert np.allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-4)
    assert (ti.numpy() == np.asarray(ji)).all()


def test_kernel_path_rejects_cpu_tensors(data):
    """The kernel launcher takes CUDA tensors only and raises otherwise; it
    never falls back to the plain version (and counts no launch)."""
    X, q, mask = data
    _, _, args, kw = port._prepare(
        torch.from_numpy(q), torch.from_numpy(X), torch.from_numpy(_norms(X, "L2")),
        torch.from_numpy(mask), MetricType.L2, K, None, None,
    )
    before = port.flat_scan_topk.launches
    with pytest.raises(ValueError, match="CUDA"):
        port._stage1_kernel(*args, **kw)
    assert port.flat_scan_topk.launches == before
