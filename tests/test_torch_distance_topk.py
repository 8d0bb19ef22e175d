"""Parity of the port's distance matrices and top-k scans with zvec_tpu.ops.

Same numpy inputs through `zvec_tpu.ops.distance` / `zvec_tpu.ops.topk` (JAX
on the CPU mesh) and their torch ports. Tolerance 1e-4 (rtol and atol):
float32 sums taken in another order. Top-k results must carry the same ids.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)
import jax.numpy as jnp  # noqa: E402

from zvec_tpu.ops import distance as jd  # noqa: E402
from zvec_tpu.ops import topk as jt  # noqa: E402
from zvec_tpu.ops.quantize import pack_int4  # noqa: E402
from zvec_tpu.typing import MetricType as JMetric  # noqa: E402
from zvec_tpu_torch.ops import distance as td  # noqa: E402
from zvec_tpu_torch.ops import topk as tt  # noqa: E402
from zvec_tpu_torch.ops.runtime import NEG_INF  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402

METRICS = ["L2", "IP", "COSINE", "HAMMING"]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((300, 24)).astype(np.float32)
    X[7] = 0.0  # a zero-norm row for the cosine convention
    q = rng.standard_normal((5, 24)).astype(np.float32)
    mask = rng.random(300) > 0.25
    return X, q, mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("metric", METRICS)
def test_similarity_matrix_float(data, metric):
    X, q, _ = data
    if metric == "HAMMING":
        X, q = np.sign(X) + (X == 0), np.sign(q) + (q == 0)  # ±1 vectors
    norms = (X**2).sum(1).astype(np.float32)
    for x_norms in (None, norms):
        j = jd.similarity_matrix(
            jnp.asarray(q), jnp.asarray(X), JMetric[metric],
            None if x_norms is None else jnp.asarray(x_norms),
        )
        t = td.similarity_matrix(
            _t(q), _t(X), MetricType[metric], None if x_norms is None else _t(x_norms)
        )
        assert np.allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
@pytest.mark.parametrize("int4", [False, True])
def test_similarity_matrix_dequant(data, metric, int4):
    X, q, _ = data
    lim = 7 if int4 else 127
    rng = np.random.default_rng(5)
    codes = rng.integers(-lim, lim + 1, size=X.shape).astype(np.int8)
    scale, bias = 0.02, -0.01
    deq = codes.astype(np.float32) * scale + bias
    norms = (deq**2).sum(1).astype(np.float32)
    stored = pack_int4(codes) if int4 else codes
    j = jd.similarity_matrix(
        jnp.asarray(q), jnp.asarray(stored), JMetric[metric], jnp.asarray(norms),
        (jnp.float32(scale), jnp.float32(bias)), int4,
    )
    t = td.similarity_matrix(
        _t(q), _t(stored), MetricType[metric], _t(norms), (scale, bias), int4
    )
    assert np.allclose(t.numpy(), np.asarray(j), **TOL)


def test_int4_odd_dim_and_unpack():
    rng = np.random.default_rng(9)
    codes = rng.integers(-8, 8, size=(40, 17)).astype(np.int8)
    packed = pack_int4(codes)
    lo, hi = td.unpack_nibbles(_t(packed))
    planes = torch.stack([lo, hi], dim=-1).reshape(40, -1)[:, :17]
    assert (planes.numpy() == codes).all()
    q = rng.standard_normal((3, 17)).astype(np.float32)
    j = jd.ip_matrix(jnp.asarray(q), jnp.asarray(packed), None, True)
    t = td.ip_matrix(_t(q), _t(packed), None, True)
    assert np.allclose(t.numpy(), np.asarray(j), **TOL)
    assert np.allclose(t.numpy(), q @ codes.T.astype(np.float32), **TOL)


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_score_conversions_round_trip(metric):
    sims = np.array([[0.5, -1.25, 2.0]], np.float32)
    s = td.similarity_to_score(sims, MetricType[metric])
    assert np.allclose(s, np.asarray(jd.similarity_to_score(sims, JMetric[metric])))
    assert np.allclose(td.score_to_similarity(s, MetricType[metric]), sims)
    st = td.similarity_to_score(torch.from_numpy(sims), MetricType[metric])
    assert np.allclose(st.numpy(), s)


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("block_size", [64, 4096])
def test_blockwise_topk_search(data, metric, masked, block_size):
    X, q, mask = data
    norms = (X**2).sum(1).astype(np.float32)
    m = mask if masked else None
    js, ji = jt.blockwise_topk_search(
        jnp.asarray(q), jnp.asarray(X), JMetric[metric], 10,
        mask=None if m is None else jnp.asarray(m), x_sq_norms=jnp.asarray(norms),
        block_size=block_size,
    )
    ts, ti = tt.blockwise_topk_search(
        _t(q), _t(X), MetricType[metric], 10,
        mask=None if m is None else _t(m), x_sq_norms=_t(norms),
        block_size=block_size,
    )
    assert ti.dtype == torch.int64
    assert (ti.numpy() == np.asarray(ji)).all()
    assert np.allclose(ts.numpy(), np.asarray(js), **TOL)


def test_blockwise_fewer_valid_than_k(data):
    X, q, _ = data
    mask = np.zeros(300, bool)
    mask[[3, 150, 299]] = True
    js, ji = jt.blockwise_topk_search(
        jnp.asarray(q), jnp.asarray(X), JMetric.IP, 8, mask=jnp.asarray(mask),
        block_size=128,
    )
    ts, ti = tt.blockwise_topk_search(
        _t(q), _t(X), MetricType.IP, 8, mask=_t(mask), block_size=128
    )
    assert (ti.numpy() == np.asarray(ji)).all()
    assert (ti.numpy()[:, 3:] == -1).all()
    assert (ts.numpy()[:, 3:] <= NEG_INF / 2).all()


def test_blockwise_ties_follow_lax_top_k():
    """Hamming-style integer scores tie often; both pick the lower index."""
    rng = np.random.default_rng(21)
    X = np.sign(rng.standard_normal((256, 8))).astype(np.float32)
    q = np.sign(rng.standard_normal((4, 8))).astype(np.float32)
    js, ji = jt.blockwise_topk_search(
        jnp.asarray(q), jnp.asarray(X), JMetric.L2, 16, block_size=64
    )
    ts, ti = tt.blockwise_topk_search(_t(q), _t(X), MetricType.L2, 16, block_size=64)
    assert (ti.numpy() == np.asarray(ji)).all()
    assert np.allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("topk", [4, 12])
def test_merge_topk(topk):
    rng = np.random.default_rng(31)
    s1 = rng.standard_normal((6, 5)).astype(np.float32)
    s2 = rng.standard_normal((6, 3)).astype(np.float32)
    i1 = rng.integers(0, 100, (6, 5)).astype(np.int32)
    i2 = rng.integers(100, 200, (6, 3)).astype(np.int32)
    i1[0, 2] = -1  # an invalid slot loses every comparison
    js, ji = jt.merge_topk([jnp.asarray(s1), jnp.asarray(s2)],
                           [jnp.asarray(i1), jnp.asarray(i2)], topk)
    ts, ti = tt.merge_topk([_t(s1), _t(s2)], [_t(i1), _t(i2)], topk)
    assert ts.shape == (6, topk)
    assert (ti.numpy() == np.asarray(ji)).all()
    assert np.allclose(ts.numpy(), np.asarray(js), **TOL)


def test_apply_mask():
    sims = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    mask = torch.tensor([True, False, True])
    out = tt.apply_mask(sims, mask)
    j = jt.apply_mask(jnp.asarray(sims.numpy()), jnp.asarray(mask.numpy()))
    assert (out.numpy() == np.asarray(j)).all()
    assert tt.apply_mask(sims, None) is sims


def test_runtime_matches_jax_runtime():
    """Full float32 products (no TF32), the same sentinel and the same query
    buckets as `zvec_tpu.ops.runtime`."""
    from zvec_tpu.ops import runtime as jr
    from zvec_tpu_torch.ops import runtime as tr

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert tr.NEG_INF == jr.NEG_INF == float(np.finfo(np.float32).min)
    for nq in (1, 5, 8, 9, 100, 512, 513, 1024, 1500):
        assert tr.bucket_queries(nq) == jr.bucket_queries(nq)
    assert tr.round_up(1_000_000, 8192) == jr.round_up(1_000_000, 8192) == 1_007_616
    assert tr.cdiv(10, 4) == jr.cdiv(10, 4) == 3
    assert tr.device().type == "cpu"  # asked for at the top of this file
    vals, idx = tr.topk_desc(torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]]), 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3.0, 3.0, 3.0]]
