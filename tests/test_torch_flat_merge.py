"""The flat scan's global merge: the port's plain version against numpy, JAX
and the merge kernel's algorithm, and the sorted tiles the kernel reads.

`zvec_tpu/ops/flat_pallas.py:255-258` merges stage one's (n_tiles, k, Q)
winner groups with one `lax.top_k` over a query's n_tiles * k keys. The port
keeps that as `ops/flat_scan.py::_merge_plain` (a stable descending sort)
beside the CUDA kernel `csrc/flat_merge.cu`, which must equal it bit for bit
(held on the card by tests/test_torch_flat_merge_cuda.py). Here, on the same
numpy keys:
- `_merge_plain` equals a numpy reference (`np.lexsort((pos, -key))`, -0.0
  as +0.0) exactly, keys and ids, and equals JAX's merge exactly except in
  the order of -0.0 and +0.0, which `lax.top_k` ranks +0.0 first (a total
  order) and `torch.sort` holds equal;
- `_select_merge`, the kernel's algorithm in numpy (a radix select of the
  k-th largest tile maximum L, a second one of the k-th largest key T among
  the keys >= L, walks that stop at the first key below the bound, the keys
  equal to T taken in position order), equals `_merge_plain` exactly;
- both stage ones, the port's plain one and the Pallas kernel in interpret
  mode, write each tile's keys sorted descending, ties by the lower lane, and
  no NaN from finite codes: what the kernel relies on.
Cases: many keys equal across tiles, +-0.0, NEG_INF padding with id -1 and
queries with fewer valid groups than k, k in {1, 10, 128}, one tile and
many, Q not a multiple of 8 or 32.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)
import jax.numpy as jnp  # noqa: E402

from zvec_tpu.typing import MetricType as JMetric  # noqa: E402
from zvec_tpu_torch.ops import flat_scan as port  # noqa: E402
from zvec_tpu_torch.ops.runtime import NEG_INF, topk_desc  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402

LANES = 128
CASES = ["gauss", "ties", "zeros", "padding"]


def _tiles(case, n_tiles, k, nq, seed=0):
    """Stage one's output for random group maxima: (n_tiles, k, Q) keys and
    int32 ids, each tile's top-k of its 128 group maxima by `topk_desc`
    (descending, ties to the lower lane), id -1 where the key is NEG_INF."""
    rng = np.random.default_rng(seed)
    shape = (n_tiles, nq, LANES)
    if case == "gauss":
        g = rng.standard_normal(shape).astype(np.float32)
    elif case == "ties":  # a handful of values: ties within and across tiles
        g = rng.choice(np.array([-3.0, -1.0, 0.5, 2.0], np.float32), shape)
    elif case == "zeros":  # +0.0 and -0.0 beside a few other keys
        g = rng.choice(np.array([0.0, -0.0, 1.0, -1.0, -0.0], np.float32), shape, p=[0.3, 0.3, 0.1, 0.1, 0.2])
    else:  # most groups masked; query q keeps about q valid groups in all
        g = rng.standard_normal(shape).astype(np.float32)
        keep = rng.random(shape) < (np.arange(nq, dtype=np.float64)[None, :, None] / (n_tiles * LANES))
        g = np.where(keep, g, np.float32(NEG_INF))
    m, lane = topk_desc(torch.from_numpy(g), k)  # (T, Q, k)
    base = torch.arange(n_tiles)[:, None, None] * LANES
    ids = torch.where(m > NEG_INF / 2, lane + base, torch.full_like(lane, -1))
    return m.permute(0, 2, 1).contiguous().numpy(), ids.permute(0, 2, 1).to(torch.int32).contiguous().numpy()


def _flat(ts, ti):
    n_tiles, k, nq = ts.shape
    return ts.transpose(2, 0, 1).reshape(nq, n_tiles * k), ti.transpose(2, 0, 1).reshape(nq, n_tiles * k)


def _numpy_merge(ts, ti, k, total_order=False):
    """np.lexsort over (position, -key): key descending, ties by the lower
    position; -0.0 as +0.0, or below +0.0 with `total_order`."""
    keys, ids = _flat(ts, ti)
    pos = np.arange(keys.shape[1])
    out_s, out_i = [], []
    for r in range(keys.shape[0]):
        key = np.where(keys[r] == 0, 0.0, keys[r].astype(np.float64))
        if total_order:  # -0.0 just below +0.0 and above every negative float32
            key = np.where((keys[r] == 0) & np.signbit(keys[r]), -1e-300, key)
        order = np.lexsort((pos, -key))[:k]
        out_s.append(keys[r, order])
        out_i.append(ids[r, order].astype(np.int64))
    return np.stack(out_s), np.stack(out_i)


def _jax_merge(ts, ti, k):
    """flat_pallas.py:255-258 on the same keys."""
    keys, ids = _flat(ts, ti)
    top_s, sel = jax.lax.top_k(jnp.asarray(keys), k)
    return np.asarray(top_s), np.asarray(jnp.take_along_axis(jnp.asarray(ids), sel, axis=1))


def _order_bits(keys):
    """csrc/flat_merge.cu::order_bits: monotone uint32 words, -0.0 as +0.0."""
    b = np.where(keys == 0, np.float32(0), keys).astype(np.float32).view(np.uint32).astype(np.uint64)
    return np.where(b >> 31 == 1, b ^ 0xFFFFFFFF, b | 0x80000000)


def _select_merge(ts, ti, k):
    """The merge kernel's algorithm, query by query, in numpy. A walk down a
    tile stops at the first word below its bound (a prefix, on sorted tiles)."""
    n_tiles, _, nq = ts.shape
    r = np.arange(k)[None, :]
    out_s, out_i = np.empty((nq, k), np.float32), np.empty((nq, k), np.int64)
    for qi in range(nq):
        w = _order_bits(ts[:, :, qi])  # (n_tiles, k)

        def select(rmax, floor):
            prefix, want = 0, k
            for shift in (24, 16, 8, 0):
                fixed = 0 if shift == 24 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
                walked = np.cumprod(w >= max(floor, prefix), axis=1).astype(bool) & (r < rmax)
                sel = walked & ((w & fixed) == prefix)
                hist = np.bincount(((w[sel] >> shift) & 0xFF).astype(np.int64), minlength=256)
                above = np.cumsum(hist[::-1])  # keys in bins 255 .. 255 - i
                i = int(np.searchsorted(above, want))
                prefix |= (255 - i) << shift
                want -= int(above[i - 1]) if i else 0
            return prefix, want

        lower, _ = select(min(k, -(-k // n_tiles)), 0)
        thr, need = select(k, lower)
        flat = w.reshape(-1)
        gt = np.flatnonzero(flat > thr)
        eq = np.flatnonzero(flat == thr)[:need]
        assert len(gt) == k - need and len(eq) == need
        pick = np.concatenate([gt, eq])
        pick = pick[np.lexsort((pick, -flat[pick].astype(np.float64)))]
        out_s[qi] = ts.reshape(-1, nq)[pick, qi]
        out_i[qi] = ti.reshape(-1, nq)[pick, qi]
    return out_s, out_i


def _plain(ts, ti, k):
    s, i = port.flat_scan_merge(torch.from_numpy(ts), torch.from_numpy(ti), topk=k)
    assert s.dtype == torch.float32 and i.dtype == torch.int64 and s.shape == i.shape == (ts.shape[2], k)
    return s.numpy(), i.numpy()


def _bitwise(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("n_tiles", [1, 37])
@pytest.mark.parametrize("case", CASES)
def test_merge_plain_against_numpy_jax_and_select(case, n_tiles, k):
    nq = 37
    ts, ti = _tiles(case, n_tiles, k, nq, seed=n_tiles * 1000 + k)
    before = port.flat_scan_merge.launches
    ps, pi = _plain(ts, ti, k)
    assert port.flat_scan_merge.launches == before  # CPU tensors: the plain version, no launch
    ns, ni = _numpy_merge(ts, ti, k)
    assert _bitwise(ps, ns) and (pi == ni).all()
    js, ji = _jax_merge(ts, ti, k)
    if case == "zeros":  # lax.top_k ranks +0.0 above -0.0; so does the numpy total order
        ts_tot, ti_tot = _numpy_merge(ts, ti, k, total_order=True)
        assert _bitwise(js, ts_tot) and (ji == ti_tot).all()
        assert (js == ps).all()  # the same keys by value, -0.0 == +0.0
    else:
        assert _bitwise(js, ps) and (ji == pi).all()
    ss, si = _select_merge(ts, ti, k)
    assert _bitwise(ss, ps) and (si == pi).all()
    if case == "padding":  # queries with fewer valid groups than k get the plain fill
        short = (pi < 0).any(axis=1)
        assert short.any() and ((pi < 0) == (ps <= NEG_INF / 2)).all()


def test_signed_zero_order_differs_from_lax_top_k():
    """-0.0 at position 0 and +0.0 at position 1: the port (and its kernel)
    keep position order, lax.top_k puts +0.0 first."""
    ts = np.array([[[-0.0], [-1.0]], [[0.0], [-2.0]]], np.float32)  # (2 tiles, k 2, Q 1)
    ti = np.array([[[5], [6]], [[130], [131]]], np.int32)
    ps, pi = _plain(ts, ti, 2)
    js, ji = _jax_merge(ts, ti, 2)
    assert pi.tolist() == [[5, 130]] and np.signbit(ps[0, 0]) and not np.signbit(ps[0, 1])
    assert ji.tolist() == [[130, 5]]
    assert _bitwise(_select_merge(ts, ti, 2)[0], ps)


def test_merge_kernel_rejects_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only and raises otherwise; it
    never falls back to the plain version (and counts no launch)."""
    ts, ti = _tiles("gauss", 3, 10, 5)
    before = port.flat_scan_merge.launches
    with pytest.raises(ValueError, match="CUDA"):
        port._merge_kernel(torch.from_numpy(ts), torch.from_numpy(ti), 10)
    assert port.flat_scan_merge.launches == before


def _stage1_port(q, x, norms, mask, metric, k):
    return [t.numpy() for t in port.flat_scan_stage1(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(norms), torch.from_numpy(mask),
        metric=MetricType[metric], topk=k)]


def _stage1_jax(q, x, norms, mask, metric, k):
    """The Pallas kernel body alone, in interpret mode, as
    tests/test_torch_flat_scan.py runs it."""
    from jax.experimental import pallas as pl

    from zvec_tpu.ops import flat_pallas as fp

    n, d = x.shape
    nq = q.shape[0]
    tile = port.pick_tile(n, k)
    if metric == "L2":
        qside, knorm = (q**2).sum(1, keepdims=True), norms
    elif metric == "COSINE":
        qside = np.sqrt((q**2).sum(1, keepdims=True))
        knorm = np.where(norms > 0, 1.0 / np.where(norms > 0, norms, 1.0), 0.0)
    else:
        qside, knorm = np.zeros((nq, 1), np.float32), norms
    n_tiles = n // tile
    spec = pl.BlockSpec
    js, ji = pl.pallas_call(
        fp._kernel(JMetric[metric], k, None, tile // LANES, False),
        grid=(n_tiles,),
        in_specs=[spec((nq, d), lambda t: (0, 0)), spec((nq, 1), lambda t: (0, 0)),
                  spec((nq, 1), lambda t: (0, 0)), spec((tile, d), lambda t: (t, 0)),
                  spec((1, tile), lambda t: (0, t)), spec((1, tile), lambda t: (0, t))],
        out_specs=[spec((1, k, nq), lambda t: (t, 0, 0)), spec((1, k, nq), lambda t: (t, 0, 0))],
        out_shape=[jax.ShapeDtypeStruct((n_tiles, k, nq), jnp.float32),
                   jax.ShapeDtypeStruct((n_tiles, k, nq), jnp.int32)],
        interpret=True,
    )(jnp.asarray(q), jnp.asarray(qside.astype(np.float32)), jnp.asarray(q.sum(1, keepdims=True)),
      jnp.asarray(x), jnp.asarray(knorm.astype(np.float32).reshape(1, n)), jnp.asarray(mask.reshape(1, n)))
    return np.array(js), np.array(ji)  # writable copies


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_stage1_tiles_come_sorted(package, metric):
    """Each (tile, query)'s k keys non-increasing (-0.0 as +0.0), equal keys
    by the lower lane, ids distinct and -1 exactly on NEG_INF, no NaN: on
    rows with repeats, zero rows, a zero query and a 40% mask."""
    rng = np.random.default_rng(11)
    n, d, nq, k = 2048, 16, 9, 10
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[rng.random(n) < 0.1] = 0.0  # zero rows: IP keys +-0.0, zero-norm COSINE rows
    x[1::7] = x[0]  # repeated rows: equal keys across lanes and tiles
    q = rng.standard_normal((nq, d)).astype(np.float32)
    q[3] = 0.0  # a zero query: every key ties
    mask = (rng.random(n) > 0.4).astype(np.int8)
    sq = (x**2).sum(1).astype(np.float32)
    norms = np.sqrt(sq).astype(np.float32) if metric == "COSINE" else sq
    run = _stage1_port if package == "port" else _stage1_jax
    ts, ti = run(q, x, norms, mask, metric, k)
    assert not np.isnan(ts).any()
    w = _order_bits(ts).astype(np.int64)  # (n_tiles, k, Q)
    assert (w[:, 1:] <= w[:, :-1]).all()
    tie = w[:, 1:] == w[:, :-1]
    assert tie.any() and (ti[:, 1:][tie] > ti[:, :-1][tie]).all()
    assert ((ti < 0) == (ts <= NEG_INF / 2)).all()
    srt = np.sort(ti, axis=1)
    assert not ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()
    # and the merge of these tiles is the numpy reference's and the select's
    ps, pi = _plain(ts, ti, k)
    ns, ni = _numpy_merge(ts, ti, k)
    ss, si = _select_merge(ts, ti, k)
    assert _bitwise(ps, ns) and (pi == ni).all() and _bitwise(ss, ps) and (si == pi).all()
