"""The split-TF32 arithmetic of the CUDA flat-scan kernel, emulated on the CPU.

`csrc/flat_scan.cu` runs stage one on the tensor cores: every fp32 operand x
becomes big = tf32(x) and small = tf32(x - big), rounded as `cvt.rna.tf32.f32`
rounds (to nearest, ties away from zero, 10 mantissa bits kept), and the
products big*big + big*small + small*big (fp32 codes) or q_big*c + q_small*c
(fp16 / int8 / int4 codes, exact in TF32) are summed in fp32. This file
repeats that arithmetic in torch, since the kernel cannot run here, and holds
it to the plain stage one and to the final top-k of `flat_scan_topk_plain`:
keys within rtol 1e-4 / atol 1e-3, group-id swaps at most 1e-3 (swaps between
keys within 1e-6 relative, float32 near-ties, not counted), final id sets
equal except where the k-th and (k+1)-th plain scores lie within 1e-5
relative. It also shows that one unsplit TF32 pass misses the key tolerance on
the same data, so the split is needed, and that the one pass the kernel runs
with `exact_tf32` (+-1 codes against +-1 queries) gives the plain keys exactly.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

from zvec_tpu_torch.ops import flat_scan as fs  # noqa: E402
from zvec_tpu_torch.ops.quantize import pack_int4  # noqa: E402
from zvec_tpu_torch.ops.runtime import NEG_INF, topk_desc  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402

N, Q = 8192, 32
KEY_RTOL, KEY_ATOL = 1e-4, 1e-3
MAX_ID_SWAPS = 1e-3
TIE_RTOL = 1e-5
NEAR_KEY_RTOL = 1e-6  # group keys this close (~8 float32 ulps) may swap ranks


def id_swaps(ids, ref_ids, ref_keys):
    """Share of (tile, k, q) positions whose group id differs from the
    reference, not counting positions whose reference key lies within
    NEAR_KEY_RTOL of the key ranked next to it (a near-tie in float32)."""
    gap = (ref_keys[:, 1:] - ref_keys[:, :-1]).abs() <= NEAR_KEY_RTOL * ref_keys[:, 1:].abs()
    near = torch.zeros_like(ids, dtype=torch.bool)
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    return float(((ids != ref_ids) & ~near).float().mean())


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 as cvt.rna.tf32.f32: add half an ulp of the 10-bit
    mantissa to the magnitude bits, then clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def emulated_dots(q_kern, codes_f32, fp32_codes, split=True):
    """(Q, rows) dots as the kernel's tensor-core passes form them."""
    if not split:
        return tf32(q_kern) @ tf32(codes_f32).T
    qb = tf32(q_kern)
    qs = tf32(q_kern - qb)
    if fp32_codes:
        cb = tf32(codes_f32)
        cs = tf32(codes_f32 - cb)
        return qs @ cb.T + qb @ cs.T + qb @ cb.T
    return qs @ codes_f32.T + qb @ codes_f32.T


def emulated_stage1(q_kern, qside, qsum, codes, knorm, mask, *, metric, topk,
                    tile_n, scale, bias, int4, exact_tf32=False, split=True):
    """Stage one with the kernel's products: the (n_tiles, topk, Q) group keys
    and ids of the contract in `csrc/flat_scan.cu` (one TF32 product with
    exact_tf32, as its one-pass instance)."""
    n, nq = codes.shape[0], q_kern.shape[0]
    n_tiles, group = n // tile_n, tile_n // 128
    dots = emulated_dots(q_kern, fs._codes_f32(codes, int4),
                         codes.dtype == torch.float32, split and not exact_tf32)
    nrm = knorm[None, :]
    if metric == MetricType.IP:
        key = dots
    elif metric == MetricType.L2:
        key = (2.0 * scale) * dots - nrm
    else:
        real = scale * dots + bias * qsum[:, None]
        key = torch.where(nrm > 0, real * nrm, qside[:, None].expand_as(real))
    key = torch.where(mask[None, :] != 0, key, torch.full_like(key, NEG_INF))
    gmax = key.view(nq, n_tiles, group, 128).amax(dim=2)
    m, lane = topk_desc(gmax, topk)
    base = torch.arange(n_tiles)[None, :, None] * 128
    ids = torch.where(m > NEG_INF / 2, lane + base, torch.full_like(lane, -1))
    return m.permute(1, 2, 0).contiguous(), ids.permute(1, 2, 0).to(torch.int32).contiguous()


def _case(ctype, metric, d, seed, x=None, q=None):
    rng = np.random.default_rng(seed)
    if x is None:
        x = rng.standard_normal((N, d)).astype(np.float32)
        q = rng.standard_normal((Q, d)).astype(np.float32)
    mask = (rng.random(len(x)) > 0.3).astype(np.int8)
    dequant, int4_dim = None, None
    if ctype == "fp32":
        codes, deq = x, x
    elif ctype == "fp16":
        codes = x.astype(np.float16)
        deq = codes.astype(np.float32)
    else:
        lim = 127 if ctype == "int8" else 7
        scale, bias = (x.max() - x.min()) / (2 * lim), (x.max() + x.min()) / 2
        c = np.clip(np.round((x - bias) / scale), -lim, lim).astype(np.int8)
        deq = c.astype(np.float32) * scale + bias
        dequant = (float(scale), float(bias))
        codes = c if ctype == "int8" else pack_int4(c)
        int4_dim = d if ctype == "int4" else None
    sq = (deq.astype(np.float64) ** 2).sum(1).astype(np.float32)
    norms = np.sqrt(sq) if metric == "COSINE" else sq
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, codes, norms, mask)]
    return args, dict(metric=MetricType[metric], dequant=dequant, int4_dim=int4_dim)


def _norm800_data(d=128):
    """Rows and queries of norm ~800 spread around one centre: the L2 key
    2*dot - ||x||^2 cancels ~640,000 down to the spread of the data (the trap
    of the L2 epilogue noted in ROADMAP.md, Queue 3)."""
    rng = np.random.default_rng(800)
    sigma = 30.0
    centre = rng.standard_normal(d)
    centre *= np.sqrt(800.0**2 - sigma**2 * d) / np.linalg.norm(centre)
    x = (centre + sigma * rng.standard_normal((N, d))).astype(np.float32)
    q = (centre + sigma * rng.standard_normal((Q, d))).astype(np.float32)
    return x, q


def _check(args, kw, monkeypatch):
    _, _, kargs, kkw = fs._prepare(*args, kw["metric"], kw["topk"], kw["dequant"],
                                   kw["int4_dim"])
    es, ei = emulated_stage1(*kargs, **kkw)
    ps, pi = fs._stage1_plain(*kargs, **kkw)
    assert es.shape == ps.shape
    assert torch.allclose(es, ps, rtol=KEY_RTOL, atol=KEY_ATOL), float((es - ps).abs().max())
    assert id_swaps(ei, pi, ps) <= MAX_ID_SWAPS

    # the final top-k with the emulated stage one in place of the kernel
    k = kw["topk"]
    gs, gi = fs.flat_scan_topk_plain(*args, **{**kw, "topk": min(k + 1, 128)})
    monkeypatch.setattr(fs, "_stage1", lambda a, w, plain: emulated_stage1(*a, **w))
    fs_, fi = fs.flat_scan_topk(*args, **kw)
    differ = (torch.sort(fi, 1).values != torch.sort(gi[:, :k], 1).values).any(1)
    if k < 128:
        near_tie = (gs[:, k - 1] - gs[:, k]).abs() <= TIE_RTOL * gs[:, k - 1].abs()
        differ &= ~near_tie
    assert not bool(differ.any())
    same = (fi == gi[:, :k]).all(1)
    assert torch.allclose(fs_[same], gs[same, :k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("topk", [1, 10, 128])
@pytest.mark.parametrize("d", [17, 40, 128, 768])
@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
@pytest.mark.parametrize("ctype", ["fp32", "fp16", "int8", "int4"])
def test_split_tf32_matches_plain(ctype, metric, d, topk, monkeypatch):
    args, kw = _case(ctype, metric, d, seed=d * 7 + topk)
    _check(args, {**kw, "topk": topk}, monkeypatch)


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
@pytest.mark.parametrize("ctype", ["fp32", "fp16", "int8", "int4"])
def test_split_tf32_norms_near_800(ctype, metric, monkeypatch):
    x, q = _norm800_data()
    args, kw = _case(ctype, metric, 128, seed=1, x=x, q=q)
    _check(args, {**kw, "topk": 10}, monkeypatch)


@pytest.mark.parametrize("scale", ["unit", "norm800"])
def test_one_tf32_pass_misses_the_key_tolerance(scale):
    """The split is needed: one TF32 pass on the same data errs far beyond
    the key tolerance, where the split stays within it."""
    if scale == "unit":
        args, kw = _case("fp32", "L2", 128, seed=11)
    else:
        x, q = _norm800_data()
        args, kw = _case("fp32", "L2", 128, seed=11, x=x, q=q)
    _, _, kargs, kkw = fs._prepare(*args, kw["metric"], 10, None, None)
    ps, _ = fs._stage1_plain(*kargs, **kkw)
    es, _ = emulated_stage1(*kargs, **kkw)
    os_, _ = emulated_stage1(*kargs, **kkw, split=False)
    assert torch.allclose(es, ps, rtol=KEY_RTOL, atol=KEY_ATOL)
    assert not torch.allclose(os_, ps, rtol=KEY_RTOL, atol=KEY_ATOL)


def test_tf32_rounding_is_rna():
    """Round to nearest on the 13 dropped bits, ties away from zero."""
    one = 1.0
    ulp = 2.0**-10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0**-23,
                      one + 3 * ulp / 2, 3.0e-39], dtype=torch.float32)
    got = tf32(x).tolist()
    assert got[0] == one + ulp and got[1] == -(one + ulp)
    assert got[2] == one
    assert got[3] == one + 2 * ulp
    assert got[4] == pytest.approx(3.0e-39, rel=2.0**-10)
    big = tf32(x)
    assert torch.equal(tf32(big), big)


@pytest.mark.parametrize("d", [256, 96])
@pytest.mark.parametrize("kind", ["pm1", "gaussian"])
def test_one_tf32_pass_exact_only_on_pm1(kind, d, monkeypatch):
    """One TF32 product (the kernel's `exact_tf32` instance) on +-1 codes and
    queries: every product and sum is an integer held exactly, so the
    stage-one keys and ids equal the plain fp32 version's bit for bit, and so
    does the final top-k. On gaussian rows the same one pass gives other
    keys, which is why the wrapper takes the flag for +-1 codes only."""
    rng = np.random.default_rng(d)
    n = 4096
    if kind == "pm1":
        x = (rng.integers(0, 2, (n, d)) * 2 - 1).astype(np.float32)
        q = (rng.integers(0, 2, (Q, d)) * 2 - 1).astype(np.float32)
    else:
        x = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((Q, d)).astype(np.float32)
    mask = (rng.random(n) > 0.3).astype(np.int8)
    args = [torch.from_numpy(a) for a in (q, x, (x * x).sum(1), mask)]
    _, _, kargs, kkw = fs._prepare(*args, MetricType.L2, 10, None, None, kind == "pm1")
    es, ei = emulated_stage1(*kargs, **{**kkw, "exact_tf32": True})
    ps, pi = fs._stage1_plain(*kargs, **kkw)
    if kind == "gaussian":
        assert not torch.equal(es, ps)
        return
    assert torch.equal(es, ps) and torch.equal(ei, pi)
    gs, gi = fs.flat_scan_topk_plain(*args, metric=MetricType.L2, topk=10, exact_tf32=True)
    monkeypatch.setattr(fs, "_stage1", lambda a, w, plain: emulated_stage1(*a, **w))
    ks, ki = fs.flat_scan_topk(*args, metric=MetricType.L2, topk=10, exact_tf32=True)
    assert torch.equal(ks, gs) and torch.equal(ki, gi)
