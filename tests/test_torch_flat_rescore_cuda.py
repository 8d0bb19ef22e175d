"""The flat scan's stage-two kernel (`csrc/flat_rescore.cu`: candidate gather,
exact fp32 rescore, final top-k) against its plain PyTorch version
`_rescore_plain`, on the card.

Marked `cuda`: the kernel has no CPU mode, so without a card these skip.
Run them on a GPU machine with
`python -m pytest --noconftest tests/test_torch_flat_rescore_cuda.py -q`.

Tolerances. On crafted integer codes (every dot exact in any order) the
kernel must give the plain version's scores and ids bit for bit: the same
tie order (score descending, equal scores by the lower candidate position,
-0.0 and +0.0 one key) and each score's sign. On random codes the two sum
the fp32 dots in another order (the plain version in cuBLAS's `bmm`):
scores within rtol = atol = 1e-4, and ids equal except where a differing id
scores within 1e-5 (relative) of the row's k-th score. Inputs: every code
type (fp32, fp16, int8, nibble-packed int4 with dequant) and metric on the
row strides the main paths give (512, 804, 816, 3,072 and 3,088 bytes of
fp32, 1,024 of +-1 codes, 200 of fp16, 100 of int8, 50 and 17 of int4), Q
2048 with k 128 (1,024 candidates), K1's and the merge's own output, and
bad inputs, which raise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zvec_tpu_torch.ops import flat_scan as fs  # noqa: E402
from zvec_tpu_torch.ops.runtime import DEVICE_ENV, NEG_INF, device  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402

pytestmark = pytest.mark.cuda

LANES = 128
TIE_RTOL = 1e-5


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the rescore kernel has no CPU mode")
    monkeypatch.setenv(DEVICE_ENV, "cuda")  # the card, asked for: a CPU test file of the same process asks for the CPU
    device.cache_clear()
    yield torch.device("cuda")
    device.cache_clear()


def _pack_int4(c):
    """(n, d) int codes in [-8, 7] -> (n, ceil(d / 2)) int8, element 2i in the low nibble."""
    if c.shape[1] % 2:
        c = np.concatenate([c, np.zeros((c.shape[0], 1), c.dtype)], axis=1)
    return ((c[:, 0::2] & 0xF) | ((c[:, 1::2] & 0xF) << 4)).astype(np.uint8).view(np.int8)


def _inputs(ctype, metric, n, d, nq, k, seed, integer=False):
    """Stage two's inputs on numpy: random winner groups (an invalid one by
    id, one by key, a query with one valid group), a 15% mask, zero rows.
    `integer`: codes and queries of a few small integers (int codes with a
    dyadic dequant), so every dot is exact, and under L2 a zero query with a
    qside of -0.0 and norms of +-0.0 on zero rows (scores of +0.0 and -0.0)."""
    rng = np.random.default_rng(seed)
    tile_n = fs.pick_tile(n, k)
    quantized = ctype in ("int8", "int4")
    if integer or quantized:
        vals = rng.integers(-2, 3, (n, d)) if integer else rng.integers(-7 if ctype == "int4" else -127,
                                                                         8 if ctype == "int4" else 128, (n, d))
        if integer:
            vals[rng.random(n) < 0.3] = vals[0]  # repeated rows: equal scores across groups
        vals[rng.random(n) < 0.1] = 1 if quantized else 0  # rows that dequantize to zero
        q = (rng.integers(-2, 3, (nq, d)) if integer else rng.standard_normal((nq, d))).astype(np.float32)
    else:
        vals = rng.standard_normal((n, d))
        vals[rng.random(n) < 0.05] = 0.0
        q = rng.standard_normal((nq, d)).astype(np.float32)
    dequant = (0.5, -0.5) if quantized else None
    if ctype == "int8":
        c = vals.astype(np.int8)
        codes, deq = c, c.astype(np.float32) * np.float32(0.5) - np.float32(0.5)
    elif ctype == "int4":
        codes, deq = _pack_int4(vals.astype(np.int8)), vals.astype(np.float32) * np.float32(0.5) - np.float32(0.5)
    elif ctype == "fp16":
        codes = vals.astype(np.float16)
        deq = codes.astype(np.float32)
    else:
        codes = deq = vals.astype(np.float32)
    sq = (deq.astype(np.float64) ** 2).sum(1)
    qsq = (q.astype(np.float64) ** 2).sum(1)
    if metric == "L2":
        qside, norms = qsq.astype(np.float32), sq.astype(np.float32)
        if integer:  # query 0 zero, its qside -0.0: zero rows score +0.0 or -0.0 by their norm's sign
            q[0], qside[0] = 0.0, -0.0
            norms[np.flatnonzero(sq == 0)[::2]] = -0.0
    elif metric == "COSINE":
        qside, norms = np.sqrt(qsq).astype(np.float32), np.sqrt(sq).astype(np.float32)
    else:
        qside, norms = np.zeros(nq, np.float32), sq.astype(np.float32)
    if metric == "COSINE" and nq > 3:
        q[3], qside[3] = 0.0, 0.0  # a zero query: every valid row scores 1.0
    mask8 = (rng.random(n) > 0.15).astype(np.int8)
    n_groups = (n // tile_n) * LANES
    gids = np.stack([rng.choice(n_groups, k, replace=False) for _ in range(nq)]).astype(np.int64)
    top_s = np.sort(rng.standard_normal((nq, k)).astype(np.float32), axis=1)[:, ::-1].copy()
    if nq > 3 and k > 1:
        gids[1, -1], top_s[1, -1] = -1, NEG_INF
        top_s[2, -1] = NEG_INF
        gids[3, 1:], top_s[3, 1:] = -1, NEG_INF
    kw = dict(metric=MetricType[metric], topk=k, tile_n=tile_n, scale=0.5 if dequant else 1.0,
              bias=-0.5 if dequant else 0.0, dequant=dequant, int4=ctype == "int4", d=d)
    return (q, qside, codes, norms, mask8, top_s, gids), kw


def _on(args, dev):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]


def _near_ties_only(ks, ki, ps, pi):
    """Rows whose id sets differ: every id in the difference scores within
    TIE_RTOL of the row's k-th score. Returns the number of bad rows."""
    k = ki.shape[1]
    differ = (torch.sort(ki, dim=1).values != torch.sort(pi, dim=1).values).any(dim=1)
    bad = 0
    for r in differ.nonzero().flatten().tolist():
        a = dict(zip(ki[r].tolist(), ks[r].tolist()))
        b = dict(zip(pi[r].tolist(), ps[r].tolist()))
        kth = float(ps[r, k - 1])
        extra = [a[i] for i in a.keys() - b.keys()] + [b[i] for i in b.keys() - a.keys()]
        bad += any(abs(v - kth) > TIE_RTOL * abs(kth) for v in extra)
    return bad


def _check(args, kw, exact_bits=False):
    before = fs.flat_scan_rescore.launches
    ks, ki = fs._rescore_kernel(*args, **kw)
    assert fs.flat_scan_rescore.launches == before + 1
    ps, pi = fs._rescore_plain(*args, **kw)
    torch.cuda.synchronize()
    assert ks.shape == ps.shape and ki.dtype == torch.int64 and ks.dtype == torch.float32
    assert ((ki < 0) == (ks <= NEG_INF / 2)).all()
    if exact_bits:
        assert torch.equal(ks.view(torch.int32), ps.view(torch.int32)), "scores differ"
        assert torch.equal(ki, pi), "ids differ"
    else:
        assert torch.allclose(ks, ps, rtol=1e-4, atol=1e-4), float((ks - ps).abs().max())
        assert _near_ties_only(ks, ki, ps, pi) == 0
    return ks, ki


STRIDES = [  # (code type, D): the row strides of the main paths, and the odd ones
    ("fp32", 128),   # 512 B, 16-byte loads (FLAT, the HNSW build)
    ("fp32", 201),   # 804 B, 4-byte loads (an unpadded MIPS row)
    ("fp32", 204),   # 816 B, 16-byte loads (the MIPS build's padded codes)
    ("fp32", 768),   # 3,072 B (Cohere)
    ("fp32", 772),   # 3,088 B (default-IP Cohere, padded)
    ("fp16", 100),   # 200 B, 8-byte loads (FP16 GloVe-100)
    ("int8", 100),   # 100 B, 4-byte loads
    ("int4", 100),   # 50 B, 2-byte loads
    ("int4", 33),    # 17 B, byte loads, the odd D's phantom nibble
]


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
@pytest.mark.parametrize("ctype,d", STRIDES)
def test_rescore_kernel_random(cuda, ctype, d, metric):
    args, kw = _inputs(ctype, metric, 16384, d, 37, 10, seed=d * 7 + len(metric))
    _check(_on(args, cuda), kw)


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
@pytest.mark.parametrize("ctype", ["fp32", "fp16", "int8", "int4"])
def test_rescore_kernel_bitwise_on_exact_dots(cuda, ctype, metric, k):
    """Integer codes: ties within and across groups, +-0.0 scores, invalid
    groups and masked rows, bit for bit."""
    args, kw = _inputs(ctype, metric, 8192, 7, 16, k, seed=k + len(ctype) * 10 + len(metric), integer=True)
    ks, _ = _check(_on(args, cuda), kw, exact_bits=True)
    if metric == "L2" and k >= 10:
        z = ks[0][ks[0] == 0]
        assert torch.signbit(z).any() and (~torch.signbit(z)).any()


def test_rescore_kernel_build_batch(cuda):
    """Q 2048, k 128: 1,024 candidates a query at the build's 128 columns."""
    args, kw = _inputs("fp32", "L2", 131072, 128, 2048, 128, seed=5)
    _check(_on(args, cuda), kw)


def test_rescore_kernel_hamming_codes(cuda):
    """+-1 codes at D = 256 (1,024-byte rows), L2: integer scores, exact."""
    rng = np.random.default_rng(6)
    n, d, nq, k = 65536, 256, 64, 10
    x = np.where(rng.random((n, d)) < 0.5, -1.0, 1.0).astype(np.float32)
    q = np.where(rng.random((nq, d)) < 0.5, -1.0, 1.0).astype(np.float32)
    tile_n = fs.pick_tile(n, k)
    gids = np.stack([rng.choice((n // tile_n) * LANES, k, replace=False) for _ in range(nq)]).astype(np.int64)
    args = (q, np.full(nq, d, np.float32), x, np.full(n, d, np.float32), np.ones(n, np.int8),
            np.zeros((nq, k), np.float32), gids)
    kw = dict(metric=MetricType.L2, topk=k, tile_n=tile_n, scale=1.0, bias=0.0, dequant=None, int4=False, d=d)
    _check(_on(args, cuda), kw, exact_bits=True)


@pytest.mark.parametrize("ctype", ["fp32", "fp16", "int8", "int4"])
@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_rescore_kernel_on_k1_and_merge_output(cuda, ctype, metric):
    """On K1's and the merge's own output (zero rows, a 30% mask, repeated
    rows), then the whole scan: it launches K1, the merge and stage two once
    each, and gives the answer of the same stages with the plain stage two."""
    rng = np.random.default_rng(8)
    n, d, nq, k = 65536, 40 if ctype != "int4" else 41, 70, 10
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[rng.random(n) < 0.05] = 0.0
    x[1::97] = x[0]
    q = rng.standard_normal((nq, d)).astype(np.float32)
    mask = (rng.random(n) > 0.3).astype(np.int8)
    dequant, int4_dim = None, None
    if ctype == "fp16":
        codes = x.astype(np.float16)
        deq = codes.astype(np.float32)
    elif ctype in ("int8", "int4"):
        lim = 127 if ctype == "int8" else 7
        scale, bias = float(np.abs(x).max()) / lim, 0.0
        c = np.clip(np.round(x / scale), -lim, lim).astype(np.int8)
        deq = c.astype(np.float32) * np.float32(scale)
        codes, dequant = (c if ctype == "int8" else _pack_int4(c)), (scale, bias)
        int4_dim = d if ctype == "int4" else None
    else:
        codes = deq = x
    sq = (deq.astype(np.float64) ** 2).sum(1)
    norms = (np.sqrt(sq) if metric == "COSINE" else sq).astype(np.float32)
    targs = _on((q, codes, norms, mask), cuda)
    kw = dict(metric=MetricType[metric], topk=k, dequant=dequant, int4_dim=int4_dim)
    ts, ti = fs.flat_scan_stage1(*targs, **kw)
    top_s, gids = fs.flat_scan_merge(ts, ti, topk=k)
    qf, nrm, args, pkw = fs._prepare(*targs, kw["metric"], k, dequant, int4_dim)
    rargs, rkw = fs._rescore_inputs(qf, nrm, args, pkw, dequant)
    ks, ki = _check([*rargs, top_s, gids], rkw)
    counts = (fs.flat_scan_topk.launches, fs.flat_scan_merge.launches, fs.flat_scan_rescore.launches)
    s, i = fs.flat_scan_topk(*targs, **kw)
    assert (fs.flat_scan_topk.launches, fs.flat_scan_merge.launches, fs.flat_scan_rescore.launches) == tuple(
        c + 1 for c in counts)
    assert torch.equal(s, ks) and torch.equal(i, ki)  # the same stage one, merge and stage two: deterministic
    ps, pi = fs._rescore_plain(*rargs, top_s, gids, **rkw)
    assert torch.allclose(s, ps, rtol=1e-4, atol=1e-4) and _near_ties_only(s, i, ps, pi) == 0


def test_rescore_kernel_rejects_bad_inputs(cuda):
    args, kw = _inputs("fp32", "L2", 8192, 16, 5, 10, seed=3)
    good = _on(args, cuda)
    q, qside, codes, norms, mask8, top_s, gids = good
    bad_sets = [
        [q.cpu(), qside, codes, norms, mask8, top_s, gids],  # a CPU tensor among CUDA ones
        [q, qside, codes.double(), norms, mask8, top_s, gids],  # a code type the kernel does not take
        [q, qside, codes, norms, mask8, top_s, gids.int()],  # int32 group ids
        [q, qside, codes, norms, mask8.bool(), top_s, gids],  # a bool mask
        [q, qside, codes[:, :8], norms, mask8, top_s, gids],  # D disagrees (and not contiguous)
        [q, qside, codes.t().contiguous().t(), norms, mask8, top_s, gids],  # not contiguous
        [q, qside, codes, norms[:-1], mask8, top_s, gids],  # norms of another length
        [q, qside, codes, norms, mask8, top_s[:, :5], gids[:, :5]],  # k disagrees
    ]
    before = fs.flat_scan_rescore.launches
    for bad in bad_sets:
        with pytest.raises(ValueError):
            fs._rescore_kernel(*bad, **kw)
    for bad_kw in (dict(tile_n=1000), dict(tile_n=16384), dict(int4=True)):
        with pytest.raises(ValueError):
            fs._rescore_kernel(*good, **{**kw, **bad_kw})
    assert fs.flat_scan_rescore.launches == before
