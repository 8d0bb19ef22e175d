"""The CUDA flat-scan kernel against its plain PyTorch version, on the card.

Marked `cuda`: the kernel has no CPU mode, so without a card these skip.
Run them on a GPU machine with `python -m pytest tests/test_torch_flat_scan_cuda.py -q`.

Tolerances: stage-one keys rtol 1e-4 / atol 1e-3 (float32 sums in another
order; keys reach a few hundred), group ids equal except swaps on near-equal
keys (at most 0.1%; `_check_stage1` does not count swaps between keys within
1e-6 relative of the next rank's key, float32 near-ties); final top-k id sets equal and scores within 1e-5 (stage
two is the same code on the same candidates).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zvec_tpu_torch.ops import flat_scan as fs  # noqa: E402
from zvec_tpu_torch.ops.quantize import pack_int4  # noqa: E402
from zvec_tpu_torch.ops.runtime import DEVICE_ENV, device  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flat-scan kernel has no CPU mode")
    monkeypatch.setenv(DEVICE_ENV, "cuda")  # the card, asked for: a CPU test file of the same process asks for the CPU
    device.cache_clear()
    yield torch.device("cuda")
    device.cache_clear()


def _case(ctype, metric, n=8192, d=40, nq=70, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    mask = (rng.random(n) > 0.3).astype(np.int8)
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
    sq = (deq**2).sum(1).astype(np.float32)
    norms = np.sqrt(sq) if metric == "COSINE" else sq
    kw = dict(metric=MetricType[metric], topk=10, dequant=dequant, int4_dim=int4_dim)
    return (q, codes, norms, mask), kw


def _to(dev, arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
@pytest.mark.parametrize("ctype", ["fp32", "fp16", "int8", "int4"])
def test_kernel_matches_plain(cuda, ctype, metric):
    arrays, kw = _case(ctype, metric, d=17 if ctype == "int4" else 40)
    args = _to(cuda, arrays)
    before = fs.flat_scan_topk.launches
    ks, ki = fs.flat_scan_stage1(*args, **kw)
    assert fs.flat_scan_topk.launches == before + 1
    ps, pi = fs.flat_scan_stage1(*args, plain=True, **kw)
    torch.cuda.synchronize()
    assert torch.allclose(ks, ps, rtol=1e-4, atol=1e-3)
    assert float((ki != pi).float().mean()) <= 1e-3
    fs_, fi = fs.flat_scan_topk(*args, **kw)
    gs, gi = fs.flat_scan_topk_plain(*args, **kw)
    assert (torch.sort(fi, 1).values == torch.sort(gi, 1).values).all()
    assert torch.allclose(fs_, gs, rtol=1e-5, atol=1e-5)


def test_kernel_topk_128_and_empty_rows(cuda):
    """topk = 128 (the HNSW-build shape) and a mask with fewer than k rows."""
    arrays, kw = _case("fp32", "L2", n=3072, d=16, nq=5)
    q, codes, norms, _ = _to(cuda, arrays)
    mask = torch.zeros(3072, dtype=torch.int8, device=cuda)
    mask[:3] = 1
    s, i = fs.flat_scan_topk(q, codes, norms, mask, metric=MetricType.L2, topk=128)
    assert (torch.sort(i[:, :3], 1).values == torch.arange(3, device=cuda)).all()
    assert (i[:, 3:] == -1).all()
    mask[:] = 1
    s, i = fs.flat_scan_topk(q, codes, norms, mask, metric=MetricType.L2, topk=128)
    ps, pi = fs.flat_scan_topk_plain(q, codes, norms, mask, metric=MetricType.L2, topk=128)
    assert (torch.sort(i, 1).values == torch.sort(pi, 1).values).all()


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_kernel_hnsw_build_shape(cuda, metric):
    """The HNSW build's scan (`ops/hnsw.py::knn_build_step`): Q = 2048 code
    rows against the codes, topk = knn_k + 1 = 128, TILE_N = 1024."""
    arrays, _ = _case("fp32", metric, n=16384, d=32, nq=1)
    _, codes, norms, _ = _to(cuda, arrays)
    q = codes[:2048].contiguous()
    mask = torch.ones(16384, dtype=torch.int8, device=cuda)
    kw = dict(metric=MetricType[metric], topk=128)
    assert fs.pick_tile(16384, 128) == 1024
    ks, ki = fs.flat_scan_stage1(q, codes, norms, mask, **kw)
    ps, pi = fs.flat_scan_stage1(q, codes, norms, mask, plain=True, **kw)
    torch.cuda.synchronize()
    assert ks.shape == (16, 128, 2048)
    assert torch.allclose(ks, ps, rtol=1e-4, atol=1e-3)
    assert float((ki != pi).float().mean()) <= 1e-3
    fs_, fi = fs.flat_scan_topk(q, codes, norms, mask, **kw)
    gs, gi = fs.flat_scan_topk_plain(q, codes, norms, mask, **kw)
    assert (torch.sort(fi, 1).values == torch.sort(gi, 1).values).all()
    assert torch.allclose(fs_, gs, rtol=1e-5, atol=1e-5)
    assert (fi[:, 0] == torch.arange(2048, device=cuda)).all()  # each row finds itself


def test_kernel_cosine_zero_norm_rows(cuda):
    arrays, kw = _case("fp32", "COSINE", n=2048, d=16, nq=3)
    q, codes, norms, mask = _to(cuda, arrays)
    codes[5] = 0.0
    codes[1500] = 0.0
    norms = torch.sqrt((codes * codes).sum(1))
    mask[:] = 1
    s, i = fs.flat_scan_topk(q, codes, norms, mask, **kw)
    for r in range(3):
        assert {5, 1500} <= set(i[r].tolist())
        assert float(s[r, 0]) == pytest.approx(1.0)


def _id_swaps(ids, ref_ids, ref_keys, rtol=1e-6):
    """Share of positions whose group id differs from the plain version's,
    not counting near-equal keys: those whose plain key lies within rtol of
    the key ranked next to it."""
    gap = (ref_keys[:, 1:] - ref_keys[:, :-1]).abs() <= rtol * ref_keys[:, 1:].abs()
    near = torch.zeros_like(ids, dtype=torch.bool)
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    return float(((ids != ref_ids) & ~near).float().mean())


def _check_stage1(args, kw):
    """Stage one on the card against its plain version, then the final top-k."""
    before = fs.flat_scan_topk.launches
    ks, ki = fs.flat_scan_stage1(*args, **kw)
    assert fs.flat_scan_topk.launches == before + 1
    ps, pi = fs.flat_scan_stage1(*args, plain=True, **kw)
    torch.cuda.synchronize()
    assert ks.shape == ps.shape
    assert torch.allclose(ks, ps, rtol=1e-4, atol=1e-3)
    assert _id_swaps(ki, pi, ps) <= 1e-3
    fs_, fi = fs.flat_scan_topk(*args, **kw)
    gs, gi = fs.flat_scan_topk_plain(*args, **kw)
    assert (torch.sort(fi, 1).values == torch.sort(gi, 1).values).all()
    assert torch.allclose(fs_, gs, rtol=1e-5, atol=1e-5)
    return ks, ki


@pytest.mark.parametrize("nq", [1, 5, 70, 129])
@pytest.mark.parametrize("d", [17, 40, 96, 100, 129, 201, 256, 768])
@pytest.mark.parametrize("ctype", ["fp32", "fp16", "int8", "int4"])
def test_kernel_ragged_d_and_q(cuda, ctype, d, nq):
    """Ragged contraction (D not a multiple of the 32-column chunk, rows not a
    multiple of 16 bytes) and ragged query blocks (Q not a multiple of 64);
    D above 128 streams the queries instead of keeping them resident: 129
    (one column past the limit), 201 (the MIPS-augmented text2image rows),
    256 (the +-1 HAMMING codes of 256 bits), 768."""
    metric = ["L2", "IP", "COSINE"][(d + nq) % 3]
    arrays, kw = _case(ctype, metric, n=2048, d=d, nq=nq, seed=d * 1000 + nq)
    _check_stage1(_to(cuda, arrays), kw)


def test_kernel_mips_augmented_rows(cuda):
    """The MIPS build's scan: rows of lognormal norm augmented to D = 201 by
    sqrt(max |x|^2 - |x|^2), so every row has the same norm and the L2 key
    cancels; k = 128 as the build asks."""
    from zvec_tpu_torch.ops.quantize import mips_augment

    rng = np.random.default_rng(21)
    x = rng.standard_normal((8192, 200)).astype(np.float32)
    x *= (rng.lognormal(0.0, 0.3, 8192) / np.linalg.norm(x, axis=1)).astype(np.float32)[:, None]
    xa, _ = mips_augment(x)
    q = np.ascontiguousarray(xa[:70])
    mask = np.ones(8192, np.int8)
    args = _to(cuda, (q, xa, (xa * xa).sum(1).astype(np.float32), mask))
    _check_stage1(args, dict(metric=MetricType.L2, topk=128, dequant=None, int4_dim=None))


def test_kernel_pm1_hamming_codes(cuda):
    """+-1 codes of 256 bits (HAMMING fields scan as L2): every key is an
    integer, so stage one equals its plain version exactly and the final ids
    differ only among exact ties at the k-th distance."""
    rng = np.random.default_rng(22)
    x = (rng.integers(0, 2, (8192, 256)) * 2 - 1).astype(np.float32)
    q = (rng.integers(0, 2, (70, 256)) * 2 - 1).astype(np.float32)
    q_, x_, n_, m_ = _to(cuda, (q, x, (x * x).sum(1).astype(np.float32), np.ones(8192, np.int8)))
    kw = dict(metric=MetricType.L2, topk=10, dequant=None, int4_dim=None)
    ks, _ = fs.flat_scan_stage1(q_, x_, n_, m_, **kw)
    ps, _ = fs.flat_scan_stage1(q_, x_, n_, m_, plain=True, **kw)
    assert torch.equal(ks, ps)
    fs_, fi = fs.flat_scan_topk(q_, x_, n_, m_, **kw)
    gs, gi = fs.flat_scan_topk_plain(q_, x_, n_, m_, **kw)
    assert torch.equal(fs_, gs)
    full = -((q_[:, None, :] - x_[None, :, :]) ** 2).sum(-1)  # (70, 8192) exact integers
    assert torch.equal(torch.gather(full, 1, fi), fs_)  # every returned id at its returned key


@pytest.mark.parametrize("n,topk,tile", [
    (1024, 10, 1024), (2048, 10, 2048), (4096, 10, 4096), (16384, 10, 8192),
    (8192, 1, 8192), (8192, 32, 4096), (8192, 128, 1024),
])
def test_kernel_every_tile_and_k(cuda, n, topk, tile):
    """Every TILE_N of pick_tile (a single tile at N = 1024) and k in
    {1, 10, 32, 128}."""
    arrays, kw = _case("fp32", "L2", n=n, d=64, nq=70, seed=n + topk)
    assert fs.pick_tile(n, topk) == tile
    ks, _ = _check_stage1(_to(cuda, arrays), {**kw, "topk": topk})
    assert ks.shape == (n // tile, topk, 70)


def test_kernel_tile_with_empty_mask(cuda):
    """A whole tile masked out: its keys are NEG_INF and its ids -1."""
    arrays, kw = _case("fp32", "IP", n=16384, d=64, nq=70, seed=5)
    q, codes, norms, mask = _to(cuda, arrays)
    mask[:8192] = 0
    ks, ki = _check_stage1((q, codes, norms, mask), kw)
    assert (ki[0] == -1).all() and (ks[0] <= -3e38).all()
    assert (ki[1] >= 128).all()


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_kernel_norms_near_800(cuda, metric):
    """Rows of norm ~800 around one centre: the L2 key 2*dot - ||x||^2 cancels
    ~640,000 down to the spread of the data, which one TF32 pass would not
    resolve; split TF32 must."""
    rng = np.random.default_rng(800)
    d, n, nq, sigma = 128, 8192, 64, 30.0
    centre = rng.standard_normal(d)
    centre *= np.sqrt(800.0**2 - sigma**2 * d) / np.linalg.norm(centre)
    x = (centre + sigma * rng.standard_normal((n, d))).astype(np.float32)
    q = (centre + sigma * rng.standard_normal((nq, d))).astype(np.float32)
    sq = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    norms = np.sqrt(sq) if metric == "COSINE" else sq
    mask = np.ones(n, np.int8)
    _check_stage1(_to(cuda, (q, x, norms, mask)), dict(metric=MetricType[metric], topk=10))


def test_kernel_ties_to_lower_lane_at_k128(cuda):
    """Equal group maxima within one tile: the 128 groups come out in lane
    order, as the arg-max passes and the plain version give them."""
    rng = np.random.default_rng(3)
    d, n, nq = 24, 2048, 9
    row = rng.integers(-3, 4, size=d).astype(np.float32)
    x = np.tile(row, (n, 1))
    x[1024 + 7] += 1.0  # one distinct row in tile 1
    q = rng.integers(-3, 4, size=(nq, d)).astype(np.float32)
    sq = (x**2).sum(1).astype(np.float32)
    mask = np.ones(n, np.int8)
    args = _to(cuda, (q, x, sq, mask))
    kw = dict(metric=MetricType.IP, topk=128)
    ks, ki = fs.flat_scan_stage1(*args, **kw)
    ps, pi = fs.flat_scan_stage1(*args, plain=True, **kw)
    torch.cuda.synchronize()
    assert (ki == pi).all() and torch.equal(ks, ps)
    lanes = torch.arange(128, device=cuda, dtype=torch.int32)
    assert (ki[0] == lanes[:, None]).all()
