"""The CUDA flat-scan kernel against its plain PyTorch version, on the card.

Marked `cuda`: the kernel has no CPU mode, so without a card these skip.
Run them on a GPU machine with `python -m pytest tests/test_torch_flat_scan_cuda.py -q`.

Tolerances: stage-one keys rtol 1e-4 / atol 1e-3 (float32 sums in another
order; keys reach a few hundred), group ids equal except swaps on near-equal
keys (at most 0.1%; `_check_stage1` does not count swaps between keys within
1e-6 relative of the next rank's key, float32 near-ties); final top-k id
sets equal to the plain scan's, and scores within 1e-5 of the scan whose
stage one is the plain version and whose merge and stage two are the same
kernels (`_plain_stage1_scan`: the same stage-two code on the same
candidates; the stage-two kernel is held to its plain version, whose fp32
sums run in another order, by tests/test_torch_flat_rescore_cuda.py).
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


def _plain_stage1_scan(args, kw):
    """The scan with stage one in plain PyTorch and the merge and stage two in
    their kernels: what the kernel scan gives when K1 picks the same winners."""
    ts, ti = fs.flat_scan_stage1(*args, plain=True, **kw)
    top_s, gids = fs.flat_scan_merge(ts, ti, topk=kw["topk"])
    return fs.flat_scan_rescore(*args, top_s, gids, **{k: v for k, v in kw.items() if k != "exact_tf32"})


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
    hs, _ = _plain_stage1_scan(args, kw)
    assert torch.allclose(fs_, hs, rtol=1e-5, atol=1e-5)


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
    hs, _ = _plain_stage1_scan((q, codes, norms, mask), kw)
    assert torch.allclose(fs_, hs, rtol=1e-5, atol=1e-5)
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
    hs, _ = _plain_stage1_scan(args, kw)
    assert torch.allclose(fs_, hs, rtol=1e-5, atol=1e-5)
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


# (code type, D, the copy width its rows take): ragged fp32 rows (the MIPS
# build's D = 201, the default-IP Cohere build's 769, a short 33), the GloVe-100
# width in fp16 and int8, an odd width in each, packed int4 of D = 201
RAGGED_ROWS = [("fp32", 201, 4), ("fp32", 769, 4), ("fp32", 33, 4), ("fp16", 100, 8),
               ("fp16", 101, 1), ("int8", 100, 4), ("int8", 101, 1), ("int4", 201, 1)]


@pytest.mark.parametrize("topk", [10, 128])
@pytest.mark.parametrize("ctype,d,width", RAGGED_ROWS)
def test_kernel_ragged_rows_by_copy_width(cuda, ctype, d, width, topk):
    """Rows that are not a multiple of 16 bytes reach the ring by 8- or
    4-byte asynchronous copies, or byte loads where the stride is not a
    multiple of 4 bytes; the int8 and int4 cases carry their dequant."""
    metric = ["L2", "IP", "COSINE"][d % 3]
    arrays, kw = _case(ctype, metric, n=8192, d=d, nq=70, seed=d + topk)
    args = _to(cuda, arrays)
    codes = args[1]
    assert fs.copy_bytes(codes.shape[1] * codes.element_size(), codes.data_ptr()) == width
    _check_stage1(args, {**kw, "topk": topk})


@pytest.mark.parametrize("ctype,d", [("fp32", 202), ("fp16", 100), ("int8", 104)])
@pytest.mark.parametrize("forced", [4, 1])
def test_kernel_copy_width_leaves_keys_bitwise(cuda, monkeypatch, ctype, d, forced):
    """How the bytes reach shared memory changes nothing else: keys and ids
    with the copy width forced narrower equal those of the widest (8 bytes
    here) bit for bit."""
    arrays, kw = _case(ctype, "L2", n=8192, d=d, nq=70, seed=d)
    args = _to(cuda, arrays)
    codes = args[1]
    assert fs.copy_bytes(codes.shape[1] * codes.element_size(), codes.data_ptr()) == 8
    ks, ki = fs.flat_scan_stage1(*args, **kw)
    monkeypatch.setattr(fs, "copy_bytes", lambda row_bytes, ptr: forced)
    fks, fki = fs.flat_scan_stage1(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ks, fks) and torch.equal(ki, fki)


def test_kernel_refuses_a_copy_width_the_rows_do_not_allow(cuda, monkeypatch):
    """16-byte copies of 804-byte rows: the entry point returns
    cudaErrorInvalidValue and the wrapper raises, counting no launch."""
    arrays, kw = _case("fp32", "L2", n=2048, d=201, nq=5)
    args = _to(cuda, arrays)
    monkeypatch.setattr(fs, "copy_bytes", lambda row_bytes, ptr: 16)
    before = fs.flat_scan_topk.launches
    with pytest.raises(RuntimeError, match="cudaError 1 "):
        fs.flat_scan_stage1(*args, **kw)
    assert fs.flat_scan_topk.launches == before


def test_kernel_misaligned_codes_view(cuda):
    """Codes that start 4 bytes into their storage: 4-byte copies of 512-byte
    rows, the same answer as the plain version."""
    arrays, kw = _case("fp32", "IP", n=4096, d=128, nq=70, seed=9)
    q, codes, norms, mask = _to(cuda, arrays)
    base = torch.empty(codes.numel() + 1, device=cuda)
    view = base[1:].view(codes.shape)
    view.copy_(codes)
    assert view.data_ptr() % 16 == 4 and fs.copy_bytes(512, view.data_ptr()) == 4
    _check_stage1((q, view, norms, mask), kw)


@pytest.mark.parametrize("d", [96, 256, 264, 512])
def test_kernel_one_pass_on_pm1_codes(cuda, d):
    """The one-TF32-product instance (`exact_tf32`) on +-1 codes and queries,
    with zero rows padding both as the engines pad them and a mask: the keys,
    ids and final top-k equal the plain fp32 version's exactly. D = 256 keeps
    the queries resident, 264 and 512 stream them."""
    rng = np.random.default_rng(d)
    n, nq = 16384, 130
    x = (rng.integers(0, 2, (n, d)) * 2 - 1).astype(np.float32)
    x[n - 700:] = 0.0
    q = (rng.integers(0, 2, (nq, d)) * 2 - 1).astype(np.float32)
    q[nq - 3:] = 0.0
    mask = (np.arange(n) < n - 700).astype(np.int8)
    mask[rng.random(n) < 0.2] = 0
    args = _to(cuda, (q, x, (x * x).sum(1).astype(np.float32), mask))
    for topk in (10, 128):
        kw = dict(metric=MetricType.L2, topk=topk, exact_tf32=True)
        before = fs.flat_scan_topk.launches
        ks, ki = fs.flat_scan_stage1(*args, **kw)
        assert fs.flat_scan_topk.launches == before + 1
        ps, pi = fs.flat_scan_stage1(*args, plain=True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(ks, ps) and torch.equal(ki, pi)
        fs_, fi = fs.flat_scan_topk(*args, **kw)
        gs, gi = fs.flat_scan_topk_plain(*args, **kw)
        assert torch.equal(fs_, gs) and torch.equal(fi, gi)
