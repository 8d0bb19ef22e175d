"""The flat scan's merge kernel (`csrc/flat_merge.cu`) against its plain
PyTorch version `_merge_plain`, on the card.

Marked `cuda`: the kernel has no CPU mode, so without a card these skip.
Run them on a GPU machine with
`python -m pytest --noconftest tests/test_torch_flat_merge_cuda.py -q`.

Tolerance: none. The kernel must give the plain version's keys and int64
group ids bit for bit: the same positions picked in the same order (key
descending, equal keys by the lower tile * k + rank position, -0.0 as +0.0),
each key copied with its sign bit. Inputs: stage one's contract made from
random group maxima (the CPU file's cases: gaussian keys, a handful of
values, +-0.0, NEG_INF padding with fewer valid groups than k; k 1 / 10 /
128, one tile and many, Q not a multiple of 8), K1's real outputs, keys of a
handful of values over many tiles, and P = 1.25M keys a query (the 10M-row
build's shape).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zvec_tpu_torch.ops import flat_scan as fs  # noqa: E402
from zvec_tpu_torch.ops.runtime import DEVICE_ENV, NEG_INF, device, topk_desc  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402

pytestmark = pytest.mark.cuda

LANES = 128


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the merge kernel has no CPU mode")
    monkeypatch.setenv(DEVICE_ENV, "cuda")  # the card, asked for: a CPU test file of the same process asks for the CPU
    device.cache_clear()
    yield torch.device("cuda")
    device.cache_clear()


def _tiles(case, n_tiles, k, nq, dev, seed=0):
    """(n_tiles, k, Q) keys and int32 ids as stage one writes them, from
    random group maxima: each tile's top-k by `topk_desc`, id -1 on NEG_INF."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (n_tiles, nq, LANES)
    if case == "gauss":
        gm = torch.randn(shape, generator=g, device=dev)
    elif case == "ties":
        vals = torch.tensor([-3.0, -1.0, 0.5, 2.0], device=dev)
        gm = vals[torch.randint(0, 4, shape, generator=g, device=dev)]
    elif case == "zeros":
        vals = torch.tensor([0.0, -0.0, 1.0, -1.0, -0.0], device=dev)
        gm = vals[torch.randint(0, 5, shape, generator=g, device=dev)]
    else:  # padding: query q keeps about q valid groups in all
        gm = torch.randn(shape, generator=g, device=dev)
        keep = torch.rand(shape, generator=g, device=dev) < (
            torch.arange(nq, device=dev, dtype=torch.float64)[None, :, None] / (n_tiles * LANES))
        gm = torch.where(keep, gm, torch.full_like(gm, NEG_INF))
    m, lane = topk_desc(gm, k)
    base = torch.arange(n_tiles, device=dev)[:, None, None] * LANES
    ids = torch.where(m > NEG_INF / 2, lane + base, torch.full_like(lane, -1))
    return m.permute(0, 2, 1).contiguous(), ids.permute(0, 2, 1).to(torch.int32).contiguous()


def _bitwise(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:  # compare the bits: -0.0 is not +0.0 here
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _check(ts, ti, k):
    before = fs.flat_scan_merge.launches
    ks, ki = fs.flat_scan_merge(ts, ti, topk=k)
    assert fs.flat_scan_merge.launches == before + 1
    ps, pi = fs._merge_plain(ts, ti, k)
    assert fs.flat_scan_merge.launches == before + 1
    torch.cuda.synchronize()
    assert ks.shape == (ts.shape[2], k) and ki.dtype == torch.int64
    assert _bitwise(ks, ps), "keys differ"
    assert _bitwise(ki, pi), "ids differ"


@pytest.mark.parametrize("nq", [1, 37])
@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("n_tiles", [1, 37, 130])
@pytest.mark.parametrize("case", ["gauss", "ties", "zeros", "padding"])
def test_merge_kernel_bitwise(cuda, case, n_tiles, k, nq):
    ts, ti = _tiles(case, n_tiles, k, nq, cuda, seed=n_tiles * 1000 + k + nq)
    _check(ts, ti, k)


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
@pytest.mark.parametrize("k", [10, 128])
def test_merge_kernel_on_k1_output(cuda, metric, k):
    """On K1's own output, rows repeated so that keys tie across tiles, zero
    rows, a zero query and a 30% mask; then the whole scan launches both
    kernels once and equals the scan with the plain merge."""
    rng = np.random.default_rng(5)
    n, d, nq = 65536, 40, 70
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[rng.random(n) < 0.05] = 0.0
    x[1::97] = x[0]
    q = rng.standard_normal((nq, d)).astype(np.float32)
    q[7] = 0.0
    mask = (rng.random(n) > 0.3).astype(np.int8)
    sq = (x**2).sum(1).astype(np.float32)
    norms = np.sqrt(sq) if metric == "COSINE" else sq
    args = [torch.from_numpy(a).to(cuda) for a in (q, x, norms, mask)]
    kw = dict(metric=MetricType[metric], topk=k)
    ts, ti = fs.flat_scan_stage1(*args, **kw)
    _check(ts, ti, k)
    k1, mg = fs.flat_scan_topk.launches, fs.flat_scan_merge.launches
    s, i = fs.flat_scan_topk(*args, **kw)
    assert (fs.flat_scan_topk.launches, fs.flat_scan_merge.launches) == (k1 + 1, mg + 1)
    # stage two after the merge is the same code: the plain merge of the
    # same stage one gives the same answer
    ps, pi = fs._merge_plain(ts, ti, k)
    ks, ki = fs.flat_scan_merge(ts, ti, topk=k)
    assert _bitwise(ks, ps) and _bitwise(ki, pi)
    assert torch.isfinite(s[i >= 0]).all()


@pytest.mark.parametrize("k", [10, 128])
def test_merge_kernel_handful_of_values_many_tiles(cuda, k):
    """Keys from four values over 977 tiles (the 1M build's tile count): the
    bound L and the threshold T both sit on huge runs of equal keys."""
    ts, ti = _tiles("ties", 977, k, 64, cuda, seed=3)
    _check(ts, ti, k)


def test_merge_kernel_at_10m_rows(cuda):
    """P = 9,766 tiles x 128 = 1.25M keys a query (10M rows, tile 1024,
    k 128), Q 16, gaussian keys sorted per tile, and the same with four
    values."""
    n_tiles, k, nq = 9766, 128, 16
    g = torch.Generator(device=cuda).manual_seed(9)
    for vals in (None, torch.tensor([-2.0, -0.0, 0.0, 1.0], device=cuda)):
        raw = (torch.randn((n_tiles, k, nq), generator=g, device=cuda) if vals is None
               else vals[torch.randint(0, 4, (n_tiles, k, nq), generator=g, device=cuda)])
        ts, order = torch.sort(raw, dim=1, descending=True, stable=True)
        ti = (order + torch.arange(n_tiles, device=cuda)[:, None, None] * LANES).to(torch.int32)
        _check(ts.contiguous(), ti.contiguous(), k)


def test_merge_kernel_rejects_bad_inputs(cuda):
    ts, ti = _tiles("gauss", 3, 10, 5, cuda)
    strided = (ts.transpose(0, 2).contiguous().transpose(0, 2), ti.transpose(0, 2).contiguous().transpose(0, 2))
    for bad in ((ts.double(), ti), (ts, ti.long()), (ts[:, :5], ti[:, :5]), strided, (ts.cpu(), ti)):
        with pytest.raises(ValueError):
            fs._merge_kernel(*bad, 10)
