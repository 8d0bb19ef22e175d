"""The CUDA flat-scan kernel against its plain PyTorch version, on the card.

Marked `cuda`: the kernel has no CPU mode, so without a card these skip.
Run them on a GPU machine with `python -m pytest tests/test_torch_flat_scan_cuda.py -q`.

Tolerances: stage-one keys rtol 1e-4 / atol 1e-3 (float32 sums in another
order; keys reach a few hundred), group ids equal except swaps on near-equal
keys (at most 0.1%); final top-k id sets equal and scores within 1e-5 (stage
two is the same code on the same candidates).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zvec_tpu_torch.ops import flat_scan as fs  # noqa: E402
from zvec_tpu_torch.ops.quantize import pack_int4  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flat-scan kernel has no CPU mode")
    return torch.device("cuda")


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
