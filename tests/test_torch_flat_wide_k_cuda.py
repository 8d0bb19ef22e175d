"""The fused flat scan at k = 100 and 128 on int8 codes at D = 96 (Deep10M's
width) over 262,144 rows, on the card: the refine's overscan of an INT8
FLAT index, which `core/flat.py::kernel_takes` sends to the kernels for k up
to 128.

- K1 against its plain stage one (keys rtol 1e-4 / atol 1e-3, group ids
  equal outside near-equal keys), the merge kernel bit for bit against
  `_merge_plain` on K1's output, stage two against `_rescore_plain` on the
  merge's winners (scores rtol / atol 1e-4, ids outside near-ties), and the
  whole scan's ids against the plain scan's;
- the scan in three chunks of 128-query blocks (the budget of stage one's
  output patched) bit for bit what one chunk returns;
- `FlatEngine` with the default refine at topk 10: one call counts
  `zvec.scans_wide_k` 1 and no `zvec.scan_blocks`; its refined answers equal
  those of the blockwise route, and its 100 candidates equal the blockwise
  scan's outside near-ties.

Marked `cuda`: the kernels have no CPU mode, so without a card these skip.
Run them on a GPU machine with
`python -m pytest --noconftest tests/test_torch_flat_wide_k_cuda.py -q`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zvec_tpu_torch.ops import flat_scan as fs  # noqa: E402
from zvec_tpu_torch.ops.runtime import DEVICE_ENV, NEG_INF, device  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402

pytestmark = pytest.mark.cuda
N, D, NQ = 262_144, 96, 300
TIE_RTOL = 1e-5  # ids may differ where scores lie this close (relative)


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flat-scan kernels have no CPU mode")
    monkeypatch.setenv(DEVICE_ENV, "cuda")  # the card, asked for: a CPU test file of the same process asks for the CPU
    device.cache_clear()
    yield torch.device("cuda")
    device.cache_clear()


def _int8_rows(n=N, nq=NQ, seed=96):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    q = rng.standard_normal((nq, D)).astype(np.float32)
    return x, q


def _scan_args(dev, seed=96):
    x, q = _int8_rows(seed=seed)
    scale, bias = float((x.max() - x.min()) / 254), float((x.max() + x.min()) / 2)
    codes = np.clip(np.round((x - bias) / scale), -127, 127).astype(np.int8)
    norms = ((codes.astype(np.float64) * scale + bias) ** 2).sum(1).astype(np.float32)
    mask = (np.random.default_rng(seed + 1).random(N) > 0.1).astype(np.int8)
    args = [torch.from_numpy(a).to(dev) for a in (q, codes, norms, mask)]
    return args, dict(metric=MetricType.L2, dequant=(scale, bias))


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
        bad += any(abs(v - kth) > TIE_RTOL * max(abs(kth), 1.0) for v in extra)
    return bad


def _id_swaps(ids, ref_ids, ref_keys, rtol=1e-6):
    """Share of stage one's group ids that differ from the plain version's,
    not counting keys within rtol of the key ranked next to them."""
    gap = (ref_keys[:, 1:] - ref_keys[:, :-1]).abs() <= rtol * ref_keys[:, 1:].abs()
    near = torch.zeros_like(ids, dtype=torch.bool)
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    return float(((ids != ref_ids) & ~near).float().mean())


@pytest.mark.parametrize("k", [100, 128])
def test_the_kernels_at_wide_k_on_int8_codes(cuda, k):
    args, kw = _scan_args(cuda)
    kw = {**kw, "topk": k}
    assert fs.pick_tile(N, k) == 1024
    launches = (fs.flat_scan_topk.launches, fs.flat_scan_merge.launches, fs.flat_scan_rescore.launches)
    ks, ki = fs.flat_scan_stage1(*args, **kw)
    ps, pi = fs.flat_scan_stage1(*args, plain=True, **kw)
    torch.cuda.synchronize()
    assert ks.shape == ps.shape == (N // 1024, k, NQ)
    assert torch.allclose(ks, ps, rtol=1e-4, atol=1e-3)
    assert _id_swaps(ki, pi, ps) <= 1e-3
    top_s, gids = fs.flat_scan_merge(ks, ki, topk=k)
    ms, mi = fs._merge_plain(ks, ki, k)
    assert torch.equal(top_s, ms) and torch.equal(gids, mi)
    qf, nrm, pargs, pkw = fs._prepare(*args, kw["metric"], k, kw["dequant"], None)
    rargs, rkw = fs._rescore_inputs(qf, nrm, pargs, pkw, kw["dequant"])
    rs, ri = fs._rescore_kernel(*rargs, top_s, gids, **rkw)
    ps2, pi2 = fs._rescore_plain(*rargs, top_s, gids, **rkw)
    assert ((ri < 0) == (rs <= NEG_INF / 2)).all()
    assert torch.allclose(rs, ps2, rtol=1e-4, atol=1e-4) and _near_ties_only(rs, ri, ps2, pi2) == 0
    s, i = fs.flat_scan_topk(*args, **kw)
    assert torch.equal(s, rs) and torch.equal(i, ri)  # the same three launches: deterministic
    assert (fs.flat_scan_topk.launches, fs.flat_scan_merge.launches, fs.flat_scan_rescore.launches) == tuple(
        c + n for c, n in zip(launches, (2, 2, 2)))
    gs, gi = fs.flat_scan_topk_plain(*args, **kw)
    assert torch.allclose(s, gs, rtol=1e-4, atol=1e-4) and _near_ties_only(s, i, gs, gi) == 0


def test_three_query_chunks_answer_as_one(cuda, monkeypatch):
    args, kw = _scan_args(cuda, seed=7)
    one = fs.flat_scan_topk(*args, topk=100, **kw)
    per_block = (N // 1024) * 100 * 128 * 8
    monkeypatch.setattr(fs, "_scratch_budget", lambda dev: per_block)
    before = fs.flat_scan_topk.launches
    got = fs.flat_scan_topk(*args, topk=100, **kw)
    assert fs.flat_scan_topk.launches == before + 3  # 128 + 128 + 44 queries
    assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])


def test_the_engine_takes_the_fused_scan_for_the_overscan(cuda):
    import zvec_tpu_torch as zt
    from torch.profiler import ProfilerActivity, profile
    from zvec_tpu_torch.core.flat import FlatEngine
    from zvec_tpu_torch.model.param.param import FlatQueryParam
    from zvec_tpu_torch.utils import profiler as P

    x, q = _int8_rows(seed=3)
    param = zt.FlatIndexParam(zt.MetricType.L2, zt.QuantizeType.INT8)
    fused, blockwise = (FlatEngine(zt.MetricType.L2, D, param) for _ in range(2))
    for eng in (fused, blockwise):
        eng.bind_data(lambda: x, lambda: 0)
    blockwise._use_kernel = lambda st, k: False
    fused.search(q[:1], 10, None, FlatQueryParam())  # the codes on the card, outside the count
    before = P.counter_totals()
    with profile(activities=[ProfilerActivity.CPU]):
        got = fused.search(q, 10, None, FlatQueryParam())
    after = P.counter_totals()
    grew = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    assert fused._st.codes.is_cuda and fused._st.codes.dtype == torch.int8
    assert grew["zvec.scans_wide_k"] == 1 and grew.get("zvec.scan_blocks", 0) == 0
    want = blockwise.search(q, 10, None, FlatQueryParam())
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    scan_only = FlatQueryParam(is_using_refiner=False)
    cs, ci = (torch.from_numpy(a) for a in fused.search(q, 100, None, scan_only))
    bs, bi = (torch.from_numpy(a) for a in blockwise.search(q, 100, None, scan_only))
    assert torch.allclose(cs, bs, rtol=1e-4, atol=1e-4) and _near_ties_only(cs, ci, bs, bi) == 0
