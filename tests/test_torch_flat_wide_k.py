"""The fused flat scan at 32 < k <= 128, on the CPU.

`core/flat.py::kernel_takes` sends a FLAT scan on the card to the fused
kernels (stage one, the merge, stage two) for every k up to the kernels'
128 lanes, so the refine's overscan (10 x topk) takes them too; the
blockwise torch scan keeps k > 128, small corpora and CPU tensors. Here the
engine's rule runs on codes taken as on the card (`_card_rule`) with N rows
counted as a large corpus, and the fused route on CPU tensors runs the plain
stage one, merge and stage two.
Held here:

- the fused route's answers to the blockwise route's, on int8, int4 and
  fp16 codes with the refine on at topk 10 (scan k 100) and fp32 at k 100
  and 128, without a mask, under a mask that half the rows pass and on the
  compact route (a mask that 250 rows pass): the scan's ids equal outside
  near-ties and its scores within float32 rounding; the refined answers
  equal. The fused call counts `zvec.scans_wide_k` 1 and no
  `zvec.scan_blocks`;
- the chunking of `ops/flat_scan.py`: with the budget of stage one's output
  patched to force two, three and four chunks of whole 128-query blocks,
  ragged batches among them, `flat_scan_topk` returns bit for bit what one
  chunk returns (ids equal and scores within float32 rounding where a chunk
  holds one query, whose product the CPU runs as a matrix-vector product),
  and no chunk's stage-one output passes the budget;
- a budget below one 128-query block: `kernel_takes` refuses the scan and
  the engine takes the blockwise route.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import zvec_tpu_torch as zt  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from zvec_tpu_torch.core import flat  # noqa: E402
from zvec_tpu_torch.model.param.param import FlatQueryParam  # noqa: E402
from zvec_tpu_torch.ops import flat_scan as fs  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402
from zvec_tpu_torch.utils import profiler as P  # noqa: E402

N, D, NQ = 3000, 48, 24
TIE_TOL = 1e-5  # a differing id is a near-tie when its score lies this close to the other's (relative)

CODES = {  # name: (quantize type, refiner, topk); the scan's k is 10 x topk with the refiner
    "int8_refined": ("INT8", True, 10),
    "int4_refined": ("INT4", True, 10),
    "fp16_refined": ("FP16", True, 10),
    "fp32_k100": ("UNDEFINED", False, 100),
    "fp32_k128": ("UNDEFINED", False, 128),
}


@pytest.fixture(autouse=True)
def large(monkeypatch):
    """N rows count as a large corpus: the rule's size test passes, and the
    rows pad to the largest scan tile, as a large corpus's do."""
    monkeypatch.setattr(flat, "_BIG_N", N)


def _card_rule(st, k):
    """`kernel_takes` on the engine's snapshot, its codes taken as on the card."""
    codes = SimpleNamespace(dtype=st.codes.dtype, is_cuda=True, shape=tuple(st.codes.shape),
                            device=st.codes.device)
    return flat.kernel_takes(codes, st.dequant, st.n, k)


def _engine(x, quant, fused):
    eng = flat.FlatEngine(zt.MetricType.L2, D, zt.FlatIndexParam(zt.MetricType.L2, zt.QuantizeType[quant]))
    eng.bind_data(lambda: x, lambda: 0)
    eng._use_kernel = _card_rule if fused else (lambda st, k: False)
    return eng


def _data(mask_kind, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((NQ, D)).astype(np.float32)
    mask = {
        "none": None,
        "half": rng.random(N) < 0.5,
        "compact": np.isin(np.arange(N), rng.choice(N, 250, replace=False)),
    }[mask_kind]
    return x, q, mask


def _counted(fn):
    before = P.counter_totals()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    after = P.counter_totals()
    return out, {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _held(got, want):
    """The fused scan's (scores, ids) against the blockwise scan's: scores
    within float32 rounding, and where the ids differ, near-equal scores."""
    (gs, gi), (ws, wi) = got, want
    assert gi.shape == wi.shape
    np.testing.assert_array_equal(gi >= 0, wi >= 0)
    valid = wi >= 0
    np.testing.assert_allclose(gs[valid], ws[valid], rtol=1e-5, atol=1e-4)
    kth = np.maximum(np.abs(np.where(valid, ws, 0.0)).max(1, keepdims=True), 1.0)
    differ = gi != wi
    assert (np.abs(gs - ws)[differ & valid] <= TIE_TOL * np.broadcast_to(kth, gs.shape)[differ & valid]).all()
    assert differ.mean() < 0.02
    for row in gi:  # no row twice
        assert len(set(row[row >= 0])) == (row >= 0).sum()


@pytest.mark.parametrize("mask_kind", ["none", "half", "compact"])
@pytest.mark.parametrize("codes", list(CODES))
def test_the_fused_route_answers_as_the_blockwise_route(codes, mask_kind):
    quant, refiner, topk = CODES[codes]
    x, q, mask = _data(mask_kind, seed=len(codes) * 10 + len(mask_kind))
    fused, blockwise = _engine(x, quant, True), _engine(x, quant, False)
    scan_k = 10 * topk if refiner else topk
    param = FlatQueryParam(is_using_refiner=refiner)
    got, counters = _counted(lambda: fused.search(q, topk, mask, param))
    want = blockwise.search(q, topk, mask, param)
    assert counters["zvec.scans_wide_k"] == 1 and "zvec.scan_blocks" not in counters
    assert counters["zvec.rows_scored"] == (1024 if mask_kind == "compact" else fused._st.n_pad)
    if refiner:  # the refined answers equal; the scan alone, its 100 candidates, held as below
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
        scan_only = FlatQueryParam(is_using_refiner=False)
        got, want = fused.search(q, scan_k, mask, scan_only), blockwise.search(q, scan_k, mask, scan_only)
    _held(got, want)
    n_pass = N if mask is None else int(mask.sum())
    assert ((got[1] >= 0).sum(1) == min(scan_k, n_pass)).all()
    if mask is not None:
        assert mask[got[1][got[1] >= 0]].all()


def _scan_args(n, nq, seed=11):
    """int8 codes at the width of Deep10M under a mask, with their dequant."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 96)).astype(np.float32)
    scale, bias = float((x.max() - x.min()) / 254), float((x.max() + x.min()) / 2)
    codes = np.clip(np.round((x - bias) / scale), -127, 127).astype(np.int8)
    norms = ((codes.astype(np.float32) * scale + bias) ** 2).sum(1).astype(np.float32)
    mask = (rng.random(n) > 0.2).astype(np.int8)
    q = rng.standard_normal((nq, 96)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (q, codes, norms, mask)]
    return args, dict(metric=MetricType.L2, dequant=(scale, bias))


@pytest.mark.parametrize("nq,blocks,chunks", [(256, 1, 2), (300, 2, 2), (300, 1, 3), (385, 1, 4)])
def test_query_chunks_answer_as_one_chunk(monkeypatch, nq, blocks, chunks):
    n, k = 8192, 100
    args, kw = _scan_args(n, nq)
    one_s, one_i = fs.flat_scan_topk(*args, topk=k, **kw)  # the host's budget: one chunk
    per_block = (n // fs.pick_tile(n, k)) * k * 128 * 8  # stage one's bytes for 128 queries
    budget = blocks * per_block + per_block // 2  # a part of a block more buys nothing
    monkeypatch.setattr(fs, "_scratch_budget", lambda dev: budget)
    assert fs.query_chunk(n, k, torch.device("cpu")) == 128 * blocks
    outputs = []
    stage1 = fs._stage1

    def recorded(args, kw, plain):
        out = stage1(args, kw, plain)
        outputs.append((args[0].shape[0], sum(t.numel() * t.element_size() for t in out)))
        return out

    monkeypatch.setattr(fs, "_stage1", recorded)
    got_s, got_i = fs.flat_scan_topk(*args, topk=k, **kw)
    assert [q for q, _ in outputs] == [min(128 * blocks, nq - c) for c in range(0, nq, 128 * blocks)]
    assert len(outputs) == chunks and all(b <= budget for _, b in outputs)
    assert torch.equal(got_i, one_i)
    if nq % (128 * blocks) == 1:
        # a chunk of one query: the CPU's product of one row is BLAS's
        # matrix-vector kernel, whose float32 sums run in another order
        torch.testing.assert_close(got_s, one_s, rtol=1e-6, atol=1e-5)
    else:
        assert torch.equal(got_s, one_s)


def test_a_budget_below_one_block_sends_the_scan_blockwise(monkeypatch):
    x, q, _ = _data("none", seed=4)
    quant, refiner, topk = CODES["int8_refined"]
    param = FlatQueryParam(is_using_refiner=refiner)
    eng = _engine(x, quant, True)
    want, counters = _counted(lambda: eng.search(q, topk, None, param))
    assert counters["zvec.scans_wide_k"] == 1 and "zvec.scan_blocks" not in counters
    n_pad = eng._st.n_pad
    per_block = (n_pad // fs.pick_tile(n_pad, 100)) * 100 * 128 * 8
    monkeypatch.setattr(fs, "_scratch_budget", lambda dev: per_block - 1)
    assert not _card_rule(eng._st, 100) and _card_rule(eng._st, 10)  # top-10 alone still fits
    got, counters = _counted(lambda: eng.search(q, topk, None, param))
    assert "zvec.scans_wide_k" not in counters
    assert counters["zvec.scan_blocks"] == -(-n_pad // flat._BLOCK_SIZE)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    codes, norms, mask = eng._st.codes, eng._st.norms, torch.ones(n_pad, dtype=torch.int8)
    with pytest.raises(ValueError, match="exceeds its budget"):  # the scan itself refuses it too
        fs.flat_scan_topk(torch.from_numpy(q), codes, norms, mask, metric=MetricType.L2, topk=100,
                          dequant=eng._st.dequant)
