"""The compact route of the fused flat scan, on the CPU.

`FlatEngine._search_dispatch` on the fused route (no mesh), under a mask
that lets through at most `brute_force_by_keys_ratio` of the rows, gathers
the passing rows' codes and norms into a buffer of n_pass rows rounded up to
1024, scans that with `flat_scan_topk` (here its plain stage one, merge and
stage two: `_use_kernel` is patched, as the card would take the kernels) and
maps the positions back to row ids through the row list. Held here:

- to the same engine's masked scan of every row (the ratio set to 0):
  scores equal, and ids equal or naming equal rows, on fp32 L2, fp16, int8
  (refiner off, and on at topk 3: a scan_k of 30, which the fused route
  takes as it takes every k up to 128, so the refiner sees row ids) and
  COSINE codes, for pass sets at the end of the rows, a random 1%, rows of
  one tile only, fewer than topk rows, none, and exact ties (pairs of equal
  rows). Of two rows with one score both scans return the one whose winner
  group ranks first, then the lower position in it: the position in the
  scanned buffer, so the two layouts may name different rows of a tie;
- to `zvec_tpu`'s `flat_scan_topk` (the Pallas kernel in interpret mode)
  over the engine's padded codes under the same mask: ids equal outside
  near-ties and equal rows, scores within 1e-4;
- by its counters: `zvec.scans_compacted` +1 and `zvec.rows_scored` = n_c on
  the compact route; 0 and n_pad unfiltered and where 90% of the rows pass;
  a mask-cache hit does not compute the row list again.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)
import jax.numpy as jnp  # noqa: E402

import zvec_tpu_torch as zt  # noqa: E402
from zvec_tpu_torch.model.param.param import FlatQueryParam  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from zvec_tpu.ops.flat_pallas import flat_scan_topk as jax_scan  # noqa: E402
from zvec_tpu.typing import MetricType as JMetric  # noqa: E402
from zvec_tpu_torch.core import flat  # noqa: E402
from zvec_tpu_torch.utils import profiler as P  # noqa: E402
from zvec_tpu_torch.utils.config import GlobalConfig  # noqa: E402

N, N_PAD, D, NQ, K = 3000, 3072, 48, 16, 10
TIE_TOL = 1e-5  # a differing id is a near-tie when its exact score lies this close (relative)

CODES = {  # name: (metric, quantize type, refiner, topk)
    "fp32_l2": ("L2", "UNDEFINED", False, K),
    "fp16_l2": ("L2", "FP16", False, K),
    "int8_l2": ("L2", "INT8", False, K),
    "cosine": ("COSINE", "UNDEFINED", False, K),
    "int8_refined": ("L2", "INT8", True, 3),
}


def _pass_set(kind, rng):
    rows = {
        "tail": np.arange(N - N // 100, N),
        "random": rng.choice(N, N // 100, replace=False),
        "one_tile": rng.choice(np.arange(1024, 2048), 200, replace=False),
        "fewer_than_k": rng.choice(N, 5, replace=False),
        "none": np.array([], np.int64),
        "ties": rng.choice(N, 60, replace=False),
    }[kind]
    mask = np.zeros(N, bool)
    mask[rows] = True
    return mask


def _data(kind, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    mask = _pass_set(kind, rng)
    if kind == "ties":  # every second passing row repeats the one before it
        rows = np.flatnonzero(mask)
        x[rows[1::2]] = x[rows[0::2]]
    return x, rng.standard_normal((NQ, D)).astype(np.float32), mask


def _engine(x, codes):
    metric, quant, _, _ = CODES[codes]
    eng = flat.FlatEngine(zt.MetricType[metric], D,
                          zt.FlatIndexParam(zt.MetricType[metric], zt.QuantizeType[quant]))
    eng.bind_data(lambda: x, lambda: 0)
    eng._use_kernel = lambda st, k: True  # the fused branch, its plain versions on CPU tensors
    return eng


def _search(eng, q, mask, codes):
    _, _, refiner, topk = CODES[codes]
    return eng.search(q, topk, mask, FlatQueryParam(is_using_refiner=refiner))


def _same_rows(x, a, b):
    """(Q, k) bools: ids `a` and `b` equal, or both name rows that hold the
    same vector."""
    both = (a >= 0) & (b >= 0)
    equal_rows = (x[np.maximum(a, 0)] == x[np.maximum(b, 0)]).all(-1)
    return (a == b) | (both & equal_rows)


def _compacted(eng):
    (entry,) = eng._mask_cache.values()
    return entry.rows is not None


@pytest.mark.parametrize("kind", ["tail", "random", "one_tile", "fewer_than_k", "none", "ties"])
@pytest.mark.parametrize("codes", list(CODES))
def test_compact_scan_equals_the_full_masked_scan(monkeypatch, codes, kind):
    x, q, mask = _data(kind, seed=len(codes) * 10 + len(kind))
    cfg = GlobalConfig.instance()
    compact = _engine(x, codes)
    got_s, got_i = _search(compact, q, mask, codes)
    monkeypatch.setattr(cfg, "brute_force_by_keys_ratio", 0.0)  # every non-empty pass set: the full scan
    full = _engine(x, codes)
    want_s, want_i = _search(full, q, mask, codes)
    assert _compacted(compact) and _compacted(full) == (kind == "none")
    topk = CODES[codes][3]
    assert got_i.shape == want_i.shape == (NQ, topk)
    np.testing.assert_array_equal(got_s, want_s)
    assert _same_rows(x, got_i, want_i).all()
    if kind != "ties":
        np.testing.assert_array_equal(got_i, want_i)
    n_pass = int(mask.sum())
    assert ((got_i >= 0).sum(1) == min(topk, n_pass)).all()
    assert mask[got_i[got_i >= 0]].all()
    assert all(len(set(row[row >= 0])) == (row >= 0).sum() for row in got_i)  # no row twice


JAX_CASES = [("fp32_l2", "random"), ("int8_l2", "tail"), ("cosine", "one_tile"), ("fp16_l2", "ties")]


@pytest.mark.parametrize("codes,kind", JAX_CASES, ids=[f"{c}-{k}" for c, k in JAX_CASES])
def test_compact_scan_against_jax(codes, kind):
    x, q, mask = _data(kind, seed=7 + len(kind))
    eng = _engine(x, codes)
    got_s, got_i = _search(eng, q, mask, codes)
    assert _compacted(eng)
    st = eng._st
    norms = st.norms.numpy()
    if CODES[codes][0] == "COSINE":
        norms = np.sqrt(norms)
    full_mask = np.zeros(st.n_pad, np.int8)
    full_mask[:N] = mask
    js, ji = jax_scan(jnp.asarray(q), jnp.asarray(st.codes.numpy()), jnp.asarray(norms), jnp.asarray(full_mask),
                      metric=JMetric[CODES[codes][0]], topk=K, dequant=st.dequant)
    js, ji = np.asarray(js), np.asarray(ji)
    assert ((ji >= 0) == (got_i >= 0)).all()
    np.testing.assert_allclose(got_s, js, rtol=1e-4, atol=1e-4)
    differ = ~_same_rows(x, got_i, ji)
    kth = np.abs(js[:, -1:]).repeat(K, 1)
    assert (np.abs(got_s - js)[differ] <= TIE_TOL * np.maximum(kth, 1.0)[differ]).all()  # near-ties only
    assert differ.mean() < 0.05


def _counters(fn):
    before = P.counter_totals()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    after = P.counter_totals()
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


@pytest.mark.parametrize("share,compacted,scored", [(0.01, 1, 1024), (None, 0, N_PAD), (0.9, 0, N_PAD)],
                         ids=["one_percent", "unfiltered", "ninety_percent"])
def test_counters_name_the_route(share, compacted, scored):
    x, q, _ = _data("tail", seed=3)
    mask = None if share is None else np.arange(N) >= int((1 - share) * N)
    eng = _engine(x, "fp32_l2")
    got = _counters(lambda: _search(eng, q, mask, "fp32_l2"))
    assert got.get("zvec.scans_compacted", 0) == compacted
    assert got.get("zvec.rows_scored") == scored


def test_a_mask_cache_hit_keeps_the_row_list(monkeypatch):
    x, q, mask = _data("random", seed=5)
    built = []

    def counting(*args):
        built.append(args[1])
        return compact_mask(*args)

    compact_mask = flat._compact_mask
    monkeypatch.setattr(flat, "_compact_mask", counting)
    eng = _engine(x, "fp32_l2")
    first = _search(eng, q, mask, "fp32_l2")
    (entry,) = eng._mask_cache.values()
    got = _counters(lambda: [_search(eng, q, mask, "fp32_l2") for _ in range(3)])
    assert built == [int(mask.sum())]  # the pass count and the row list, on the miss only
    (again,) = eng._mask_cache.values()
    assert again is entry and entry.rows.dtype == torch.int32 and entry.rows.shape == (1024,)
    # a writable mask handed to the engine is found by its contents: a digest a call
    assert got == {"zvec.scans_compacted": 3, "zvec.rows_scored": 3 * 1024, "zvec.mask_digests": 3}
    np.testing.assert_array_equal(_search(eng, q, mask, "fp32_l2")[1], first[1])
