"""Filtered exact search through the port's public API, held to the
benchmark's plain reference (`portbench/reference/exact.py`: float32
candidates with TF32 off, ranked in float64; `reference/filter.py`: the
filter on the field arrays). A FLAT L2 collection whose INT64 field `row_id`
(inverted) holds the row number, queried with `row_id >= v`, the rule of
VectorDBBench's filtered cases, at D = 960 (GIST1M's width) and D = 128.

Each filtered route of `_query_field_dispatch` is taken and checked by its
stage: the host's `_exact_over_rows` (Q x passing x D <= 2^24), the
brute-force-by-keys device scan (`bf_by_keys`: the whole segment scanned
under the mask) and the masked index scan (`vector_scan`: most rows pass),
the device scans both by the blockwise scan and by the fused flat scan (its
plain stage one, merge and stage two on the CPU).

Ids equal the reference's outside ties: where they differ, the float64
distance of the returned row equals the reference's at that rank within the
score tolerance. Scores within 1e-5 of the float64 distance, relative
(floored at 1): float32 sums of D products in |q|^2 + |x|^2 - 2 q.x, at
distances of ~2D, err by ~1e-7 of the distance; 1e-5 is the benchmark's
`score_gap` limit, which TF32 products (~1e-4 here) fail.

Tracing: the `zvec.mask` span and the counters `zvec.rows_passing` (rows that
passed the filter and the deletes, over the call's segments) and
`zvec.rows_scored` (rows the engines scanned on the device, padding
included) record the call's values under the profiler, and nothing with
tracing off.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import chip_smoke as cs  # noqa: E402
import zvec_tpu_torch as zt  # noqa: E402
from portbench.reference.exact import exact_topk  # noqa: E402
from portbench.reference.filter import row_mask  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from zvec_tpu_torch.core.flat import FlatEngine  # noqa: E402
from zvec_tpu_torch.utils import profiler as P  # noqa: E402

N, K = 3000, 10
N_PAD = 3072  # the engine's rows, padded to a multiple of 1024
RTOL = 1e-5
# (branch, queries, filter threshold): 30 rows pass for the host (8 x 30 x 960
# <= 2^24), 270 (<= 10% of N) for the device demotion (512 x 270 x D > 2^24),
# 2,700 for the masked index scan
ROUTES = [("host exact", 8, 2970), ("device scan", 512, 2730), ("index", 16, 300)]


@pytest.fixture(scope="module", params=[960, 128], ids=lambda d: f"D{d}")
def col(request, tmp_path_factory):
    d = request.param
    schema = zt.CollectionSchema(
        "filtered", fields=[zt.FieldSchema("row_id", zt.DataType.INT64, index_param=zt.InvertIndexParam())],
        vectors=[zt.VectorSchema("vec", zt.DataType.VECTOR_FP32, d,
                                 zt.FlatIndexParam(metric_type=zt.MetricType.L2))])
    c = zt.create_and_open(str(tmp_path_factory.mktemp(f"filtered{d}") / "col"), schema)
    rng = np.random.default_rng(d)
    x = rng.standard_normal((N, d)).astype(np.float32)
    for lo in range(0, N, 1024):  # the largest write batch
        c.insert([zt.Doc(id=str(i), vectors={"vec": x[i]}, fields={"row_id": i})
                  for i in range(lo, min(N, lo + 1024))])
    c.flush()
    c.optimize()
    c.x, c.queries = x, rng.standard_normal((512, d)).astype(np.float32)
    c.fields = {"row_id": np.arange(N, dtype=np.int64)}
    yield c
    c._impl.close()


def _query(col, nq, threshold):
    """(pks (Q, K), scores (Q, K), the branch the segment took)."""
    impl = col._impl
    impl.debug_profiling = True
    try:
        docs = col.batch_query("vec", col.queries[:nq], topk=K, filter=f"row_id >= {threshold}",
                               output_fields=[])
    finally:
        impl.debug_profiling = False
    (branch,) = cs._live_branches(impl.last_profile).values()
    pks = np.array([[int(d.id) for d in row] for row in docs])
    scores = np.array([[d.score for d in row] for row in docs], np.float64)
    return pks, scores, branch


def _check_against_reference(col, nq, threshold, pks, scores):
    x, q = torch.from_numpy(col.x), torch.from_numpy(col.queries[:nq])
    mask = torch.from_numpy(row_mask((("row_id", ">=", threshold),), col.fields, N))
    ref_d, ref_i = exact_topk(x, q, K, mask)
    assert pks.shape == (nq, K) and (pks >= threshold).all()
    got_d = ((x.double()[torch.from_numpy(pks)] - q.double()[:, None, :]) ** 2).sum(-1).numpy()
    tol = RTOL * np.maximum(got_d, 1.0)
    assert (np.abs(scores - got_d) <= tol).all(), np.abs(scores - got_d).max()
    differ = pks != ref_i.numpy()
    assert (np.abs(got_d - ref_d.numpy())[differ] <= tol[differ]).all()  # ties only
    assert differ.mean() < 0.01


ROUTE_SCANS = [(branch, nq, threshold, scan) for branch, nq, threshold in ROUTES
               for scan in (("host",) if branch == "host exact" else ("blockwise", "fused"))]


@pytest.mark.parametrize("branch,nq,threshold,scan", ROUTE_SCANS,
                         ids=[f"{r[0].replace(' ', '_')}-{r[3]}" for r in ROUTE_SCANS])
def test_filtered_route_matches_reference(col, monkeypatch, branch, nq, threshold, scan):
    if scan == "fused":
        # the fused scan's branch on CPU tensors: its plain stage one, merge and stage two
        monkeypatch.setattr(FlatEngine, "_use_kernel", lambda self, st, k: True)
    pks, scores, taken = _query(col, nq, threshold)
    assert taken == branch
    _check_against_reference(col, nq, threshold, pks, scores)


def _counted(fn):
    before_c, before_s = P.counter_totals(), P.span_totals()
    fn()
    after_c, after_s = P.counter_totals(), P.span_totals()
    counters = {k: v - before_c.get(k, 0) for k, v in after_c.items() if v != before_c.get(k, 0)}
    mask = after_s.get("zvec.mask", {"count": 0})["count"] - before_s.get("zvec.mask", {"count": 0})["count"]
    return counters, mask


@pytest.mark.parametrize("branch,nq,threshold", ROUTES, ids=[r[0].replace(" ", "_") for r in ROUTES])
def test_mask_span_and_counters_record_the_call(col, branch, nq, threshold):
    def call():
        with profile(activities=[ProfilerActivity.CPU]):
            col.batch_query("vec", col.queries[:nq], topk=K, filter=f"row_id >= {threshold}", output_fields=[])

    counters, masks = _counted(call)
    scanned = branch != "host exact"
    assert counters.get("zvec.rows_passing") == N - threshold
    assert counters.get("zvec.rows_scored", 0) == (N_PAD if scanned else 0)
    assert masks == (2 if scanned else 1)  # the AND in the dispatch; the engine's padded mask


def test_unfiltered_call_counts_every_alive_row(col):
    def call():
        with profile(activities=[ProfilerActivity.CPU]):
            col.batch_query("vec", col.queries[:4], topk=K, output_fields=[])

    col.batch_query("vec", col.queries[:4], topk=K, output_fields=[])  # the row mask built, untraced
    counters, masks = _counted(call)
    # the CPU's scan is the blockwise one: N_PAD rows in one block
    assert counters == {"zvec.rows_passing": N, "zvec.rows_scored": N_PAD, "zvec.scan_blocks": 1} and masks == 1


@pytest.mark.parametrize("branch,nq,threshold", ROUTES, ids=[r[0].replace(" ", "_") for r in ROUTES])
def test_tracing_off_records_nothing(col, branch, nq, threshold):
    assert not torch.autograd._profiler_enabled() and P._local.tree is None
    counters, masks = _counted(lambda: col.batch_query("vec", col.queries[:nq], topk=K,
                                                       filter=f"row_id >= {threshold}", output_fields=[]))
    assert counters == {} and masks == 0


def test_count_adds_while_tracing_is_on():
    def refuse():
        raise AssertionError("a counter's value computed with tracing off")

    before = P.counter_totals().get("zvec.test_rows", 0)
    with P.span("query", tree=P.Profiler(enabled=True)):
        P.count("test_rows", 7)
        P.count("test_rows", lambda: 5)
    assert P.counter_totals()["zvec.test_rows"] - before == 12
    P.count("test_rows", 100)  # no tree attached, no profiler: off
    P.count("test_rows", refuse)  # off: the function is never called
    assert P.counter_totals()["zvec.test_rows"] - before == 12
