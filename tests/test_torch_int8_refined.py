"""An int8-resident FLAT index with its default float32 refine, through the
port's public API on the CPU, held to the benchmark's plain reference
(`portbench/reference/int8_refined.py`: the quantizer, the int8 candidates
and the refine in float64), at D = 96 (Deep10M's width).

- The quantizer's scale and bias equal the reference's to float32 rounding;
  the engine's codes differ from the reference's float64 ones only at half
  steps, by one.
- Answers with the refine on (AUTO, the index's default) and off (the int8
  top-k), without and with a filter: ids equal the reference's except where
  the distances tie within 1e-6 at the k-th place or the row's codes differ
  and move that place (`portbench/reference/int8_refined.py::hold`); scores within 1e-5 of the float64
  distance, relative: to the float32 row with the refine, to the row's
  dequantized codes without. Each call takes the blockwise scan once with
  k = 10 x topk (the refine's overscan), under the filter's mask: the CPU's
  route; on the card the fused scan takes k up to 128, the overscan among
  them, and the blockwise scan k = 129 on (pinned at the cell's shape).
- Tracing: one `zvec.blockwise` and one `zvec.refine` span a segment a call,
  the counters `zvec.scan_blocks` (ceil(n_pad / block)) and
  `zvec.refine_rows` (Q x min(100, n) a segment); nothing with tracing off.
- The cell `deep10m_int8_refined.batch` run by the harness at a tiny size:
  correct, recall 1.0, and its readers `refine_ms` and
  `quantized_scan_roofline` (the latter reads device time, which a CPU run
  has none of: it is held on hand-made runs); with a scan that skips rows,
  or a refine with no overscan, not correct by its `rank_gap`.
"""

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import zvec_tpu_torch as zt  # noqa: E402
from portbench import peaks  # noqa: E402
from portbench.cell import load_module  # noqa: E402
from portbench.reference import int8_refined as ref  # noqa: E402
from portbench.reference.exact import row_distances  # noqa: E402
from portbench.roofline import quantized_scan  # noqa: E402
from portbench.port import PortSystem  # noqa: E402
from portbench.run import run  # noqa: E402
from portbench.tests.conftest import REPO, TINY_POOL, TINY_ROWS, make_tiny_root  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from zvec_tpu_torch.core import flat as flat_mod  # noqa: E402
from zvec_tpu_torch.model.param import FlatQueryParam  # noqa: E402
from zvec_tpu_torch.ops import flat_scan  # noqa: E402
from zvec_tpu_torch.utils import profiler as P  # noqa: E402

N, D, NQ, K = 8192, 96, 32, 10
C = 10 * K  # the refine's candidates: the default refiner_scale_factor x topk
THRESHOLD = 2048  # row_id >= 2048 keeps 6,144 rows: 32 x 6,144 x 96 > 2^24, a device scan, not demoted
CELL = "deep10m_int8_refined.batch"


def answer_arrays(docs, m: int):
    """A call's answers (lists of Docs) as (pks (Q, m) int64, -1 where none;
    scores (Q, m) float64, NaN where none)."""
    pks = torch.full((len(docs), m), -1, dtype=torch.int64)
    scores = torch.full((len(docs), m), float("nan"), dtype=torch.float64)
    for i, row in enumerate(docs):
        for j, doc in enumerate(row[:m]):
            pks[i, j], scores[i, j] = int(doc.id), doc.score
    return pks, scores


def _collection(path, x, per_segment=None, optimize=True):
    extra = {} if per_segment is None else {"max_doc_count_per_segment": per_segment}
    schema = zt.CollectionSchema(
        "int8", fields=[zt.FieldSchema("row_id", zt.DataType.INT64, index_param=zt.InvertIndexParam())],
        vectors=[zt.VectorSchema("vec", zt.DataType.VECTOR_FP32, D,
                                 zt.FlatIndexParam(metric_type=zt.MetricType.L2,
                                                   quantize_type=zt.QuantizeType.INT8))],
        **extra)
    c = zt.create_and_open(str(path), schema)
    for lo in range(0, len(x), 1024):  # the largest write batch
        c.insert([zt.Doc(id=str(i), vectors={"vec": x[i]}, fields={"row_id": i})
                  for i in range(lo, min(len(x), lo + 1024))])
    c.flush()
    if optimize:
        c.optimize()
    return c


@pytest.fixture(scope="module", autouse=True)
def _totals_left_as_found():
    """The benchmark's readers read the process's span and counter totals:
    a later file of this process (a test worker) finds them as this one did."""
    saved = ({k: list(v) for k, v in P._totals.items()}, {k: list(v) for k, v in P._counters.items()})
    yield
    for live, kept in zip((P._totals, P._counters), saved):
        live.clear()
        live.update(kept)


@pytest.fixture(scope="module")
def col(tmp_path_factory):
    rng = np.random.default_rng(96)
    x = rng.standard_normal((N, D)).astype(np.float32)
    c = _collection(tmp_path_factory.mktemp("int8") / "col", x)
    c.x, c.queries = x, rng.standard_normal((NQ, D)).astype(np.float32)
    (seg,) = [s for s in c._impl._segments_snapshot() if s.doc_count > 0]
    c.engine = seg.engine_for("vec")
    c.engine._ensure_fresh()
    xt = torch.from_numpy(x)
    c.quantizer = ref.fit_quantizer(xt)
    c.flipped_rows = (c.engine._st.codes[:N].double() != ref.encode(xt, *c.quantizer)).any(1)
    yield c
    c._impl.close()


def test_quantizer_and_codes_match_reference(col):
    scale, bias = col.quantizer
    qp = col.engine._qparams
    assert qp.scale == pytest.approx(scale, rel=1e-7) and qp.bias == pytest.approx(bias, rel=1e-7, abs=1e-7)
    codes = col.engine._st.codes
    assert codes.dtype == torch.int8 and codes.shape == (N, D)  # 8,192 rows: no padding
    diff = codes.double() - ref.encode(torch.from_numpy(col.x), scale, bias)
    assert diff.abs().max() <= 1 and (diff != 0).double().mean() < 1e-4


@pytest.mark.parametrize("refine", [None, False], ids=["refine_auto", "refine_off"])
@pytest.mark.parametrize("threshold", [None, THRESHOLD], ids=["all_rows", "filtered"])
def test_matches_reference(col, monkeypatch, refine, threshold):
    scans = []
    blockwise = flat_mod.blockwise_topk_search

    def spy(q, codes, metric, topk, mask=None, **kw):
        scans.append((topk, int(mask.sum()), kw["block_size"]))
        return blockwise(q, codes, metric, topk, mask=mask, **kw)

    monkeypatch.setattr(flat_mod, "blockwise_topk_search", spy)
    param = None if refine is None else FlatQueryParam(is_using_refiner=False)
    docs = col.batch_query("vec", col.queries, topk=K, param=param, output_fields=[],
                           filter=None if threshold is None else f"row_id >= {threshold}")
    passing = N - (threshold or 0)
    assert scans == [(C if refine is None else K, passing, 131072)]

    x, q = torch.from_numpy(col.x), torch.from_numpy(col.queries)
    mask = None if threshold is None else torch.arange(N) >= threshold
    scale, bias = col.quantizer

    def flipped(ids):
        return col.flipped_rows[ids.clamp(min=0)] & (ids >= 0)

    pks, scores = answer_arrays(docs, K)
    if refine is None:
        want = ref.search(x, q, K, scale, bias, mask=mask, spare=ref.SPARE)
        got = ref.hold(pks, scores, want.ids, want.dist, lambda p: row_distances(x, q, p), flipped)
    else:
        cand_d, cand_i = ref.candidates(x, q, K + ref.SPARE, scale, bias, mask)
        got = ref.hold(pks, scores, cand_i, cand_d, lambda p: ref.code_distances(x, q, p, scale, bias), flipped,
                   lambda p: ~flipped(p))
    assert got["answers"] == NQ * K and got["missing_answers"] == 0
    assert got["unexplained"] == 0, got
    assert got["differ"] <= 2  # near-ties and differing codes are rare
    assert got["score_gap"] <= 1e-5
    if threshold is not None:
        assert (pks >= threshold).all()


def test_hold_explains_ties_and_moved_edges():
    """The reference ranks rows 0..5 at distances 10..15 (its answer: 0-2,
    m = 3); row 9's codes differ from the reference's."""
    ref_ids = torch.tensor([[0, 1, 2, 3, 4, 5]])
    ref_d = torch.tensor([[10.0, 11.0, 12.0, 13.0, 14.0, 15.0]])
    dist = {0: 10.0, 1: 11.0, 2: 12.0, 3: 13.0, 4: 14.0, 5: 15.0, 9: 11.5, 7: 12.0 * (1 + 1e-7)}

    def dist_of(p):
        return torch.tensor([[dist[int(i)] for i in row] for row in p], dtype=torch.float64)

    def flipped(p):
        return p == 9

    def held(pks):
        p = torch.tensor([pks])
        return ref.hold(p, dist_of(p), ref_ids, ref_d, dist_of, flipped)

    assert held([0, 1, 2]) == {"differ": 0, "unexplained": 0, "score_gap": 0.0, "answers": 3, "missing_answers": 0}
    assert held([0, 1, 7])["unexplained"] == 0  # row 7 ties with the 3rd place within 1e-6
    assert held([0, 1, 9])["unexplained"] == 0  # row 9's codes moved it in, row 2 out
    assert held([0, 9, 1])["unexplained"] == 0  # and then row 9 in, row 2 out
    assert held([0, 9, 3])["unexplained"] == 1  # row 3 before row 1: one moved row moves one place
    assert held([0, 1, 3])["unexplained"] == 1  # row 3 for row 2, no tie and no moved row
    assert held([0, 1, 3])["differ"] == 2
    scored = ref.hold(torch.tensor([[0, 1, 2]]), torch.tensor([[10.0, 11.0, 12.001]], dtype=torch.float64),
                  ref_ids, ref_d, dist_of, flipped)
    assert scored["score_gap"] == pytest.approx(0.001 / 12.0)


@pytest.mark.parametrize("rows,blocks", [(4_000_000, 31), (3_000_000, 23)])
def test_the_overscan_takes_the_blockwise_scan_at_the_cells_shape(monkeypatch, rows, blocks):
    # the route of the refine's overscan at the cell's shape: the fused scan
    # takes k up to the kernels' 128 lanes, the blockwise scan (in `blocks`
    # blocks) what lies past them
    monkeypatch.setattr(flat_scan, "_scratch_budget", lambda dev: 80 * 10**9 // 8)  # an eighth of 80 GB
    n_pad = -(-rows // flat_mod._ROW_ALIGN_BIG) * flat_mod._ROW_ALIGN_BIG
    codes = SimpleNamespace(dtype=torch.int8, is_cuda=True, shape=(n_pad, D), device=torch.device("cuda"))
    assert flat_mod.kernel_takes(codes, (0.02, 0.0), rows, K)  # top-10 alone: the fused scan
    assert flat_mod.kernel_takes(codes, (0.02, 0.0), rows, C)  # the refine's 100: the fused scan
    assert flat_mod.kernel_takes(codes, (0.02, 0.0), rows, 128)
    assert not flat_mod.kernel_takes(codes, (0.02, 0.0), rows, 129)  # past 128 lanes: blockwise
    assert -(-n_pad // flat_mod._BLOCK_SIZE) == blocks


def _traced(fn, on=True):
    names = ("zvec.blockwise", "zvec.refine")
    before_c, before_s = P.counter_totals(), P.span_totals()
    if on:
        with profile(activities=[ProfilerActivity.CPU]):
            fn()
    else:
        fn()
    after_c, after_s = P.counter_totals(), P.span_totals()
    counters = {k: v - before_c.get(k, 0) for k, v in after_c.items() if v != before_c.get(k, 0)}
    spans = {n: after_s.get(n, {"count": 0})["count"] - before_s.get(n, {"count": 0})["count"] for n in names}
    return counters, spans


@pytest.fixture(scope="module")
def two_segments(tmp_path_factory, col):
    # optimize() would merge them: a sealed segment and the writing one
    c = _collection(tmp_path_factory.mktemp("int8_two") / "col", col.x, per_segment=N // 2, optimize=False)
    assert len([s for s in c._impl._segments_snapshot() if s.doc_count > 0]) == 2
    yield c
    c._impl.close()


@pytest.mark.parametrize("segments", [1, 2])
@pytest.mark.parametrize("block", [131072, 2048])
def test_spans_and_counters_record_the_call(col, two_segments, monkeypatch, segments, block):
    c = col if segments == 1 else two_segments
    monkeypatch.setattr(flat_mod, "_BLOCK_SIZE", block)
    calls = 2

    def query():
        for _ in range(calls):
            c.batch_query("vec", col.queries, topk=K, output_fields=[])

    query()  # any rebuild outside the count
    counters, spans = _traced(query)
    rows = N // segments  # each segment's rows: no padding at these sizes
    assert spans == {"zvec.blockwise": calls * segments, "zvec.refine": calls * segments}
    assert counters["zvec.scan_blocks"] == calls * segments * -(-rows // block)
    assert counters["zvec.refine_rows"] == calls * segments * NQ * min(C, rows)
    assert counters["zvec.rows_scored"] == calls * N
    assert _traced(query, on=False) == ({}, {"zvec.blockwise": 0, "zvec.refine": 0})


def test_refine_counts_only_valid_candidates(tmp_path):
    """Fewer rows than the overscan: each query's candidates are the 50 rows."""
    x = np.random.default_rng(7).standard_normal((50, D)).astype(np.float32)
    c = _collection(tmp_path / "col", x)
    try:
        counters, spans = _traced(lambda: c.batch_query("vec", x[:4], topk=K, output_fields=[]))
    finally:
        c._impl.close()
    assert counters["zvec.refine_rows"] == 4 * 50 and counters["zvec.scan_blocks"] == 1
    assert spans["zvec.refine"] == 1


# ---- the cell, run by the harness at a tiny size ----


def reader(name):
    return load_module(REPO / "portbench" / "metrics" / f"{name}.py", f"test_int8_metric_{name}").read


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny benchmark, this configuration cut as `make_tiny_root` cuts
    those directly under `configs/`."""
    root = make_tiny_root(tmp_path_factory.mktemp("tiny_int8"))
    path = root / "portbench" / "configs" / "quantized" / "deep10m_int8_refined.json"
    cfg = json.loads(path.read_text())
    cfg["rows"], cfg["query_pool"] = TINY_ROWS, TINY_POOL
    path.write_text(json.dumps(cfg))
    return root


def test_cell_runs_correct_with_full_recall(tiny):
    result, lines = run(tiny, CELL, 2**41 + 3, 0.3, trace=False, device="cpu")
    assert result["correct"], lines
    assert result["metrics"]["recall_at_10"]["value"] == 1.0
    checks = result["checks"]
    assert set(checks) == {"score_gap", "rank_gap"} and checks["score_gap"]["value"] <= 1e-5
    assert checks["rank_gap"]["value"] == 0.0  # the exact top-10 is among every query's 100 candidates


class _NoOverscan(PortSystem):
    """The port with its refine over topk candidates, not 10 x topk."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.param = FlatQueryParam()
        self.param.refiner_scale_factor = 1


@pytest.mark.parametrize("fault", ["scan_skips_rows", "no_overscan"])
def test_cell_with_a_planted_fault_is_not_correct(tiny, monkeypatch, fault):
    """Faults of the candidates that the scores cannot show: each answer is
    a row scored with its own float32 distance, so `score_gap` holds, and
    `rank_gap` (a true neighbour missing) decides."""
    factory = None
    if fault == "scan_skips_rows":
        blockwise = flat_mod.blockwise_topk_search

        def skipping(q, codes, metric, topk, mask=None, **kw):
            mask = mask.clone()
            mask[: mask.shape[0] // 8] = False
            return blockwise(q, codes, metric, topk, mask=mask, **kw)

        monkeypatch.setattr(flat_mod, "blockwise_topk_search", skipping)
    else:
        factory = _NoOverscan
    # each query of the pool once, whatever the CPU's speed: the reading is the widest miss among them
    result, _ = run(tiny, CELL, 2**41 + 3, 60.0, trace=False, device="cpu", system_factory=factory, max_calls=4)
    checks = result["checks"]
    assert not result["correct"], (checks, result["metrics"])
    assert checks["score_gap"]["value"] <= checks["score_gap"]["limit"]
    assert checks["rank_gap"]["value"] > checks["rank_gap"]["limit"], checks


def test_cell_traced_reads_refine_ms(tiny, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", CELL, "--seed", "5"])
    result, lines = run(tiny, CELL, 2**41 + 4, 0.3, trace=True, device="cpu")
    assert result["correct"], lines
    metrics = result["metrics"]
    assert metrics["refine_ms"]["value"] > 0 and metrics["refine_ms"]["unit"] == "ms/call"
    assert "quantized_scan_roofline" not in metrics  # no device time on the CPU


def _run(trace_calls=16, device_s=0.016):
    return {"calls": [], "setup": {}, "trace_calls": trace_calls,
            "shape": {"rows": 4_000_000, "dim": 96, "batch": 1024, "topk": 10},
            "trace": None if device_s is None else {"window_s": 1.0, "busy_s": 0.5, "device_s": device_s,
                                                    "device_ops": [], "idle_gaps": []}}


def test_least_time_of_the_int8_scan():
    b = quantized_scan.least_time(1024, 4_000_000, 96, 10)
    # two TF32 passes: the query split in two, so that it stays float32
    assert b["bound_by"] == "operations" and b["flop"] == 2 * 2.0 * 1024 * 4_000_000 * 96
    assert b["seconds"] == pytest.approx(b["flop"] / peaks.TF32_FLOPS) and 3.17e-3 < b["seconds"] < 3.18e-3
    assert b["bytes"] == 4_000_000 * (96 + 4 + 1) + 1024 * 96 * 4 + 1024 * 100 * 8
    few = quantized_scan.least_time(1, 4_000_000, 96, 10)
    assert few["bound_by"] == "bytes" and few["seconds"] == pytest.approx(few["bytes"] / peaks.HBM_BYTES_PER_S)


def test_roofline_reads_the_device_time():
    least = quantized_scan.least_time(1024, 4_000_000, 96, 10)["seconds"]
    assert reader("quantized_scan_roofline")(_run()) == pytest.approx(100.0 * least / 0.001)


@pytest.mark.parametrize("case", ["no_trace", "no_traced_call", "no_device_time"])
def test_roofline_finds_nothing(case):
    run_info = {"no_trace": _run(device_s=None), "no_traced_call": _run(trace_calls=0),
                "no_device_time": _run(device_s=0.0)}[case]
    assert reader("quantized_scan_roofline")(run_info) is None


def test_refine_ms_reads_the_span_total(monkeypatch):
    totals = {"zvec.query": {"count": 16, "total_s": 2.0, "self_s": 0.1},
              "zvec.refine": {"count": 16, "total_s": 0.8, "self_s": 0.8}}
    monkeypatch.setattr(P, "span_totals", lambda: json.loads(json.dumps(totals)))
    assert reader("refine_ms")(_run()) == pytest.approx(800 / 16)


@pytest.mark.parametrize("case", ["parent_program", "no_span_totals", "no_traced_call"])
def test_refine_ms_finds_nothing(case, monkeypatch):
    run_info = _run()
    query = {"zvec.query": {"count": 16, "total_s": 2.0, "self_s": 0.1}}
    if case == "parent_program":  # spans, but not `zvec.refine`
        monkeypatch.setattr(P, "span_totals", lambda: dict(query))
    elif case == "no_span_totals":
        monkeypatch.delattr(P, "span_totals")
    else:
        monkeypatch.setattr(P, "span_totals", lambda: {**query, "zvec.refine": {"count": 1, "total_s": 0.1,
                                                                                   "self_s": 0.1}})
        run_info["trace_calls"] = 0
    assert reader("refine_ms")(run_info) is None
