"""The spans of zvec_tpu_torch's query path (`utils/profiler.py`).

Off, a query records nothing and never opens a `record_function` range. On
(under `torch.profiler`, or with a stage tree attached), the query is one
`zvec.query` range on the trace's timeline with the engine's and the host's
spans inside it, the totals' self seconds add up to their parents' totals,
a full garbage collection inside a span is a `zvec.gc` span, concurrent
threads lose no update of the totals, and the stage tree of
`debug_profiling` keeps the per-segment branch stages its readers walk.
"""

import gc
import json
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import chip_smoke as cs  # noqa: E402
import zvec_tpu_torch as zt  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from zvec_tpu_torch.utils import profiler as P  # noqa: E402

N, D, K = 2400, 64, 10
TAGS = 40  # "tag = 3" keeps 60 rows of 2,400: under the brute-force-by-keys ratio
HOST_NQ, DEVICE_NQ = 16, 4400  # 16 x 60 x 64 <= 2^24 < 4,400 x 60 x 64


@pytest.fixture(scope="module")
def col(tmp_path_factory):
    schema = zt.CollectionSchema(
        "tracing", fields=[zt.FieldSchema("tag", zt.DataType.INT64)],
        vectors=[zt.VectorSchema("emb", zt.DataType.VECTOR_FP32, D,
                                 zt.FlatIndexParam(metric_type=zt.MetricType.L2))])
    c = zt.create_and_open(str(tmp_path_factory.mktemp("tracing") / "col"), schema)
    x = np.random.default_rng(7).standard_normal((N, D)).astype(np.float32)
    for lo in range(0, N, 1024):  # the largest write batch
        c.insert([zt.Doc(id=str(i), vectors={"emb": x[i]}, fields={"tag": i % TAGS})
                  for i in range(lo, min(N, lo + 1024))])
    c.flush()
    c.optimize()
    c.queries = np.random.default_rng(8).standard_normal((DEVICE_NQ, D)).astype(np.float32)
    yield c
    c._impl.close()


def query(col, nq=8, flt=None):
    return col.batch_query("emb", col.queries[:nq], topk=K, filter=flt, output_fields=[])


def delta(before, after):
    """The totals' growth between two `span_totals()` readings."""
    out = {}
    for name, now in after.items():
        was = before.get(name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        if now["count"] > was["count"]:
            out[name] = {k: now[k] - was[k] for k in now}
    return out


def stages(tree):
    yield tree["stage"]
    for child in tree.get("children", []):
        yield from stages(child)


def test_off_records_nothing(col, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with tracing off")

    monkeypatch.setattr(P, "record_function", refuse)
    assert not torch.autograd._profiler_enabled() and P._local.tree is None
    before = P.span_totals()
    docs = query(col, flt="tag = 3")
    assert len(docs) == 8 and len(docs[0]) == K
    assert P.span_totals() == before
    assert P.span("vector_scan", "seg_0") is P.span("docs")  # the one shared no-op
    assert P._local.frames == []


def test_trace_nests_spans_in_query(col, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        query(col)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)

    def inside(inner, outer):
        return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]

    (root,) = by_name["zvec.query"]
    for name in ("zvec.vector_scan", "zvec.engine.finalize", "zvec.engine.wait", "zvec.docs"):
        assert len(by_name[name]) == 1, name
        assert inside(by_name[name][0], root), name
    assert inside(by_name["zvec.engine.wait"][0], by_name["zvec.engine.finalize"][0])
    order = sorted(("zvec.vector_scan", "zvec.engine.finalize", "zvec.docs"), key=lambda n: by_name[n][0]["ts"])
    assert order == ["zvec.vector_scan", "zvec.engine.finalize", "zvec.docs"]


@pytest.mark.parametrize("mode", ["tree", "torch_profiler"])
def test_self_seconds_add_up(col, mode):
    before = P.span_totals()
    if mode == "tree":
        col._impl.debug_profiling = True
        try:
            query(col, flt="tag != 3")
        finally:
            col._impl.debug_profiling = False
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            query(col, flt="tag != 3")
    got = delta(before, P.span_totals())
    assert got["zvec.query"]["count"] == 1
    assert {"zvec.filter", "zvec.mask", "zvec.vector_scan", "zvec.blockwise", "zvec.engine.finalize",
            "zvec.engine.wait", "zvec.docs"} <= set(got)
    assert got["zvec.mask"]["count"] == 2  # the AND in the dispatch, the engine's padded mask
    assert got["zvec.blockwise"]["count"] == 1  # the scan's launch (the CPU's scan), inside `vector_scan`
    scan_children = got["zvec.vector_scan"]["total_s"] - got["zvec.vector_scan"]["self_s"]
    mask_in_scan = scan_children - got["zvec.blockwise"]["total_s"]
    children = {"zvec.query": ["zvec.filter", "zvec.mask", "zvec.vector_scan", "zvec.engine.finalize",
                               "zvec.docs", "zvec.gc"],
                "zvec.engine.finalize": ["zvec.engine.wait"]}
    for parent, kids in children.items():
        covered = sum(got[k]["total_s"] for k in kids if k in got)
        if parent == "zvec.query":
            covered -= mask_in_scan  # the engine's mask span lies inside `vector_scan`
        assert got[parent]["self_s"] + covered == pytest.approx(got[parent]["total_s"], rel=1e-9, abs=1e-12)
        assert got[parent]["self_s"] >= 0
    assert 0 < mask_in_scan < got["zvec.mask"]["total_s"]
    for leaf in ("zvec.filter", "zvec.blockwise", "zvec.engine.wait", "zvec.docs"):
        assert got[leaf]["self_s"] == pytest.approx(got[leaf]["total_s"], rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("where", ["inside_a_span", "outside_any_span", "young_inside_a_span"])
def test_full_collection_is_a_gc_span(where):
    tree = P.Profiler(enabled=True)
    before = P.span_totals()
    with profile(activities=[ProfilerActivity.CPU]):
        if where == "outside_any_span":
            gc.collect(2)
        else:
            with P.span("query", tree=tree), P.span("docs"):
                gc.collect(1 if where.startswith("young") else 2)
    got = delta(before, P.span_totals())
    names = list(stages(json.loads(tree.to_json())))
    if where == "inside_a_span":
        assert got["zvec.gc"]["count"] == 1
        assert got["zvec.docs"]["self_s"] + got["zvec.gc"]["total_s"] == pytest.approx(got["zvec.docs"]["total_s"])
        assert names == ["query", "docs", "gc"]
    else:
        assert "zvec.gc" not in got and "gc" not in names
    assert P._local.gc is None and P._local.frames == []


def test_unmatched_gc_stop_does_nothing():
    before = P.span_totals()
    P._on_gc("stop", {"generation": 2, "collected": 0, "uncollectable": 0})
    P._on_gc("start", {})  # a malformed call is swallowed, never raised
    assert P.span_totals() == before and P._local.gc is None


def test_concurrent_threads_lose_no_update():
    threads, each = 16, 400
    before = P.span_totals().get("zvec.stress", {"count": 0})["count"]
    start = threading.Barrier(threads)
    errors = []

    def work():
        try:
            start.wait(timeout=30)
            with P.span("query", tree=P.Profiler(enabled=True)):
                for _ in range(each):
                    with P.span("stress"):
                        pass
        except Exception as exc:  # reported by the assertion below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in pool)
    assert P.span_totals()["zvec.stress"]["count"] - before == threads * each


@pytest.mark.parametrize("branch,nq,flt", [
    ("index", HOST_NQ, None),
    ("host exact", HOST_NQ, "tag = 3"),
    ("device scan", DEVICE_NQ, "tag = 3"),
])
@pytest.mark.parametrize("entry", ["batch_query", "query_field"])
def test_stage_tree_keeps_branch_stages(col, branch, nq, flt, entry):
    impl = col._impl
    if entry == "batch_query":
        impl.debug_profiling = True
        try:
            docs = query(col, nq, flt)
        finally:
            impl.debug_profiling = False
        assert len(docs) == nq
        tree = json.loads(impl.last_profile)
    else:
        prof = P.Profiler(enabled=True)
        impl.query_field("emb", col.queries[:nq], K, flt, None, profiler=prof)
        prof.finish()
        tree = json.loads(prof.to_json())
    names = set(stages(tree))
    (seg,) = {name.partition(" ")[2] for name in names if name.startswith(("filter ", "vector_scan ", "bf_by_keys "))}
    assert cs._live_branches(json.dumps(tree)) == {seg: branch}
    assert tree["stage"] == "query" and tree["ms"] > 0
    if branch != "host exact":
        assert {f"engine.finalize {seg}", f"engine.wait {seg}"} <= names
    assert ("docs" in names) == (entry == "batch_query")
