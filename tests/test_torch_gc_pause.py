"""Answer Docs built with the garbage collector paused (`utils/profiler.py`'s
`gc_paused`, used by `db/collection_impl.py`).

A batch of 1,024 queries x top-10 builds 10,240 Docs; no collection of any
generation starts while they are built, the answers are those of a build
without the pause, and the collector's state afterwards is the one it had
before: enabled, disabled by the user, after a build that raised, and after
two threads' builds that overlapped. `gc_pauses()` counts the builds and the
pauses.
"""

import gc
import os
import sys
import threading
from contextlib import nullcontext

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import zvec_tpu_torch as zt  # noqa: E402
from zvec_tpu_torch.db import collection_impl as CI  # noqa: E402
from zvec_tpu_torch.utils import profiler as P  # noqa: E402

N, D, K, NQ = 2000, 16, 10, 1024


@pytest.fixture(scope="module")
def col(tmp_path_factory):
    schema = zt.CollectionSchema(
        "gcpause", vectors=[zt.VectorSchema("emb", zt.DataType.VECTOR_FP32, D,
                                            zt.FlatIndexParam(metric_type=zt.MetricType.L2))])
    c = zt.create_and_open(str(tmp_path_factory.mktemp("gcpause") / "col"), schema)
    x = np.random.default_rng(3).standard_normal((N, D)).astype(np.float32)
    for lo in range(0, N, 1000):
        c.insert([zt.Doc(id=str(i), vectors={"emb": x[i]}) for i in range(lo, lo + 1000)])
    c.flush()
    c.optimize()
    c.queries = np.random.default_rng(4).standard_normal((NQ, D)).astype(np.float32)
    yield c
    c._impl.close()


@pytest.fixture(autouse=True)
def collector_on():
    """Every test starts with the collector on, and leaves it on."""
    was = gc.isenabled()
    gc.enable()
    yield
    assert P._pause_depth == 0 and not P._pause_owned
    gc.enable() if was else gc.disable()


def fields(output_fields):
    """`output_fields=[]` (id and score) for (), every field for None."""
    return None if output_fields is None else list(output_fields)


def batch(col, nq=NQ, output_fields=()):
    return col.batch_query("emb", col.queries[:nq], topk=K,
                           output_fields=fields(output_fields))


def answers(rows):
    return [[(d.id, d.score) for d in row] for row in rows]


def collections_in_build(col, monkeypatch):
    """The generations of the collections that started inside
    `_docs_from_results` during one batch of NQ queries."""
    seen, inside = [], [False]

    def record(phase, info):
        if phase == "start" and inside[0]:
            seen.append(info["generation"])

    real = CI.CollectionImpl._docs_from_results

    def build(self, *a, **kw):
        inside[0] = True
        try:
            return real(self, *a, **kw)
        finally:
            inside[0] = False

    monkeypatch.setattr(CI.CollectionImpl, "_docs_from_results", build)
    gc.callbacks.append(record)
    try:
        docs = batch(col)
    finally:
        gc.callbacks.remove(record)
    assert len(docs) == NQ and all(len(row) == K for row in docs)
    return seen


def test_no_collection_while_docs_are_built(col, monkeypatch):
    batch(col)  # warm
    assert collections_in_build(col, monkeypatch) == []
    assert gc.isenabled()


def test_unpaused_build_collects(col, monkeypatch):
    """The control: the same build with the pause made a no-op sets off
    young collections, so the test above can see one."""
    monkeypatch.setattr(CI, "gc_paused", nullcontext)
    assert collections_in_build(col, monkeypatch)


@pytest.mark.parametrize("output_fields", [(), None], ids=["id_score", "materialized"])
def test_answers_equal_unpaused(col, monkeypatch, output_fields):
    nq = NQ if output_fields == () else 64
    paused = batch(col, nq, output_fields)
    monkeypatch.setattr(CI, "gc_paused", nullcontext)
    plain = batch(col, nq, output_fields)
    assert answers(paused) == answers(plain)
    assert len(paused) == nq and all(len(row) == K for row in paused)


def test_enabled_before_enabled_after(col):
    before = P.gc_pauses()
    batch(col, 8)
    after = P.gc_pauses()
    assert gc.isenabled()
    assert after == {"builds": before["builds"] + 1, "paused": before["paused"] + 1}


def test_disabled_before_disabled_after(col):
    gc.disable()
    before = P.gc_pauses()
    batch(col, 8)
    after = P.gc_pauses()
    assert not gc.isenabled()
    assert after == {"builds": before["builds"] + 1, "paused": before["paused"]}


@pytest.mark.parametrize("output_fields", [(), None], ids=["id_score", "materialized"])
def test_restored_after_a_build_that_raises(col, monkeypatch, output_fields):
    class Boom(RuntimeError):
        pass

    made = [0]

    class FailingDoc(zt.Doc):
        __slots__ = ()

        def __init__(self, *a, **kw):
            made[0] += 1
            if made[0] == 5:
                assert not gc.isenabled()
                raise Boom
            super().__init__(*a, **kw)

    monkeypatch.setattr(CI, "Doc", FailingDoc)
    with pytest.raises(Boom):
        batch(col, 8, output_fields)
    assert gc.isenabled()


def test_overlapping_threads(col, monkeypatch):
    """Two threads' builds meet at a barrier inside their Docs: the collector
    is off for both while they overlap, and on again after both."""
    barrier = threading.Barrier(2, timeout=60)
    local = threading.local()
    off_at_barrier, errors = [], []

    class MeetingDoc(zt.Doc):
        __slots__ = ()

        def __init__(self, *a, **kw):
            if not getattr(local, "met", False):
                local.met = True
                barrier.wait()
                off_at_barrier.append(not gc.isenabled())
                barrier.wait()
            super().__init__(*a, **kw)

    def run():
        try:
            docs = batch(col, 64)
            assert len(docs) == 64 and all(len(row) == K for row in docs)
        except BaseException as e:  # reported below, in the test's thread
            errors.append(e)
            barrier.abort()

    monkeypatch.setattr(CI, "Doc", MeetingDoc)
    before = P.gc_pauses()
    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert off_at_barrier == [True, True]
    assert gc.isenabled()
    after = P.gc_pauses()
    assert after == {"builds": before["builds"] + 2, "paused": before["paused"] + 1}


@pytest.mark.parametrize("path", ["query", "batch_query", "batch_query_many", "query_dispatch"])
@pytest.mark.parametrize("output_fields", [(), None], ids=["id_score", "materialized"])
def test_every_query_path_builds_paused(col, monkeypatch, path, output_fields):
    """Each of the Host API's query paths builds its Docs with the collector
    off and counts one build a block of answers."""
    states = []

    class WatchedDoc(zt.Doc):
        __slots__ = ()

        def __init__(self, *a, **kw):
            states.append(gc.isenabled())
            super().__init__(*a, **kw)

    monkeypatch.setattr(CI, "Doc", WatchedDoc)
    impl, q, fields_ = col._impl, col.queries, fields(output_fields)
    before = P.gc_pauses()
    if path == "query":
        docs = [impl.query("emb", q[0], topk=K, output_fields=fields_)]
    elif path == "batch_query":
        docs = impl.batch_query("emb", q[:4], topk=K, output_fields=fields_)
    elif path == "batch_query_many":
        blocks = impl.batch_query_many("emb", [q[:2], q[2:4]], topk=K, output_fields=fields_)
        docs = [row for block in blocks for row in block]
    else:
        docs = [impl.query_dispatch("emb", q[0], topk=K, output_fields=fields_)()]
    builds = {"query": 1, "batch_query": 1, "batch_query_many": 2, "query_dispatch": 1}[path]
    assert all(len(row) == K for row in docs)
    assert len(states) == K * len(docs) and not any(states)
    assert gc.isenabled()
    assert P.gc_pauses() == {"builds": before["builds"] + builds,
                             "paused": before["paused"] + builds}


def test_nested_pauses_restore_once():
    """A pause inside a pause leaves the collector off until the outer one
    ends, and counts both builds but one pause."""
    before = P.gc_pauses()
    with P.gc_paused():
        with P.gc_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()
    assert gc.isenabled()
    assert P.gc_pauses() == {"builds": before["builds"] + 2, "paused": before["paused"] + 1}


def test_many_threads_lose_no_update():
    """More threads than cores enter and leave pauses, nested, under a short
    switch interval: the collector is off inside every pause, on after the
    last, and every build is counted."""
    n_threads, rounds = 2 * (os.cpu_count() or 4), 300
    on_inside, errors = [], []

    def run():
        try:
            for _ in range(rounds):
                with P.gc_paused():
                    with P.gc_paused():
                        if gc.isenabled():
                            on_inside.append(1)
                    if gc.isenabled():
                        on_inside.append(1)
        except BaseException as e:  # reported below, in the test's thread
            errors.append(e)

    before = P.gc_pauses()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert on_inside == []
    assert gc.isenabled()
    after = P.gc_pauses()
    assert after["builds"] - before["builds"] == 2 * n_threads * rounds
    assert 1 <= after["paused"] - before["paused"] <= n_threads * rounds
