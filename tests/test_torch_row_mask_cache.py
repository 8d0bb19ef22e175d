"""The cached row mask, on the CPU.

Collection: `CollectionImpl._row_mask` caches a segment's alive-AND-filter
rows under what they are built from (the caller's row count, the segment's
first doc id and write version, the filter, the delete store and its
version). Every caller gets the same read-only array until one of those
changes; then a new array, equal to one built from scratch here (the
tombstones read row by row, the filter on the field's values in numpy).

Engine: `FlatEngine._device_mask` finds the device copy of such an array
(read-only, owning its data, one bool per row) by its identity and takes no
content digest (counter `zvec.mask_digests`); any other mask, such as a
writable one a caller changes in place between two searches, is still found
by its contents and gives the new answer.

End to end through the public `Collection` API, on the blockwise scan and on
the fused route (`_use_kernel` patched: the plain stage one, merge and stage
two), unfiltered and filtered: a deleted answer goes, a nearer row inserted
into the writing segment comes, a new filter moves the pass set; every
answer equals a numpy brute force over the live rows.
"""

import hashlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import zvec_tpu_torch as zt  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from zvec_tpu_torch.core import flat as tflat  # noqa: E402
from zvec_tpu_torch.core.flat import FlatEngine  # noqa: E402
from zvec_tpu_torch.db.delete_store import DeleteStore  # noqa: E402
from zvec_tpu_torch.model.param.param import FlatIndexParam  # noqa: E402
from zvec_tpu_torch.typing.enum import MetricType  # noqa: E402
from zvec_tpu_torch.utils import profiler as P  # noqa: E402

N, D, K = 300, 8, 10
FILTERS = {"tag >= 5": lambda t: t >= 5, "tag < 4": lambda t: t < 4}


@pytest.fixture
def col(tmp_path):
    schema = zt.CollectionSchema(
        "rows", fields=[zt.FieldSchema("tag", zt.DataType.INT64, index_param=zt.InvertIndexParam())],
        vectors=[zt.VectorSchema("vec", zt.DataType.VECTOR_FP32, D,
                                 zt.FlatIndexParam(metric_type=zt.MetricType.L2))])
    c = zt.create_and_open(str(tmp_path / "col"), schema)
    rng = np.random.default_rng(3)
    c.x = {str(i): v for i, v in enumerate(rng.standard_normal((N, D)).astype(np.float32))}
    c.tags = {str(i): i % 10 for i in range(N)}
    c.insert([zt.Doc(id=pk, vectors={"vec": v}, fields={"tag": c.tags[pk]}) for pk, v in c.x.items()])
    c.delete([str(i) for i in range(0, N, 7)])
    for i in range(0, N, 7):
        del c.x[str(i)], c.tags[str(i)]
    yield c
    c._impl.close()


def _segment(col):
    (seg,) = [s for s in col._impl._segments_snapshot() if s.doc_count]
    return seg


def _from_scratch(impl, seg, n_rows, flt):
    """The segment's row mask and pass count, built without the cache."""
    alive = np.array([not impl.deletes.is_deleted(seg.doc_id_start + r) for r in range(n_rows)], bool)
    if flt is None:
        return alive, None
    tags = np.asarray(seg.store.scalar_column("tag"))[:n_rows]
    alive &= FILTERS[flt](tags)
    return alive, int(alive.sum())


def _counted(fn):
    """`fn()` under the profiler, and the counters it moved."""
    before = P.counter_totals()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    after = P.counter_totals()
    return out, {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


@pytest.mark.parametrize("flt", [None, "tag >= 5"], ids=["unfiltered", "filtered"])
def test_an_unchanged_segment_gets_the_same_read_only_mask(col, flt):
    impl, seg = col._impl, _segment(col)
    n = seg.doc_count
    (first, n_pass), built = _counted(lambda: impl._row_mask(seg, n, flt))
    assert built == {"zvec.row_mask_builds": 1}
    assert not first.flags.writeable and first.flags.owndata and first.dtype == np.bool_
    want, want_pass = _from_scratch(impl, seg, n, flt)
    assert np.array_equal(first, want) and n_pass == want_pass
    for _ in range(3):
        (again, again_pass), moved = _counted(lambda: impl._row_mask(seg, n, flt))
        assert again is first and again_pass == n_pass and "zvec.row_mask_builds" not in moved


CHANGES = ["delete", "upsert", "insert", "other_filter", "fewer_rows", "recovered_store"]


@pytest.mark.parametrize("flt", [None, "tag >= 5"], ids=["unfiltered", "filtered"])
@pytest.mark.parametrize("change", CHANGES)
def test_a_changed_input_builds_a_new_mask(col, tmp_path, change, flt):
    impl, seg = col._impl, _segment(col)
    n = seg.doc_count
    before, _ = impl._row_mask(seg, n, flt)
    ask = flt
    if change == "delete":
        col.delete("5")  # alive and passing both filters' cases
    elif change == "upsert":
        col.upsert(zt.Doc(id="6", vectors={"vec": np.zeros(D, np.float32)}, fields={"tag": 2}))
    elif change == "insert":
        col.insert(zt.Doc(id="new", vectors={"vec": np.zeros(D, np.float32)}, fields={"tag": 9}))
    elif change == "other_filter":
        ask = "tag < 4"
    elif change == "fewer_rows":
        n -= 5  # a caller's earlier snapshot of the doc count
    else:  # `_recover` swaps in a loaded store: one more tombstone, at the old store's
        # version, so that only the store's identity tells the two apart
        path = str(tmp_path / "deletes.npy")
        impl.deletes.snapshot(path)
        loaded = DeleteStore.load(path)
        loaded.mark(seg.doc_id_start + 8)
        loaded._version = impl.deletes.version
        impl.deletes = loaded
    seg = _segment(col)
    if change in ("upsert", "insert"):
        assert seg.doc_count == n + 1
        n = seg.doc_count
    (after, n_pass), built = _counted(lambda: impl._row_mask(seg, n, ask))
    assert after is not before and built == {"zvec.row_mask_builds": 1}
    want, want_pass = _from_scratch(impl, seg, n, ask)
    assert np.array_equal(after, want) and n_pass == want_pass
    assert not np.array_equal(after, before[:n]) or change == "fewer_rows"


def _engine(x):
    eng = FlatEngine(MetricType.L2, D, FlatIndexParam(metric_type=MetricType.L2))
    eng.bind_data(lambda: x, lambda: 0)
    return eng


def _brute(x, q, mask):
    d = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64)) ** 2).sum(-1)
    d[:, ~mask] = np.inf
    order = np.argsort(d, axis=1, kind="stable")[:, :K]
    return np.where(np.take_along_axis(d, order, 1) < np.inf, order, -1)


@pytest.mark.parametrize("scan", ["blockwise", "fused"])
def test_a_read_only_mask_from_the_collection_takes_no_digest(col, monkeypatch, scan):
    if scan == "fused":
        monkeypatch.setattr(FlatEngine, "_use_kernel", lambda self, st, k: True)
    impl, seg = col._impl, _segment(col)
    q = np.stack(list(col.x.values())[:4])
    masks = [impl._row_mask(seg, seg.doc_count, flt)[0] for flt in (None, "tag >= 5")]

    def no_digest(*args, **kwargs):
        raise AssertionError("a content digest of a fixed mask")

    eng = seg.engine_for("vec")
    eng._mask_cache.clear()
    monkeypatch.setattr(tflat.hashlib, "blake2b", no_digest)
    x = eng._data_fn()
    for mask in masks + [None]:
        _, moved = _counted(lambda: [eng.search(q, K, mask, None) for _ in range(2)])
        assert "zvec.mask_digests" not in moved
        _, ids = eng.search(q, K, mask, None)
        want = _brute(x, q, np.ones(len(x), bool) if mask is None else mask)
        assert np.array_equal(ids, want)
    assert len(eng._mask_cache) == 3 and all(e.src is m for e, m in zip(eng._mask_cache.values(), masks))


@pytest.mark.parametrize("scan", ["blockwise", "fused"])
@pytest.mark.parametrize("kind", ["writable", "read_only_view"])
def test_a_mask_changed_in_place_gives_the_new_answer(monkeypatch, scan, kind):
    if scan == "fused":
        monkeypatch.setattr(FlatEngine, "_use_kernel", lambda self, st, k: True)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2000, D)).astype(np.float32)
    q = x[:4] + 0.01
    eng = _engine(x)
    buf = np.ones(2000, bool)
    mask = buf if kind == "writable" else buf[:]  # a view owns no data
    if kind == "read_only_view":
        mask.flags.writeable = False
    digests = []
    blake2b = hashlib.blake2b
    monkeypatch.setattr(tflat.hashlib, "blake2b", lambda *a, **kw: digests.append(1) or blake2b(*a, **kw))
    _, first = eng.search(q, K, mask, None)
    assert np.array_equal(first, _brute(x, q, buf))
    buf[first[:, :3].ravel()] = False  # the caller changes its mask in place
    buf[1500:] = False
    _, second = eng.search(q, K, mask, None)
    assert np.array_equal(second, _brute(x, q, buf)) and not np.array_equal(second, first)
    assert len(digests) == 2


def _query(col, q, flt):
    return [d.id for d in col.query(zt.VectorQuery("vec", vector=q), topk=K, filter=flt)]


def _want(col, q, flt):
    pks = [pk for pk in col.x if flt is None or FILTERS[flt](col.tags[pk])]
    d = [float(((col.x[pk].astype(np.float64) - q) ** 2).sum()) for pk in pks]
    return [pks[i] for i in np.argsort(d, kind="stable")[:K]]


@pytest.mark.parametrize("flt", [None, "tag >= 5"], ids=["unfiltered", "filtered"])
@pytest.mark.parametrize("scan", ["blockwise", "fused"])
def test_no_stale_mask_through_the_collection(col, monkeypatch, scan, flt):
    if scan == "fused":
        monkeypatch.setattr(FlatEngine, "_use_kernel", lambda self, st, k: True)
    q = np.random.default_rng(11).standard_normal(D).astype(np.float32)
    first = _query(col, q, flt)
    assert first == _want(col, q, flt) == _query(col, q, flt)
    col.delete(first[0])  # a row in the answer
    del col.x[first[0]], col.tags[first[0]]
    gone = _query(col, q, flt)
    assert first[0] not in gone and gone == _want(col, q, flt)
    col.insert(zt.Doc(id="nearest", vectors={"vec": q}, fields={"tag": 9}))  # into the writing segment
    col.x["nearest"], col.tags["nearest"] = q.copy(), 9
    came = _query(col, q, flt)
    assert came[0] == "nearest" and came == _want(col, q, flt)
    other = "tag < 4" if flt else "tag >= 5"
    moved = _query(col, q, other)
    assert moved == _want(col, q, other) and all(FILTERS[other](col.tags[pk]) for pk in moved)
    assert _query(col, q, flt) == came
