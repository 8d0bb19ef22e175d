"""Crash-atomicity of the checkpoint / WAL / version protocol in both packages.

The eleven scenarios of `tests/test_crash_recovery.py`, each driven on a
`zvec_tpu` collection and a `zvec_tpu_torch` collection with the same
operations: the collection is brought to a crash point (the in-memory state
abandoned, only what was fsync'd survives) and reopened from disk. Each
scenario's own checks hold in both packages, and the doc counts and the
answers (ids and scores) after recovery are equal. The fault injected inside
`VersionManager.commit` patches each package's own `db/version.py`.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import zvec_tpu  # noqa: E402
import zvec_tpu.db.version  # noqa: E402
import zvec_tpu_torch  # noqa: E402
import zvec_tpu_torch.db.version  # noqa: E402

PKGS = {"jax": zvec_tpu, "torch": zvec_tpu_torch}
VERSION_MODULES = {"jax": zvec_tpu.db.version, "torch": zvec_tpu_torch.db.version}


def _schema(pkg, max_docs=None):
    kw = {} if max_docs is None else {"max_doc_count_per_segment": max_docs}
    return pkg.CollectionSchema(
        "crash",
        fields=[pkg.FieldSchema("price", pkg.DataType.DOUBLE, nullable=True)],
        vectors=[pkg.VectorSchema("emb", pkg.DataType.VECTOR_FP32, 8, pkg.FlatIndexParam(pkg.MetricType.L2))],
        **kw,
    )


def make_docs(pkg, rng, n, start=0):
    vecs = rng.standard_normal((n, 8)).astype(np.float32)
    docs = [pkg.Doc(id=f"d{start + i}", vectors={"emb": vecs[i]}, fields={"price": float(i)})
            for i in range(n)]
    return docs, vecs


def crash_and_reopen(pkg, coll):
    """Abandon in-memory state; reopen from whatever is on disk."""
    path = coll._impl.path
    coll._impl.close()
    return pkg.open(path)


def _answer(pkg, coll, vec, topk):
    return [(d.id, d.score) for d in coll.query(pkg.VectorQuery("emb", vector=vec), topk=topk)]


def _same(out):
    """The two packages' records of one scenario: equal counts and ids,
    scores within 1e-4."""
    a, b = out["jax"], out["torch"]
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        if isinstance(ra, list):
            assert [i for i, _ in ra] == [i for i, _ in rb]
            assert np.allclose([s for _, s in ra], [s for _, s in rb], rtol=1e-4, atol=1e-4)
        else:
            assert ra == rb


def _run(tmp_path, scenario, **kw):
    out = {}
    for name, pkg in PKGS.items():
        out[name] = scenario(pkg, tmp_path / name, np.random.default_rng(42), **kw)
    _same(out)


def _recovery_with_unflushed_wal_after_version_commit(pkg, path, rng):
    c = pkg.create_and_open(str(path), _schema(pkg))
    docs, vecs = make_docs(pkg, rng, 10)
    c.insert(docs)
    c.create_index("price", pkg.InvertIndexParam())  # a version ahead of the (empty) checkpoint
    c2 = crash_and_reopen(pkg, c)
    rec = [c2.stats.doc_count, _answer(pkg, c2, vecs[4], 3)]
    assert rec[0] == 10 and rec[1][0][0] == "d4"
    more, _ = make_docs(pkg, rng, 3, start=10)
    assert all(s.is_ok() for s in c2.insert(more))
    rec.append(c2.stats.doc_count)
    assert rec[2] == 13
    c2._impl.close()
    return rec


def _crash_between_checkpoint_and_commit(pkg, path, rng):
    c = pkg.create_and_open(str(path), _schema(pkg))
    docs, vecs = make_docs(pkg, rng, 8)
    c.insert(docs)
    c._impl.writing.write_checkpoint()  # phase 1 only: "crash" before the commit
    c2 = crash_and_reopen(pkg, c)
    rec = [c2.stats.doc_count, _answer(pkg, c2, vecs[2], 3)]
    assert rec[0] == 8 and rec[1][0][0] == "d2"
    c2._impl.close()
    return rec


def _crash_between_commit_and_gc(pkg, path, rng):
    c = pkg.create_and_open(str(path), _schema(pkg))
    docs, vecs = make_docs(pkg, rng, 8)
    c.insert(docs)
    impl = c._impl
    impl.writing.write_checkpoint()
    impl._snapshot_maps()
    impl._commit_version()  # "crash" before gc_stale_files()
    seg_dir = impl.writing.directory
    assert os.path.exists(os.path.join(seg_dir, "wal_0.log"))
    c2 = crash_and_reopen(pkg, c)
    rec = [c2.stats.doc_count, os.path.exists(os.path.join(seg_dir, "wal_0.log")),
           _answer(pkg, c2, vecs[7], 3)]
    assert rec[0] == 8 and not rec[1] and rec[2][0][0] == "d7"
    c2._impl.close()
    return rec


def _no_duplicate_replay_after_flush(pkg, path, rng):
    c = pkg.create_and_open(str(path), _schema(pkg))
    docs, vecs = make_docs(pkg, rng, 6)
    c.insert(docs)
    c.flush()
    more, _ = make_docs(pkg, rng, 4, start=6)
    c.insert(more)  # in wal_1 only
    c2 = crash_and_reopen(pkg, c)
    rec = [c2.stats.doc_count, _answer(pkg, c2, vecs[1], 10)]
    assert rec[0] == 10 and rec[1][0][0] == "d1" and len(rec[1]) == 10
    c2._impl.close()
    return rec


def _update_then_crash(pkg, path, rng):
    c = pkg.create_and_open(str(path), _schema(pkg))
    docs, _ = make_docs(pkg, rng, 5)
    c.insert(docs)
    c.flush()
    newv = rng.standard_normal(8).astype(np.float32)
    c.update(pkg.Doc(id="d2", vectors={"emb": newv}, fields={"price": 99.0}))
    c2 = crash_and_reopen(pkg, c)
    rec = [c2.stats.doc_count, _answer(pkg, c2, newv, 5), c2.fetch("d2")["d2"].field("price")]
    assert rec[0] == 5 and rec[1][0][0] == "d2" and rec[2] == 99.0
    c2._impl.close()
    return rec


def _delete_then_crash(pkg, path, rng):
    c = pkg.create_and_open(str(path), _schema(pkg))
    docs, vecs = make_docs(pkg, rng, 5)
    c.insert(docs)
    c.flush()
    c.delete("d3")
    c2 = crash_and_reopen(pkg, c)
    rec = [c2.stats.doc_count, _answer(pkg, c2, vecs[3], 5)]
    assert rec[0] == 4 and "d3" not in [i for i, _ in rec[1]]
    c2._impl.close()
    return rec


def _update_does_not_rotate_mid_apply(pkg, path, rng):
    c = pkg.create_and_open(str(path), _schema(pkg, max_docs=4))
    docs, _ = make_docs(pkg, rng, 4)  # exactly fills the segment
    c.insert(docs)
    newv = rng.standard_normal(8).astype(np.float32)
    c.update(pkg.Doc(id="d1", vectors={"emb": newv}, fields={"price": 77.0}))
    c2 = crash_and_reopen(pkg, c)
    rec = [c2.stats.doc_count, _answer(pkg, c2, newv, 4), c2.fetch("d1")["d1"].field("price")]
    assert rec[0] == 4 and rec[1][0][0] == "d1" and rec[2] == 77.0
    c2._impl.close()
    return rec


def _crash_mid_compaction_before_swap(pkg, path, rng):
    c = pkg.create_and_open(str(path), _schema(pkg))
    docs, vecs = make_docs(pkg, rng, 6)
    c.insert(docs)
    impl = c._impl
    impl._seal_writing_segment()
    orphan = os.path.join(impl.path, "seg_99")  # a half-written compaction target
    os.makedirs(orphan)
    with open(os.path.join(orphan, "forward.arrow"), "wb") as fh:
        fh.write(b"garbage")
    c2 = crash_and_reopen(pkg, c)
    rec = [os.path.exists(orphan), c2.stats.doc_count, _answer(pkg, c2, vecs[5], 6)]
    assert not rec[0] and rec[1] == 6 and rec[2][0][0] == "d5"
    c2._impl.close()
    return rec


def _crash_inside_commit_before_current_swing(pkg, path, rng, monkeypatch, vmod):
    c = pkg.create_and_open(str(path), _schema(pkg))
    docs, _ = make_docs(pkg, rng, 6)
    c.insert(docs)
    c.flush()  # a durable generation
    more, mvecs = make_docs(pkg, rng, 4, start=6)
    c.insert(more)  # WAL only

    real_replace = os.replace

    def bomb(src, dst):
        if os.path.basename(dst) == "CURRENT":
            raise OSError("injected crash before CURRENT swing")
        return real_replace(src, dst)

    monkeypatch.setattr(vmod.os, "replace", bomb)
    with pytest.raises(OSError):
        c.flush()
    monkeypatch.setattr(vmod.os, "replace", real_replace)
    # the orphan version file exists but CURRENT still names the old version
    assert [n for n in os.listdir(c._impl.path) if n.startswith("version_")]
    c2 = crash_and_reopen(pkg, c)
    rec = [c2.stats.doc_count, _answer(pkg, c2, mvecs[1], 10)]
    assert rec[0] == 10 and rec[1][0][0] == "d7"
    c2.flush()  # a whole flush after recovery overwrites the orphan
    c3 = crash_and_reopen(pkg, c2)
    rec += [c3.stats.doc_count, _answer(pkg, c3, mvecs[2], 10)]
    assert rec[2] == 10
    c3._impl.close()
    return rec


def _leftover_tmp_files_ignored_on_open(pkg, path, rng):
    c = pkg.create_and_open(str(path), _schema(pkg))
    docs, vecs = make_docs(pkg, rng, 5)
    c.insert(docs)
    c.flush()
    impl = c._impl
    with open(os.path.join(impl.path, "CURRENT.tmp"), "w") as fh:
        fh.write("999")  # torn: never replaced
    with open(os.path.join(impl.path, "version_999.json.tmp"), "w") as fh:
        fh.write("{ torn json")
    c2 = crash_and_reopen(pkg, c)
    rec = [c2.stats.doc_count, _answer(pkg, c2, vecs[0], 5)]
    assert rec[0] == 5 and rec[1][0][0] == "d0"
    c2._impl.close()
    return rec


def _orphan_snapshots_gcd_by_next_flush(pkg, path, rng):
    c = pkg.create_and_open(str(path), _schema(pkg))
    docs, vecs = make_docs(pkg, rng, 5)
    c.insert(docs)
    impl = c._impl
    impl.writing.write_checkpoint()
    impl._snapshot_maps()  # writes idmap_{v+1} / deletes_{v+1}, then "crash"
    c2 = crash_and_reopen(pkg, c)
    rec = [c2.stats.doc_count]
    c2.flush()
    snaps = sorted(n for n in os.listdir(c2._impl.path) if n.startswith(("idmap_", "deletes_")))
    rec += [len(snaps), _answer(pkg, c2, vecs[3], 5)]
    assert rec[0] == 5 and rec[1] == 2  # exactly one live pair remains
    c2._impl.close()
    return rec


SCENARIOS = {
    "recovery_with_unflushed_wal_after_version_commit": _recovery_with_unflushed_wal_after_version_commit,
    "crash_between_checkpoint_and_commit": _crash_between_checkpoint_and_commit,
    "crash_between_commit_and_gc": _crash_between_commit_and_gc,
    "no_duplicate_replay_after_flush": _no_duplicate_replay_after_flush,
    "update_then_crash": _update_then_crash,
    "delete_then_crash": _delete_then_crash,
    "update_does_not_rotate_mid_apply": _update_does_not_rotate_mid_apply,
    "crash_mid_compaction_before_swap": _crash_mid_compaction_before_swap,
    "leftover_tmp_files_ignored_on_open": _leftover_tmp_files_ignored_on_open,
    "orphan_snapshots_gcd_by_next_flush": _orphan_snapshots_gcd_by_next_flush,
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_crash_scenario_matches_jax(tmp_path, scenario):
    _run(tmp_path, SCENARIOS[scenario])


def test_crash_inside_commit_before_current_swing_matches_jax(tmp_path, monkeypatch):
    """The fault is injected in each package's own `db/version.py`."""
    out = {}
    for name, pkg in PKGS.items():
        out[name] = _crash_inside_commit_before_current_swing(
            pkg, tmp_path / name, np.random.default_rng(42), monkeypatch, VERSION_MODULES[name])
    _same(out)
