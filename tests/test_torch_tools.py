"""The command-line tools of zvec_tpu_torch: the cases of tests/test_tools.py
and tests/test_txt2vecs.py against the port, and collections built by one
package's `tools.build` read by the other's `tools.recall` with equal recall
(both walk the same graph file)."""

import os
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

from zvec_tpu_torch.tools import bench, build, recall  # noqa: E402
from zvec_tpu_torch.tools.io import read_vecs, write_vecs  # noqa: E402
from zvec_tpu_torch.tools.recall import compute_recall  # noqa: E402
from zvec_tpu_torch.tools.txt2vecs import convert_sparse, main as txt2vecs, sparse_rows  # noqa: E402


def test_vecs_roundtrip(tmp_path, rng):
    data = rng.standard_normal((20, 7)).astype(np.float32)
    p = str(tmp_path / "x.fvecs")
    write_vecs(p, data)
    np.testing.assert_array_equal(read_vecs(p), data)
    assert read_vecs(p, limit=5).shape == (5, 7)
    ints = rng.integers(0, 100, (10, 4)).astype(np.int32)
    p2 = str(tmp_path / "x.ivecs")
    write_vecs(p2, ints)
    np.testing.assert_array_equal(read_vecs(p2), ints)
    with pytest.raises(ValueError, match="extension"):
        write_vecs(str(tmp_path / "x.txt"), ints)


def test_compute_recall():
    r = compute_recall(np.array([[1, 2, 3], [4, 9, 6]]), np.array([[1, 2, 3], [4, 5, 6]]), [1, 3])
    assert r["recall@1"] == 1.0 and r["recall@3"] == 5 / 6


def test_build_bench_recall_cli(tmp_path, rng, capsys):
    base = rng.standard_normal((300, 12)).astype(np.float32)
    queries = base[:10] + 0.01 * rng.standard_normal((10, 12)).astype(np.float32)
    gt = np.argsort(((queries[:, None, :] - base[None, :, :]) ** 2).sum(-1), axis=1)[:, :10].astype(np.int32)
    write_vecs(str(tmp_path / "base.fvecs"), base)
    write_vecs(str(tmp_path / "q.fvecs"), queries)
    write_vecs(str(tmp_path / "gt.ivecs"), gt)
    col = str(tmp_path / "col")
    build.main(["--output", col, "--vectors", str(tmp_path / "base.fvecs"), "--index", "flat", "--metric", "l2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["docs"] == 300
    recall.main(["--collection", col, "--field", "emb", "--queries", str(tmp_path / "q.fvecs"),
                 "--ground-truth", str(tmp_path / "gt.ivecs"), "--topk", "1,10"])
    assert json.loads(capsys.readouterr().out)["recall@10"] == 1.0  # the flat scan is exact
    bench.main(["--collection", col, "--field", "emb", "--queries", str(tmp_path / "q.fvecs"),
                "--seconds", "0.5", "--batch", "4"])
    out = json.loads(capsys.readouterr().out)
    assert out["qps"] > 0 and "p99" in out and out["batch"] == 4


def test_parquet_dataset_prep(tmp_path):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    from zvec_tpu_torch.tools.io import convert_parquet_dataset, load_vectors, read_parquet_vectors

    rng = np.random.default_rng(0)
    X = rng.standard_normal((37, 8)).astype(np.float32)
    G = rng.integers(0, 37, (37, 5)).astype(np.int64)
    p = str(tmp_path / "shard.parquet")
    pq.write_table(pa.table({
        "id": pa.array(range(37)),
        "emb": pa.array(X.tolist(), pa.list_(pa.float32())),
        "neighbors_id": pa.array(G.tolist(), pa.list_(pa.int64())),
    }), p)
    assert np.allclose(read_parquet_vectors(p), X)
    assert read_parquet_vectors(p, limit=10).shape == (10, 8)
    assert np.allclose(load_vectors(p, limit=5), X[:5])
    with pytest.raises(ValueError):
        read_parquet_vectors(p, column="nope")
    out_v, out_g = str(tmp_path / "v.npy"), str(tmp_path / "g.npy")
    assert convert_parquet_dataset([p], out_v, neighbors_column="neighbors_id", out_neighbors=out_g) == 37
    assert np.allclose(np.load(out_v), X) and np.array_equal(np.load(out_g), G)
    out_f = str(tmp_path / "v.fvecs")
    convert_parquet_dataset([p], out_f, limit=12)
    assert np.allclose(load_vectors(out_f), X[:12])


def test_txt2vecs_dense_roundtrip(tmp_path):
    txt = tmp_path / "in.txt"
    txt.write_text("0;1 2 3 4\n1;5 6 7 8\n\n7;9 10 11 12\n")
    out = str(tmp_path / "out.fvecs")
    assert txt2vecs(["--input", str(txt), "--output", out, "--dimension", "4"]) == 0
    np.testing.assert_array_equal(
        read_vecs(out), np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], np.float32))
    np.testing.assert_array_equal(np.load(out + ".keys.npy"), np.array([0, 1, 7], np.uint64))


def test_txt2vecs_dense_int8_and_dim_mismatch(tmp_path):
    txt = tmp_path / "in.txt"
    txt.write_text("0;1 2 3\n1;4 5\n2;6 7 8\n")  # middle row: wrong dim, skipped
    out = str(tmp_path / "out.bvecs")
    txt2vecs(["--input", str(txt), "--output", out, "--dimension", "3", "--type", "int8"])
    got = read_vecs(out)
    assert got.shape == (2, 3)
    np.testing.assert_array_equal(got[1], np.array([6, 7, 8], np.uint8))


def test_txt2vecs_sparse_roundtrip_and_validation(tmp_path):
    txt = tmp_path / "in.txt"
    txt.write_text("3;2;1 5:0.5 0.25\n9;3;0 2 7:1 2 3\n")
    out = str(tmp_path / "out.npz")
    assert txt2vecs(["--input", str(txt), "--output", out, "--vector-type", "sparse"]) == 0
    keys, rows = sparse_rows(out)
    np.testing.assert_array_equal(keys, np.array([3, 9], np.uint64))
    assert rows == [{1: 0.5, 5: 0.25}, {0: 1.0, 2: 2.0, 7: 3.0}]
    (tmp_path / "a.txt").write_text("1;2;1 5:0.5\n")  # 2 indices, 1 value
    with pytest.raises(ValueError, match="count"):
        convert_sparse(str(tmp_path / "a.txt"))
    (tmp_path / "b.txt").write_text("1;2;5 1:0.5 0.25\n")  # indices not ascending
    with pytest.raises(ValueError, match="ordered"):
        convert_sparse(str(tmp_path / "b.txt"))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_recall_across_packages(tmp_path, capsys, writer):
    """One package's tools.build writes an HNSW collection (its graph in the
    shared file format); both packages' tools.recall read it at a small ef and
    report the same recall."""
    from zvec_tpu.tools import build as jbuild, recall as jrecall

    rng = np.random.default_rng(8)
    base = rng.standard_normal((1500, 16)).astype(np.float32)
    queries = rng.standard_normal((12, 16)).astype(np.float32)
    gt = np.argsort(((queries[:, None, :] - base[None, :, :]) ** 2).sum(-1), axis=1)[:, :10].astype(np.int32)
    for name, arr in (("base.fvecs", base), ("q.fvecs", queries), ("gt.ivecs", gt)):
        write_vecs(str(tmp_path / name), arr)
    col = str(tmp_path / "col")
    (jbuild if writer == "jax" else build).main([
        "--output", col, "--vectors", str(tmp_path / "base.fvecs"), "--index", "hnsw",
        "--m", "8", "--ef-construction", "40"])
    capsys.readouterr()
    got = {}
    for name, tool in (("jax", jrecall), ("torch", recall)):
        tool.main(["--collection", col, "--field", "emb", "--queries", str(tmp_path / "q.fvecs"),
                   "--ground-truth", str(tmp_path / "gt.ivecs"), "--topk", "1,10", "--ef", "12"])
        got[name] = json.loads(capsys.readouterr().out)
    assert 0.5 < got["torch"]["recall@10"] < 1.0  # the beam, not an exact scan
    for k in ("recall@1", "recall@10", "queries"):
        assert got["torch"][k] == got["jax"][k]
