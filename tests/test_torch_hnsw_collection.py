"""The HNSW slice end to end: zvec_tpu_torch against zvec_tpu.

The default schema (no index param, so HNSW with m=50, ef_construction=500,
metric IP) goes through `create_and_open` -> `insert` -> `optimize` ->
`query` / `batch_query` / `batch_query_many` / filtered `query` in both
packages. Both build the same graph (n <= 8,192 builds on the host), so ids
must be equal and scores within 1e-4 (rtol and atol: float32 sums in another
order). The graph file is the state carried across: a collection written by
one package opens in the other and answers alike, without a rebuild.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import zvec_tpu  # noqa: E402
import zvec_tpu_torch  # noqa: E402
from zvec_tpu_torch.ops.flat_scan import flat_scan_topk  # noqa: E402

N, DIM, NQ, K = 1200, 16, 9, 10
PKGS = {"jax": zvec_tpu, "torch": zvec_tpu_torch}


def _vectors():
    rng = np.random.default_rng(20)
    return (
        rng.standard_normal((N, DIM)).astype(np.float32),
        rng.standard_normal((NQ, DIM)).astype(np.float32),
    )


def _schema(pkg, index_param=None):
    return pkg.CollectionSchema(
        "hnsw_parity",
        fields=[
            pkg.FieldSchema("price", pkg.DataType.DOUBLE, nullable=True),
            pkg.FieldSchema("tag", pkg.DataType.STRING, nullable=True),
        ],
        vectors=[pkg.VectorSchema("emb", pkg.DataType.VECTOR_FP32, DIM, index_param)],
    )


def _fill(pkg, path, index_param=None, optimize=True):
    X, _ = _vectors()
    col = pkg.create_and_open(str(path), _schema(pkg, index_param))
    for lo in range(0, N, 300):
        col.insert(
            [
                pkg.Doc(id=f"d{i}", vectors={"emb": X[i]},
                        fields={"price": float(i % 50), "tag": f"t{i % 7}"})
                for i in range(lo, min(lo + 300, N))
            ]
        )
    if optimize:
        col.optimize()
    return col


def _ids_scores(docs_lists):
    ids = [[d.id for d in docs] for docs in docs_lists]
    return ids, np.array([[d.score for d in docs] for docs in docs_lists], np.float64)


def _assert_same(a, b):
    (ia, sa), (ib, sb) = a, b
    assert ia == ib
    assert np.allclose(sa, sb, rtol=1e-4, atol=1e-4)


def _engine(col):
    seg = next(s for s in col._impl._segments_snapshot() if s.doc_count > 0)
    return seg.engine_for("emb")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("hnsw_default")
    cj = _fill(zvec_tpu, root / "jax")
    ct = _fill(zvec_tpu_torch, root / "torch")
    yield cj, ct
    cj._impl.close()
    ct._impl.close()


def test_default_schema_is_hnsw(pair):
    _, ct = pair
    eng = _engine(ct)
    assert type(eng).__module__ == "zvec_tpu_torch.core.hnsw"
    assert (eng.m, eng.ef_construction) == (50, 500)
    assert eng._dev is not None and eng._dev["num_levels"] >= 1


def test_batch_query(pair):
    cj, ct = pair
    _, Q = _vectors()
    a = _ids_scores(cj.batch_query("emb", Q, topk=K, output_fields=[]))
    b = _ids_scores(ct.batch_query("emb", Q, topk=K, output_fields=[]))
    _assert_same(a, b)


@pytest.mark.parametrize("ef,done_frac", [(32, 1.0), (100, 0.97)])
def test_batch_query_many_with_param(pair, ef, done_frac):
    cj, ct = pair
    _, Q = _vectors()
    blocks = [Q, np.roll(Q, 3, axis=0)]
    ra = cj.batch_query_many("emb", blocks, topk=K, output_fields=[],
                             param=zvec_tpu.HnswQueryParam(ef=ef, done_frac=done_frac))
    rb = ct.batch_query_many("emb", blocks, topk=K, output_fields=[],
                             param=zvec_tpu_torch.HnswQueryParam(ef=ef, done_frac=done_frac))
    assert len(ra) == len(rb) == 2
    for xa, xb in zip(ra, rb):
        _assert_same(_ids_scores(xa), _ids_scores(xb))


def test_query_and_filtered_query(pair):
    cj, ct = pair
    _, Q = _vectors()
    for flt in (None, "price < 20", "tag = 't3'", "price = 7"):
        a = cj.query(zvec_tpu.VectorQuery("emb", vector=Q[1]), topk=K, filter=flt)
        b = ct.query(zvec_tpu_torch.VectorQuery("emb", vector=Q[1]), topk=K, filter=flt)
        _assert_same(_ids_scores([a]), _ids_scores([b]))
        assert [d.field("price") for d in a] == [d.field("price") for d in b]
        if flt == "price < 20":
            assert all(d.field("price") < 20 for d in b)


def test_group_by_on_hnsw_matches_jax(pair):
    """Group-by on the default HNSW field (metric IP, so the graph lives in
    the MIPS-augmented space and `search_grouped` hands over to iterative
    deepening): admitted, and equal to zvec_tpu's answer."""
    cj, ct = pair
    _, Q = _vectors()
    out = []
    for pkg, col in ((zvec_tpu, cj), (zvec_tpu_torch, ct)):
        docs = col.group_by_query(
            pkg.VectorQuery("emb", vector=Q[0]), group_by_field="tag",
            group_count=3, group_topk=2,
        )
        out.append(([(d.id, d.field("tag")) for d in docs], [[d.score for d in docs]]))
    assert out[0][0] == out[1][0]
    assert np.allclose(out[0][1], out[1][1], rtol=1e-4, atol=1e-4)
    assert len({t for _, t in out[1][0]}) == 3 and len(out[1][0]) == 6


def test_reopen_loads_graph_from_disk(tmp_path):
    _, Q = _vectors()
    p = zvec_tpu_torch
    col = _fill(p, tmp_path / "c", p.HnswIndexParam(p.MetricType.L2, m=8, ef_construction=60))
    before = _ids_scores(col.batch_query("emb", Q, topk=K, output_fields=[]))
    col.flush()
    col._impl.close()
    launches = flat_scan_topk.launches
    again = p.open(str(tmp_path / "c"))
    after = _ids_scores(again.batch_query("emb", Q, topk=K, output_fields=[]))
    _assert_same(before, after)
    eng = _engine(again)
    assert eng._loaded_aux is not None  # the graph came from the aux file
    assert eng.stats.build_count == 1 and "forward_knn" not in eng.build_times
    assert flat_scan_topk.launches == launches
    again._impl.close()


def test_create_index_hnsw_on_flat_collection(tmp_path):
    _, Q = _vectors()
    out = {}
    for name, pkg in PKGS.items():
        col = _fill(pkg, tmp_path / name, pkg.FlatIndexParam(pkg.MetricType.COSINE))
        col.create_index("emb", pkg.HnswIndexParam(pkg.MetricType.COSINE, m=8, ef_construction=60))
        assert "emb" in col._impl.segments[0].meta.indexes
        out[name] = _ids_scores(col.batch_query("emb", Q, topk=K, output_fields=[]))
        if name == "torch":
            assert type(_engine(col)).__name__ == "HnswEngine"
        col._impl.close()
    _assert_same(out["jax"], out["torch"])


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_hnsw_collection_opens_across_packages(tmp_path, writer, reader):
    """The graph file `hnsw_emb.npz` has one format: a collection built by
    one package (sealed HNSW rows plus WAL-only rows) opens in the other,
    which loads the graph instead of rebuilding it, and answers alike."""
    w, r = PKGS[writer], PKGS[reader]
    _, Q = _vectors()
    col = _fill(w, tmp_path / "c", w.HnswIndexParam(w.MetricType.L2, m=8, ef_construction=60))
    col.insert([w.Doc(id="wal_only", vectors={"emb": Q[2]}, fields={"price": 3.0})])
    col.flush()
    param = w.HnswQueryParam(ef=48, done_frac=1.0)
    expect = _ids_scores(col.batch_query("emb", Q, topk=K, output_fields=[], param=param))
    col._impl.close()
    other = r.open(str(tmp_path / "c"))
    got = _ids_scores(other.batch_query("emb", Q, topk=K, output_fields=[],
                                        param=r.HnswQueryParam(ef=48, done_frac=1.0)))
    _assert_same(expect, got)
    assert got[0][2][0] == "wal_only"
    assert other.stats.doc_count == N + 1
    assert _engine(other)._loaded_aux is not None
    other._impl.close()
