"""The FLAT slice end to end: zvec_tpu_torch against zvec_tpu.

The same documents go through `create_and_open` -> `insert` -> `optimize` ->
`batch_query` / `batch_query_many` / `query` / filtered `query` in both
packages; ids must be equal and scores within 1e-4 (rtol and atol: float32
sums in another order). The collection on disk is the state a database
carries across, so a collection written by one package must open in the other
and answer alike. IVF collections train, answer, reopen and open across
packages the same way. Also: the port imports no JAX, a sparse field opens,
and what the port still has no engine for (multi-GPU sharding) fails loudly.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import zvec_tpu  # noqa: E402
import zvec_tpu_torch  # noqa: E402

N, DIM, NQ, K = 600, 16, 9, 10
REPO = Path(__file__).resolve().parent.parent

CONFIGS = {
    "l2": ("L2", "UNDEFINED"),
    "ip": ("IP", "UNDEFINED"),
    "cosine": ("COSINE", "UNDEFINED"),
    "int8_l2": ("L2", "INT8"),
    "fp16_cosine": ("COSINE", "FP16"),
}


def _schema(pkg, metric, qtype, index_param=None):
    return pkg.CollectionSchema(
        "parity",
        fields=[
            pkg.FieldSchema("price", pkg.DataType.DOUBLE, nullable=True),
            pkg.FieldSchema("tag", pkg.DataType.STRING, nullable=True),
        ],
        vectors=[
            pkg.VectorSchema(
                "emb",
                pkg.DataType.VECTOR_FP32,
                DIM,
                index_param
                or pkg.FlatIndexParam(
                    pkg.MetricType[metric], quantize_type=pkg.QuantizeType[qtype]
                ),
            )
        ],
    )


def _vectors():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, DIM)).astype(np.float32)
    Q = rng.standard_normal((NQ, DIM)).astype(np.float32)
    return X, Q


def _fill(pkg, path, metric="L2", qtype="UNDEFINED", optimize=True):
    X, _ = _vectors()
    col = pkg.create_and_open(str(path), _schema(pkg, metric, qtype))
    for lo in range(0, N, 256):
        col.insert(
            [
                pkg.Doc(
                    id=f"d{i}",
                    vectors={"emb": X[i]},
                    fields={"price": float(i % 50), "tag": f"t{i % 7}"},
                )
                for i in range(lo, min(lo + 256, N))
            ]
        )
    if optimize:
        col.optimize()
    return col


def _ids_scores(docs_lists):
    ids = [[d.id for d in docs] for docs in docs_lists]
    scores = np.array([[d.score for d in docs] for docs in docs_lists], np.float64)
    return ids, scores


def _assert_same(a, b):
    (ia, sa), (ib, sb) = a, b
    assert ia == ib
    assert np.allclose(sa, sb, rtol=1e-4, atol=1e-4)


@pytest.fixture(params=sorted(CONFIGS), scope="module")
def pair(request, tmp_path_factory):
    metric, qtype = CONFIGS[request.param]
    root = tmp_path_factory.mktemp(request.param)
    cj = _fill(zvec_tpu, root / "jax", metric, qtype)
    ct = _fill(zvec_tpu_torch, root / "torch", metric, qtype)
    yield cj, ct
    cj._impl.close()
    ct._impl.close()


def test_batch_query(pair):
    cj, ct = pair
    _, Q = _vectors()
    a = _ids_scores(cj.batch_query("emb", Q, topk=K, output_fields=[]))
    b = _ids_scores(ct.batch_query("emb", Q, topk=K, output_fields=[]))
    _assert_same(a, b)


def test_batch_query_many(pair):
    cj, ct = pair
    _, Q = _vectors()
    blocks = [Q, np.roll(Q, 3, axis=0)]
    ra = cj.batch_query_many("emb", blocks, topk=K, output_fields=[])
    rb = ct.batch_query_many("emb", blocks, topk=K, output_fields=[])
    assert len(ra) == len(rb) == 2
    for xa, xb in zip(ra, rb):
        _assert_same(_ids_scores(xa), _ids_scores(xb))


def test_query_and_filtered_query(pair):
    cj, ct = pair
    _, Q = _vectors()
    for flt in (None, "price < 20", "tag = 't3'"):
        a = cj.query(zvec_tpu.VectorQuery("emb", vector=Q[1]), topk=K, filter=flt)
        b = ct.query(zvec_tpu_torch.VectorQuery("emb", vector=Q[1]), topk=K, filter=flt)
        _assert_same(_ids_scores([a]), _ids_scores([b]))
        assert [d.field("price") for d in a] == [d.field("price") for d in b]
        if flt == "price < 20":
            assert all(d.field("price") < 20 for d in b)


def test_reopen_after_flush(tmp_path):
    _, Q = _vectors()
    col = _fill(zvec_tpu_torch, tmp_path / "c")
    col.insert([zvec_tpu_torch.Doc(id="late", vectors={"emb": Q[0]}, fields={"price": 1.0})])
    before = _ids_scores(col.batch_query("emb", Q, topk=K, output_fields=[]))
    col.flush()
    col._impl.close()
    again = zvec_tpu_torch.open(str(tmp_path / "c"))
    after = _ids_scores(again.batch_query("emb", Q, topk=K, output_fields=[]))
    _assert_same(before, after)
    assert before[0][0][0] == "late"  # the unsealed insert came back from the WAL
    again._impl.close()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_collection_opens_across_packages(tmp_path, writer, reader):
    """Manifest, WAL codec and Arrow forward file are shared: a collection
    written by one package (sealed rows plus WAL-only rows) opens in the other
    and answers as the writer does."""
    pkgs = {"jax": zvec_tpu, "torch": zvec_tpu_torch}
    w, r = pkgs[writer], pkgs[reader]
    _, Q = _vectors()
    col = _fill(w, tmp_path / "c", "COSINE", "UNDEFINED")
    col.insert([w.Doc(id="wal_only", vectors={"emb": Q[2]}, fields={"price": 3.0})])
    col.flush()
    expect = _ids_scores(col.batch_query("emb", Q, topk=K, output_fields=[]))
    col._impl.close()
    other = r.open(str(tmp_path / "c"))
    got = _ids_scores(other.batch_query("emb", Q, topk=K, output_fields=[]))
    _assert_same(expect, got)
    assert other.stats.doc_count == N + 1
    other._impl.close()


PKGS = {"jax": zvec_tpu, "torch": zvec_tpu_torch}
N_IVF = 1500  # above the IVF brute-force threshold of 1,000 rows


def _fill_ivf(pkg, path, index_param, optimize=True):
    """N_IVF clustered docs; the first N come from `_vectors`."""
    X, _ = _vectors()
    rng = np.random.default_rng(1)
    extra = (X[rng.integers(0, N, N_IVF - N)] + 0.1 * rng.standard_normal((N_IVF - N, DIM)))
    X = np.concatenate([X, extra.astype(np.float32)])
    col = pkg.create_and_open(str(path), _schema(pkg, "L2", "UNDEFINED", index_param))
    for lo in range(0, N_IVF, 500):
        col.insert(
            [
                pkg.Doc(id=f"d{i}", vectors={"emb": X[i]},
                        fields={"price": float(i % 50), "tag": f"t{i % 7}"})
                for i in range(lo, lo + 500)
            ]
        )
    if optimize:
        col.optimize()
    return col


def _ivf_engine(col):
    return next(s for s in col._impl._segments_snapshot() if s.doc_count > 0).engine_for("emb")


def test_ivf_collection_create_fill_query(tmp_path):
    """An IVF collection (SOAR lists) trains on optimize and answers
    batch_query, IVFQueryParam and a filtered query as zvec_tpu does; it
    flushes and reopens without training again."""
    from zvec_tpu_torch.ops.kmeans import lloyd

    _, Q = _vectors()
    out = {}
    for name, pkg in PKGS.items():
        col = _fill_ivf(pkg, tmp_path / name, pkg.IVFIndexParam(pkg.MetricType.L2, n_list=16, use_soar=True))
        p = pkg.IVFQueryParam(nprobe=3)
        out[name] = [
            _ids_scores(col.batch_query("emb", Q, topk=K, output_fields=[])),
            _ids_scores(col.batch_query("emb", Q, topk=K, output_fields=[], param=p)),
            _ids_scores([col.query(pkg.VectorQuery("emb", vector=Q[1], param=p), topk=K,
                                   filter="price < 20")]),
        ]
        if name == "torch":
            assert type(_ivf_engine(col)).__name__ == "IvfEngine"
            col.flush()
            col._impl.close()
            calls = lloyd.calls
            col = pkg.open(str(tmp_path / name))
            _assert_same(out[name][1], _ids_scores(
                col.batch_query("emb", Q, topk=K, output_fields=[], param=p)))
            assert lloyd.calls == calls and _ivf_engine(col)._loaded_aux is not None
        col._impl.close()
    for a, b in zip(out["jax"], out["torch"]):
        _assert_same(a, b)


def test_create_index_ivf_on_flat_collection(tmp_path):
    _, Q = _vectors()
    out = {}
    for name, pkg in PKGS.items():
        col = _fill_ivf(pkg, tmp_path / name, pkg.FlatIndexParam(pkg.MetricType.L2))
        col.create_index("emb", pkg.IVFIndexParam(pkg.MetricType.L2, n_list=12))
        assert "emb" in col._impl.segments[0].meta.indexes
        out[name] = _ids_scores(col.batch_query(
            "emb", Q, topk=K, output_fields=[], param=pkg.IVFQueryParam(nprobe=2)))
        if name == "torch":
            assert type(_ivf_engine(col)).__name__ == "IvfEngine"
        col._impl.close()
    _assert_same(out["jax"], out["torch"])


def test_open_jax_ivf_collection(tmp_path):
    """An IVF collection written by zvec_tpu (sealed rows plus WAL-only
    rows) opens in the port, which loads the trained lists from
    `ivf_emb.npz` instead of training, and returns zvec_tpu's ids."""
    from zvec_tpu_torch.ops.kmeans import lloyd

    _, Q = _vectors()
    jc = _fill_ivf(zvec_tpu, tmp_path / "j", zvec_tpu.IVFIndexParam(zvec_tpu.MetricType.L2, n_list=16))
    jc.insert([zvec_tpu.Doc(id="wal_only", vectors={"emb": Q[2]}, fields={"price": 3.0})])
    jc.flush()
    expect = _ids_scores(jc.batch_query("emb", Q, topk=K, output_fields=[],
                                        param=zvec_tpu.IVFQueryParam(nprobe=4)))
    jc._impl.close()
    calls = lloyd.calls
    tc = zvec_tpu_torch.open(str(tmp_path / "j"))
    got = _ids_scores(tc.batch_query("emb", Q, topk=K, output_fields=[],
                                     param=zvec_tpu_torch.IVFQueryParam(nprobe=4)))
    _assert_same(expect, got)
    assert got[0][2][0] == "wal_only"
    assert lloyd.calls == calls and _ivf_engine(tc)._loaded_aux is not None
    tc._impl.close()


def test_sparse_field_and_multi_gpu_raise(tmp_path, monkeypatch):
    p = zvec_tpu_torch
    schema = p.CollectionSchema(
        "sparse_col",
        vectors=[p.VectorSchema("sp", p.DataType.SPARSE_VECTOR_FP32, 0, p.FlatIndexParam(p.MetricType.IP))],
    )
    # a sparse field is admitted: the collection opens, answers and reopens
    col = p.create_and_open(str(tmp_path / "s"), schema)
    col.insert([p.Doc(id=str(i), vectors={"sp": {i: 1.0, i + 1: 0.5}}) for i in range(8)])
    assert [d.id for d in col.query(p.VectorQuery("sp", vector={3: 1.0}), topk=2)] == ["3", "2"]
    col.flush()
    col._impl.close()
    col = p.open(str(tmp_path / "s"))
    assert col.query(p.VectorQuery("sp", vector={5: 1.0}), topk=1)[0].id == "5"
    col._impl.close()
    # init(mesh_devices=2) is accepted, and a collection then answers sharded
    from zvec_tpu_torch.utils.config import GlobalConfig

    monkeypatch.setattr(GlobalConfig, "_instance", None)
    p.init(mesh_devices=2)
    assert GlobalConfig.instance().mesh_devices == 2
    col = p.create_and_open(str(tmp_path / "m"), schema)
    col.insert([p.Doc(id=str(i), vectors={"sp": {i: 1.0, i + 1: 0.5}}) for i in range(600)])
    col.optimize()
    eng = col._impl._segments_snapshot()[0].engine_for("sp")
    eng._ensure_fresh()
    assert eng._smesh is not None and len(eng._doc_idx) == 2
    assert [d.id for d in col.query(p.VectorQuery("sp", vector={513: 1.0}), topk=2)] == ["513", "512"]
    col._impl.close()


def test_import_leaves_jax_out():
    code = (
        "import sys; import zvec_tpu_torch; import zvec_tpu_torch.core.flat; "
        "import zvec_tpu_torch.ops.flat_scan; import zvec_tpu_torch.core.hnsw; "
        "import zvec_tpu_torch.ops.hnsw; import zvec_tpu_torch.core.ivf; "
        "import zvec_tpu_torch.ops.kmeans; "
        "import zvec_tpu_torch.ops.sparse; import zvec_tpu_torch.core.sparse_flat; "
        "import zvec_tpu_torch.ops.hnsw_sparse; import zvec_tpu_torch.core.hnsw_sparse; "
        "import zvec_tpu_torch.ops.fused; import zvec_tpu_torch.tool.util; "
        "import zvec_tpu_torch.extension.multi_vector_reranker; "
        "import zvec_tpu_torch.extension.providers; "
        "import zvec_tpu_torch.extension.bm25_embedding_function; "
        "import zvec_tpu_torch.tools.build, zvec_tpu_torch.tools.recall, zvec_tpu_torch.tools.bench; "
        "import zvec_tpu_torch.tools.txt2vecs, zvec_tpu_torch.tools.io; "
        "import zvec_tpu_torch.examples.quickstart, zvec_tpu_torch.examples.hybrid_multivector; "
        "import zvec_tpu_torch.examples.quantized_groupby, zvec_tpu_torch.examples.mesh_sharding; "
        "import zvec_tpu_torch.parallel.mesh, zvec_tpu_torch.graft_entry; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'zvec_tpu' or m.startswith('zvec_tpu.') or m == 'triton']; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env)


def test_no_jax_or_zvec_tpu_imports_in_port():
    """No module of the port imports jax or zvec_tpu, and none imports
    triton at module level (only inside the function that launches)."""
    offenders = []
    pkg = REPO / "zvec_tpu_torch"
    for path in sorted(pkg.rglob("*.py")):
        if (pkg / "_build") in path.parents:  # build outputs, not the package
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                top_level = node in tree.body
                if root in ("jax", "jaxlib", "zvec_tpu") or (root == "triton" and top_level):
                    offenders.append(f"{path.relative_to(REPO)}:{node.lineno} {name}")
    assert not offenders, offenders
