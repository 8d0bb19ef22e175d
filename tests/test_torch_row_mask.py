"""The row mask on its way from the collection to the card, on the CPU.

Engines: every engine takes its host row mask through
`core/interface.py`'s `fit_row_mask` (sized to the engine's rows) and
`device_row_mask` (padded, pad rows out, placed on the device or the mesh).
Each engine searches under six masks: None, every row, a 1% tail, no row,
a mask 100 rows short of the engine's rows and one 100 rows long (the
concurrent-append race: the rows past a short mask stay out, a long mask is
cut). It is held to `zvec_tpu`'s engine of the same type on the same data
and graph or lists under the same mask, fitted by hand (the JAX sparse
engines take no other length): the same id set per query, scores within the
engine's parity tolerance (dense 1e-4 as `test_torch_hnsw_search.py` and
`test_torch_ivf.py`; sparse 1e-5 relative as `test_torch_hnsw_sparse.py`).
FLAT runs twice: its blockwise scan, and its fused route (`_use_kernel`
patched, the plain stage one, merge and stage two), where the 1% tail and
the empty mask take the compact route.

Collection: `CollectionImpl._row_mask` alone builds a segment's
alive-AND-filter rows; `_filter_only_doc_ids`, `scan` and `query` return the
same rows under a filter, with deletes, and when the filter's mask is 7 rows
shorter than the segment (rows appended after it was evaluated stay out).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import zvec_tpu  # noqa: E402
import zvec_tpu_torch as zt  # noqa: E402
from zvec_tpu.core import flat as jflat  # noqa: E402
from zvec_tpu.core import hnsw as jhnsw  # noqa: E402
from zvec_tpu.core import hnsw_sparse as jhsparse  # noqa: E402
from zvec_tpu.core import ivf as jivf  # noqa: E402
from zvec_tpu.core import sparse_flat as jsparse  # noqa: E402
from zvec_tpu_torch.core import flat as tflat  # noqa: E402
from zvec_tpu_torch.core import hnsw as thnsw  # noqa: E402
from zvec_tpu_torch.core import hnsw_sparse as thsparse  # noqa: E402
from zvec_tpu_torch.core import ivf as tivf  # noqa: E402
from zvec_tpu_torch.core import sparse_flat as tsparse  # noqa: E402
from zvec_tpu_torch.core.interface import device_row_mask, fit_row_mask  # noqa: E402
from zvec_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

N, D, NQ, K = 1200, 16, 8, 10
DENSE_TOL = 1e-4
SPARSE_RTOL = 1e-5
MASKS = ["none_given", "all", "tail1", "no_row", "short", "long"]
ENGINES = ["flat", "flat_fused", "hnsw", "ivf", "sparse_flat", "sparse_hnsw"]


def _mask(kind, n):
    rng = np.random.default_rng(len(kind))
    return {
        "none_given": None,
        "all": np.ones(n, bool),
        "tail1": np.arange(n) >= n - n // 100,
        "no_row": np.zeros(n, bool),
        "short": rng.random(n - 100) < 0.5,
        "long": rng.random(n + 100) < 0.5,
    }[kind]


def _fitted(mask, n):
    """The mask the engine's rows see, by hand: cut, or padded with rows out."""
    if mask is None:
        return None
    out = np.zeros(n, bool)
    out[: min(n, len(mask))] = mask[:n]
    return out


def _sparse_rows(rng, n):
    rows = []
    for _ in range(n):
        dims = rng.choice(600, 12, replace=False)
        rows.append({int(d): float(rng.random() + 0.1) for d in dims})
    return rows


def _build(name, tmp):
    """(jax engine, torch engine, queries) over one data set; the graph or
    lists are zvec_tpu's, loaded by the port's engine."""
    rng = np.random.default_rng(ENGINES.index(name))
    if name.startswith("sparse"):
        data, queries = _sparse_rows(rng, N), _sparse_rows(rng, NQ)
    else:
        data = rng.standard_normal((N, D)).astype(np.float32)
        queries = rng.standard_normal((NQ, D)).astype(np.float32)
    pair = []
    for pkg, mods in ((zvec_tpu, (jflat, jhnsw, jivf, jsparse, jhsparse)),
                      (zt, (tflat, thnsw, tivf, tsparse, thsparse))):
        flat, hnsw, ivf, sparse, hsparse = mods
        metric = pkg.MetricType.IP if name.startswith("sparse") else pkg.MetricType.L2
        if name.startswith("flat"):
            eng = flat.FlatEngine(metric, D, pkg.FlatIndexParam(metric))
        elif name == "hnsw":
            eng = hnsw.HnswEngine(metric, D, pkg.HnswIndexParam(metric, m=8, ef_construction=40))
        elif name == "ivf":
            eng = ivf.IvfEngine(metric, D, pkg.IVFIndexParam(metric, n_list=16, n_iters=4))
        elif name == "sparse_flat":
            eng = sparse.SparseFlatEngine(metric, 0, pkg.FlatIndexParam(metric))
        else:
            eng = hsparse.SparseHnswEngine(metric, 0, pkg.HnswIndexParam(metric, m=8, ef_construction=40))
        pair.append(eng)
    je, te = pair
    je.bind_data(lambda: data, lambda: 1)
    if name in ("hnsw", "ivf", "sparse_hnsw"):
        desc = je.dump_aux(str(tmp), "emb")
        te.load_aux(str(tmp), desc)
    te.bind_data(lambda: data, lambda: 1)
    if name == "flat_fused":
        te._use_kernel = lambda st, k: True  # the fused route, its plain versions on CPU tensors
    return je, te, queries


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _build(name, tmp_path_factory.mktemp(name))
        return cache[name]

    return get


def _param(pkg, name):
    if "hnsw" in name:
        return pkg.HnswQueryParam(ef=24, done_frac=1.0)
    if name == "ivf":
        return pkg.IVFQueryParam(nprobe=4)
    return None


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("name", ENGINES)
def test_engine_under_the_mask_matches_zvec_tpu(engines, name, kind):
    je, te, queries = engines(name)
    mask = _mask(kind, N)
    js, ji = je.search(queries, K, _fitted(mask, N), _param(zvec_tpu, name))
    if name == "flat_fused":
        te._mask_cache.clear()
    ts, ti = te.search(queries, K, mask, _param(zt, name))
    js, ji = np.asarray(js), np.asarray(ji)
    assert ti.shape == ji.shape == (NQ, K)
    for r in range(NQ):
        assert set(ti[r].tolist()) == set(ji[r].tolist()), r
    hit = ji >= 0
    assert (hit == (ti >= 0)).all()
    got, want = np.sort(np.where(hit, ts, 0), 1), np.sort(np.where(hit, js, 0), 1)
    if name.startswith("sparse"):
        np.testing.assert_allclose(got, want, rtol=SPARSE_RTOL)
    else:
        np.testing.assert_allclose(got, want, rtol=DENSE_TOL, atol=DENSE_TOL)
    fitted = _fitted(mask, N)
    if fitted is not None:
        assert fitted[ti[ti >= 0]].all()
        assert ((ti >= 0).sum(1) == min(K, int(fitted.sum()))).all()
    if name == "flat_fused":  # the compact route where at most a tenth of the rows pass
        (entry,) = te._mask_cache.values()
        assert (entry.rows is not None) == (kind in ("tail1", "no_row"))


@pytest.mark.parametrize("kind", MASKS)
def test_device_row_mask_pads_and_places(kind):
    n, n_pad = 1000, 1024
    mask = _mask(kind, n)
    want = np.zeros(n_pad, bool)
    want[:n] = True if mask is None else _fitted(mask, n)
    got = device_row_mask(mask, n, n_pad, dev="cpu")
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    mesh = make_mesh(4, device="cpu")
    shards = device_row_mask(mask, n, n_pad, mesh=mesh)
    assert [s.shape[0] for s in shards] == [n_pad // 4] * 4
    assert np.array_equal(torch.cat(shards).numpy(), want)
    if mask is not None and len(mask) == n:
        assert fit_row_mask(mask, n) is mask  # a mask that fits reaches the engine as it is
        placed = device_row_mask(mask, n, dev="cpu")
        assert not np.shares_memory(placed.numpy(), mask)  # engines cache what they place


@pytest.fixture
def col(tmp_path):
    schema = zt.CollectionSchema(
        "rows", fields=[zt.FieldSchema("tag", zt.DataType.INT64, index_param=zt.InvertIndexParam())],
        vectors=[zt.VectorSchema("vec", zt.DataType.VECTOR_FP32, 8,
                                 zt.FlatIndexParam(metric_type=zt.MetricType.L2))])
    c = zt.create_and_open(str(tmp_path / "col"), schema)
    rng = np.random.default_rng(1)
    c.x = rng.standard_normal((300, 8)).astype(np.float32)
    c.insert([zt.Doc(id=str(i), vectors={"vec": c.x[i]}, fields={"tag": i % 10}) for i in range(300)])
    c.delete([str(i) for i in range(0, 300, 7)])
    yield c
    c._impl.close()


@pytest.mark.parametrize("short_filter", [False, True], ids=["fitted", "filter_mask_short"])
def test_filter_only_scan_and_query_pass_the_same_rows(col, monkeypatch, short_filter):
    impl = col._impl
    if short_filter:  # the filter was evaluated before the segment's last 7 rows were appended
        evaluate = impl._filter_mask_for_segment
        monkeypatch.setattr(impl, "_filter_mask_for_segment", lambda seg, f: evaluate(seg, f)[:-7])
    flt = "tag >= 5"
    want = {i for i in range(300) if i % 10 >= 5 and i % 7 and (not short_filter or i < 293)}

    def pks(doc_ids):
        segs = [impl._segment_for_doc_id(d) for d in doc_ids]
        return {int(seg.store.pk(d - seg.doc_id_start)) for seg, d in zip(segs, doc_ids)}

    by_ids = pks(impl._filter_only_doc_ids(flt))
    by_scan = {int(pk) for batch in col.scan(filter=flt) for pk in batch.column("id").to_pylist()}
    by_query = {int(d.id) for d in col.query(zt.VectorQuery("vec", vector=col.x[0]), topk=300, filter=flt)}
    assert by_ids == by_scan == by_query == want
    assert pks(impl._filter_only_doc_ids(None)) == {i for i in range(300) if i % 7}
