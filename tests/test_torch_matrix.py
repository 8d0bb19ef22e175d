"""The index-configuration matrix through both packages, small: zvec_tpu_torch
against zvec_tpu on the CPU, one case per configuration that `chip_smoke.py`
runs at deployment size on the card (phases `mips`, `compact`, `codes`,
`hamming`).

- mips: HnswIndexParam()'s default IP metric (the MIPS -> L2 augmentation) on
  the text2image-shaped generator, 10,000 x 200 (cut from 20,000 for the
  file's time): L0 rows equal as sets on >= 99% of nodes (after the
  augmentation every row has the same norm, so the L2 epilogue cancels and
  near-ties reorder a row's neighbours: 92% of rows are equal in order at
  9,000 rows, 99.9% as sets; raw L2 on the same rows 98.4% in order), the
  same ids outside near-ties, scores within 1e-4 relative and equal to q.x
  of the returned rows.
- compact: delete, delete_by_filter, then optimize on FLAT / HNSW / IVF
  collections of 5,000 rows: the same doc count, ids and scores, one sealed
  segment, and each package's compacted files open in the other with the same
  answers.
- codes: FLAT FP16 / INT8 / INT4 / IP, IVF-SQ8 and IVF IP, HNSW INT8 / FP16 /
  INT4 (COSINE, config #3's generator), refine on and off: the same ids
  outside near-ties, scores within 1e-4.
- hamming: HAMMING FLAT and HNSW on the script's 256-bit generator: identical
  ids and exactly equal scores.
- chip_smoke.py's copies of the generators held draw for draw to their
  sources: config #3's (`benchmarks/bench_suite.py`) and `make_data`
  (`benchmarks/h2h.py`) at the text2image width.

Near-tie: a row whose ids differ is accepted when every differing id scores
within TOL (relative) of the row's k-th score in both packages.
"""

import importlib
import importlib.util
import inspect
import os
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import chip_smoke as cs  # noqa: E402
import zvec_tpu  # noqa: E402
import zvec_tpu_torch  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PKGS = {"jax": zvec_tpu, "torch": zvec_tpu_torch}
TOL = 1e-4
K = 10


def _answers(col, field, queries, param=None, topk=K):
    docs = col.batch_query(field, queries, topk=topk, output_fields=[], param=param)
    ids = np.array([[int(d.id) for d in row] for row in docs], np.int64)
    scores = np.array([[d.score for d in row] for row in docs], np.float64)
    return ids, scores


def _agree(a, b, tol=TOL):
    """Two (ids, scores) batches: per row the same ids, except near-ties at the
    k-th score; scores within tol on the rows whose ids agree."""
    (ai, as_), (bi, bs) = a, b
    assert ai.shape == bi.shape
    differ = 0
    for r in range(len(ai)):
        if (ai[r] == bi[r]).all():
            np.testing.assert_allclose(as_[r], bs[r], rtol=tol, atol=tol)
            continue
        differ += 1
        sa, sb = dict(zip(ai[r], as_[r])), dict(zip(bi[r], bs[r]))
        kth = bs[r, -1]
        extra = [sa[i] for i in sa.keys() - sb.keys()] + [sb[i] for i in sb.keys() - sa.keys()]
        assert all(abs(v - kth) <= tol * max(abs(kth), 1.0) for v in extra), (r, ai[r], bi[r], as_[r], bs[r])
    return differ


def _engine(col, field):
    return next(s for s in col._impl._segments_snapshot() if s.doc_count > 0).engine_for(field)


# ---------------------------------------------------------------- mips

MI_N, MI_NQ = 10_000, 32


@pytest.fixture(scope="module")
def mips(tmp_path_factory):
    X, Q = cs.mips_data(MI_N, MI_NQ)
    out = {}
    for name, p in PKGS.items():
        path = str(tmp_path_factory.mktemp(f"mips_{name}") / "c")
        # HnswIndexParam()'s own metric, m and ef_construction; knn_k 127 is
        # what the 1M build takes on the card, and what zvec_tpu caps it to on
        # a CPU backend (its graph would differ from the port's otherwise)
        param = p.HnswIndexParam(knn_k=127)
        assert (param.metric_type, param.m, param.ef_construction) == (p.MetricType.IP, 50, 500)
        schema = p.CollectionSchema("t2i", vectors=[p.VectorSchema("vec", p.DataType.VECTOR_FP32, cs.MI_D, param)])
        col = p.create_and_open(path, schema)
        for lo in range(0, MI_N, 1024):
            col.insert([p.Doc(id=str(i), vectors={"vec": X[i]}) for i in range(lo, min(lo + 1024, MI_N))])
        col.optimize()
        out[name] = col
    yield X, Q, out
    for col in out.values():
        col._impl.close()


def test_mips_default_hnsw_graph_across_packages(mips):
    X, _, cols = mips
    je, te = _engine(cols["jax"], "vec"), _engine(cols["torch"], "vec")
    assert je._mips and te._mips and te._search_metric == zvec_tpu_torch.MetricType.L2
    assert te._mips_max_norm2 == pytest.approx(je._mips_max_norm2, rel=1e-6)
    assert te._codes.shape[1] == cs.MI_D + 1  # the augmented column
    np.testing.assert_array_equal(te._graph.levels, je._graph.levels)
    same = (np.sort(te._graph.l0, axis=1) == np.sort(je._graph.l0, axis=1)).all(axis=1).mean()
    assert same >= 0.99, same


@pytest.mark.parametrize("ef", [64, 256])
def test_mips_default_hnsw_answers_across_packages(mips, ef):
    X, Q, cols = mips
    got = {n: _answers(c, "vec", Q, PKGS[n].HnswQueryParam(ef=ef)) for n, c in cols.items()}
    _agree(got["torch"], got["jax"])
    ids, scores = got["torch"]
    exact = np.einsum("qd,qkd->qk", Q.astype(np.float64), X[ids].astype(np.float64))
    np.testing.assert_allclose(scores, exact, rtol=TOL, atol=TOL)  # scores are inner products
    assert (np.diff(scores, axis=1) <= 1e-6).all()


# ---------------------------------------------------------------- compact

CP_N, CP_D, CP_NQ = 5000, 24, 16


def _cp_index(p, index):
    m = p.MetricType.L2
    if index == "flat":
        return p.FlatIndexParam(m)
    if index == "hnsw":
        return p.HnswIndexParam(m, m=16, ef_construction=100)
    return p.IVFIndexParam(m, n_list=16, n_iters=6)


def _cp_param(p, index):
    return {"hnsw": p.HnswQueryParam(ef=64), "ivf": p.IVFQueryParam(nprobe=4)}.get(index)


@pytest.mark.parametrize("index", ["flat", "hnsw", "ivf"])
def test_compaction_across_packages(tmp_path, index):
    rng = np.random.default_rng(0xC0DE)
    X = rng.standard_normal((CP_N, CP_D)).astype(np.float32)
    Q = rng.standard_normal((CP_NQ, CP_D)).astype(np.float32)
    grp = rng.integers(0, 50, CP_N)
    gone = rng.choice(CP_N, 500, replace=False)
    alive = np.ones(CP_N, bool)
    alive[gone] = False
    alive &= grp != 7
    paths, out = {}, {}
    for name, p in PKGS.items():
        paths[name] = str(tmp_path / name)
        schema = p.CollectionSchema("compact", fields=[p.FieldSchema("grp", p.DataType.INT64)],
                                    vectors=[p.VectorSchema("vec", p.DataType.VECTOR_FP32, CP_D, _cp_index(p, index))])
        col = p.create_and_open(paths[name], schema)
        for lo in range(0, CP_N, 1000):
            col.insert([p.Doc(id=str(i), vectors={"vec": X[i]}, fields={"grp": int(grp[i])})
                        for i in range(lo, lo + 1000)])
        col.optimize()
        col.delete([str(i) for i in gone])
        col.delete_by_filter("grp = 7")
        col.optimize()
        segs = [s for s in col._impl._segments_snapshot() if s.doc_count > 0]
        assert len(segs) == 1 and segs[0].doc_count == alive.sum() == col.stats.doc_count
        ids, scores = _answers(col, "vec", Q, _cp_param(p, index))
        assert alive[ids[ids >= 0]].all()  # no deleted pk
        out[name] = (ids, scores)
        col.flush()
        col._impl.close()
    _agree(out["torch"], out["jax"])
    # each package's compacted files open in the other with the same answers
    for name, other in (("jax", "torch"), ("torch", "jax")):
        p = PKGS[other]
        col = p.open(paths[name])
        assert col.stats.doc_count == alive.sum()
        _agree(_answers(col, "vec", Q, _cp_param(p, index)), out[name])
        col._impl.close()


# ---------------------------------------------------------------- codes

CD_N, CD_D, CD_NQ = 3000, 32, 24


def _codes_collection(p, path, fields, make_param, X):
    schema = p.CollectionSchema("codes", vectors=[
        p.VectorSchema(f, p.DataType.VECTOR_FP32, X.shape[1], make_param(p, *spec)) for f, spec in fields.items()])
    col = p.create_and_open(path, schema)
    for lo in range(0, len(X), 1000):
        col.insert([p.Doc(id=str(i), vectors={f: X[i] for f in fields}) for i in range(lo, min(lo + 1000, len(X)))])
    col.optimize()
    return col


def _flat_param(p, refine):
    return importlib.import_module(f"{p.__name__}.model.param.param").FlatQueryParam(is_using_refiner=refine)


def _quant(p, name):
    return p.QuantizeType.UNDEFINED if name is None else p.QuantizeType[name]


@pytest.fixture(scope="module")
def codes_flat(tmp_path_factory):
    rng = np.random.default_rng(11)
    X = rng.standard_normal((CD_N, CD_D)).astype(np.float32)
    Q = rng.standard_normal((CD_NQ, CD_D)).astype(np.float32)
    cols = {n: _codes_collection(p, str(tmp_path_factory.mktemp(f"cf_{n}") / "c"), cs.CD_FLAT_FIELDS,
                                 lambda p, m, q: p.FlatIndexParam(p.MetricType[m], quantize_type=_quant(p, q)), X)
            for n, p in PKGS.items()}
    yield X, Q, cols
    for col in cols.values():
        col._impl.close()


@pytest.mark.parametrize("field", list(cs.CD_FLAT_FIELDS))
def test_flat_codes_across_packages(codes_flat, field):
    X, Q, cols = codes_flat
    metric = cs.CD_FLAT_FIELDS[field][0]
    for refine in (None, False):
        got = {n: _answers(c, field, Q, _flat_param(PKGS[n], refine)) for n, c in cols.items()}
        _agree(got["torch"], got["jax"])
    te = _engine(cols["torch"], field)
    assert te._st.codes.dtype == {"fp16": torch.float16, "int8": torch.int8, "int4": torch.int8,
                                  "ip": torch.float32}[field]
    assert te._st.int4_packed == (field == "int4")


@pytest.fixture(scope="module")
def codes_ivf(tmp_path_factory):
    X, Q = cs.make_clustered(CD_N, CD_D, CD_NQ)
    cols = {n: _codes_collection(p, str(tmp_path_factory.mktemp(f"ci_{n}") / "c"), cs.CD_IVF_FIELDS,
                                 lambda p, m, q: p.IVFIndexParam(p.MetricType[m], n_list=16, n_iters=6, use_soar=True,
                                                                 quantize_type=_quant(p, q)), X)
            for n, p in PKGS.items()}
    yield X, Q, cols
    for col in cols.values():
        col._impl.close()


@pytest.mark.parametrize("field", list(cs.CD_IVF_FIELDS))
def test_ivf_codes_across_packages(codes_ivf, field):
    X, Q, cols = codes_ivf
    for nprobe in (2, 8):
        got = {n: _answers(c, field, Q, PKGS[n].IVFQueryParam(nprobe=nprobe)) for n, c in cols.items()}
        _agree(got["torch"], got["jax"])
    te, je = _engine(cols["torch"], field), _engine(cols["jax"], field)
    np.testing.assert_array_equal(te._trained["assign_rows"], je._trained["assign_rows"])
    assert (te._lists_codes.dtype == torch.int8) == (field == "sq8")


@pytest.fixture(scope="module")
def codes_hnsw(tmp_path_factory):
    X, Q = cs.config3_data(CD_N, CD_NQ)
    cols = {n: _codes_collection(p, str(tmp_path_factory.mktemp(f"ch_{n}") / "c"),
                                 {f: ("COSINE", f.upper()) for f in cs.CD_HNSW_FIELDS},
                                 lambda p, m, q: p.HnswIndexParam(p.MetricType[m], m=16, ef_construction=100,
                                                                  quantize_type=_quant(p, q)), X)
            for n, p in PKGS.items()}
    yield X, Q, cols
    for col in cols.values():
        col._impl.close()


@pytest.mark.parametrize("field", cs.CD_HNSW_FIELDS)
def test_hnsw_codes_across_packages(codes_hnsw, field):
    X, Q, cols = codes_hnsw
    for refine in (True, False):
        got = {n: _answers(c, field, Q, PKGS[n].HnswQueryParam(ef=32, is_using_refiner=refine))
               for n, c in cols.items()}
        _agree(got["torch"], got["jax"])
    te, je = _engine(cols["torch"], field), _engine(cols["jax"], field)
    np.testing.assert_array_equal(te._graph.l0, je._graph.l0)
    assert te._int4_packed == (field == "int4")


# ---------------------------------------------------------------- hamming

HM_N, HM_NQ = 3000, 24


@pytest.mark.parametrize("index", ["flat", "hnsw"])
def test_hamming_across_packages(tmp_path, index):
    from zvec_tpu_torch.ops.quantize import pack_bits

    bits, qbits = cs.hamming_data(HM_N, HM_NQ)
    packed, qpacked = pack_bits(bits, 32), pack_bits(qbits, 32)
    dist = (qbits[:, None, :] != bits[None, :, :]).sum(axis=2)
    out = {}
    for name, p in PKGS.items():
        param = (p.FlatIndexParam(p.MetricType.HAMMING) if index == "flat"
                 else p.HnswIndexParam(p.MetricType.HAMMING, m=16, ef_construction=100))
        schema = p.CollectionSchema("ham", vectors=[p.VectorSchema("code", p.DataType.VECTOR_BINARY32, cs.HM_BITS, param)])
        col = p.create_and_open(str(tmp_path / name), schema)
        for lo in range(0, HM_N, 1000):
            col.insert([p.Doc(id=str(i), vectors={"code": packed[i]}) for i in range(lo, lo + 1000)])
        col.optimize()
        # bit-form queries in a batch (zvec_tpu refuses a packed batch), packed one at a time
        ids, scores = _answers(col, "code", qbits, p.HnswQueryParam(ef=64) if index == "hnsw" else None)
        one = [col.query(p.VectorQuery("code", vector=qpacked[r]), topk=K) for r in range(4)]
        assert [[int(d.id) for d in row] for row in one] == ids[:4].tolist()
        out[name] = (ids, scores)
        col._impl.close()
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    np.testing.assert_array_equal(out["torch"][1], out["jax"][1])
    ids, scores = out["torch"]
    np.testing.assert_array_equal(scores, np.take_along_axis(dist, ids, 1))  # exact hamming distances
    kth = np.sort(dist, axis=1)[:, K - 1]
    hits = (np.take_along_axis(dist, ids, 1) <= kth[:, None]).mean()  # tie-aware recall
    assert hits == 1.0 if index == "flat" else hits >= 0.9


# ---------------------------------------------------------------- generators

def _bench_suite(tmp_path, monkeypatch):
    monkeypatch.setenv("SUITE_DIR", str(tmp_path))
    spec = importlib.util.spec_from_file_location("bench_suite", REPO / "benchmarks" / "bench_suite.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Caught(Exception):
    pass


@pytest.mark.parametrize("n", [3000, 210_000])  # 16 centres, then n // 10,000
def test_config3_generator_is_bench_suites(tmp_path, monkeypatch, n):
    """chip_smoke.config3_data equals the rows and queries that
    bench_suite.py's stage_int8_hnsw makes (read from its frame when it
    opens its collection, before any build)."""
    suite = _bench_suite(tmp_path, monkeypatch)
    monkeypatch.setenv("SUITE_N_HNSW", str(n))
    seen = {}

    def catch(*a, **kw):
        frame = inspect.currentframe().f_back
        seen.update(X=frame.f_locals["X"], Q=frame.f_locals["Q"])
        raise _Caught

    monkeypatch.setattr(zvec_tpu, "create_and_open", catch)
    if n > 100_000:  # the stage's cosine ground truth is (256, n): skip it at the larger size
        monkeypatch.setattr(np, "argsort", lambda a, axis=-1, **kw: np.zeros(a.shape, np.int64))
    with pytest.raises(_Caught):
        suite.stage_int8_hnsw()
    X, Q = cs.config3_data(n, 1024)
    np.testing.assert_array_equal(X, seen["X"])
    np.testing.assert_array_equal(Q, seen["Q"])
    assert X.shape == (n, cs.CD_HNSW_D) and X.dtype == np.float32


def test_mips_generator_on_make_data():
    """mips_data's directions are benchmarks/h2h.py::make_data("clustered")'s
    rows at D = 200, its norms lognormal from MI_NORM_SEED, its queries near
    make_data's centres."""
    from benchmarks.h2h import make_data

    n, nq = 2000, 16
    X, Q = cs.mips_data(n, nq)
    rx, _ = make_data("clustered", n, cs.MI_D, nq=0)
    norms = np.random.default_rng(cs.MI_NORM_SEED).lognormal(0.0, cs.MI_NORM_SIGMA, n).astype(np.float32)
    np.testing.assert_allclose(np.linalg.norm(X, axis=1), norms, rtol=1e-5)
    np.testing.assert_allclose(X / norms[:, None], rx / np.linalg.norm(rx, axis=1, keepdims=True), rtol=1e-5, atol=1e-6)
    assert Q.shape == (nq, cs.MI_D) and Q.dtype == np.float32
    # the IP, COSINE and L2 top-10 of the same query differ
    ip = np.argsort(-(Q @ X.T), axis=1)[:, :K]
    l2 = np.argsort(((Q[:, None, :] - X[None]) ** 2).sum(-1), axis=1)[:, :K]
    assert np.mean([len(set(a) & set(b)) for a, b in zip(ip, l2)]) < K - 1
