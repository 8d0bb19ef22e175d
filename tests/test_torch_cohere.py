"""The Cohere deployment of `benchmarks/bench_cohere10m.py` (768-d COSINE
HNSW on INT8 codes with the fp32 refine) through both packages, small.

- `chip_smoke.py`'s copy of the benchmark's generator equals the original on
  windows that cross a GEN_BLOCK boundary (the script imports nothing from
  the JAX package or the benchmarks).
- 3,000 of its rows, HnswIndexParam(COSINE, m=16, ef_construction=100,
  quantize_type=INT8), through create_and_open -> insert -> optimize ->
  batch_query in zvec_tpu and in the port: the same ids outside near-ties and
  scores within 1e-4, with the refine on and off.
- The flat scan (K1's plain version here) at D = 768 on that data, fp32 and
  int8 codes, COSINE, k = 10 and 128: int8 against the JAX `flat_scan_topk`
  in interpret mode; fp32 against the JAX exact `blockwise_topk_search`,
  since the JAX kernel's tile rule (a 2 MB code tile for the TPU's VMEM)
  takes no fp32 tile at D = 768. The same ids outside near-ties, scores
  within 1e-4.
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
import zvec_tpu  # noqa: E402
import zvec_tpu_torch  # noqa: E402
from zvec_tpu.ops.flat_pallas import flat_scan_topk as jax_scan  # noqa: E402
from zvec_tpu.ops.quantize import encode, train_quantizer  # noqa: E402
from zvec_tpu.ops.topk import blockwise_topk_search as jax_exact  # noqa: E402
from zvec_tpu.typing import MetricType as JMetric  # noqa: E402
from zvec_tpu.typing import QuantizeType as JQuantize  # noqa: E402
from zvec_tpu_torch.ops import flat_scan as port  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
N, NQ, K = 3000, 48, 10
TOL = 1e-4
PKGS = {"jax": zvec_tpu, "torch": zvec_tpu_torch}


def _bench():
    """benchmarks/bench_cohere10m.py, imported by path (its import runs no stage)."""
    spec = importlib.util.spec_from_file_location(
        "bench_cohere10m", REPO / "benchmarks" / "bench_cohere10m.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data():
    centers = cs.cohere_centers()
    return cs.cohere_gen_chunk(centers, 0, N), cs.cohere_queries(centers)[:NQ]


def test_generator_copy_equals_the_benchmark():
    ref = _bench()
    assert (cs.CO_D, cs.CO_NCENTERS, cs.CO_SEED, cs.CO_GEN_BLOCK, cs.CO_NQ) == (
        ref.D, ref.NCENTERS, ref.SEED, ref.GEN_BLOCK, ref.NQ)
    centers = cs.cohere_centers()
    np.testing.assert_array_equal(centers, ref._centers())
    b = ref.GEN_BLOCK
    for lo, hi in ((b - 700, b + 300), (3 * b - 5, 3 * b + 5)):
        np.testing.assert_array_equal(cs.cohere_gen_chunk(centers, lo, hi), ref.gen_chunk(centers, lo, hi))
    # the benchmark caches its queries under C10M_DIR: draw them the same way here
    rng = np.random.default_rng(ref.SEED + 999_983)
    q = centers[rng.integers(0, ref.NCENTERS, ref.NQ)] + rng.standard_normal(
        (ref.NQ, ref.D), dtype=np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_array_equal(cs.cohere_queries(centers), q)


def _fill(pkg, path, X):
    schema = pkg.CollectionSchema("cohere_parity", vectors=[pkg.VectorSchema(
        "vec", pkg.DataType.VECTOR_FP32, cs.CO_D,
        pkg.HnswIndexParam(pkg.MetricType.COSINE, m=16, ef_construction=100,
                           quantize_type=pkg.QuantizeType.INT8))])
    col = pkg.create_and_open(str(path), schema)
    for lo in range(0, N, 1024):
        col.insert([pkg.Doc(id=str(i), vectors={"vec": X[i]}) for i in range(lo, min(lo + 1024, N))])
    col.optimize()
    return col


@pytest.fixture(scope="module")
def collections(data, tmp_path_factory):
    X, _ = data
    root = tmp_path_factory.mktemp("cohere")
    cols = {name: _fill(pkg, root / name, X) for name, pkg in PKGS.items()}
    yield cols
    for col in cols.values():
        col._impl.close()


def _same_outside_ties(ids_a, s_a, ids_b, s_b, ascending):
    """Rows may differ only in ids that score within TOL of the row's k-th
    score in both packages; scores of equal ids agree within TOL."""
    for r in range(len(ids_a)):
        a = dict(zip(ids_a[r], s_a[r]))
        b = dict(zip(ids_b[r], s_b[r]))
        for i in a.keys() & b.keys():
            assert abs(a[i] - b[i]) <= TOL, (r, i)
        kth = s_b[r][-1]
        for i in a.keys() ^ b.keys():
            v = a.get(i, b.get(i))
            assert abs(v - kth) <= TOL, (r, i, v, kth)
        order = np.asarray(s_a[r])
        assert (np.diff(order) >= -TOL if ascending else np.diff(order) <= TOL).all()


@pytest.mark.parametrize("refine", [True, False])
def test_collection_matches_jax(collections, data, refine):
    _, Q = data
    out = {}
    for name, col in collections.items():
        param = PKGS[name].HnswQueryParam(ef=64, is_using_refiner=refine)
        docs = col.batch_query("vec", Q, topk=K, output_fields=[], param=param)
        out[name] = ([[d.id for d in row] for row in docs], [[d.score for d in row] for row in docs])
    assert all(len(r) == K for r in out["torch"][0])
    _same_outside_ties(*out["torch"], *out["jax"], ascending=True)
    eng = next(s for s in collections["torch"]._impl._segments_snapshot() if s.doc_count > 0).engine_for("vec")
    assert eng._codes.dtype == torch.int8 and eng._codes.device.type == "cpu"
    if refine:  # exact fp32 cosine distances
        X, _ = data
        ids = np.array(out["torch"][0], np.int64)
        exact = 1.0 - np.einsum("qd,qkd->qk", Q.astype(np.float64), X[ids].astype(np.float64))
        assert np.abs(np.array(out["torch"][1]) - exact).max() <= TOL


@pytest.mark.parametrize("topk", [10, 128])
@pytest.mark.parametrize("ctype", ["fp32", "int8"])
def test_flat_scan_at_d768_matches_jax(data, ctype, topk):
    X, Q = data
    n = 2048
    x = X[:n]
    q = Q[:4]
    dequant = None
    if ctype == "int8":
        qp = train_quantizer(x, JQuantize.INT8, symmetric=True)
        codes = np.asarray(encode(x, JQuantize.INT8, qp))
        dequant = (float(np.float32(qp.scale)), float(np.float32(qp.bias)))
        deq = codes.astype(np.float32) * dequant[0] + dequant[1]
    else:
        codes, deq = x, x
    norms = np.sqrt((deq.astype(np.float32) ** 2).sum(1)).astype(np.float32)
    mask = np.ones(n, np.int8)
    if ctype == "int8":
        js, ji = jax_scan(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(norms), jnp.asarray(mask),
                          metric=JMetric.COSINE, topk=topk, dequant=dequant)
    else:
        js, ji = jax_exact(jnp.asarray(q), jnp.asarray(codes), JMetric.COSINE, topk,
                           x_sq_norms=jnp.asarray(norms**2), block_size=1024)
    ts, ti = port.flat_scan_topk(torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(norms),
                                 torch.from_numpy(mask), metric=MetricType.COSINE, topk=topk,
                                 dequant=dequant)
    js, ji, ts, ti = np.asarray(js), np.asarray(ji), ts.numpy(), ti.numpy()
    assert ti.shape == (4, topk) and (ti >= 0).all()
    _same_outside_ties(ti.tolist(), ts.tolist(), ji.tolist(), js.tolist(), ascending=False)
