"""HNSW search parity: zvec_tpu_torch's beam on a graph that zvec_tpu built.

`zvec_tpu`'s HnswEngine builds the graph (n = 2,500, d = 16, m = 8,
efc = 60, the shapes of tests/test_hnsw.py); the port's engine opens it
through `dump_aux` -> `load_aux`, so both searches walk the same graph. Both
run the same queries with the same params; every query must return the same
id set, with scores within 1e-4 (rtol and atol: float32 sums in another
order). 40 queries, so done_frac=0.97 stops the batch one query early.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import zvec_tpu  # noqa: E402
import zvec_tpu_torch  # noqa: E402
from zvec_tpu.core.hnsw import HnswEngine as JaxHnsw  # noqa: E402
from zvec_tpu.ops.quantize import pack_bits  # noqa: E402
from zvec_tpu_torch.core.hnsw import HnswEngine as TorchHnsw  # noqa: E402

N, DIM, NQ, K = 2500, 16, 40, 10

# name -> (metric, quantize, n)
CONFIGS = {
    "l2": ("L2", "UNDEFINED", N),
    "ip": ("IP", "UNDEFINED", N),
    "cosine": ("COSINE", "UNDEFINED", N),
    "hamming": ("HAMMING", "UNDEFINED", N),
    "fp16_l2": ("L2", "FP16", N),
    "fp16_cosine": ("COSINE", "FP16", N),
    "int8_l2": ("L2", "INT8", N),
    "int8_cosine": ("COSINE", "INT8", N),
    "int4_l2": ("L2", "INT4", N),
    "small_l2": ("L2", "UNDEFINED", 300),
}

# (id, config, query-param kwargs, mask density or None, topk, index kwargs)
CASES = [
    ("l2", "l2", {}, None, K, {}),
    ("l2-done0.97", "l2", {"done_frac": 0.97}, None, K, {}),
    ("ip", "ip", {}, None, K, {}),
    ("ip-done0.97", "ip", {"done_frac": 0.97}, None, K, {}),
    ("cosine", "cosine", {}, None, K, {}),
    ("hamming", "hamming", {}, None, K, {}),
    ("fp16_l2-refine", "fp16_l2", {}, None, K, {}),
    ("fp16_cosine-norefine", "fp16_cosine", {"is_using_refiner": False}, None, K, {}),
    ("int8_l2-refine", "int8_l2", {}, None, K, {}),
    ("int8_l2-norefine", "int8_l2", {"is_using_refiner": False}, None, K, {}),
    ("int8_cosine-norefine", "int8_cosine", {"is_using_refiner": False}, None, K, {}),
    ("int4_l2-refine", "int4_l2", {}, None, K, {}),
    ("int4_l2-norefine", "int4_l2", {"is_using_refiner": False}, None, K, {}),
    ("filter30", "l2", {}, 0.3, K, {}),
    ("filter30-cosine", "cosine", {}, 0.3, K, {}),
    ("filter1-rescan", "l2", {}, 0.01, K, {}),
    ("radius", "l2", {"radius": 6.0}, None, 20, {}),
    ("is_linear", "l2", {"is_linear": True}, None, K, {}),
    ("brute_force_threshold", "l2", {}, None, K, {"brute_force_threshold": 5000}),
    ("k_gt_n", "small_l2", {"ef": 16}, None, 400, {"brute_force_threshold": 1}),
    ("frontier1", "l2", {"frontier": 1}, None, K, {}),
    ("frontier1-filter30", "l2", {"frontier": 1}, 0.3, K, {}),
    ("visited_bits8", "l2", {"visited_bits": 8}, None, K, {}),
    ("visited_bits8-frontier1", "l2", {"visited_bits": 8, "frontier": 1}, None, K, {}),
    ("visited_bytes", "l2", {"visited_bits": 8, "visited_bytes": True}, None, K, {}),
    ("visited_bytes-filter30", "l2", {"visited_bits": 10, "visited_bytes": True}, 0.3, K, {}),
    ("steps_slack0-scan_ratio", "l2", {"steps_slack": 0, "max_scan_ratio": 0.01}, None, K, {}),
]


def _data(metric, n):
    rng = np.random.default_rng(3)
    if metric == "HAMMING":
        bits = rng.integers(0, 2, (n, DIM)).astype(np.uint8)
        qbits = rng.integers(0, 2, (NQ, DIM)).astype(np.uint8)
        return pack_bits(bits, 32), pack_bits(qbits, 32)
    X = rng.standard_normal((n, DIM)).astype(np.float32)
    return X, rng.standard_normal((NQ, DIM)).astype(np.float32)


def _index_param(pkg, metric, qtype, **kw):
    return pkg.HnswIndexParam(
        pkg.MetricType[metric], m=8, ef_construction=60,
        quantize_type=pkg.QuantizeType[qtype], **kw,
    )


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """config -> (data, queries, aux directory, aux descriptor), built once
    by zvec_tpu."""
    cache = {}

    def get(name):
        if name not in cache:
            metric, qtype, n = CONFIGS[name]
            X, Qs = _data(metric, n)
            eng = JaxHnsw(zvec_tpu.MetricType[metric], DIM, _index_param(zvec_tpu, metric, qtype))
            eng.bind_data(lambda: X, lambda: 1)
            d = tmp_path_factory.mktemp(name)
            cache[name] = (X, Qs, str(d), eng.dump_aux(str(d), "emb"))
        return cache[name]

    return get


def _engines(graphs, config, index_kw):
    metric, qtype, _ = CONFIGS[config]
    X, Qs, d, desc = graphs(config)
    out = []
    for pkg, cls in ((zvec_tpu, JaxHnsw), (zvec_tpu_torch, TorchHnsw)):
        eng = cls(pkg.MetricType[metric], DIM, _index_param(pkg, metric, qtype, **index_kw))
        eng.load_aux(d, desc)
        eng.bind_data(lambda: X, lambda: 1)
        out.append(eng)
    return out, X, Qs


def _assert_same(a, b):
    (sa, ia), (sb, ib) = a, b
    assert ia.shape == ib.shape
    for r in range(ia.shape[0]):
        assert set(ia[r].tolist()) == set(ib[r].tolist()), f"row {r}"
    np.testing.assert_allclose(sb, sa, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "config,qkw,density,topk,index_kw",
    [pytest.param(*c[1:], id=c[0]) for c in CASES],
)
def test_search_parity_on_jax_graph(graphs, config, qkw, density, topk, index_kw):
    (je, te), X, Qs = _engines(graphs, config, index_kw)
    qkw = {"ef": 64, "done_frac": 1.0, **qkw}
    mask = None
    if density is not None:
        mask = np.random.default_rng(4).random(X.shape[0]) < density
    a = je.search(Qs, topk, mask=mask, param=zvec_tpu.HnswQueryParam(**qkw))
    b = te.search(Qs, topk, mask=mask, param=zvec_tpu_torch.HnswQueryParam(**qkw))
    assert te._loaded_aux is not None  # the port walked zvec_tpu's graph
    np.testing.assert_array_equal(te._graph.l0, je._graph.l0)
    _assert_same(a, b)
    if mask is not None:
        assert all(mask[i] for i in b[1].ravel() if i >= 0)


def test_beam_parity_unit():
    """`ops.hnsw.hnsw_search` against `_beam_core` on hand-made arrays: a
    random graph with two upper levels and duplicate neighbours in the
    adjacency rows (the frontier-1 exact bitset then skips the dedup)."""
    import jax.numpy as jnp

    from zvec_tpu.ops.hnsw import hnsw_search as jax_search
    from zvec_tpu_torch.ops.hnsw import hnsw_search as torch_search
    from zvec_tpu_torch.typing import MetricType

    rng = np.random.default_rng(5)
    n, d, m0 = 512, 8, 12
    codes = rng.standard_normal((n, d)).astype(np.float32)
    norms = (codes**2).sum(1).astype(np.float32)
    l0 = rng.integers(-1, n, (n, m0)).astype(np.int32)
    up1 = np.sort(rng.choice(n, 40, replace=False)).astype(np.int32)
    up2 = np.sort(rng.choice(40, 6, replace=False)).astype(np.int32)  # level-2 rows in level 1
    ids2 = up1[up2]
    nb1 = rng.integers(-1, 40, (40, 6)).astype(np.int32)
    nb2 = rng.integers(-1, 6, (6, 3)).astype(np.int32)
    entry = np.array([up1[up2[0]], up2[0], 0], np.int32)
    q = rng.standard_normal((33, d)).astype(np.float32)
    for frontier, bits, ef in ((1, 0, 16), (3, 0, 16), (2, 6, 20)):
        kw = dict(ef=ef, topk=10, max_steps=ef + 8, num_levels=2, frontier=frontier,
                  visited_bits=bits, done_frac=0.9)
        js, ji = jax_search(
            jnp.asarray(q), jnp.asarray(codes), jnp.asarray(norms), jnp.asarray(l0),
            (jnp.asarray(up1), jnp.asarray(ids2)), (jnp.asarray(nb1), jnp.asarray(nb2)),
            (jnp.asarray(up1), jnp.asarray(up2)), jnp.asarray(entry), None,
            jnp.int32(10_000), metric=zvec_tpu.MetricType.L2, **kw,
        )
        t = torch.from_numpy
        ts, ti = torch_search(
            t(q), t(codes), t(norms), t(l0), [t(up1).long(), t(ids2).long()],
            [t(nb1).long(), t(nb2).long()], [t(up1).long(), t(up2).long()],
            entry.tolist(), None, 10_000, metric=MetricType.L2, **kw,
        )
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
