"""The six sharded functions of `parallel/mesh.py`: zvec_tpu_torch against zvec_tpu.

The JAX package runs them under `shard_map` on its 8-device virtual CPU mesh;
the port runs 8 corpus shards on the CPU, one after another, and merges their
top-k on the merge device. Same numpy inputs on both sides: the same ids, and
scores within 1e-4 (k-means centroids and inertia within 1e-5 relative). The
beams run on graph arrays that zvec_tpu built under its mesh, with a shard
whose graph has fewer upper levels than the others.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import jax.numpy as jnp  # noqa: E402

import zvec_tpu  # noqa: E402
import zvec_tpu_torch  # noqa: E402
from zvec_tpu.ops.quantize import decode, encode, pack_int4, train_quantizer  # noqa: E402
from zvec_tpu.parallel import mesh as jmesh  # noqa: E402
from zvec_tpu.typing import QuantizeType  # noqa: E402
from zvec_tpu.utils.config import GlobalConfig as JConfig  # noqa: E402
from zvec_tpu_torch.core import hnsw as thnsw  # noqa: E402
from zvec_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from zvec_tpu_torch.utils.config import GlobalConfig as TConfig  # noqa: E402

S = 8
TOL = 1e-4
MT = zvec_tpu_torch.MetricType
MJ = zvec_tpu.MetricType


@pytest.fixture(scope="module")
def meshes():
    return jmesh.make_mesh(S), tmesh.make_mesh(S, device="cpu")


def t(a):
    return torch.from_numpy(np.array(a))


def _same(j_out, t_out, tol=TOL):
    js, ji = (np.asarray(x) for x in j_out)
    ts, ti = (x.numpy() for x in t_out)
    assert ti.shape == ji.shape
    assert (ti == ji.astype(np.int64)).all(), (ti, ji)
    ok = ji >= 0
    np.testing.assert_allclose(ts[ok], js[ok], rtol=tol, atol=tol)
    return ti


def _codes(X, qtype):
    """Storage codes, their dequantized squared norms and the dequant pair."""
    if qtype == "fp32":
        return X, (X**2).sum(1), None
    if qtype == "fp16":
        c = X.astype(np.float16)
        return c, (c.astype(np.float32) ** 2).sum(1), None
    qt = QuantizeType.INT8 if qtype == "int8" else QuantizeType.INT4
    qp = train_quantizer(X, qt)
    c = encode(X, qt, qp)
    norms = (decode(c, qp) ** 2).sum(1).astype(np.float32)
    if qtype == "int4":
        c = pack_int4(c)
    return c, norms, (float(np.float32(qp.scale)), float(np.float32(qp.bias)))


def _flat_pair(meshes, X, q, metric, qtype, k, mask, batch_axis=1):
    codes, norms, deq = _codes(X, qtype)
    jm, tm = meshes
    if batch_axis != 1:
        jm, tm = jmesh.make_mesh(S, batch_axis), tmesh.make_mesh(S, batch_axis, device="cpu")
    j = jmesh.sharded_flat_search(
        jm, jnp.asarray(q), jnp.asarray(codes), MJ[metric], k, mask=jnp.asarray(mask),
        x_sq_norms=jnp.asarray(norms),
        dequant=None if deq is None else (jnp.float32(deq[0]), jnp.float32(deq[1])),
        int4_packed=qtype == "int4",
    )
    tt = tmesh.sharded_flat_search(
        tm, t(q), t(codes), MT[metric], k, mask=t(mask), x_sq_norms=t(norms),
        dequant=deq, int4_packed=qtype == "int4",
    )
    return j, tt


@pytest.mark.parametrize("qtype", ["fp32", "fp16", "int8", "int4"])
@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_sharded_flat_search(meshes, metric, qtype):
    rng = np.random.default_rng(11)
    X = rng.standard_normal((S * 256, 24)).astype(np.float32)
    q = rng.standard_normal((8, 24)).astype(np.float32)
    mask = rng.random(S * 256) < 0.7
    j, tt = _flat_pair(meshes, X, q, metric, qtype, 10, mask)
    ti = _same(j, tt)
    assert mask[ti[ti >= 0]].all()


def test_sharded_flat_search_batch_axis(meshes):
    """A (2, 4) mesh: the query batch splits over 'batch', rows over 'corpus'."""
    rng = np.random.default_rng(12)
    X = rng.standard_normal((S * 128, 16)).astype(np.float32)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    mask = np.ones(S * 128, bool)
    j, tt = _flat_pair(meshes, X, q, "L2", "fp32", 5, mask, batch_axis=2)
    _same(j, tt)


@pytest.mark.parametrize("metric,qtype", [("L2", "fp32"), ("COSINE", "int8"), ("L2", "int4")])
def test_sharded_flat_search_kernel_branch(meshes, monkeypatch, metric, qtype):
    """Each shard takes the fused scan where the single-device rule takes it
    (on the card); forced here, the scan's plain stage one runs on CPU shards
    of 1,024 rows and gives the reference's ids."""
    from zvec_tpu_torch.core import flat as tflat

    monkeypatch.setattr(tflat, "kernel_takes", lambda codes, dequant, n, k: True)
    rng = np.random.default_rng(13)
    X = rng.standard_normal((S * 1024, 16)).astype(np.float32)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    mask = rng.random(S * 1024) < 0.8
    j, tt = _flat_pair(meshes, X, q, metric, qtype, 10, mask)
    _same(j, tt)


def test_tie_goes_to_the_lower_shard(meshes):
    """The same row in shards 2 and 5: the merge ranks shard 2's copy first,
    as lax.top_k over the reference's all_gather does."""
    rng = np.random.default_rng(14)
    X = rng.standard_normal((S * 64, 8)).astype(np.float32)
    X[5 * 64 + 7] = X[2 * 64 + 9]
    q = np.repeat(X[2 * 64 + 9][None], 8, 0)
    j, tt = _flat_pair(meshes, X, q, "L2", "fp32", 4, np.ones(S * 64, bool))
    ti = _same(j, tt)
    assert (ti[:, 0] == 2 * 64 + 9).all() and (ti[:, 1] == 5 * 64 + 7).all()


@pytest.mark.parametrize("max_scan", [0, 40])
def test_sharded_ivf_probe(meshes, max_scan):
    """29 real virtual lists padded to 32 with dummy lists that `cent_valid`
    masks out of every shard's centroid top-k."""
    rng = np.random.default_rng(15)
    kv, kv_pad, L, d, n = 29, 32, 16, 12, 400
    cents = np.zeros((kv_pad, d), np.float32)
    cents[:kv] = rng.standard_normal((kv, d))
    codes = np.zeros((kv_pad, L, d), np.float32)
    ids = np.full((kv_pad, L), -1, np.int32)
    perm = rng.permutation(n)
    slots = [(v, s) for v in range(kv) for s in range(L)]
    for row, (v, s) in zip(perm, slots):
        codes[v, s] = cents[v] + 0.3 * rng.standard_normal(d)
        ids[v, s] = row
    norms = (codes**2).sum(-1)
    valid = np.arange(kv_pad) < kv
    q = rng.standard_normal((8, d)).astype(np.float32)
    mask = rng.random(n) < 0.8
    jm, tm = meshes
    j = jmesh.sharded_ivf_probe(
        jm, jnp.asarray(q), jnp.asarray(cents), jnp.asarray(codes), jnp.asarray(norms),
        jnp.asarray(ids), jnp.asarray(valid), jnp.asarray(mask), None,
        metric=MJ.L2, nprobe=3, topk=10, max_scan=max_scan,
    )
    tt = tmesh.sharded_ivf_probe(
        tm, t(q), t(cents), t(codes), t(norms), t(ids), t(valid), t(mask), None,
        metric=MT.L2, nprobe=3, topk=10, max_scan=max_scan,
    )
    ti = _same(j, tt)
    assert mask[ti[ti >= 0]].all()


def _sparse_rows(rng, n, vocab, nnz):
    idx = np.full((n, nnz), -1, np.int32)
    val = np.zeros((n, nnz), np.float32)
    for i in range(n):
        k = rng.integers(1, nnz + 1)
        idx[i, :k] = np.sort(rng.choice(vocab, k, replace=False))
        val[i, :k] = rng.random(k) + 0.1
    return idx, val


def test_sharded_sparse_topk(meshes):
    rng = np.random.default_rng(16)
    vocab = 256
    di, dv = _sparse_rows(rng, S * 64, vocab, 8)
    qi, qv = _sparse_rows(rng, 8, vocab, 8)
    mask = rng.random(S * 64) < 0.9
    jm, tm = meshes
    j = jmesh.sharded_sparse_topk(
        jm, jnp.asarray(qi), jnp.asarray(qv), jnp.asarray(di), jnp.asarray(dv),
        jnp.asarray(mask), topk=10, vocab=vocab,
    )
    tt = tmesh.sharded_sparse_topk(tm, t(qi), t(qv), t(di), t(dv), t(mask), topk=10, vocab=vocab)
    _same(j, tt, tol=1e-5)


@pytest.fixture(scope="module")
def jax_hnsw():
    """A zvec_tpu HNSW engine built under its 8-device mesh: 8 shards of 256
    rows (the last shard 96), m = 6, so the last shard has fewer levels."""
    rng = np.random.default_rng(17)
    X = rng.standard_normal((S * 256 - 160, 16)).astype(np.float32)
    JConfig.instance().mesh_devices = S
    try:
        from zvec_tpu.core.hnsw import HnswEngine
        from zvec_tpu.model.param.param import HnswIndexParam

        eng = HnswEngine(MJ.L2, 16, HnswIndexParam(MJ.L2, m=6, ef_construction=40))
        eng.bind_data(lambda: X, lambda: 1)
        eng._ensure_fresh()
    finally:
        JConfig.instance().mesh_devices = 0
    assert eng._dev.get("sharded")
    return eng, X


def test_sharded_hnsw_search_on_the_reference_graphs(meshes, jax_hnsw):
    """Both packages' sharded beams on the reference's stacked arrays (every
    shard padded to one level count with pass-through levels), and the
    port's own layout (each shard its own levels) on the same graphs."""
    eng, X = jax_hnsw
    levels = [len(g.upper_ids) for g in eng._shard_graphs]
    assert min(levels) < max(levels) == eng._dev["num_levels"], levels
    d = eng._dev
    rng = np.random.default_rng(18)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    kw = dict(ef=24, topk=10, max_steps=24 + 64, frontier=4)
    jm, tm = meshes
    j = jmesh.sharded_hnsw_search(
        jm, jnp.asarray(q), eng._codes, eng._norms, d["l0"], d["upper_ids"], d["upper_nbrs"],
        d["upper_down"], d["entry_rows"], d["valid"], jnp.int32(1000), None,
        metric=MJ.L2, num_levels=d["num_levels"], **kw,
    )
    host = [np.asarray(a) for a in (eng._codes, eng._norms, d["l0"], d["entry_rows"], d["valid"])]
    tt = tmesh.sharded_hnsw_search(
        tm, t(q), t(host[0]), t(host[1]), t(host[2]).int(),
        [t(a).long() for a in d["upper_ids"]], [t(a).long() for a in d["upper_nbrs"]],
        [t(a).long() for a in d["upper_down"]], host[3], t(host[4]), 1000, None,
        metric=MT.L2, num_levels=d["num_levels"], **kw,
    )
    # the global form takes tuples of per-level arrays as the reference does
    ids = _same(j, tt)
    assert (ids >= 0).all() and (ids < X.shape[0]).all()

    # per-shard layout: each shard's own graph with its own level count
    R = d["R"]
    te = thnsw.HnswEngine(MT.L2, 16, None)
    shards = []
    for g in eng._shard_graphs:
        tg = thnsw._Graph(g.levels.shape[0], 6)
        tg.levels, tg.l0, tg.entry_point = g.levels, g.l0, g.entry_point
        tg.upper_ids, tg.upper_nbrs, tg.row_of = g.upper_ids, g.upper_nbrs, g.row_of
        shards.append(te._device_graph(tg, torch.device("cpu"), rows=R))
    own = tmesh.sharded_hnsw_search(
        tm, t(q), tmesh.shard_rows(host[0], tm), t(host[1]),
        [sh["l0"] for sh in shards], [sh["upper_ids"] for sh in shards],
        [sh["upper_nbrs"] for sh in shards], [sh["upper_down"] for sh in shards],
        [sh["entry_rows"] for sh in shards], t(host[4]), 1000, None,
        metric=MT.L2, num_levels=[sh["num_levels"] for sh in shards], **kw,
    )
    _same(j, own)


def test_sharded_sparse_beam_on_the_reference_graphs(meshes):
    rng = np.random.default_rng(19)
    rows = [
        {int(k): float(rng.random() + 0.1) for k in rng.choice(300, 10, replace=False)}
        for _ in range(1500)
    ]
    JConfig.instance().mesh_devices = S
    try:
        from zvec_tpu.core.hnsw_sparse import SparseHnswEngine
        from zvec_tpu.model.param.param import HnswIndexParam

        eng = SparseHnswEngine(MJ.IP, 0, HnswIndexParam(MJ.IP, m=8, ef_construction=50))
        eng.bind_data(lambda: rows, lambda: 1)
        eng._ensure_fresh()
    finally:
        JConfig.instance().mesh_devices = 0
    assert eng._smesh is not None
    qi, qv = eng._prep_query_arrays(rows[:5] + [rows[700]] + rows[-2:])
    mask = np.zeros(eng._doc_idx.shape[0], bool)
    mask[: len(rows)] = rng.random(len(rows)) < 0.9
    jm, tm = meshes
    kw = dict(ef=32, topk=10, max_steps=32 + 64, vocab=eng._vocab, frontier=4)
    j = jmesh.sharded_sparse_beam(
        jm, jnp.asarray(qi), jnp.asarray(qv), eng._doc_idx, eng._doc_val, eng._l0,
        eng._entries, jnp.asarray(mask), jnp.int32(10000), **kw,
    )
    arrs = [np.asarray(a) for a in (eng._doc_idx, eng._doc_val, eng._l0, eng._entries)]
    tt = tmesh.sharded_sparse_beam(
        tm, t(qi), t(qv), *[t(a) for a in arrs], t(mask), 10000, **kw,
    )
    _same(j, tt, tol=1e-5)


@pytest.mark.parametrize("batch_axis", [1, 2])
def test_sharded_kmeans_step(batch_axis):
    rng = np.random.default_rng(20)
    data = (rng.standard_normal((S * 64, 16)) + rng.integers(0, 3, (S * 64, 1))).astype(np.float32)
    cents = data[rng.choice(len(data), 16, replace=False)] + 0.01
    cents[3] = 100.0  # an empty cluster keeps its centroid
    jc, ji = jmesh.sharded_kmeans_step(jmesh.make_mesh(S, batch_axis), jnp.asarray(data), jnp.asarray(cents))
    tc, ti = tmesh.sharded_kmeans_step(tmesh.make_mesh(S, batch_axis, device="cpu"), t(data), t(cents))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)
    assert (tc.numpy()[3] == 100.0).all()


def test_mesh_placement_and_shard_rows(monkeypatch):
    m = tmesh.make_mesh(4, device="cpu")
    assert m.shape == {"batch": 1, "corpus": 4} and m.merge_device == torch.device("cpu")
    m2 = tmesh.make_mesh(6, batch_axis=2)
    assert m2.shape == {"batch": 2, "corpus": 3}
    blocks = tmesh.shard_rows(np.arange(12).reshape(12, 1), m)
    assert [b[:, 0].tolist() for b in blocks] == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]]
    assert tmesh.corpus_sharding(m, 1)(np.arange(8))[3].tolist() == [6, 7]
    with pytest.raises(ValueError):
        tmesh.shard_rows(np.arange(10), m)
    cfg = TConfig.instance()
    monkeypatch.setattr(cfg, "mesh_devices", 1)
    assert tmesh.collection_mesh() is None
    monkeypatch.setattr(cfg, "mesh_devices", 3)
    cm = tmesh.collection_mesh()
    # N shards even where fewer than N devices exist (the CPU here)
    assert cm.shape["corpus"] == 3 and tmesh.collection_mesh() is cm
    assert set(cm.devices) == {torch.device("cpu")}
    assert sorted(jmesh.__all__) == sorted(set(tmesh.__all__) - {"Mesh", "shard_rows"})


def test_graft_entry_and_dryrun_multichip_on_the_cpu():
    """`entry()` gives the reference step's answer; `dryrun_multichip(8)`
    runs the sharded step, the k-means step and the four collection paths
    on 8 shards (a (2, 4) mesh for the steps)."""
    import importlib.util
    from pathlib import Path

    from zvec_tpu_torch import graft_entry

    spec = importlib.util.spec_from_file_location(
        "ref_graft_entry", Path(__file__).resolve().parents[1] / "__graft_entry__.py"
    )
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    jfn, jargs = ref.entry()
    fn, args = graft_entry.entry()
    assert all(a.device.type == "cpu" for a in args)
    _same(jfn(*jargs), fn(*args))
    out = graft_entry.dryrun_multichip(S)
    assert out["mesh"] == {"batch": 2, "corpus": 4} and np.isfinite(out["inertia"])
    assert {k: len(v) for k, v in out["shards"].items()} == {"flat": S, "hnsw": S, "ivf": S, "sparse_hnsw": S}
    assert TConfig.instance().mesh_devices == 0
