"""The sharded paths on the card against the same functions on CPU copies.

Marked `cuda`: without a card these skip. Run them on a GPU machine with
`python -m pytest --noconftest tests/test_torch_mesh_cuda.py -q`. The CPU side
is held to zvec_tpu by `tests/test_torch_mesh.py` and
`tests/test_torch_mesh_collection.py`.

On one card every shard lives on `cuda:0`. The flat scan of a shard of
>= 100,000 rows is the CUDA kernel (one launch per shard per batch); the CPU
copies run its plain version or the blockwise scan, which are exact too.
Float32 sums run in another order on the card, so scores agree within 1e-4
and a row whose id sets differ is allowed only on near-ties at the k-th score.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zvec_tpu_torch.model.param.param import HnswIndexParam, IVFIndexParam  # noqa: E402
from zvec_tpu_torch.ops.flat_scan import flat_scan_topk  # noqa: E402
from zvec_tpu_torch.ops.runtime import DEVICE_ENV, device  # noqa: E402
from zvec_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402
from zvec_tpu_torch.utils.config import GlobalConfig  # noqa: E402

pytestmark = pytest.mark.cuda

S = 4
RTOL = 1e-4


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: these compare the card with the CPU")
    monkeypatch.setenv(DEVICE_ENV, "cuda")  # the card, asked for: a CPU test file of the same process asks for the CPU
    device.cache_clear()
    monkeypatch.setattr(GlobalConfig.instance(), "mesh_devices", S)
    yield torch.device("cuda")
    device.cache_clear()


def _cpu(x):
    if isinstance(x, (list, tuple)):
        return [_cpu(v) for v in x]
    return x.cpu() if torch.is_tensor(x) else x


def _agree(card, cpu, rtol=RTOL):
    """The same ids outside near-ties at the k-th score, scores within rtol."""
    s_a, i_a = (t.cpu().numpy() for t in card)
    s_b, i_b = (t.cpu().numpy() for t in cpu)
    ok = (i_a >= 0) & (i_b >= 0) & (i_a == i_b)
    np.testing.assert_allclose(s_a[ok], s_b[ok], rtol=rtol, atol=rtol)
    for r in range(i_a.shape[0]):
        a = dict(zip(i_a[r].tolist(), s_a[r].tolist()))
        b = dict(zip(i_b[r].tolist(), s_b[r].tolist()))
        if a.keys() == b.keys():
            continue
        kth = float(s_b[r][i_b[r] >= 0].min())
        extra = [a[i] for i in a.keys() - b.keys()] + [b[i] for i in b.keys() - a.keys()]
        assert all(abs(v - kth) <= rtol * max(abs(kth), 1.0) for v in extra), r


def _engine(eng_cls, data, metric, dim, params):
    eng = eng_cls(metric, dim, params)
    eng.bind_data(lambda: data, lambda: 1)
    eng._ensure_fresh()
    return eng


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.COSINE])
def test_sharded_flat_launches_the_kernel_per_shard(cuda, metric):
    from zvec_tpu_torch.core.flat import FlatEngine

    rng = np.random.default_rng(0)
    X = rng.standard_normal((S * 102_400 - 5_000, 64)).astype(np.float32)
    Q = rng.standard_normal((256, 64)).astype(np.float32)
    eng = _engine(FlatEngine, X, metric, 64, None)
    st = eng._st
    # 404,600 rows pad to a multiple of 4 x 8,192: 4 shards of 106,496 rows
    assert st.mesh is not None and [c.shape[0] for c in st.codes] == [106_496] * S
    assert all(c.is_cuda for c in st.codes)
    before = flat_scan_topk.launches
    card = eng.search(Q, 10)
    assert flat_scan_topk.launches - before == S
    mask = np.zeros(st.n_pad, bool)
    mask[: len(X)] = True
    cpu = tmesh.sharded_flat_search(
        tmesh.make_mesh(S, device="cpu"), torch.from_numpy(Q), _cpu(st.codes), metric, 10,
        mask=torch.from_numpy(mask), x_sq_norms=_cpu(st.norms),
    )
    _agree((torch.from_numpy(card[0]), torch.from_numpy(card[1])), cpu)


def test_sharded_hnsw_engine_card_vs_cpu(cuda):
    from zvec_tpu_torch.core.hnsw import HnswEngine

    rng = np.random.default_rng(1)
    X = rng.standard_normal((20_000, 32)).astype(np.float32)
    Q = rng.standard_normal((64, 32)).astype(np.float32)
    eng = _engine(HnswEngine, X, MetricType.L2, 32, HnswIndexParam(MetricType.L2, m=16, ef_construction=100))
    d = eng._dev
    assert d["sharded"] and all(c.is_cuda for c in eng._codes) and len(d["shards"]) == S
    kw = dict(metric=MetricType.L2, ef=64, topk=10, max_steps=128, frontier=4)

    def run(mesh, codes, norms, shards):
        return tmesh.sharded_hnsw_search(
            mesh, torch.from_numpy(Q), codes, norms, [sh["l0"] for sh in shards],
            [sh["upper_ids"] for sh in shards], [sh["upper_nbrs"] for sh in shards],
            [sh["upper_down"] for sh in shards], [sh["entry_rows"] for sh in shards], None, 10_000,
            num_levels=[sh["num_levels"] for sh in shards], **kw,
        )

    card = run(d["mesh"], eng._codes, eng._norms, d["shards"])
    cpu_shards = [{k: _cpu(v) for k, v in sh.items()} for sh in d["shards"]]
    cpu = run(tmesh.make_mesh(S, device="cpu"), _cpu(eng._codes), _cpu(eng._norms), cpu_shards)
    _agree(card, cpu)
    assert card[0].device == torch.device("cuda", 0)


def test_sharded_ivf_and_sparse_engines_card_vs_cpu(cuda):
    from zvec_tpu_torch.core.hnsw_sparse import SparseHnswEngine
    from zvec_tpu_torch.core.ivf import IvfEngine

    rng = np.random.default_rng(2)
    X = rng.standard_normal((20_000, 32)).astype(np.float32)
    Q = rng.standard_normal((64, 32)).astype(np.float32)
    ivf = _engine(IvfEngine, X, MetricType.L2, 32, IVFIndexParam(MetricType.L2, n_list=64, n_iters=3))
    assert ivf._smesh is not None and all(c.is_cuda for c in ivf._lists_codes)
    kw = dict(metric=MetricType.L2, nprobe=8, topk=10)
    args = (ivf._centroids, ivf._lists_codes, ivf._lists_norms, ivf._lists_ids, ivf._cent_valid)
    card = tmesh.sharded_ivf_probe(ivf._smesh, torch.from_numpy(Q), *args, None, None, **kw)
    cpu = tmesh.sharded_ivf_probe(tmesh.make_mesh(S, device="cpu"), torch.from_numpy(Q), *_cpu(args), None, None, **kw)
    _agree(card, cpu)

    rows = [{int(t): float(rng.random() + 0.1) for t in rng.choice(2_000, 16, replace=False)}
            for _ in range(8_000)]
    sp = _engine(SparseHnswEngine, rows, MetricType.IP, 0, HnswIndexParam(MetricType.IP, m=16, ef_construction=100))
    assert sp._smesh is not None and all(t.is_cuda for t in sp._l0)
    qi, qv = sp._prep_query_arrays(rows[:32])
    mask = sp.device_mask(None)
    skw = dict(ef=64, topk=10, max_steps=128, vocab=sp._vocab, frontier=4)
    arrs = (sp._doc_idx, sp._doc_val, sp._l0, sp._entries)
    card = tmesh.sharded_sparse_beam(sp._smesh, torch.from_numpy(qi), torch.from_numpy(qv), *arrs, mask, 10_000, **skw)
    cpu = tmesh.sharded_sparse_beam(tmesh.make_mesh(S, device="cpu"), torch.from_numpy(qi), torch.from_numpy(qv),
                                    *_cpu(arrs), _cpu(mask), 10_000, **skw)
    _agree(card, cpu, rtol=1e-5)
    card = tmesh.sharded_sparse_topk(sp._smesh, torch.from_numpy(qi), torch.from_numpy(qv), sp._doc_idx,
                                     sp._doc_val, mask, topk=10, vocab=sp._vocab)
    cpu = tmesh.sharded_sparse_topk(tmesh.make_mesh(S, device="cpu"), torch.from_numpy(qi), torch.from_numpy(qv),
                                    *_cpu((sp._doc_idx, sp._doc_val, mask)), topk=10, vocab=sp._vocab)
    _agree(card, cpu, rtol=1e-5)


def test_sharded_kmeans_step_card_vs_cpu_and_repeatable(cuda):
    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.standard_normal((S * 50_000, 32)).astype(np.float32))
    cents = data[torch.from_numpy(rng.choice(len(data), 256, replace=False))].clone()
    card_mesh = tmesh.make_mesh(S)
    a = tmesh.sharded_kmeans_step(card_mesh, data.to(cuda), cents.to(cuda))
    b = tmesh.sharded_kmeans_step(card_mesh, data.to(cuda), cents.to(cuda))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])  # sums in shard order: bitwise repeatable
    c = tmesh.sharded_kmeans_step(tmesh.make_mesh(S, device="cpu"), data, cents)
    np.testing.assert_allclose(a[0].cpu().numpy(), c[0].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(a[1]), float(c[1]), rtol=1e-4)
