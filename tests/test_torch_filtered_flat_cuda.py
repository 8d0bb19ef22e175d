"""The fused flat scan on the card (K1, the merge and stage two) under a
filter's row mask at GIST1M's width, D = 960 (3,840-byte rows), and at D =
128, held to the benchmark's plain reference (`portbench/reference/exact.py`:
float32 candidates with TF32 off, ranked in float64), and through the
port's public API on a collection large enough that the brute-force-by-keys
demotion takes the fused scan; `FlatEngine`'s compact scan of the passing
rows against its masked scan of every row.

Marked `cuda`: the kernels have no CPU mode, so without a card these skip.
Run them on a GPU machine with
`python -m pytest tests/test_torch_filtered_flat_cuda.py -q`.

Tolerances: ids equal the reference's outside ties (where they differ, the
float64 distance of the returned row equals the reference's at that rank
within the score tolerance); scores within 1e-5 of the float64 distance,
relative (floored at 1): the kernels' float32 sums of D products err by
~1e-7 of the distance, and 1e-5 is the benchmark's `score_gap` limit, which
TF32 products fail.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench.reference.exact import exact_topk  # noqa: E402
from zvec_tpu_torch.ops import flat_scan as fs  # noqa: E402
from zvec_tpu_torch.ops.runtime import DEVICE_ENV, device  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402

pytestmark = pytest.mark.cuda
K, RTOL = 10, 1e-5


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flat-scan kernels have no CPU mode")
    monkeypatch.setenv(DEVICE_ENV, "cuda")  # the card, asked for: a CPU test file of the same process asks for the CPU
    device.cache_clear()
    yield torch.device("cuda")
    device.cache_clear()


def _check(x, q, mask, pks, scores):
    """pks (Q, K) and scores against the reference's filtered top-k."""
    ref_d, ref_i = exact_topk(x, q, K, mask)
    assert bool(mask[pks.clamp(min=0)].all()) and bool((pks >= 0).all())
    got_d = ((x.double()[pks] - q.double()[:, None, :]) ** 2).sum(-1)
    tol = RTOL * got_d.clamp(min=1.0)
    assert bool(((scores.double() - got_d).abs() <= tol).all()), float((scores.double() - got_d).abs().max())
    differ = pks != ref_i
    assert bool(((got_d - ref_d).abs()[differ] <= tol[differ]).all())  # ties only
    assert float(differ.float().mean()) < 0.01


@pytest.mark.parametrize("rule", ["last_percent", "random_percent"])
@pytest.mark.parametrize("d", [960, 128])
def test_fused_scan_under_a_one_percent_mask(cuda, d, rule):
    gen = torch.Generator(device=cuda).manual_seed(d)
    n, nq = 131072, 1024
    x = torch.randn((n, d), generator=gen, device=cuda)
    q = torch.randn((nq, d), generator=gen, device=cuda)
    mask = torch.zeros(n, dtype=torch.bool, device=cuda)
    if rule == "last_percent":
        mask[int(0.99 * n):] = True
    else:
        mask[torch.randperm(n, generator=gen, device=cuda)[: n // 100]] = True
    before = (fs.flat_scan_topk.launches, fs.flat_scan_merge.launches, fs.flat_scan_rescore.launches)
    sims, idx = fs.flat_scan_topk(q, x, (x * x).sum(1), mask.to(torch.int8), metric=MetricType.L2, topk=K)
    torch.cuda.synchronize()
    after = (fs.flat_scan_topk.launches, fs.flat_scan_merge.launches, fs.flat_scan_rescore.launches)
    assert all(a == b + 1 for a, b in zip(after, before))  # K1, the merge and stage two, once each
    _check(x, q, mask, idx, -sims)


@pytest.mark.parametrize("rule", ["last_percent", "random_percent"])
def test_engine_compacts_a_one_percent_mask(cuda, monkeypatch, rule):
    """`FlatEngine` at the filtered cell's shape cut to 100,000 x 960: under
    a 1% mask it scans only the passing rows (one K1 launch a call, over
    1,024 rows), with the ids and scores of its masked scan of every row."""
    from zvec_tpu_torch.core.flat import FlatEngine
    from zvec_tpu_torch.model.param.param import FlatIndexParam
    from zvec_tpu_torch.utils.config import GlobalConfig

    n, d, nq = 100_000, 960, 1024
    rng = np.random.default_rng(11)
    x = rng.standard_normal((n, d), dtype=np.float32)
    queries = rng.standard_normal((nq, d), dtype=np.float32)
    mask = np.zeros(n, dtype=bool)
    mask[int(0.99 * n):] = True
    if rule == "random_percent":
        mask = rng.permutation(mask)

    def engine():
        eng = FlatEngine(MetricType.L2, d, FlatIndexParam(MetricType.L2))
        eng.bind_data(lambda: x, lambda: 0)
        return eng

    compact = engine()
    got = []
    for _ in range(2):  # a miss of the mask cache, then a hit
        before = fs.flat_scan_topk.launches
        got.append(compact.search(queries, K, mask, None))
        assert fs.flat_scan_topk.launches == before + 1
    (entry,) = compact._mask_cache.values()
    assert entry.rows.shape == (1024,) and int(entry.dev.sum()) == n // 100
    monkeypatch.setattr(GlobalConfig.instance(), "brute_force_by_keys_ratio", 0.0)  # the full scan
    full = engine()
    want_s, want_i = full.search(queries, K, mask, None)
    (entry,) = full._mask_cache.values()
    assert entry.rows is None
    for got_s, got_i in got:
        assert np.array_equal(got_i, want_i) and np.array_equal(got_s, want_s)
    xt, qt = torch.from_numpy(x).to(cuda), torch.from_numpy(queries).to(cuda)
    pks = torch.from_numpy(got[0][1]).to(cuda)
    _check(xt, qt, torch.from_numpy(mask).to(cuda), pks, -torch.from_numpy(got[0][0]).to(cuda))


def test_public_api_demotes_to_the_fused_scan(cuda, tmp_path):
    import zvec_tpu_torch as zt

    n, d, nq, threshold = 131072, 960, 256, 129761  # 1,311 rows pass: under a tenth
    rng = np.random.default_rng(9)
    x = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((nq, d)).astype(np.float32)
    schema = zt.CollectionSchema(
        "filtered", fields=[zt.FieldSchema("row_id", zt.DataType.INT64, index_param=zt.InvertIndexParam())],
        vectors=[zt.VectorSchema("vec", zt.DataType.VECTOR_FP32, d,
                                 zt.FlatIndexParam(metric_type=zt.MetricType.L2))])
    col = zt.create_and_open(str(tmp_path / "col"), schema)
    try:
        for lo in range(0, n, 1024):
            col.insert([zt.Doc(id=str(i), vectors={"vec": x[i]}, fields={"row_id": i})
                        for i in range(lo, min(n, lo + 1024))])
        col.flush()
        col.optimize()
        col._impl.debug_profiling = True
        before = fs.flat_scan_topk.launches
        docs = col.batch_query("vec", queries, topk=K, filter=f"row_id >= {threshold}", output_fields=[])
        assert fs.flat_scan_topk.launches == before + 1
        assert "bf_by_keys" in col._impl.last_profile
    finally:
        col._impl.close()
    pks = torch.tensor([[int(doc.id) for doc in row] for row in docs], device=cuda)
    scores = torch.tensor([[doc.score for doc in row] for row in docs], device=cuda, dtype=torch.float64)
    mask = torch.arange(n, device=cuda) >= threshold
    _check(torch.from_numpy(x).to(cuda), torch.from_numpy(queries).to(cuda), mask, pks, scores)
