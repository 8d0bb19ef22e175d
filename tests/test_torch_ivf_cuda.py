"""IVF ops on the card against the same ops on the CPU.

Marked `cuda`: without a card these skip. Run them on a GPU machine with
`python -m pytest --noconftest tests/test_torch_ivf_cuda.py -q`. The CPU side
is held to zvec_tpu by `tests/test_torch_ivf.py`.

Tolerances: float32 sums run in another order on the card, so scores agree
within 1e-4 and a row whose id sets differ is allowed only when every
differing id scores within 1e-4 (relative) of the row's k-th score. The
k-means update sums in a fixed order, so two trainings on one card are
bitwise equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zvec_tpu_torch.core.ivf import IvfEngine, ivf_probe_core  # noqa: E402
from zvec_tpu_torch.model.param.param import IVFIndexParam, IVFQueryParam  # noqa: E402
from zvec_tpu_torch.ops.hnsw import assign_top2_blocked  # noqa: E402
from zvec_tpu_torch.ops.kmeans import assign, kmeanspp_seed, lloyd  # noqa: E402
from zvec_tpu_torch.ops.runtime import DEVICE_ENV, device  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: these compare the card with the CPU")
    monkeypatch.setenv(DEVICE_ENV, "cuda")  # the card, asked for: a CPU test file of the same process asks for the CPU
    device.cache_clear()
    yield torch.device("cuda")
    device.cache_clear()


def _clustered(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, d)).astype(np.float32) * 5
    X = (centers[rng.integers(0, 64, n)] + rng.standard_normal((n, d))).astype(np.float32)
    Q = (centers[rng.integers(0, 64, 128)] + rng.standard_normal((128, d))).astype(np.float32)
    return X, Q


def _near_tie_ok(s_a, i_a, s_b, i_b, rtol=1e-4):
    """Rows whose id sets differ must differ only on near-ties at the k-th score."""
    for r in range(i_a.shape[0]):
        a = dict(zip(i_a[r].tolist(), s_a[r].tolist()))
        b = dict(zip(i_b[r].tolist(), s_b[r].tolist()))
        if a.keys() == b.keys():
            continue
        kth = float(s_b[r].min())
        extra = [a[i] for i in a.keys() - b.keys()] + [b[i] for i in b.keys() - a.keys()]
        if any(abs(v - kth) > rtol * max(abs(kth), 1.0) for v in extra):
            return False
    return True


def test_lloyd_bitwise_repeatable(cuda):
    X, _ = _clustered(150_000, 48, 0)  # three 65,536-row blocks, the last partial
    seeds = kmeanspp_seed(X, 256, np.random.default_rng(1))
    x = torch.from_numpy(X).to(cuda)
    c1, a1 = lloyd(x, torch.from_numpy(seeds), iters=5)
    c2, a2 = lloyd(x, torch.from_numpy(seeds), iters=5)
    assert c1.is_cuda and torch.equal(c1, c2) and torch.equal(a1, a2)
    # the assignment step against the CPU: a row may differ on a near-tie only
    a_gpu = assign(x, torch.from_numpy(seeds).to(cuda))
    a_cpu = assign(torch.from_numpy(X), torch.from_numpy(seeds))
    assert float((a_gpu.cpu() != a_cpu).float().mean()) <= 1e-3


def test_assign_top2_blocked_cuda_matches_cpu(cuda):
    X, _ = _clustered(40_000, 96, 2)  # two 16,384-row blocks and a remainder
    C = kmeanspp_seed(X, 1024, np.random.default_rng(3))
    a_gpu = assign_top2_blocked(torch.from_numpy(X).to(cuda), torch.from_numpy(C).to(cuda))
    a_cpu = assign_top2_blocked(torch.from_numpy(X), torch.from_numpy(C))
    assert a_gpu.is_cuda and a_gpu.dtype == torch.int32
    # float32 sums in another order: a row may swap on a near-tie only
    assert float((a_gpu.cpu() != a_cpu).any(dim=1).float().mean()) <= 1e-3


@pytest.mark.parametrize("quantize", ["UNDEFINED", "INT8", "INT4"])
@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_probe_cuda_matches_cpu(cuda, metric, quantize):
    from zvec_tpu_torch.typing import QuantizeType

    X, Q = _clustered(30_000, 33, 4)
    eng = IvfEngine(MetricType[metric], 33, IVFIndexParam(
        MetricType[metric], n_list=128, n_iters=5, use_soar=True,
        quantize_type=QuantizeType[quantize]))
    eng.bind_data(lambda: X, lambda: 1)
    eng._ensure_fresh()
    assert eng._centroids.is_cuda and eng._lists_codes.is_cuda and eng._lists_ids.is_cuda
    mask = np.random.default_rng(5).random(len(X)) < 0.5

    def run(dev, m):
        t = lambda a: a.to(dev)  # noqa: E731
        s, i = ivf_probe_core(
            torch.from_numpy(Q).to(dev), t(eng._centroids), t(eng._lists_codes),
            t(eng._lists_norms), t(eng._lists_ids),
            None if m is None else torch.from_numpy(m).to(dev), eng._dequant,
            metric=MetricType[metric], nprobe=8, topk=20, int4_packed=eng._int4_packed,
        )
        return s.cpu().numpy(), i.cpu().numpy()

    for m in (None, mask):
        (cs, ci), (ps, pi) = run(cuda, m), run(torch.device("cpu"), m)
        assert _near_tie_ok(cs, ci, ps, pi)
        same = (np.sort(ci, 1) == np.sort(pi, 1)).all(1)
        assert same.mean() >= 0.98
        assert np.allclose(np.sort(cs[same], 1), np.sort(ps[same], 1), rtol=1e-4, atol=1e-4)
    _, idx = eng.search(Q, 10, param=IVFQueryParam(nprobe=8))
    assert idx.shape == (128, 10) and (idx >= 0).all()
