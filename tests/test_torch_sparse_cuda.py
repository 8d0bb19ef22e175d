"""Sparse ops on the card against the same ops on the CPU.

Marked `cuda`: without a card these skip. Run them on a GPU machine with
`python -m pytest --noconftest tests/test_torch_sparse_cuda.py -q`. The CPU
side is held to zvec_tpu by `tests/test_torch_sparse.py` and
`tests/test_torch_hnsw_sparse.py`.

Tolerances: a row's slots are summed in another order on the card, so scores
agree within 1e-5 relative and ids are compared as sets where the boundary
scores lie that close; beam id sets must be equal on at least 98% of the
queries. The signatures are summed in a fixed order and must be bitwise equal
from one call to the next on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zvec_tpu_torch.core.hnsw_sparse import SparseHnswEngine  # noqa: E402
from zvec_tpu_torch.model.param.param import HnswIndexParam  # noqa: E402
from zvec_tpu_torch.ops.hnsw_sparse import hnsw_sparse_search  # noqa: E402
from zvec_tpu_torch.ops.runtime import DEVICE_ENV, device  # noqa: E402
from zvec_tpu_torch.ops.sparse import (  # noqa: E402
    _densify_queries,
    _signature_chunk,
    sparse_ip_rows,
    sparse_ip_topk,
)
from zvec_tpu_torch.typing import MetricType  # noqa: E402

pytestmark = pytest.mark.cuda
RTOL = 1e-5


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this file compares the card with the CPU")
    monkeypatch.setenv(DEVICE_ENV, "cuda")  # the card, asked for: a CPU test file of the same process asks for the CPU
    device.cache_clear()
    yield torch.device("cuda")
    device.cache_clear()


def _rows(seed, n, p, vocab):
    rng = np.random.default_rng(seed)
    idx = np.full((n, p), -1, np.int32)
    val = np.zeros((n, p), np.float32)
    for i in range(n):
        m = int(rng.integers(1, p + 1))
        idx[i, :m] = np.sort(rng.choice(vocab, m, replace=False))
        val[i, :m] = rng.random(m).astype(np.float32) + 0.1
    return idx, val


def _same_topk(cs, ci, ps, pi, min_rows=1.0):
    cs, ci, ps, pi = (a.cpu().numpy() for a in (cs, ci, ps, pi))
    valid = pi >= 0
    equal = 0
    for r in range(pi.shape[0]):
        a, b = set(ci[r][ci[r] >= 0].tolist()), set(pi[r][valid[r]].tolist())
        if a != b:
            kth = ps[r][valid[r]].min()
            score = dict(zip(ci[r].tolist(), cs[r].tolist())) | dict(zip(pi[r].tolist(), ps[r].tolist()))
            if not all(abs(score[i] - kth) <= RTOL * abs(kth) for i in a ^ b):
                continue
        equal += 1
    assert equal >= min_rows * pi.shape[0], (equal, pi.shape[0])
    same = (ci == pi).all(axis=1)
    np.testing.assert_allclose(cs[same], ps[same], rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_sparse_ip_topk_card_matches_cpu(cuda, masked):
    di, dv = _rows(0, 4096, 24, 5000)
    qi, qv = _rows(1, 32, 8, 5000)
    mask = torch.from_numpy(np.random.default_rng(2).random(4096) > 0.3) if masked else None
    outs = []
    for dev in (cuda, torch.device("cpu")):
        args = [torch.from_numpy(a).to(dev) for a in (qi, qv, di, dv)]
        outs.append(sparse_ip_topk(*args, None if mask is None else mask.to(dev), topk=10, vocab=5120, block_size=1000))
    _same_topk(*outs[0], *outs[1])


def test_densify_and_rows_card_matches_cpu(cuda):
    di, dv = _rows(3, 600, 16, 3000)
    qi, qv = _rows(4, 24, 8, 3000)
    pick = np.random.default_rng(5).integers(0, 600, (24, 40))
    dense, sims = [], []
    for dev in (cuda, torch.device("cpu")):
        tq = [torch.from_numpy(a).to(dev) for a in (qi, qv)]
        dense.append(_densify_queries(*tq, 3072).cpu())
        sims.append(sparse_ip_rows(*tq, torch.from_numpy(di[pick]).to(dev), torch.from_numpy(dv[pick]).to(dev),
                                   vocab=3072).cpu())
    assert torch.equal(dense[0], dense[1])  # one non-zero per slot: any order of adds
    np.testing.assert_allclose(sims[0].numpy(), sims[1].numpy(), rtol=RTOL, atol=1e-6)


def test_signatures_bitwise_repeatable_on_card(cuda):
    di, dv = _rows(6, 3000, 96, 131072)
    args = [torch.from_numpy(a).to(cuda) for a in (di, dv)]
    first = _signature_chunk(*args, sig_dims=256)
    for _ in range(3):
        assert torch.equal(_signature_chunk(*args, sig_dims=256), first)
    cpu = _signature_chunk(torch.from_numpy(di), torch.from_numpy(dv), sig_dims=256)
    assert torch.equal(first.cpu(), cpu)  # the same order of sums on both devices


@pytest.fixture(scope="module")
def engine():
    """A forced clustered build; on a machine with a card it lives there."""
    rng = np.random.default_rng(7)
    n, v, topics, nnz = 6000, 20000, 30, 24
    pools = [rng.choice(v, 200, replace=False) for _ in range(topics)]

    def make_row(tp):
        terms = rng.choice(pools[tp], nnz, replace=False)
        return dict(zip(terms.tolist(), (rng.random(nnz) + 0.2).astype(float).tolist()))

    rows = [make_row(tp) for tp in rng.integers(0, topics, n)]
    qrows = [make_row(tp) for tp in rng.integers(0, topics, 64)]
    eng = SparseHnswEngine(MetricType.IP, 0, HnswIndexParam(MetricType.IP, m=16, ef_construction=200))
    eng.bind_data(lambda: rows, lambda: 1)
    eng._force_clustered = True
    return eng, qrows


def test_beam_card_matches_cpu(cuda, engine):
    eng, qrows = engine
    eng._ensure_fresh()
    assert eng._doc_idx.is_cuda and eng._l0.is_cuda and eng.build_info["clustered"]
    q_idx, q_val = eng._queries_from_rows(qrows)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        tensors = [x.to(dev) for x in (eng._doc_idx, eng._doc_val, eng._l0, eng._entries)]
        outs.append(hnsw_sparse_search(
            torch.from_numpy(q_idx).to(dev), torch.from_numpy(q_val).to(dev), *tensors, None, 6000,
            ef=64, topk=10, max_steps=128, vocab=eng._vocab, frontier=4,
        ))
    _same_topk(*outs[0], *outs[1], min_rows=0.98)


def test_rescore_card_matches_cpu(cuda, engine):
    eng, _ = engine
    eng._ensure_fresh()
    l0 = eng._aux_l0[:, :-2]
    cand = np.concatenate([l0, l0[np.clip(l0[:, 0], 0, None)]], axis=1).astype(np.int32)
    ci, cs = eng._rescore_topk_batched(cand, 33)
    doc_idx, doc_val = eng._doc_idx, eng._doc_val
    eng._doc_idx, eng._doc_val = doc_idx.cpu(), doc_val.cpu()
    try:
        pi, ps = eng._rescore_topk_batched(cand, 33)
    finally:
        eng._doc_idx, eng._doc_val = doc_idx, doc_val
    assert (np.sort(ci, 1) == np.sort(pi, 1)).all(axis=1).mean() >= 0.99
    same = (ci == pi).all(axis=1)
    assert same.mean() >= 0.9
    np.testing.assert_allclose(cs[same], ps[same], rtol=RTOL)
