"""The plain reference against a brute-force NumPy loop at a tiny size."""

import numpy as np
import pytest
import torch

from portbench.reference.exact import exact_topk, round_tf32, row_distances, sq_l2_f32
from portbench.reference.filter import row_mask


def brute(x, q, k, mask=None):
    """For each query, every allowed row's float64 distance, sorted."""
    out_d, out_i = [], []
    for qi in q.astype(np.float64):
        d = [(float(((x[r].astype(np.float64) - qi) ** 2).sum()), r) for r in range(len(x))
             if mask is None or mask[r]]
        d.sort()
        d = d[:k] + [(np.inf, -1)] * (k - len(d[:k]))
        out_d.append([v for v, _ in d])
        out_i.append([r for _, r in d])
    return np.array(out_d), np.array(out_i)


@pytest.fixture
def data():
    rng = np.random.default_rng(11)
    return rng.standard_normal((700, 12)).astype(np.float32), rng.standard_normal((9, 12)).astype(np.float32)


def test_exact_topk_matches_loop(data):
    x, q = data
    d, i = exact_topk(torch.from_numpy(x), torch.from_numpy(q), 10)
    bd, bi = brute(x, q, 10)
    assert np.array_equal(i.numpy(), bi)
    np.testing.assert_allclose(d.numpy(), bd, rtol=1e-12)


def test_exact_topk_filtered_matches_loop(data):
    x, q = data
    mask = np.random.default_rng(3).random(len(x)) < 0.05  # ~35 rows
    d, i = exact_topk(torch.from_numpy(x), torch.from_numpy(q), 10, torch.from_numpy(mask))
    bd, bi = brute(x, q, 10, mask)
    assert np.array_equal(i.numpy(), bi)
    assert mask[i.numpy()].all()
    np.testing.assert_allclose(d.numpy(), bd, rtol=1e-12)


def test_exact_topk_fewer_rows_than_k(data):
    x, q = data
    mask = np.zeros(len(x), bool)
    mask[[5, 17, 400]] = True
    d, i = exact_topk(torch.from_numpy(x), torch.from_numpy(q), 10, torch.from_numpy(mask))
    bd, bi = brute(x, q, 10, mask)
    assert np.array_equal(i.numpy(), bi)
    assert (i.numpy()[:, 3:] == -1).all() and np.isinf(d.numpy()[:, 3:]).all()


def test_exact_topk_blocks_agree(data, monkeypatch):
    x, q = data
    whole = exact_topk(torch.from_numpy(x), torch.from_numpy(q), 10)
    monkeypatch.setattr("portbench.reference.exact.BLOCK_ELEMS", 700 * 2)
    blocked = exact_topk(torch.from_numpy(x), torch.from_numpy(q), 10)
    assert torch.equal(whole[1], blocked[1]) and torch.equal(whole[0], blocked[0])


def test_row_distances(data):
    x, q = data
    ids = np.array([[0, 5, -1, 699, 700]] * len(q))
    d = row_distances(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(ids)).numpy()
    for r in range(len(q)):
        for c, pk in enumerate(ids[r]):
            if 0 <= pk < len(x):
                assert d[r, c] == pytest.approx(((x[pk].astype(np.float64) - q[r]) ** 2).sum(), rel=1e-12)
            else:
                assert np.isnan(d[r, c])


def test_round_tf32_keeps_ten_mantissa_bits():
    v = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-12, 1.0 + 2**-11 + 2**-13, -3.0e-5])
    r = round_tf32(v)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10
    assert r[2] == 1.0  # below half an ulp of TF32: rounds down
    assert r[3] == 1.0 + 2**-10  # above half: rounds up
    bits = r.view(torch.int32) & 0x1FFF
    assert (bits == 0).all()


def test_tf32_distances_are_coarser(data):
    x, q = data
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    xn = (xt * xt).sum(1)
    exact = ((qt.double()[:, None, :] - xt.double()[None]) ** 2).sum(-1)
    e32 = (sq_l2_f32(qt, xt, xn).double() - exact).abs().max()
    e19 = (sq_l2_f32(qt, xt, xn, tf32_products=True).double() - exact).abs().max()
    assert e19 > 10 * e32


def test_row_mask():
    fields = {"tag": np.array(["t0", "t1", "t1", "t2"]), "price": np.array([0.1, 0.6, 0.4, 0.2])}
    assert row_mask(None, fields, 4).all()
    assert list(row_mask((("tag", "=", "t1"), ("price", "<", 0.5)), fields, 4)) == [False, False, True, False]
    assert list(row_mask((("tag", "!=", "t1"),), fields, 4)) == [True, False, False, True]
    assert list(row_mask((("price", ">=", 0.4),), fields, 4)) == [False, True, True, False]
