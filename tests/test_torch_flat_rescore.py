"""Stage two of the flat scan: the candidate gather, the exact fp32 rescore
and the final top-k, on the CPU.

`zvec_tpu/ops/flat_pallas.py:259-301` expands the merge's k winner groups to
k * GROUP candidate rows, rescores them in fp32 under the real metric and
takes one `lax.top_k`. The port keeps that as `ops/flat_scan.py::
_rescore_plain` beside the CUDA kernel `csrc/flat_rescore.cu` (held to it on
the card by tests/test_torch_flat_rescore_cuda.py). Here:
- the port's `flat_scan_topk` on CPU tensors (stage two is `_rescore_plain`)
  against `zvec_tpu`'s, the Pallas kernel in interpret mode as the JAX
  tests run it: fp32, fp16, int8 and int4 codes with dequant, odd D for
  int4, IP / L2 / COSINE with zero-norm rows and a zero query, a mask that
  leaves fewer than k rows, k 1 and 10. k 128 is held to an fp64 numpy
  oracle instead: its interpret-mode stage one takes ~10 s a call. Ids equal
  outside near-ties (a differing id scores within 1e-5 of the k-th exact
  score), scores within rtol = atol = 1e-4 (float32 sums in another order);
- 16-byte-padded rows against unpadded ones (the kernel's 16- and 4-byte
  row loads), same tolerances;
- `_emulate`, the kernel's algorithm in numpy (per-candidate fp32 dots, the
  metric epilogue rounded op by op, the bitonic sort of (key word, position)
  words), bit for bit against `_rescore_plain` on crafted integer codes whose
  dots are exact in any order: equal scores within and across groups, +0.0
  and -0.0 scores, masked rows, invalid groups, fewer valid rows than k;
- the +-0.0 order at the public API (ROADMAP Queue 3): both packages'
  FlatEngine on IP rows whose dots are exactly zero, with the fused-scan
  branch forced and not;
- the kernel's wrapper on CPU tensors raises and counts no launch.
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
from zvec_tpu.core.flat import FlatEngine as JaxFlat  # noqa: E402
from zvec_tpu.ops.flat_pallas import flat_scan_topk as jax_scan  # noqa: E402
from zvec_tpu.ops.quantize import pack_int4  # noqa: E402
from zvec_tpu.typing import MetricType as JMetric  # noqa: E402
from zvec_tpu_torch.core.flat import FlatEngine as TorchFlat  # noqa: E402
from zvec_tpu_torch.ops import flat_scan as port  # noqa: E402
from zvec_tpu_torch.ops.runtime import NEG_INF  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402

N, Q = 2048, 8
LANES = 128
TIE_TOL = 1e-5  # a differing id is a near-tie when its exact score lies this close to the k-th (relative)


def _codes(x, ctype, metric):
    """(codes, dequantized rows, dequant) for one case, as FlatEngine stores
    them: fp16, or int8 / int4 with an affine dequant (int4 nibble-packed)."""
    if metric == "COSINE" and ctype in ("int8", "int4"):
        nrm = np.linalg.norm(x, axis=1, keepdims=True)
        x = np.where(nrm > 0, x / np.where(nrm > 0, nrm, 1), x).astype(np.float32)
    if ctype == "fp32":
        return x, x, None
    if ctype == "fp16":
        c = x.astype(np.float16)
        return c, c.astype(np.float32), None
    lim = 127 if ctype == "int8" else 7
    lo, hi = float(x.min()), float(x.max())
    scale, bias = (hi - lo) / (2 * lim), (hi + lo) / 2
    c = np.clip(np.round((x - bias) / scale), -lim, lim).astype(np.int8)
    deq = (c.astype(np.float32) * np.float32(scale) + np.float32(bias)).astype(np.float32)
    return (c if ctype == "int8" else pack_int4(c)), deq, (scale, bias)


def _norms(deq, metric):
    sq = (deq.astype(np.float64) ** 2).sum(1)
    return (np.sqrt(sq) if metric == "COSINE" else sq).astype(np.float32)


def _exact(q, deq, mask, metric):
    """fp64 scores (Q, N) of the real metric, -inf where masked."""
    qd, xd = q.astype(np.float64), deq.astype(np.float64)
    dots = qd @ xd.T
    if metric == "IP":
        s = dots
    elif metric == "L2":
        s = -((qd**2).sum(1)[:, None] + (xd**2).sum(1)[None, :] - 2 * dots)
    else:
        den = np.linalg.norm(qd, axis=1)[:, None] * np.linalg.norm(xd, axis=1)[None, :]
        s = np.where(den > 0, dots / np.where(den > 0, den, 1), 1.0)
    return np.where(mask[None, :] != 0, s, -np.inf)


def _assert_close(exact, got, ref):
    """(scores, ids) `got` against `ref` at the same k: scores within 1e-4,
    ids equal except among near-ties of the row's k-th exact score; -1
    exactly where the score is NEG_INF."""
    (gs, gi), (rs, ri) = got, ref
    assert gi.dtype == np.int64 or gi.dtype == np.int32
    assert np.allclose(gs, rs, rtol=1e-4, atol=1e-4)
    assert ((gi < 0) == (gs <= NEG_INF / 2)).all() and ((ri < 0) == (rs <= NEG_INF / 2)).all()
    k = gi.shape[1]
    for r in range(gi.shape[0]):
        a, b = set(gi[r].tolist()), set(ri[r].tolist())
        if a == b:
            continue
        kth = np.sort(exact[r])[::-1][k - 1]
        for i in a ^ b:
            assert i >= 0 and abs(exact[r, i] - kth) <= TIE_TOL * abs(kth) + 1e-6, (r, i)


def _case(ctype, metric, d, mask_kind, seed, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[rng.random(n) < 0.05] = 0.0  # zero rows: zero-norm COSINE rows score 1.0, IP dots 0
    q = rng.standard_normal((Q, d)).astype(np.float32)
    if metric == "COSINE":
        q[3] = 0.0  # a zero query: every row scores 1.0
    if mask_kind == "few":  # six rows survive: every query gets fewer than k
        mask = np.zeros(n, np.int8)
        mask[rng.choice(n, 6, replace=False)] = 1
    else:
        mask = (rng.random(n) > 0.3).astype(np.int8)
    codes, deq, dequant = _codes(x, ctype, metric)
    return q, codes, deq, _norms(deq, metric), mask, dequant


def _port(q, codes, norms, mask, metric, k, dequant, int4_dim):
    s, i = port.flat_scan_topk(torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(norms),
                               torch.from_numpy(mask), metric=MetricType[metric], topk=k,
                               dequant=dequant, int4_dim=int4_dim)
    assert s.dtype == torch.float32 and i.dtype == torch.int64 and s.shape == (q.shape[0], k)
    return s.numpy(), i.numpy()


JAX_CASES = [  # (code type, metric, D, mask, k)
    ("fp32", "L2", 16, "few", 10),
    ("fp32", "COSINE", 16, "30%", 10),
    ("fp16", "IP", 16, "30%", 1),
    ("int8", "COSINE", 16, "30%", 10),
    ("int4", "L2", 33, "30%", 10),
    ("int4", "IP", 33, "few", 1),
]


@pytest.mark.parametrize("ctype,metric,d,mask_kind,k", JAX_CASES)
def test_scan_against_jax(ctype, metric, d, mask_kind, k):
    # one tile of 1024 rows: the interpret-mode kernel's compile grows with its group count
    q, codes, deq, norms, mask, dequant = _case(ctype, metric, d, mask_kind, seed=d * 10 + k, n=1024)
    int4_dim = d if ctype == "int4" else None
    rescores = port.flat_scan_rescore.launches
    got = _port(q, codes, norms, mask, metric, k, dequant, int4_dim)
    assert port.flat_scan_rescore.launches == rescores  # CPU tensors: the plain version, no launch
    js, ji = jax_scan(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(norms), jnp.asarray(mask),
                      metric=JMetric[metric], topk=k, dequant=dequant, int4_dim=int4_dim)
    exact = _exact(q, deq, mask, metric)
    _assert_close(exact, got, (np.asarray(js), np.asarray(ji)))
    if mask_kind == "few":  # six valid rows, then -1 ids on NEG_INF keys in the same places
        assert ((got[1] >= 0).sum(1) == min(k, 6)).all()
        assert ((got[1] < 0) == (np.asarray(ji) < 0)).all()


@pytest.mark.parametrize("ctype,metric", [("fp32", "L2"), ("int4", "COSINE"), ("int8", "IP")])
def test_scan_k128_against_oracle(ctype, metric):
    """k 128 (tile 1024, 8 rows a group, C 1024) against the fp64 oracle's
    top-128, with a mask that leaves 100 rows: 28 ids of -1 a query."""
    d = 33 if ctype == "int4" else 16
    q, codes, deq, norms, mask, dequant = _case(ctype, metric, d, "30%", seed=128)
    mask[:] = 0
    mask[np.random.default_rng(3).choice(N, 100, replace=False)] = 1
    k = 128
    gs, gi = _port(q, codes, norms, mask, metric, k, dequant, d if ctype == "int4" else None)
    exact = _exact(q, deq, mask, metric)
    order = np.argsort(-exact, axis=1, kind="stable")[:, :k]
    es = np.take_along_axis(exact, order, axis=1)
    ref = (np.where(np.isfinite(es), es, NEG_INF).astype(np.float32), np.where(np.isfinite(es), order, -1))
    _assert_close(exact, (gs, gi), ref)
    assert ((gi >= 0).sum(1) == 100).all()


def test_padded_rows_against_unpadded():
    """fp32 rows of 33 columns (132 bytes: 4-byte loads) and the same rows
    padded with zeros to 36 (144 bytes: 16-byte loads), under all three
    metrics: the same answers."""
    rng = np.random.default_rng(4)
    d = 33
    x = rng.standard_normal((N, d)).astype(np.float32)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    mask = (rng.random(N) > 0.2).astype(np.int8)
    xp, qp = np.zeros((N, 36), np.float32), np.zeros((Q, 36), np.float32)
    xp[:, :d], qp[:, :d] = x, q
    assert port._load_bytes(d * 4, 0) == 4 and port._load_bytes(36 * 4, 0) == 16
    assert port._load_bytes(50, 0) == 2 and port._load_bytes(201, 0) == 1 and port._load_bytes(144, 8) == 8
    for metric in ("L2", "IP", "COSINE"):
        norms = _norms(x, metric)
        a = _port(q, x, norms, mask, metric, 10, None, None)
        b = _port(qp, xp, norms, mask, metric, 10, None, None)
        _assert_close(_exact(q, x, mask, metric), a, b)


# --- the kernel's algorithm, in numpy ---------------------------------------


def _order_bits(keys):
    """csrc/flat_rescore.cu::order_bits: monotone uint32 words, -0.0 as +0.0."""
    b = np.where(keys == 0, np.float32(0), keys).astype(np.float32).view(np.uint32).astype(np.uint64)
    return np.where(b >> 31 == 1, b ^ 0xFFFFFFFF, b | 0x80000000)


def _bitonic_desc(words):
    """The kernel's bitonic network over a power-of-two row of words, largest
    first: stage s, distance h, pair i -> (a, a + h)."""
    w = words.copy()
    n = len(w)
    i = np.arange(n // 2)
    s = 2
    while s <= n:
        h = s >> 1
        while h > 0:
            a = (i // h) * 2 * h + i % h
            b = a + h
            x, y = w[a], w[b]
            swap = (x < y) == ((a & s) == 0)
            w[a], w[b] = np.where(swap, y, x), np.where(swap, x, y)
            h >>= 1
        s <<= 1
    return w


def _widen(row, ctype, d):
    if ctype == "int4":
        c = row.astype(np.int32)
        lo, hi = ((c & 0xF) ^ 8) - 8, c >> 4
        return np.stack([lo, hi], axis=1).reshape(-1)[:d].astype(np.float32)
    return row.astype(np.float32)


def _emulate(q, qside, codes, norms, mask8, top_s, gids, *, metric, topk, tile_n, scale, bias, dequant,
             int4, d):
    """csrc/flat_rescore.cu in numpy, query by query. The dots are summed in
    fp64 and rounded once: exact on the crafted inputs, whatever the order."""
    ctype = "int4" if int4 else "other"
    n = codes.shape[0]
    group = tile_n // LANES
    cand = topk * group
    cand2 = 1 << (cand - 1).bit_length()
    f32 = np.float32
    out_s, out_i = np.empty((q.shape[0], topk), f32), np.empty((q.shape[0], topk), np.int64)
    for qi in range(q.shape[0]):
        rows = np.full(cand, -1, np.int64)
        score = np.full(cand, f32(NEG_INF), f32)
        for p in range(cand):
            r, j = divmod(p, group)
            g = int(gids[qi, r])
            if g < 0 or not top_s[qi, r] > NEG_INF / 2:
                continue
            row = (g // LANES) * tile_n + g % LANES + LANES * j
            if row >= n or mask8[row] == 0:
                continue
            rows[p] = row
            c = _widen(codes[row], ctype, d)
            if dequant is not None:
                c = (c * f32(scale)).astype(f32) + f32(bias)
            # + 0: the kernel's sum starts at +0.0, so an exact zero is +0.0
            dot = f32(np.dot(q[qi].astype(np.float64), c.astype(np.float64))) + f32(0)
            if metric == MetricType.IP:
                s = dot
            elif metric == MetricType.L2:
                s = -((f32(qside[qi]) + f32(norms[row])) - f32(2) * dot)
            else:
                den = f32(qside[qi]) * f32(norms[row])
                s = dot / den if den > 0 else f32(1)
            score[p] = s
        words = np.zeros(cand2, np.uint64)
        words[:cand] = (_order_bits(score) << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - np.arange(cand, dtype=np.uint64))
        top = _bitonic_desc(words)[:topk]
        pos = (np.uint64(0xFFFFFFFF) - (top & np.uint64(0xFFFFFFFF))).astype(np.int64)
        out_s[qi] = score[pos]
        out_i[qi] = np.where(score[pos] > NEG_INF / 2, rows[pos], -1)
    return out_s, out_i


def _crafted(ctype, metric, k, seed):
    """Stage two's inputs made for ties: integer codes in a few values, many
    rows repeated (equal scores within and across groups), zero rows and a
    qside of -0.0 with norms of +-0.0 under L2 (scores of +0.0 and -0.0),
    masked rows, an invalid group by id and one by key, and a query whose
    groups hold fewer valid rows than k."""
    rng = np.random.default_rng(seed)
    n, d, tile_n = 4096, 7, 1024
    group = tile_n // LANES
    quantized, int4 = ctype in ("int8", "int4"), ctype == "int4"
    vals = rng.integers(-2, 3, (n, d))
    vals[rng.random(n) < 0.3] = vals[0]  # repeated rows
    vals[rng.random(n) < 0.2] = 1 if quantized else 0  # rows that dequantize to zero
    q = rng.integers(-2, 3, (Q, d)).astype(np.float32)
    dequant = None
    if quantized:
        dequant = (0.5, -0.5)  # dyadic: every dequantized value and dot stays exact
        c = vals.astype(np.int8)
        codes = pack_int4(c) if int4 else c
        deq = c.astype(np.float32) * np.float32(0.5) - np.float32(0.5)
    else:
        codes = vals.astype(np.float16 if ctype == "fp16" else np.float32)
        deq = vals.astype(np.float32)
    sq = (deq.astype(np.float64) ** 2).sum(1).astype(np.float32)
    if metric == "L2":
        qside = (q.astype(np.float64) ** 2).sum(1).astype(np.float32)
        qside[0] = -0.0  # with norms of +-0.0 and a zero dot: scores of -0.0 and +0.0
        norms = sq.copy()
        zero = np.flatnonzero(sq == 0)
        norms[zero[::2]] = -0.0
    elif metric == "COSINE":
        qside = np.sqrt((q.astype(np.float64) ** 2).sum(1)).astype(np.float32)
        norms = np.sqrt(sq.astype(np.float64)).astype(np.float32)
    else:
        qside, norms = np.zeros(Q, np.float32), sq
    if metric == "L2":
        q[0] = 0.0
    mask8 = (rng.random(n) > 0.15).astype(np.int8)
    n_groups = (n // tile_n) * LANES
    gids = np.stack([rng.choice(n_groups, k, replace=False) for _ in range(Q)]).astype(np.int64)
    top_s = rng.standard_normal((Q, k)).astype(np.float32)
    gids[1, -1] = -1  # an invalid group by id
    top_s[1, -1] = NEG_INF
    top_s[2, 0] = NEG_INF  # and one by key
    gids[3, 1:] = -1  # one valid group: fewer valid rows than k where k > GROUP
    top_s[3, 1:] = NEG_INF
    mask8[[(g // LANES) * tile_n + g % LANES + LANES * j for g in gids[4, :2] for j in range(group)]] = 0
    args = (q, qside, codes, norms, mask8, top_s, gids)
    kw = dict(metric=MetricType[metric], topk=k, tile_n=tile_n, scale=0.5 if dequant else 1.0,
              bias=-0.5 if dequant else 0.0, dequant=dequant, int4=int4, d=d)
    return args, kw


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
@pytest.mark.parametrize("ctype", ["fp32", "fp16", "int8", "int4"])
def test_emulation_equals_rescore_plain(ctype, metric, k):
    args, kw = _crafted(ctype, metric, k, seed=len(ctype) * 100 + len(metric) * 10 + k)
    ps, pi = port._rescore_plain(*[torch.from_numpy(a) for a in args], **kw)
    es, ei = _emulate(*args, **kw)
    assert ps.numpy().view(np.int32).tolist() == es.view(np.int32).tolist()  # bitwise: signs too
    assert pi.numpy().tolist() == ei.tolist()
    assert ((pi < 0) == (ps <= NEG_INF / 2)).all()
    if k > 1:  # the crafted ties are there: equal scores inside a row, +-0.0 under L2
        assert (ps[:, 1:] == ps[:, :-1]).any()
    if metric == "L2" and k >= 10:
        z = ps[0][ps[0] == 0]
        assert torch.signbit(z).any() and (~torch.signbit(z)).any()
    if k == 128:  # one valid group of 8 rows: the rest -1
        assert (pi[3] >= 0).sum() <= 8 and (pi[3, 8:] == -1).all()


def test_public_rescore_on_cpu_is_the_plain_version():
    """`flat_scan_rescore` on the merge's output equals the scan's own answer
    (CPU tensors: `_rescore_plain`), with no launch counted."""
    q, codes, _, norms, mask, _ = _case("fp32", "L2", 16, "30%", seed=1)
    args = [torch.from_numpy(a) for a in (q, codes, norms, mask)]
    kw = dict(metric=MetricType.L2, topk=10)
    ts, ti = port.flat_scan_stage1(*args, **kw)
    top_s, gids = port.flat_scan_merge(ts, ti, topk=10)
    before = port.flat_scan_rescore.launches
    rs, ri = port.flat_scan_rescore(*args, top_s, gids, **kw)
    fs_, fi = port.flat_scan_topk(*args, **kw)
    assert port.flat_scan_rescore.launches == before
    assert torch.equal(rs, fs_) and torch.equal(ri, fi)


def test_rescore_kernel_rejects_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only and raises otherwise; it
    never falls back to the plain version (and counts no launch)."""
    args, kw = _crafted("fp32", "L2", 10, seed=0)
    before = port.flat_scan_rescore.launches
    with pytest.raises(ValueError, match="CUDA"):
        port._rescore_kernel(*[torch.from_numpy(a) for a in args], **kw)
    assert port.flat_scan_rescore.launches == before


# --- +-0.0 at the public API --------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
def test_signed_zero_scores_across_packages(fused):
    """IP rows whose dots with the query are exactly zero (two zero rows and
    one that cancels) beside a row that scores below them: both packages'
    FlatEngine give ids [0, 1, 2] and three +0.0 scores, on the engine's
    blockwise path and on the fused scan (`flat_scan_topk` on both sides,
    forced as tests/test_torch_flat_engine.py forces it). The emulated
    kernel gives the same on the fused scan's rescore."""
    X = np.array([[0, 0, 0, 0], [1, -1, 1, -0.5], [0, 0, 0, 0], [2, 2, 2, 2]], np.float32)
    q = np.array([[-1, -2, -3, -4]], np.float32)
    out = []
    for pkg, cls in ((zvec_tpu, JaxFlat), (zvec_tpu_torch, TorchFlat)):
        eng = cls(pkg.MetricType.IP, 4, pkg.FlatIndexParam(pkg.MetricType.IP))
        eng.bind_data(lambda: X, lambda: 0)
        if fused and pkg is zvec_tpu:
            eng._use_pallas = lambda st, k: True
        elif fused:
            eng._use_kernel = lambda st, k: True
        out.append(eng.search(q, 3, None, None))
    (js, ji), (ts, ti) = out
    assert ji.tolist() == ti.tolist() == [[0, 1, 2]]
    assert (js == 0).all() and (ts == 0).all()
    assert not np.signbit(js).any() and not np.signbit(ts).any()
    if fused:  # the kernel's algorithm on the same rows, padded to one tile
        xp = np.zeros((1024, 4), np.float32)
        xp[:4] = X
        mask = np.zeros(1024, np.int8)
        mask[:4] = 1
        ts1, ti1 = port.flat_scan_stage1(*[torch.from_numpy(a) for a in (q, xp, np.zeros(1024, np.float32), mask)],
                                         metric=MetricType.IP, topk=3)
        top_s, gids = port.flat_scan_merge(ts1, ti1, topk=3)
        es, ei = _emulate(q, np.zeros(1, np.float32), xp, np.zeros(1024, np.float32), mask, top_s.numpy(),
                          gids.numpy(), metric=MetricType.IP, topk=3, tile_n=1024, scale=1.0, bias=0.0,
                          dequant=None, int4=False, d=4)
        assert ei.tolist() == [[0, 1, 2]] and not np.signbit(es).any()
