"""The two input paths of the CUDA flat-scan kernel that its wrapper chooses.

`ops/flat_scan.py` picks, per launch, how the code rows reach the kernel's
ring (`copy_bytes`: 16-, 8- or 4-byte asynchronous copies, or byte loads where
the row stride is not a multiple of 4 bytes) and whether one TF32 product
runs (`exact_tf32`, for the +-1 codes of HAMMING and BINARY fields). The
kernel cannot run here; these tests pin the rule, the refusals, which
callers ask for one pass, and the exact HNSW build's scan codes padded to
16-byte rows on the card. The arithmetic of one pass is emulated in
`test_torch_flat_scan_split.py`.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import zvec_tpu_torch  # noqa: E402
from zvec_tpu_torch.core import flat as tflat  # noqa: E402
from zvec_tpu_torch.core import hnsw as thnsw  # noqa: E402
from zvec_tpu_torch.model.param.param import QueryParam  # noqa: E402
from zvec_tpu_torch.ops import flat_scan as fs  # noqa: E402
from zvec_tpu_torch.ops.quantize import pack_bits  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402

N, D, NQ, K = 2000, 64, 5, 10


@pytest.mark.parametrize("dtype,d,width", [
    (torch.float32, 128, 16), (torch.float32, 201, 4), (torch.float32, 769, 4),
    (torch.float16, 100, 8), (torch.float16, 101, 1),
    (torch.int8, 100, 4), (torch.int8, 101, 1),
    pytest.param(torch.int8, 101, 1, id="int4-LD101"),  # packed int4 of D = 201
])
def test_copy_bytes_follows_the_row_stride(dtype, d, width):
    codes = torch.zeros((1024, d), dtype=dtype)
    assert codes.data_ptr() % 16 == 0
    assert fs.copy_bytes(d * codes.element_size(), codes.data_ptr()) == width


def test_copy_bytes_follows_the_address():
    """A view that starts 4 bytes into its storage: 16-byte rows, 4-byte copies."""
    base = torch.zeros(1024 * 128 + 1, dtype=torch.float32)
    view = base[1:].view(1024, 128)
    assert view.data_ptr() % 16 == 4
    assert fs.copy_bytes(128 * 4, view.data_ptr()) == 4
    assert fs.copy_bytes(128 * 4, view.data_ptr() + 4) == 8
    assert fs.copy_bytes(128 * 4, view.data_ptr() - 4) == 16


def _pm1(n, d, nq, seed):
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 2, (n, d)) * 2 - 1).astype(np.float32)
    q = (rng.integers(0, 2, (nq, d)) * 2 - 1).astype(np.float32)
    args = [torch.from_numpy(a) for a in (q, x, (x * x).sum(1), np.ones(n, np.int8))]
    return args


def test_exact_tf32_refuses_what_one_pass_cannot_hold():
    q, x, norms, mask = _pm1(1024, 32, 4, seed=1)
    kw = dict(metric=MetricType.L2, topk=K, exact_tf32=True)
    fs.flat_scan_topk(q, x, norms, mask, **kw)  # +-1 queries and codes: taken
    q0 = q.clone()
    q0[2] = 0.0  # a zero row pads a query batch
    fs.flat_scan_topk(q0, x, norms, mask, **kw)
    half = q.clone()
    half[1, 3] = 0.5
    with pytest.raises(ValueError, match="query entry"):
        fs.flat_scan_topk(half, x, norms, mask, **kw)
    with pytest.raises(ValueError, match="fp32 codes"):
        fs.flat_scan_topk(q, x.half(), norms, mask, **kw)
    with pytest.raises(ValueError, match="L2"):
        fs.flat_scan_topk(q, x, norms, mask, **{**kw, "metric": MetricType.IP})
    with pytest.raises(ValueError, match="fp32 codes"):
        fs.flat_scan_stage1(q, x[:, :16].to(torch.int8).contiguous(), norms, mask, metric=MetricType.L2,
                            topk=K, dequant=(1.0, 0.0), int4_dim=32, exact_tf32=True)


def test_exact_tf32_changes_nothing_on_the_cpu():
    """The plain version computes in fp32 with or without the flag."""
    args = _pm1(4096, 96, 7, seed=2)
    a = fs.flat_scan_topk(*args, metric=MetricType.L2, topk=K, exact_tf32=True)
    b = fs.flat_scan_topk(*args, metric=MetricType.L2, topk=K)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _record(monkeypatch, module, name):
    """Wrap module.name so that every call's exact_tf32 keyword is recorded."""
    seen = []
    orig = getattr(module, name)

    def wrapped(*a, **kw):
        seen.append(kw.get("exact_tf32", False))
        return orig(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)
    return seen


@pytest.mark.parametrize("metric,qtype,exact", [
    ("HAMMING", "UNDEFINED", True), ("L2", "BINARY", True),
    ("L2", "UNDEFINED", False), ("IP", "UNDEFINED", False), ("L2", "FP16", False),
])
def test_flat_engine_asks_one_pass_for_pm1_codes(monkeypatch, metric, qtype, exact):
    rng = np.random.default_rng(3)
    if metric == "HAMMING":
        data = pack_bits(rng.integers(0, 2, (N, D)).astype(np.uint8), 32)
        queries = pack_bits(rng.integers(0, 2, (NQ, D)).astype(np.uint8), 32)
    else:
        data = rng.standard_normal((N, D)).astype(np.float32)
        queries = rng.standard_normal((NQ, D)).astype(np.float32)
    p = zvec_tpu_torch
    param = p.FlatIndexParam(p.MetricType[metric], quantize_type=p.QuantizeType[qtype])
    eng = tflat.FlatEngine(p.MetricType[metric], D, param)
    eng.bind_data(lambda: data, lambda: 0)
    eng._use_kernel = lambda st, k: True  # the fused-scan branch, on CPU tensors
    seen = _record(monkeypatch, fs, "flat_scan_topk")
    _, ids = eng.search(queries, K, None, QueryParam(is_using_refiner=False))
    assert seen == [exact]
    assert ids.shape == (NQ, K) and (ids >= 0).all()


@pytest.mark.parametrize("metric,exact", [("HAMMING", True), ("L2", False)])
def test_hnsw_build_asks_one_pass_for_pm1_codes(monkeypatch, metric, exact):
    rng = np.random.default_rng(4)
    n = 1500
    if metric == "HAMMING":
        data = pack_bits(rng.integers(0, 2, (n, D)).astype(np.uint8), 32)
    else:
        data = rng.standard_normal((n, D)).astype(np.float32)
    monkeypatch.setattr(thnsw, "_HOST_LAYER_MAX", 256)  # L0 builds on the device path
    steps = _record(monkeypatch, thnsw, "knn_build_step")
    scans = _record(monkeypatch, fs, "flat_scan_topk")
    p = zvec_tpu_torch
    eng = thnsw.HnswEngine(p.MetricType[metric], D,
                           p.HnswIndexParam(p.MetricType[metric], m=8, ef_construction=40))
    eng.bind_data(lambda: data, lambda: 1)
    _, ids = eng.search(data[:3], 1)
    assert steps and set(steps) == {exact}  # every forward batch of L0 (knn_k 40 rides K1)
    assert len(scans) == len(steps) and set(scans) == {exact}
    assert ids[:, 0].tolist() == [0, 1, 2]


def test_knn_build_step_scan_on_padded_codes():
    """Zero columns change no key: the build step scanning codes padded from
    D = 37 to 40 columns (integer-valued rows, every sum exact) writes the
    adjacency the unpadded scan writes; the prune reads the unpadded view."""
    from zvec_tpu_torch.ops import hnsw as ops_hnsw

    rng = np.random.default_rng(5)
    n, d = 4096, 37
    padded = torch.zeros((n, 40))
    padded[:, :d] = torch.from_numpy(rng.integers(-4, 5, (n, d)).astype(np.float32))
    codes = padded[:, :d]
    norms2 = (codes * codes).sum(1)
    mask = torch.ones(n, dtype=torch.int8)
    rows = torch.arange(0, 1024)
    adjs = []
    for scan in (None, padded):
        adj = torch.full((n, 16), -1, dtype=torch.int32)
        ops_hnsw.knn_build_step(rows, codes, norms2, mask, adj, metric=MetricType.L2, knn_k=31,
                                max_out=16, scan_codes=scan)
        adjs.append(adj)
    assert torch.equal(adjs[0], adjs[1]) and bool((adjs[0][:1024] >= 0).all())


def test_mips_build_scans_padded_codes_on_the_card(monkeypatch):
    """HnswIndexParam()'s IP build at D = 38 scans the MIPS-augmented codes
    (39 columns) padded to 40 where the card would run K1, and the graph is
    the one the unpadded scan builds."""
    rng = np.random.default_rng(6)
    n, d = 3000, 38
    data = (rng.standard_normal((n, d)) * rng.lognormal(0.0, 0.3, (n, 1))).astype(np.float32)
    monkeypatch.setattr(thnsw, "_HOST_LAYER_MAX", 256)  # L0 builds on the device path
    p = zvec_tpu_torch
    graphs = []
    for on_card in (False, True):
        monkeypatch.setattr(thnsw, "_on_card", lambda: on_card)
        shapes = []
        orig = thnsw.knn_build_step

        def step(*a, **kw):
            shapes.append((a[1].shape[1], kw["scan_codes"].shape[1]))
            return orig(*a, **kw)

        monkeypatch.setattr(thnsw, "knn_build_step", step)
        eng = thnsw.HnswEngine(p.MetricType.IP, d, p.HnswIndexParam(m=8, ef_construction=40))
        eng.bind_data(lambda: data, lambda: 1)
        eng._ensure_fresh()
        # every layer built on the device path: L0 and the upper levels of >= 256 rows
        assert len(shapes) >= 2 and set(shapes) == {(d + 1, 40 if on_card else d + 1)}
        graphs.append(eng._graph.l0)
        monkeypatch.setattr(thnsw, "knn_build_step", orig)
    np.testing.assert_array_equal(graphs[0], graphs[1])
