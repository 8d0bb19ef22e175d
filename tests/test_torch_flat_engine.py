"""Parity of the port's FlatEngine with zvec_tpu's on the same data.

Each case builds `FlatEngine` in both packages over the same numpy matrix
and runs the same queries, with and without an alive mask, with the refiner
on (the default for quantized codes) and off. Ids must be equal and scores
within 1e-4 (rtol and atol: float32 sums in another order).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import zvec_tpu  # noqa: E402
import zvec_tpu_torch  # noqa: E402
from zvec_tpu.core.flat import FlatEngine as JaxFlat  # noqa: E402
from zvec_tpu.ops.quantize import pack_bits  # noqa: E402
from zvec_tpu_torch.core.flat import FlatEngine as TorchFlat  # noqa: E402

N, DIM, NQ, K = 2000, 32, 7, 10

# (metric, quantize) pairs; refine matters only for quantized codes
CASES = [
    ("L2", "UNDEFINED", (None,)),
    ("IP", "UNDEFINED", (None,)),
    ("COSINE", "UNDEFINED", (None,)),
    ("L2", "FP16", (None, False)),
    ("COSINE", "FP16", (None, False)),
    ("L2", "INT8", (None, False)),
    ("IP", "INT8", (None, False)),
    ("COSINE", "INT8", (None, False)),
    ("L2", "INT4", (None, False)),
    ("COSINE", "INT4", (None, False)),
    ("L2", "BINARY", (None, True)),
    ("HAMMING", "UNDEFINED", (None,)),
]
PARAMS = [
    pytest.param(m, qt, refine, masked, id=f"{m}-{qt}-refine{refine}-mask{masked}")
    for m, qt, refines in CASES
    for refine in refines
    for masked in (False, True)
]


def _data(metric):
    rng = np.random.default_rng(1)
    if metric == "HAMMING":
        bits = rng.integers(0, 2, (N, DIM)).astype(np.uint8)
        qbits = rng.integers(0, 2, (NQ, DIM)).astype(np.uint8)
        return pack_bits(bits, 32), pack_bits(qbits, 32)
    X = rng.standard_normal((N, DIM)).astype(np.float32)
    return X, rng.standard_normal((NQ, DIM)).astype(np.float32)


def _engine(pkg, cls, metric, qtype, data):
    params = pkg.FlatIndexParam(
        pkg.MetricType[metric], quantize_type=pkg.QuantizeType[qtype]
    )
    eng = cls(pkg.MetricType[metric], DIM, params)
    eng.bind_data(lambda: data, lambda: 0)
    return eng


def _param(pkg, refine):
    if refine is None:
        return None
    from importlib import import_module

    return import_module(pkg.__name__ + ".model.param.param").QueryParam(
        is_using_refiner=refine
    )


def _run(metric, qtype, refine, masked, use_kernel=False):
    X, q = _data(metric)
    mask = None
    if masked:
        mask = np.random.default_rng(2).random(N) > 0.4
    js, ji = _engine(zvec_tpu, JaxFlat, metric, qtype, X).search(
        q, K, mask, _param(zvec_tpu, refine)
    )
    te = _engine(zvec_tpu_torch, TorchFlat, metric, qtype, X)
    if use_kernel:
        # drive the fused-scan branch on CPU tensors (its plain stage one)
        te._use_kernel = lambda st, k: True
    ts, ti = te.search(q, K, mask, _param(zvec_tpu_torch, refine))
    return (js, ji), (ts, ti), mask


@pytest.mark.parametrize("metric,qtype,refine,masked", PARAMS)
def test_flat_engine_parity(metric, qtype, refine, masked):
    (js, ji), (ts, ti), mask = _run(metric, qtype, refine, masked)
    assert ti.dtype == np.int64 and ts.shape == (NQ, K)
    assert (ti == ji).all()
    assert np.allclose(ts, js, rtol=1e-4, atol=1e-4)
    if mask is not None:
        assert mask[ti[ti >= 0]].all()


@pytest.mark.parametrize(
    "metric,qtype",
    [("L2", "UNDEFINED"), ("IP", "UNDEFINED"), ("COSINE", "UNDEFINED"),
     ("L2", "FP16"), ("COSINE", "INT8"), ("L2", "INT4")],
)
def test_flat_engine_fused_scan_branch(metric, qtype):
    """The engine's fused-scan branch (taken on the card at N >= 100k)
    gives the JAX engine's answers: cosine norms, int8 mask, dequant and
    packed int4 reach the scan as they should."""
    (js, ji), (ts, ti), _ = _run(metric, qtype, False, True, use_kernel=True)
    assert (ti == ji).all()
    assert np.allclose(ts, js, rtol=1e-4, atol=1e-4)


def test_kernel_rule_needs_cuda_codes():
    X, _ = _data("L2")
    te = _engine(zvec_tpu_torch, TorchFlat, "L2", "UNDEFINED", X)
    te._ensure_fresh()
    assert te._st.codes.device.type == "cpu"
    assert te._st.n_pad == 2048 and te._st.codes.dtype == torch.float32
    assert not te._use_kernel(te._st, K)


def test_fp16_codes_stay_fp16():
    X, _ = _data("L2")
    te = _engine(zvec_tpu_torch, TorchFlat, "L2", "FP16", X)
    te._ensure_fresh()
    assert te._st.codes.dtype == torch.float16


def test_empty_engine():
    te = _engine(zvec_tpu_torch, TorchFlat, "L2", "UNDEFINED", np.zeros((0, DIM), np.float32))
    s, i = te.search(np.zeros((2, DIM), np.float32), 3)
    assert (i == -1).all() and np.isneginf(s).all()
