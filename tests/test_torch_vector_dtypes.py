"""The public vector dtypes through both packages: zvec_tpu_torch against zvec_tpu.

The cases of `tests/test_vector_dtypes.py` (FP16 / FP32 / FP64 / INT8 / INT16 /
INT4 fields) and `tests/test_binary.py` (BINARY32 / BINARY64 FLAT fields, the
HNSW hamming graph, the BinaryConverter, schema validation and bad inputs),
each run as one seeded script on a `zvec_tpu` collection and a
`zvec_tpu_torch` collection. Every answer is compared across the packages:
the same ids, scores within 1e-4 (rtol and atol; hamming scores exactly), the
same fetched vectors, the same statuses and the same exception types, and
each keeps the original test's own assertions.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import zvec_tpu  # noqa: E402
import zvec_tpu_torch  # noqa: E402
from zvec_tpu.ops import quantize as jq  # noqa: E402
from zvec_tpu_torch.ops import quantize as tq  # noqa: E402

PKGS = {"jax": zvec_tpu, "torch": zvec_tpu_torch}
TOL = 1e-4
BITS = 96  # tests/test_binary.py's DIM: not a multiple of 64


def _hits(res):
    return [h.id for h in res], np.array([h.score for h in res], np.float64)


def _same(a, b, exact=False):
    """Two (ids, scores) answers: the same ids, scores within TOL (or equal)."""
    assert a[0] == b[0], (a[0], b[0])
    if exact:
        np.testing.assert_array_equal(a[1], b[1])
    else:
        np.testing.assert_allclose(a[1], b[1], rtol=TOL, atol=TOL)


def _both(tmp_path, script):
    """script(pkg, path) in each package on its own path -> {name: result}."""
    return {name: script(pkg, str(tmp_path / name)) for name, pkg in PKGS.items()}


@pytest.mark.parametrize("dtype,np_dtype", [("VECTOR_FP16", np.float16), ("VECTOR_FP32", np.float32),
                                            ("VECTOR_FP64", np.float64)])
def test_float_vector_dtypes_across_packages(tmp_path, dtype, np_dtype):
    d = 8
    xs = np.random.default_rng(42).standard_normal((50, d)).astype(np_dtype)

    def script(p, path):
        schema = p.CollectionSchema("col_vt", vectors=[
            p.VectorSchema("v", p.DataType[dtype], d, p.FlatIndexParam(p.MetricType.L2))])
        c = p.create_and_open(path, schema)
        c.insert([p.Doc(id=f"v{i}", vectors={"v": xs[i]}) for i in range(50)])
        first = _hits(c.query(p.VectorQuery("v", vector=xs[7]), topk=3))
        fetched = np.asarray(c.fetch("v7")["v7"].vector("v"), np.float64)
        c.flush()
        c._impl.close()
        c2 = p.open(path)
        again = _hits(c2.query(p.VectorQuery("v", vector=xs[3]), topk=1))
        refetched = np.asarray(c2.fetch("v7")["v7"].vector("v"))
        c2._impl.close()
        return first, fetched, again, refetched

    out = _both(tmp_path, script)
    for first, fetched, again, refetched in out.values():
        assert first[0][0] == "v7" and again[0] == ["v3"]
        np.testing.assert_allclose(fetched, xs[7].astype(np.float64), rtol=1e-2)
        if np_dtype == np.float64:
            np.testing.assert_array_equal(refetched, xs[7])
    j, t = out["jax"], out["torch"]
    _same(t[0], j[0])
    _same(t[2], j[2])
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[3], j[3])
    assert t[3].dtype == j[3].dtype


def test_int8_ip_field_across_packages(tmp_path):
    d = 8
    xs = np.random.default_rng(42).integers(-100, 100, (40, d)).astype(np.int8)

    def script(p, path):
        schema = p.CollectionSchema("col_vi", vectors=[
            p.VectorSchema("v", p.DataType.VECTOR_INT8, d, p.FlatIndexParam(p.MetricType.IP))])
        c = p.create_and_open(path, schema)
        c.insert([p.Doc(id=f"i{i}", vectors={"v": xs[i]}) for i in range(40)])
        res = _hits(c.query(p.VectorQuery("v", vector=xs[5]), topk=3))
        got = c.fetch("i5")["i5"].vector("v")
        c._impl.close()
        return res, got

    out = _both(tmp_path, script)
    ip = xs.astype(np.float32) @ xs[5].astype(np.float32)
    for res, got in out.values():
        assert res[0][0] == f"i{np.argmax(ip)}"
        assert res[1][0] == pytest.approx(float(ip.max()), rel=1e-5)
        assert got == xs[5].tolist()
    _same(out["torch"][0], out["jax"][0])


@pytest.mark.parametrize("dtype,np_dtype,lo,hi", [("VECTOR_INT16", np.int16, -3000, 3000),
                                                  ("VECTOR_INT8", np.int8, -128, 127)])
def test_int_vector_dtypes_across_packages(tmp_path, dtype, np_dtype, lo, hi):
    d = 8
    xs = np.random.default_rng(42).integers(lo, hi, size=(40, d)).astype(np_dtype)

    def script(p, path):
        schema = p.CollectionSchema("col_vi", vectors=[
            p.VectorSchema("v", p.DataType[dtype], d, p.FlatIndexParam(p.MetricType.L2))])
        c = p.create_and_open(path, schema)
        c.insert([p.Doc(id=f"v{i}", vectors={"v": xs[i]}) for i in range(40)])
        first = _hits(c.query(p.VectorQuery("v", vector=xs[5]), topk=3))
        c.flush()
        c._impl.close()
        c2 = p.open(path)
        fetched = np.asarray(c2.fetch("v5")["v5"].vector("v"))
        again = _hits(c2.query(p.VectorQuery("v", vector=xs[9]), topk=1))
        c2._impl.close()
        return first, fetched, again

    out = _both(tmp_path, script)
    for first, fetched, again in out.values():
        assert first[0][0] == "v5" and again[0] == ["v9"]
        np.testing.assert_array_equal(fetched, xs[5])
    _same(out["torch"][0], out["jax"][0])
    _same(out["torch"][2], out["jax"][2])


def test_int4_vector_across_packages(tmp_path):
    d = 9  # odd: the padded last nibble
    xs = np.random.default_rng(42).integers(-8, 8, size=(30, d)).astype(np.int8)

    def script(p, path):
        schema = p.CollectionSchema("col_v4", vectors=[
            p.VectorSchema("v", p.DataType.VECTOR_INT4, d, p.FlatIndexParam(p.MetricType.L2))])
        c = p.create_and_open(path, schema)
        c.insert([p.Doc(id=f"v{i}", vectors={"v": xs[i]}) for i in range(30)])
        width = c._impl.writing.store._dense["v"].shape[1]
        res = _hits(c.query(p.VectorQuery("v", vector=xs[4]), topk=5))
        c.flush()
        c._impl.close()
        c2 = p.open(path)
        fetched = np.asarray(c2.fetch("v4")["v4"].vector("v"))
        c2._impl.close()
        return width, res, fetched

    out = _both(tmp_path, script)
    d2 = ((xs.astype(np.float64) - xs[4].astype(np.float64)) ** 2).sum(1)
    for width, res, fetched in out.values():
        assert width == 5  # ceil(9 / 2) bytes a row
        assert res[0] == [f"v{i}" for i in np.argsort(d2, kind="stable")[:5]]
        np.testing.assert_array_equal(fetched, xs[4])
    _same(out["torch"][1], out["jax"][1])


def test_int4_range_statuses_across_packages(tmp_path):
    def script(p, path):
        schema = p.CollectionSchema("v4r", vectors=[
            p.VectorSchema("v", p.DataType.VECTOR_INT4, 4, p.FlatIndexParam(p.MetricType.L2))])
        c = p.create_and_open(path, schema)
        out = [bool(c.insert(p.Doc(id=pk, vectors={"v": np.array(v)})))
               for pk, v in (("a", [8, 0, 0, 0]), ("b", [1.5, 0, 0, 0]), ("c", [-8, 7, 0, 1]))]
        c._impl.close()
        return out

    out = _both(tmp_path, script)
    assert out["torch"] == out["jax"] == [False, False, True]


def _bits(rng, n):
    return (rng.random((n, BITS)) > 0.5).astype(np.uint8)


def _hamming(qbits, xbits):
    return (qbits[:, None, :] != xbits[None, :, :]).sum(axis=2)


def test_pack_bits_and_pm1_equal_the_reference():
    bits = _bits(np.random.default_rng(3), 17)
    for wb in (32, 64):
        words = tq.pack_bits(bits, wb)
        np.testing.assert_array_equal(words, jq.pack_bits(bits, wb))
        np.testing.assert_array_equal(tq.unpack_bits(words, BITS), bits)
    np.testing.assert_array_equal(tq.bits_to_pm1(bits), jq.bits_to_pm1(bits))
    x = np.random.default_rng(4).standard_normal((5, 33)).astype(np.float32)
    np.testing.assert_array_equal(tq.binarize(x), jq.binarize(x))


@pytest.mark.parametrize("dtype,word_bits", [("VECTOR_BINARY32", 32), ("VECTOR_BINARY64", 64)])
def test_flat_binary_across_packages(tmp_path, dtype, word_bits):
    rng = np.random.default_rng(42)
    bits = _bits(rng, 200)
    qbits = _bits(rng, 8)
    packed = jq.pack_bits(bits, word_bits)
    qpacked = jq.pack_bits(qbits, word_bits)

    def script(p, path):
        schema = p.CollectionSchema("bin", vectors=[
            p.VectorSchema("code", p.DataType[dtype], BITS, p.FlatIndexParam(p.MetricType.HAMMING))])
        c = p.create_and_open(path, schema)
        docs = [p.Doc(id=f"d{i}", vectors={"code": packed[i]}) for i in range(100)]
        docs += [p.Doc(id=f"d{i}", vectors={"code": bits[i]}) for i in range(100, 200)]
        assert all(s.is_ok() for s in c.insert(docs))
        res = [_hits(c.query(p.VectorQuery("code", vector=qpacked[r]), topk=5)) for r in range(4)]
        res.append(_hits(c.query(p.VectorQuery("code", vector=qbits[4]), topk=3)))
        batch = [_hits(r) for r in c.batch_query("code", qbits, topk=5, output_fields=[])]
        try:  # zvec_tpu's batch_query casts packed words to float and refuses them
            packed_batch = [_hits(r) for r in c.batch_query("code", qpacked, topk=5, output_fields=[])]
        except Exception as err:  # noqa: BLE001
            packed_batch = type(err).__name__
        c.flush()
        c._impl.close()
        c2 = p.open(path)
        res.append(_hits(c2.query(p.VectorQuery("code", vector=qbits[0]), topk=5)))
        words = np.asarray(c2.fetch("d0")["d0"].vectors["code"], np.uint64 if word_bits == 64 else np.uint32)
        c2._impl.close()
        return res, batch, words, packed_batch

    out = _both(tmp_path, script)
    dist = _hamming(qbits, bits)
    for res, batch, words, _ in out.values():
        for r in range(4):
            exp = np.argsort(dist[r], kind="stable")[:5]
            assert res[r][0] == [f"d{i}" for i in exp]
            np.testing.assert_array_equal(res[r][1], dist[r][exp])
        assert res[4][0] == [f"d{i}" for i in np.argsort(dist[4], kind="stable")[:3]]
        assert res[5][0] == [f"d{i}" for i in np.argsort(dist[0], kind="stable")[:5]]
        for r in range(8):  # bit-form queries in one batch
            np.testing.assert_array_equal(batch[r][1], np.sort(dist[r])[:5])
        assert (jq.unpack_bits(words[None, :], BITS)[0] == bits[0]).all()
    (jr, jb, jw, jp), (tr, tb, tw, tp) = out["jax"], out["torch"]
    for a, b in zip(tr + tb, jr + jb):
        _same(a, b, exact=True)
    np.testing.assert_array_equal(tw, jw)
    # a packed batch: the port answers it as the bit-form batch; zvec_tpu refuses it
    assert jp == "ZvecError"
    for a, b in zip(tp, tb):
        _same(a, b, exact=True)


def test_hnsw_hamming_graph_across_packages(tmp_path):
    rng = np.random.default_rng(42)
    bits = _bits(rng, 1500)
    qbits = _bits(rng, 16)

    def script(p, path):
        schema = p.CollectionSchema("binh", vectors=[p.VectorSchema(
            "code", p.DataType.VECTOR_BINARY32, BITS, p.HnswIndexParam(p.MetricType.HAMMING, m=16))])
        c = p.create_and_open(path, schema)
        for lo in range(0, 1500, 500):
            c.insert([p.Doc(id=f"d{i}", vectors={"code": bits[i]}) for i in range(lo, lo + 500)])
        c.flush()
        c.optimize()
        res = [_hits(c.query(p.VectorQuery("code", vector=qbits[r], param=p.HnswQueryParam(ef=96)), topk=10))
               for r in range(16)]
        l0 = next(s for s in c._impl._segments_snapshot() if s.doc_count > 0).engine_for("code")._graph.l0
        c._impl.close()
        return res, np.asarray(l0)

    out = _both(tmp_path, script)
    dist = _hamming(qbits, bits)
    for res, _ in out.values():
        hits = 0
        for r, (_, got_d) in enumerate(res):
            exp_d = np.sort(dist[r])[:10]
            hits += int((got_d <= exp_d[-1]).sum())
            assert got_d[0] == exp_d[0]
        assert hits / 160 >= 0.9
    np.testing.assert_array_equal(out["torch"][1], out["jax"][1])  # the host build: one graph
    for a, b in zip(out["torch"][0], out["jax"][0]):
        _same(a, b, exact=True)


def test_binary_converter_across_packages(tmp_path):
    rng = np.random.default_rng(42)
    X = rng.standard_normal((300, 64)).astype(np.float32)
    q = rng.standard_normal((4, 64)).astype(np.float32)

    def script(p, path):
        schema = p.CollectionSchema("conv", vectors=[p.VectorSchema(
            "emb", p.DataType.VECTOR_FP32, 64,
            p.FlatIndexParam(p.MetricType.L2, quantize_type=p.QuantizeType.BINARY))])
        c = p.create_and_open(path, schema)
        c.insert([p.Doc(id=f"d{i}", vectors={"emb": X[i]}) for i in range(300)])
        res = [_hits(c.query(p.VectorQuery("emb", vector=q[r]), topk=5)) for r in range(4)]
        c._impl.close()
        return res

    out = _both(tmp_path, script)
    dist = _hamming((q >= 0).astype(np.uint8), (X >= 0).astype(np.uint8))
    for res in out.values():
        for r in range(4):
            np.testing.assert_array_equal(res[r][1], np.sort(dist[r], kind="stable")[:5])
    for a, b in zip(out["torch"], out["jax"]):
        _same(a, b, exact=True)


_BAD_SCHEMAS = {
    "ivf": lambda p: p.VectorSchema("b", p.DataType.VECTOR_BINARY32, 64, p.IVFIndexParam(p.MetricType.HAMMING)),
    "l2": lambda p: p.VectorSchema("b", p.DataType.VECTOR_BINARY32, 64, p.FlatIndexParam(p.MetricType.L2)),
    "requantized": lambda p: p.VectorSchema("b", p.DataType.VECTOR_BINARY32, 64, p.FlatIndexParam(
        p.MetricType.HAMMING, quantize_type=p.QuantizeType.INT8)),
}


@pytest.mark.parametrize("case,match", [("ivf", "FLAT/HNSW"), ("l2", "HAMMING"), ("requantized", "re-quantized")])
def test_binary_schema_validation_across_packages(case, match):
    raised = {}
    for name, p in PKGS.items():
        with pytest.raises(Exception, match=match) as err:
            _BAD_SCHEMAS[case](p)
        raised[name] = type(err.value)
    assert raised["torch"].__name__ == raised["jax"].__name__ == "ValueError"


def test_binary_default_metric_across_packages():
    for p in PKGS.values():
        assert p.VectorSchema("b", p.DataType.VECTOR_BINARY64, 128).index_param.metric_type == p.MetricType.HAMMING


def test_binary_bad_inputs_across_packages(tmp_path):
    def script(p, path):
        schema = p.CollectionSchema("bad", vectors=[p.VectorSchema("code", p.DataType.VECTOR_BINARY32, BITS)])
        c = p.create_and_open(path, schema)
        out = []
        for v in (np.zeros(7, np.uint32), np.full(BITS, 2, np.uint8)):
            st = c.insert(p.Doc(id="x", vectors={"code": v}))
            out.append((st.is_ok(), st.message))
        c._impl.close()
        return out

    out = _both(tmp_path, script)
    assert out["torch"] == out["jax"]
    (ok1, msg1), (ok2, msg2) = out["torch"]
    assert not ok1 and "matches neither" in msg1
    assert not ok2 and "0/1" in msg2


def test_binary_query_of_wrong_width_raises_alike(tmp_path):
    """A packed query of the wrong word count: the same exception type in both."""
    raised = {}
    for name, p in PKGS.items():
        schema = p.CollectionSchema("bqw", vectors=[p.VectorSchema("code", p.DataType.VECTOR_BINARY32, BITS)])
        c = p.create_and_open(str(tmp_path / name), schema)
        c.insert([p.Doc(id="a", vectors={"code": np.zeros(BITS, np.uint8)})])
        with pytest.raises(Exception) as err:
            c.query(p.VectorQuery("code", vector=np.zeros(7, np.uint32)), topk=1)
        raised[name] = type(err.value).__name__
        c._impl.close()
    assert raised["torch"] == raised["jax"]
