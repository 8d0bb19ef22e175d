"""Embedding functions: zvec_tpu_torch's copies against zvec_tpu's.

- BM25: on the corpora of tests/test_sparse.py (`test_bm25*`), with the same
  arguments, both packages give identical term dictionaries, document dicts
  and query dicts (equal floats, not close ones: the same host arithmetic).
- Providers: every case of tests/test_providers.py runs against each package
  with that file's fake SDK modules, and both give the same outputs.
- The local sentence-transformers classes default to the port's device
  (`ops/runtime.device()`), where zvec_tpu defaults to "cpu".
"""

import os
import sys
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import zvec_tpu  # noqa: E402
import zvec_tpu_torch  # noqa: E402
from test_providers import (  # noqa: E402,F401  (the same fakes)
    fake_dashscope,
    fake_openai,
    fake_sentence_transformers,
)
from zvec_tpu.extension import bm25_embedding_function as jbm25  # noqa: E402
from zvec_tpu_torch.extension import bm25_embedding_function as tbm25  # noqa: E402
from zvec_tpu_torch.extension import providers as tprov  # noqa: E402
from zvec_tpu_torch.ops.runtime import device  # noqa: E402

PKGS = (zvec_tpu, zvec_tpu_torch)

# (corpus, constructor kwargs, documents embedded after fit, queries)
BM25_CASES = {
    "ranking": (
        ["the quick brown fox jumps over the lazy dog",
         "a fast auburn fox leaped over a sleepy canine",
         "completely unrelated text about databases and indexes",
         "vector databases index embeddings for similarity search"],
        {}, [], ["fox dog", "databases", "zulu"],
    ),
    "formula": (
        ["the quick brown fox", "the lazy dog", "quick quick fox jumps", "a dog and a fox"],
        {"k1": 1.5, "b": 0.75}, [], ["quick fox", "dog dog"],
    ),
    "indicator_idf": (
        ["alpha beta", "beta gamma", "gamma delta"],
        {}, ["alpha beta", "epsilon alpha"], ["alpha gamma gamma", "alpha gamma"],
    ),
    "collision_free": (
        ["costarring liquid declinate macallums", "liquid macallums"],
        {}, [], ["liquid costarring"],
    ),
    "large_vocab": ([" ".join(f"t{i}" for i in range(50_000))], {}, [], ["t7 t49999 t123"]),
    "stopwords": (
        ["the quick fox", "a lazy dog"],
        {"stopwords": "ENGLISH_STOPWORDS"}, [], ["the the the", "the fox"],
    ),
    "stemmer": (["dogs dog"], {"stemmer": "strip_s"}, ["dog dogs cats"], ["dogs"]),
    "zh": (["今天天气很好", "天气不错"], {"language": "zh"}, [], ["天气", "很好 good"]),
    "document_mode": (["alpha beta"], {"encoding_type": "document"}, ["alpha alpha"], ["alpha"]),
}


def _bm25_kwargs(mod, kw):
    kw = dict(kw)
    if kw.get("stopwords") == "ENGLISH_STOPWORDS":
        kw["stopwords"] = mod.ENGLISH_STOPWORDS
    if kw.get("stemmer") == "strip_s":
        kw["stemmer"] = lambda t: t[:-1] if t.endswith("s") else t
    return kw


@pytest.mark.parametrize("case", list(BM25_CASES))
def test_bm25_identical_to_jax(case):
    corpus, kw, later, queries = BM25_CASES[case]
    out = []
    for mod in (jbm25, tbm25):
        bm = mod.BM25EmbeddingFunction(**_bm25_kwargs(mod, kw)).fit(corpus)
        docs = bm.embed_documents(corpus)
        calls = [bm(t) for t in later]  # bare calls follow encoding_type; may grow the dictionary
        qs = [bm.embed_query(q) for q in queries]
        out.append((bm.dump_vocab(), bm.vocab_size, bm.corpus_size, docs, calls, qs))
    assert out[0] == out[1]
    assert tbm25.ENGLISH_STOPWORDS == jbm25.ENGLISH_STOPWORDS


def test_bm25_argument_checks_match_jax():
    for kw in ({"encoding_type": "nope"}, {"language": "fr"}, {"corpus": []}, {"corpus": ["a", 3]}):
        for pkg in PKGS:
            with pytest.raises(ValueError):
                pkg.BM25EmbeddingFunction(**kw)


def _both(fn):
    """fn(pkg) run for each package; the two results must be equal."""
    a, b = (fn(pkg) for pkg in PKGS)
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b
    return b


def test_openai_dense_embedding(fake_openai):
    def run(pkg):
        fn = pkg.OpenAIDenseEmbedding(dimension=8, api_key="k")
        vecs = fn.embed_documents(["ab", "cdef"])
        assert fn.dimension == 8 and len(vecs) == 2 and vecs[0].shape == (8,)
        assert vecs[0].dtype == np.float32
        assert fn.embed_query("xyz").shape == (8,)
        assert fake_openai.OpenAI.last.calls[0]["model"] == "text-embedding-3-small"
        return np.stack(vecs + [fn("xyz")])

    _both(run)


def test_qwen_dense_and_sparse_embedding(fake_dashscope):
    def run(pkg):
        dense = pkg.QwenDenseEmbedding(dimension=16, api_key="secret")
        assert fake_dashscope.api_key == "secret"
        vecs = dense.embed_documents(["hi", "there"])
        assert vecs[0].shape == (16,) and vecs[0].dtype == np.float32
        assert float(vecs[1][0]) == 5.0
        sparse = pkg.QwenSparseEmbedding()
        rows = sparse.embed_documents(["hi", "there"])
        assert rows[0] == {1: 0.5, 7: 2.0} and all(isinstance(k, int) for k in rows[1])
        q = sparse.embed_query("abc")
        assert q[7] == 3.0
        return [v.tolist() for v in vecs], rows, q

    _both(run)


def test_qwen_reranker_orders_by_relevance(fake_dashscope):
    def run(pkg):
        rr = pkg.QwenReRanker(topn=2, rerank_field="txt", query="q")
        results = {
            "f1": [pkg.Doc(id="a", score=0.1, fields={"txt": "sh"}),
                   pkg.Doc(id="b", score=0.2, fields={"txt": "medium"})],
            "f2": [pkg.Doc(id="c", score=0.3, fields={"txt": "the longest text"}),
                   pkg.Doc(id="b", score=0.2, fields={"txt": "medium"})],
        }
        out = rr.rerank(results)
        assert [d.id for d in out] == ["c", "b"]
        assert out[0].score == float(len("the longest text"))
        return [(d.id, d.score) for d in out]

    _both(run)


def test_local_dense_embedding_and_reranker(fake_sentence_transformers):
    def run(pkg):
        fn = pkg.DefaultLocalDenseEmbedding()
        assert fn.dimension == 4
        vecs = fn.embed_documents(["ab", "c"])
        assert np.allclose(vecs[0], 2.0) and vecs[0].dtype == np.float32
        assert fn.embed_query("abc").shape == (4,)
        rr = pkg.DefaultLocalReRanker(topn=1, rerank_field="t", query="q")
        docs = {"f": [pkg.Doc(id="x", score=0.0, fields={"t": "tiny"}),
                      pkg.Doc(id="y", score=0.0, fields={"t": "substantially longer"})]}
        out = rr.rerank(docs)
        assert [d.id for d in out] == ["y"]
        assert out[0].score == float(len("substantially longer"))
        return [v.tolist() for v in vecs], [(d.id, d.score) for d in out]

    _both(run)


def test_local_sparse_embedding_no_network():
    corpus = ["the quick brown fox", "jumped over the lazy dog", "the fox"]

    def run(pkg):
        fn = pkg.DefaultLocalSparseEmbedding(corpus=corpus)
        rows = fn.embed_documents(corpus)
        assert len(rows) == 3 and all(rows)
        q = fn.embed_query("fox")
        assert isinstance(q, dict) and len(q) >= 1
        return rows, q

    _both(run)


def test_missing_provider_raises_friendly_importerror(monkeypatch):
    monkeypatch.setitem(sys.modules, "openai", None)
    for pkg in PKGS:
        with pytest.raises(ImportError, match="openai"):
            pkg.OpenAIDenseEmbedding()


def test_local_providers_default_to_the_port_device(monkeypatch):
    """The port's local models load on its device unless told otherwise; the
    JAX package's default is "cpu"."""
    seen = []

    class _Model:
        def __init__(self, model, device="unset"):
            seen.append(device)

    mod = types.ModuleType("sentence_transformers")
    mod.SentenceTransformer = mod.CrossEncoder = _Model
    monkeypatch.setitem(sys.modules, "sentence_transformers", mod)
    tprov.DefaultLocalDenseEmbedding()
    tprov.DefaultLocalReRanker()
    tprov.SentenceTransformerFunctionBase("m")
    zvec_tpu.DefaultLocalDenseEmbedding()
    tprov.DefaultLocalDenseEmbedding(device="cpu")
    assert seen == [str(device())] * 3 + ["cpu", "cpu"]
