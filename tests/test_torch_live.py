"""The live, filtered collection: zvec_tpu_torch against zvec_tpu.

One seeded script of operations runs on a `zvec_tpu` collection and a
`zvec_tpu_torch` collection side by side, for each dense index type (FLAT,
HNSW, IVF). The schema is `benchmarks/bench_filtered10m.py`'s on
`bench_ivf10m.py`'s fields, small: 4,000 x 32 L2 rows, a `tag` string with an
inverted index, a `price` double, a `gid` int (i % 997), and
`max_doc_count_per_segment` 2,400, so that the fill seals a segment (which
gets the index; the writing segment scans flat).

The script: fill -> delete 1% of the pks -> delete_by_filter -> upsert 100
pks with fresh vectors -> update the price of 100 pks (a fifth of them
upserted before, so the writing segment holds deleted rows) -> insert 1,300
new docs (one more segment sealed, holding the mutated rows) -> a crash (the
impl closed without a flush) and the WAL replay at `open` -> optimize.

After every step both packages answer the same queries: the unfiltered
batch, three filters chosen so that every branch of the brute-force-by-keys
rule (`db/collection_impl.py::_query_field_dispatch`) is reached, and a
grouped query on `gid`. Ids must be identical and scores within 1e-4 (rtol
and atol), the doc counts equal, and every segment must take the same branch
in both packages (read from the query profile): the index (`vector_scan`),
the host `_exact_over_rows`, or the device scan over the segment with
`is_linear` (`bf_by_keys`).
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import chip_smoke as cs  # noqa: E402
import zvec_tpu  # noqa: E402
import zvec_tpu_torch  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
N, DIM, SEG, NQ, K = 4000, 32, 2400, 16, 10
# the device branch needs Q * n_alive * D > 2^24 on a demoted segment (at
# most a tenth of its rows): ~190 rows of a sealed segment pass `price > 0.92`
# (the updates' 0.05 does not), so 3,500 queries
NQ_BIG = 3500
PKGS = {"jax": zvec_tpu, "torch": zvec_tpu_torch}
TOL = 1e-4
# (filter, queries): the index, the host exact scan, the device scan
FILTERS = (
    ("price < 0.5", NQ),
    ("tag = 't3' AND price < 0.1", NQ),
    ("price > 0.92", NQ_BIG),
)
STEPS = ("fill", "delete", "delete_by_filter", "upsert", "update", "insert", "crash", "optimize")


def _index_param(pkg, index):
    m = pkg.MetricType.L2
    if index == "flat":
        return pkg.FlatIndexParam(m)
    if index == "hnsw":
        return pkg.HnswIndexParam(m, m=16, ef_construction=100)
    return pkg.IVFIndexParam(m, n_list=16, n_iters=6)


def _query_param(pkg, index):
    if index == "hnsw":
        return pkg.HnswQueryParam(ef=64)
    return pkg.IVFQueryParam(nprobe=4) if index == "ivf" else None


def _schema(pkg, index):
    return pkg.CollectionSchema(
        "live",
        fields=[
            pkg.FieldSchema("tag", pkg.DataType.STRING, index_param=pkg.InvertIndexParam()),
            pkg.FieldSchema("price", pkg.DataType.DOUBLE),
            pkg.FieldSchema("gid", pkg.DataType.INT32),
        ],
        vectors=[pkg.VectorSchema("emb", pkg.DataType.VECTOR_FP32, DIM, _index_param(pkg, index))],
        max_doc_count_per_segment=SEG,
    )


def _data():
    rng = np.random.default_rng(0x11FE)
    centers = rng.standard_normal((24, DIM)).astype(np.float32) * 1.5
    X = centers[rng.integers(0, 24, N)] + rng.standard_normal((N, DIM)).astype(np.float32)
    Q = centers[rng.integers(0, 24, NQ_BIG)] + rng.standard_normal((NQ_BIG, DIM)).astype(np.float32)
    tags = rng.integers(0, 10, N)
    price = rng.random(N)
    fresh = centers[rng.integers(0, 24, 1400)] + rng.standard_normal((1400, DIM)).astype(np.float32)
    return X, Q, tags, price, fresh, rng


def _docs(pkg, rows, X, tags, price):
    return [pkg.Doc(id=f"d{i}", vectors={"emb": X[j]},
                    fields={"tag": f"t{tags[j]}", "price": float(price[j]), "gid": int(i % 997)})
            for j, i in enumerate(rows)]


class _Script:
    """The two collections of one index type and the script's state; `run_to`
    applies the steps up to one and records every checkpoint it passes."""

    def __init__(self, root: Path, index: str):
        self.index = index
        self.root = root
        self.cols = {}
        self.done = 0
        self.results = {}
        X, Q, tags, price, fresh, rng = _data()
        self.X, self.Q, self.tags, self.price, self.fresh = X, Q, tags, price, fresh
        pks = np.arange(N)
        self.deleted = np.sort(rng.choice(pks, N // 100, replace=False))
        rest = np.setdiff1d(pks, self.deleted)
        self.upserted = np.sort(rng.choice(rest[rest % 997 != 5], 100, replace=False))
        others = np.setdiff1d(rest[rest % 997 != 5], self.upserted)
        self.updated = np.sort(np.concatenate([rng.choice(others, 80, replace=False),
                                               rng.choice(self.upserted, 20, replace=False)]))

    def live_vectors(self, n_step: int) -> dict:
        """pk -> its live vector once the steps up to `n_step` have run."""
        done = STEPS[: n_step + 1]
        live = {f"d{i}": self.X[i] for i in range(N)}
        if "delete" in done:
            for i in self.deleted:
                del live[f"d{i}"]
        if "delete_by_filter" in done:
            for i in range(5, N, 997):
                live.pop(f"d{i}", None)
        if "upsert" in done:
            live.update({f"d{i}": self.fresh[j] for j, i in enumerate(self.upserted)})
        if "insert" in done:
            live.update({f"d{N + j}": self.fresh[100 + j] for j in range(1300)})
        return live

    def _step(self, name: str) -> None:
        for pname, pkg in PKGS.items():
            col = self.cols.get(pname)
            if name == "fill":
                col = pkg.create_and_open(str(self.root / pname), _schema(pkg, self.index))
                for lo in range(0, N, 500):
                    rows = np.arange(lo, min(lo + 500, N))
                    col.insert(_docs(pkg, rows, self.X[rows], self.tags[rows], self.price[rows]))
            elif name == "delete":
                for lo in range(0, len(self.deleted), 16):
                    col.delete([f"d{i}" for i in self.deleted[lo : lo + 16]])
            elif name == "delete_by_filter":
                col.delete_by_filter("gid = 5")
            elif name == "upsert":
                rows = self.upserted
                col.upsert(_docs(pkg, rows, self.fresh[: len(rows)], self.tags[rows], self.price[rows]))
            elif name == "update":
                col.update([pkg.Doc(id=f"d{i}", fields={"price": 0.05}) for i in self.updated])
            elif name == "insert":
                new = np.arange(N, N + 1300)
                more = self.fresh[100:1400]
                tags, price = self.tags[new - N], self.price[new - N]
                for lo in range(0, 1300, 500):
                    sl = slice(lo, lo + 500)
                    col.insert(_docs(pkg, new[sl], more[sl], tags[sl], price[sl]))
            elif name == "crash":
                path = col._impl.path
                col._impl.close()
                col = pkg.open(path)
            elif name == "optimize":
                col.optimize()
            self.cols[pname] = col

    def _answers(self, pname: str) -> dict:
        pkg, col = PKGS[pname], self.cols[pname]
        param = _query_param(pkg, self.index)
        out = {"count": col.stats.doc_count}
        docs = col.batch_query("emb", self.Q[:NQ], topk=K, output_fields=[], param=param)
        out["plain"] = _ids_scores(docs)
        for flt, nq in FILTERS:
            if nq == NQ:
                col._impl.debug_profiling = True
                docs = col.batch_query("emb", self.Q[:nq], topk=K, filter=flt, output_fields=[], param=param)
                profile = col._impl.last_profile
                col._impl.debug_profiling = False
                out[flt] = _ids_scores(docs)
            else:  # the large batch without its Docs: (doc ids, similarities)
                prof = pkg.utils.profiler.Profiler(enabled=True)
                sims, ids = col._impl.query_field("emb", self.Q[:nq], K, flt, param, profiler=prof)
                prof.finish()
                profile = prof.to_json()
                out[flt] = (np.asarray(ids).tolist(), np.asarray(sims, np.float64))
            out[flt + " branches"] = _branches(profile)
        grouped = col.group_by_query(pkg.VectorQuery("emb", vector=self.Q[1], param=param), group_by_field="gid",
                                     group_count=5, group_topk=2, output_fields=["gid"])
        out["grouped"] = ([(d.id, d.field("gid")) for d in grouped], [[d.score for d in grouped]])
        return out

    def run_to(self, step: str) -> None:
        while self.done <= STEPS.index(step):
            name = STEPS[self.done]
            self.done += 1
            try:
                self._step(name)
                self.results[name] = (self._answers("jax"), self._answers("torch"))
            except Exception as exc:  # recorded for the step's own case
                self.results[name] = exc

    def close(self) -> None:
        for col in self.cols.values():
            col._impl.close()


def _ids_scores(docs_lists):
    ids = [[d.id for d in docs] for docs in docs_lists]
    return ids, np.array([[d.score for d in docs] for docs in docs_lists], np.float64)


def _branches(profile: str) -> dict:
    """Per segment, the branch the query took: `vector_scan` (the index),
    `bf_by_keys` (the device scan with is_linear) or, where the segment was
    filtered and neither stage ran, `host` (`_exact_over_rows`)."""
    out = {}

    def walk(node):
        name = node["stage"]
        kind, _, seg = name.partition(" ")
        if kind in ("filter", "vector_scan", "bf_by_keys"):
            prev = out.get(seg)
            out[seg] = kind if prev in (None, "filter") else prev
        for child in node.get("children", []):
            walk(child)

    walk(json.loads(profile))
    return {seg: ("host" if kind == "filter" else kind) for seg, kind in out.items()}


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    made = {}

    def get(index):
        if index not in made:
            made[index] = _Script(tmp_path_factory.mktemp(f"live_{index}"), index)
        return made[index]

    yield get
    for s in made.values():
        s.close()


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("index", ("flat", "hnsw", "ivf"))
def test_live_step_matches_jax(scripts, index, step):
    """After the step, both packages give the same answers and branches."""
    s = scripts(index)
    s.run_to(step)
    res = s.results[step]
    if isinstance(res, Exception):
        raise res
    a, b = res
    assert a["count"] == b["count"]
    for key in ("plain", "grouped") + tuple(flt for flt, _ in FILTERS):
        (ia, sa), (ib, sb) = a[key], b[key]
        assert ia == ib, key
        assert np.allclose(sa, sb, rtol=TOL, atol=TOL), key
    for flt, _ in FILTERS:
        assert a[flt + " branches"] == b[flt + " branches"], flt


@pytest.mark.parametrize("index", ("flat", "hnsw", "ivf"))
def test_live_script_invariants(scripts, index):
    """What the script must show in the port beside the parity: after every
    step each returned (pk, score) is a live pk scored against its live
    vector (no deleted pk, no superseded version), the crash lost nothing,
    every branch was taken, and on the exact FLAT index the upserts are read
    back at rank 1 with their own vectors and the updates' price."""
    s = scripts(index)
    s.run_to("optimize")
    col = s.cols["torch"]
    seen = set()
    for n_step, name in enumerate(STEPS):
        res = s.results[name]
        if isinstance(res, Exception):
            raise res
        live = s.live_vectors(n_step)
        for flt, nq in FILTERS:
            seen.update(res[1][flt + " branches"].values())
        for key in ("plain",) + tuple(flt for flt, nq in FILTERS if nq == NQ):
            ids, scores = res[1][key]
            for q, row, srow in zip(s.Q, ids, scores):
                assert all(pk in live for pk in row), (name, key)
                exact = [float(((q - live[pk]) ** 2).sum()) for pk in row]
                assert np.allclose(srow[: len(row)], exact, rtol=TOL, atol=1e-3), (name, key)
    assert col.stats.doc_count == len(s.live_vectors(len(STEPS) - 1))
    assert seen == {"vector_scan", "host", "bf_by_keys"}
    if index != "flat":
        return  # HNSW and IVF are approximate: a self-query may miss its row
    docs = col.batch_query("emb", s.fresh[:100], topk=1, output_fields=["price"])
    assert [d[0].id for d in docs] == [f"d{i}" for i in s.upserted]
    assert max(abs(d[0].score) for d in docs) <= 1e-3
    for i, d in zip(s.upserted, docs):
        assert d[0].field("price") == (0.05 if i in s.updated else s.price[i])


def _bench_ivf10m(monkeypatch, n: int):
    """benchmarks/bench_ivf10m.py imported by path with IVF10M_N = n (its
    import runs no stage)."""
    monkeypatch.setenv("IVF10M_N", str(n))
    spec = importlib.util.spec_from_file_location("bench_ivf10m", REPO / "benchmarks" / "bench_ivf10m.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fields_generator_copy_equals_the_benchmark(monkeypatch):
    """`chip_smoke.py`'s copy of `fields_arrays` draws the benchmark's tags
    and prices at the live phase's row count."""
    ref = _bench_ivf10m(monkeypatch, cs.CL_N)
    assert ref.SEED == cs.LV_FIELDS_SEED
    tags, price = cs.live_fields(cs.CL_N)
    rtags, rprice = ref.fields_arrays()
    np.testing.assert_array_equal(tags, rtags)
    np.testing.assert_array_equal(price, rprice)
