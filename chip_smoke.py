"""Smoke run of zvec_tpu_torch on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is non-zero):
  1. toolchain: torch / CUDA / nvcc versions and the card's name and power limit
  2. build the CUDA kernels from zvec_tpu_torch/csrc/ (seconds printed)
  3. the fused flat-scan kernel against its plain PyTorch version on the card,
     at N=1M (padded to 1,007,616 rows), D=128, Q=1024, k=10, for L2 / IP /
     COSINE x fp32 / fp16 / int8 / int4 codes (one case with a 30% mask):
     stage one and the final top-k
  4. the main path through the public API: create_and_open -> insert 1M x 128
     fp32 docs (batches of 1024) -> optimize -> flush -> batch_query_many over
     4 blocks of 1024 queries, top-10, L2; recall 1.0 against an exact oracle
     on the card, codes resident on CUDA, and the kernel's launch count > 0
  5. durability: reopen the collection and get the same ids
  3b. the same kernel at the shape the HNSW build gives it: N=1M (padded to
     1,000,448 rows), Q=2048 code rows, k=128, fp32 L2 and COSINE, against its
     plain version (stage one and the final top-128)
  6. the HNSW path through the public API: HnswIndexParam(L2) with the
     default m=50, ef_construction=500 -> insert the same 1M docs -> optimize
     (graph build on the card, the kernel scoring its forward kNN pass) ->
     flush -> batch_query_many over 4 blocks of 1024 queries at ef 128 / 256 /
     500 (recall@10 against the exact oracle; >= 0.85 at ef=500), one profiled
     ef=256 batch, the CUDA beam against the same beam on CPU copies of its
     tensors (64 queries), and a reopen that loads the graph from disk
  7. the IVF path through the public API, on the JAX package's IVF deployment
     (benchmarks/bench_suite.py:182-294): 1M x 96 clustered fp32 docs
     (benchmarks/h2h.py::make_data) with an inverted `tag` string and a
     `price` double, IVFIndexParam(L2, use_soar=True), n_list auto (1,024)
     -> insert (batches of 1024) -> optimize (k-means, SOAR spill and lists on
     the card) -> flush -> batch_query of 1024 queries at nprobe 8 / 16 / 32 /
     64 (recall@10 against the exact oracle: >= 0.98 at 8, >= 0.995 above),
     the filter `tag = 't3' AND price < 0.5` (recall@10 1.0 against the
     filtered oracle), one profiled nprobe=16 batch, the CUDA probe against
     the same probe on CPU copies of its tensors (64 queries), and a reopen
     that loads the trained lists without running k-means

Phases 3 and 3b print, beside each stage-one time, its bound (the larger of
the split-TF32 tensor-core work over 495 TFLOP/s and the bytes over 3.35
TB/s, with the FLOP and byte counts), the roofline share (bound / time) and,
for fp32 codes, a library yardstick: torch.matmul of the same (Q, D) x (D, N)
product in full fp32, the product only (the port never calls it).

The line before the last is a JSON object with the kernel's launches, error,
times, bound and yardstick; the last line is {"ok": true, "device": {...}}. Needs one CUDA
card; exits non-zero without one.
"""

from __future__ import annotations

import gc
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N, D, Q, K = 1_000_000, 128, 1024, 10
N_PAD = 1_007_616  # N rounded up to the 8192-row tile, as FlatEngine pads it
SEED = 0
REPO = Path(__file__).resolve().parent
# stage-one keys: float32 sums in another order (|key| up to ~300 at D=128)
STAGE1_RTOL, STAGE1_ATOL = 1e-4, 1e-3
STAGE1_MAX_ID_SWAPS = 1e-3  # share of (tile, k, q) ids that may swap on near-equal keys
TIE_RTOL = 1e-5  # final top-k: rows whose k-th and (k+1)-th scores lie this close may differ
N_BUILD_PAD = 1_000_448  # N rounded up to 1024 rows, as the HNSW build pads its scan
Q_BUILD, K_BUILD = 2048, 128  # build rows per scan and knn_k + 1 (knn_k = 127 above 400k rows)
EFS = (128, 256, 500)
# recall@10 of zvec's C++ HNSW on the same data and index (m=50, efc=500),
# benchmarks/ab_backfill_gaussian1m.json "reference_curve"
REF_CURVE = {128: 0.653, 256: 0.811, 500: 0.911}
MIN_RECALL_EF500 = 0.85
BEAM_CHECK_Q, BEAM_CHECK_EF = 64, 128
BEAM_RTOL = 1e-4  # CUDA beam vs CPU beam: scores, and the width of a near-tie
IVF_N, IVF_D = 1_000_000, 96  # the Deep1M shape of bench_suite.py's config #4
NPROBES = (8, 16, 32, 64)
# recall@10 floors; zvec_tpu read 0.9906 / 1.0 / 1.0 / 1.0 on this config
# (benchmarks/suite_results.json, "ivf_hybrid_filter")
IVF_FLOORS = {8: 0.98, 16: 0.995, 32: 0.995, 64: 0.995}
IVF_FILTER = "tag = 't3' AND price < 0.5"
PROBE_CHECK_Q, PROBE_CHECK_NPROBE = 64, 16
PROBE_RTOL = 1e-4  # CUDA probe vs CPU probe: scores, and the width of a near-tie
# published H100 SXM peaks (NVIDIA's data sheet), for the roofline bound of K1
PEAK_TF32_FLOPS = 495e12  # dense TF32 tensor-core rate
PEAK_HBM_BYTES = 3.35e12  # device memory rate


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median device time of fn() in ms (CUDA events, synchronised)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _bound(nq: int, n: int, d: int, topk: int, tile_n: int, codes: torch.Tensor) -> dict:
    """The least time the card could take for stage one: the larger of its
    tensor-core work (three TF32 products per fp32 pair, two for fp16 / int8 /
    int4 codes, 2*Q*N*D FLOP each) over the TF32 peak and its bytes (codes,
    norms, mask and queries read once, (tile, k, Q) keys and ids written
    once) over the memory rate."""
    passes = 3 if codes.dtype == torch.float32 else 2
    flop = passes * 2.0 * nq * n * d
    nbytes = (codes.numel() * codes.element_size() + n * 5 + nq * d * 4
              + (n // tile_n) * topk * nq * 8)
    t_ops, t_bytes = flop / PEAK_TF32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                flop=flop, bytes=nbytes)


def _library_ms(q: torch.Tensor, codes: torch.Tensor):
    """torch.matmul of the same (Q, D) x (D, N) fp32 product in full fp32
    (TF32 off): the product only, without key, mask or group-max. A yardstick;
    the port never calls it. None for codes other than fp32."""
    if codes.dtype != torch.float32:
        return None
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return time_ms(lambda: torch.matmul(q, codes.T))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _bound_text(b: dict, k_ms: float, lib_ms) -> str:
    lib = "n/a" if lib_ms is None else f"{lib_ms:.3f} ms"
    return (f"bound {b['bound_ms']:.3f} ms by {b['bound_by']} ({b['flop']:.4g} FLOP at 495 TFLOP/s, "
            f"{b['bytes']:.4g} B at 3.35 TB/s), roofline {b['bound_ms'] / k_ms:.1%}; "
            f"library {lib} (torch.matmul fp32, product only)")


def phase_toolchain() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card")
    import zvec_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True, text=True, check=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    log(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from zvec_tpu_torch.ops.flat_scan import build_kernels

    so, secs = build_kernels()
    log(f"build: {so.name} in {secs:.2f} s")
    report = so.with_suffix(".log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")


def _make_codes(x: torch.Tensor, ctype: str, metric: str):
    """Codes, norms and dequant for one case, made on the card from x."""
    if metric == "COSINE" and ctype in ("int8", "int4"):
        nrm = x.norm(dim=1, keepdim=True)
        x = torch.where(nrm > 0, x / torch.where(nrm > 0, nrm, 1.0), x)
    if ctype == "fp32":
        codes, deq, dequant = x, x, None
    elif ctype == "fp16":
        codes = x.half()
        deq, dequant = codes.float(), None
    else:
        lim = 127 if ctype == "int8" else 7
        lo, hi = float(x.min()), float(x.max())
        scale, bias = (hi - lo) / (2 * lim), (hi + lo) / 2
        c = torch.clamp(torch.round((x - bias) / scale), -lim, lim).to(torch.int32)
        deq = c.float() * scale + bias
        dequant = (scale, bias)
        if ctype == "int8":
            codes = c.to(torch.int8)
        else:  # two codes per byte, low nibble = even element
            pairs = c.view(c.shape[0], -1, 2)
            byte = (pairs[..., 0] & 0xF) | ((pairs[..., 1] & 0xF) << 4)
            codes = byte.to(torch.uint8).view(torch.int8).contiguous()
    sq = (deq * deq).sum(1)
    norms = torch.sqrt(sq) if metric == "COSINE" else sq
    return codes.contiguous(), norms, dequant


def _check_final(ks, ki, ps, pi):
    """Kernel top-k (ks, ki) against the plain top-(k+1) (ps, pi)."""
    near_tie = (ps[:, K - 1] - ps[:, K]).abs() <= TIE_RTOL * ps[:, K - 1].abs()
    ks_sorted = torch.sort(ki, dim=1).values
    ps_sorted = torch.sort(pi[:, :K], dim=1).values
    differ = (ks_sorted != ps_sorted).any(dim=1)
    bad = int((differ & ~near_tie).sum())
    err = float((ks - ps[:, :K]).abs().max())
    return bad, int(differ.sum()), err


def _check_final_at_k(ks, ki, ps, pi, rtol=TIE_RTOL):
    """Top-k (ks, ki) against a reference top-k (ps, pi) at the same k: a row
    whose id sets differ is bad unless every id in the difference scores
    within rtol of the row's k-th score (a near-tie at the boundary).
    Returns (bad rows, differing rows, max |score difference| on the rows
    whose sets agree)."""
    k = ki.shape[1]
    differ = (torch.sort(ki, dim=1).values != torch.sort(pi, dim=1).values).any(dim=1)
    bad = 0
    for r in differ.nonzero().flatten().tolist():
        a = dict(zip(ki[r].tolist(), ks[r].tolist()))
        b = dict(zip(pi[r].tolist(), ps[r].tolist()))
        kth = float(ps[r, k - 1])
        extra = [a[i] for i in a.keys() - b.keys()] + [b[i] for i in b.keys() - a.keys()]
        bad += any(abs(v - kth) > rtol * abs(kth) for v in extra)
    same = ~differ
    err = float((ks[same] - ps[same]).abs().max()) if bool(same.any()) else 0.0
    return bad, int(differ.sum()), err


def phase_kernel_vs_plain() -> dict:
    from zvec_tpu_torch.ops import flat_scan as fs
    from zvec_tpu_torch.typing import MetricType

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    # the shapes the main path gives the kernel: N rows padded with zero rows
    # to N_PAD, the padding masked out
    x = torch.randn((N_PAD, D), generator=g, device=dev)
    x[N:] = 0.0
    q = torch.randn((Q, D), generator=g, device=dev)
    full = (torch.arange(N_PAD, device=dev) < N).to(torch.int8)
    sparse = full * (torch.rand(N_PAD, generator=g, device=dev) > 0.3).to(torch.int8)
    main_case = None
    lib_ms = _library_ms(q, x)
    for ctype in ("fp32", "fp16", "int8", "int4"):
        for metric in ("L2", "IP", "COSINE"):
            codes, norms, dequant = _make_codes(x, ctype, metric)
            bound = _bound(Q, N_PAD, D, K, fs.pick_tile(N_PAD, K), codes)
            case_lib_ms = lib_ms if ctype == "fp32" else None
            mask = sparse if (ctype, metric) == ("fp32", "IP") else full
            kw = dict(metric=MetricType[metric], topk=K, dequant=dequant,
                      int4_dim=D if ctype == "int4" else None)
            args = (q, codes, norms, mask)
            ts_k, ti_k = fs.flat_scan_stage1(*args, **kw)
            ts_p, ti_p = fs.flat_scan_stage1(*args, plain=True, **kw)
            torch.cuda.synchronize()
            s1_err = float((ts_k - ts_p).abs().max())
            s1_ok = torch.allclose(ts_k, ts_p, rtol=STAGE1_RTOL, atol=STAGE1_ATOL)
            swaps = float((ti_k != ti_p).float().mean())
            ks, ki = fs.flat_scan_topk(*args, **kw)
            ps, pi = fs.flat_scan_topk_plain(*args, **{**kw, "topk": K + 1})
            bad, differ, final_err = _check_final(ks, ki, ps, pi)
            finite = bool(torch.isfinite(ks).all()) and bool((ki >= 0).all())
            k_ms = time_ms(lambda: fs.flat_scan_stage1(*args, **kw))
            p_ms = time_ms(lambda: fs.flat_scan_stage1(*args, plain=True, **kw))
            kf_ms = time_ms(lambda: fs.flat_scan_topk(*args, **kw))
            pf_ms = time_ms(lambda: fs.flat_scan_topk_plain(*args, **kw))
            log(
                f"kernel {ctype:>4} {metric:<6} mask={'30%' if mask is sparse else 'none'}: "
                f"stage1 max|dkey| {s1_err:.3g} id swaps {swaps:.2e}; final rows differing "
                f"{differ} (outside ties {bad}) max|dscore| {final_err:.3g}; "
                f"stage1 {k_ms:.3f} ms vs plain {p_ms:.3f} ms; "
                f"full scan {kf_ms:.3f} ms vs plain {pf_ms:.3f} ms; "
                + _bound_text(bound, k_ms, case_lib_ms)
            )
            if not (s1_ok and swaps <= STAGE1_MAX_ID_SWAPS and bad == 0 and finite):
                raise AssertionError(f"kernel disagrees with plain version: {ctype} {metric}")
            if (ctype, metric) == ("fp32", "L2"):
                main_case = dict(max_abs_err=s1_err, ms=k_ms, plain_ms=p_ms,
                                 bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                                 library_ms=case_lib_ms, roofline=bound["bound_ms"] / k_ms)
            del codes, norms
    return main_case


def _exact_oracle(X: torch.Tensor, queries: torch.Tensor):
    """Exact L2 top-(k+1) on the card: float32 products, no TF32."""
    xn = (X * X).sum(1)
    best_s, best_i = [], []
    for lo in range(0, queries.shape[0], 256):
        qb = queries[lo : lo + 256]
        sims = -((qb * qb).sum(1)[:, None] + xn[None, :] - 2.0 * (qb @ X.T))
        s, i = torch.topk(sims, K + 1, dim=1)
        best_s.append(s)
        best_i.append(i)
    return torch.cat(best_s), torch.cat(best_i)


def _ids(results) -> np.ndarray:
    return np.array([[int(d.id) for d in docs] for docs in results], dtype=np.int64)


def _data():
    """The data of bench.py:309-312 (queries first, then the corpus)."""
    rng = np.random.default_rng(SEED)
    queries = rng.standard_normal((Q, D)).astype(np.float32)
    qset = [np.roll(queries, i, axis=0) for i in range(4)]
    X = rng.standard_normal((N, D), dtype=np.float32)
    return qset, X


def phase_main_path(workdir: Path, qset, X) -> int:
    import zvec_tpu_torch as zt
    from zvec_tpu_torch.ops.flat_scan import flat_scan_topk

    flat_scan_topk.launches = 0
    zt.init()
    schema = zt.CollectionSchema(
        "bench1m",
        vectors=[zt.VectorSchema("vec", zt.DataType.VECTOR_FP32, D, zt.FlatIndexParam(zt.MetricType.L2))],
    )
    path = workdir / "bench1m"
    t0 = time.perf_counter()
    col = zt.create_and_open(str(path), schema)
    for lo in range(0, N, 1024):
        col.insert([zt.Doc(id=str(i), vectors={"vec": X[i]}) for i in range(lo, min(lo + 1024, N))])
    t_insert = time.perf_counter() - t0
    col.optimize()
    col.flush()
    t_build = time.perf_counter() - t0
    log(f"main path: insert {t_insert:.2f} s, insert+optimize+flush {t_build:.2f} s")

    first = col.batch_query("vec", qset[0], topk=K, output_fields=[])  # device upload + first scan
    iters = 8
    times = []
    for _ in range(2):
        t1 = time.perf_counter()
        out = col.batch_query_many("vec", [qset[i % 4] for i in range(iters)], topk=K, output_fields=[])
        times.append((time.perf_counter() - t1) / iters)
    batch_s = min(times)
    launches = flat_scan_topk.launches
    log(f"main path: {batch_s * 1e3:.2f} ms per 1024-query batch, {Q / batch_s:.1f} qps "
        f"(batch_query_many, {iters} blocks, best of 2); kernel launches {launches}")

    seg = next(s for s in col._impl._segments_snapshot() if s.doc_count > 0)
    engine = seg.engine_for("vec")
    if not engine._st.codes.is_cuda:
        raise AssertionError("main path: codes are not resident on CUDA")
    if launches == 0:
        raise AssertionError("main path: the flat-scan kernel was never launched")
    if len(out) != iters or any(len(r) != Q for r in out):
        raise AssertionError("main path: wrong number of results")

    dev = torch.device("cuda")
    os_, oi = _exact_oracle(torch.from_numpy(X).to(dev), torch.from_numpy(qset[0]).to(dev))
    got = _ids(first)
    scores = np.array([[d.score for d in docs] for docs in first], np.float32)
    if got.shape != (Q, K) or not np.isfinite(scores).all():
        raise AssertionError("main path: results are not (1024, 10) finite scores")
    exp = oi.cpu().numpy()
    ps = -os_.cpu().numpy()  # squared L2 distances, ascending
    near_tie = np.abs(ps[:, K - 1] - ps[:, K]) <= TIE_RTOL * np.abs(ps[:, K - 1])
    hit = np.array([len(set(got[r]) & set(exp[r, :K])) for r in range(Q)])
    recall = hit.sum() / (Q * K)
    bad = int(((hit < K) & ~near_tie).sum())
    score_err = float(np.abs(scores - ps[:, :K]).max())
    log(f"main path: recall@{K} {recall:.6f} on {Q} queries ({int((hit < K).sum())} rows short, "
        f"{bad} outside near-ties); max |score - oracle| {score_err:.3g}")
    if bad:
        raise AssertionError("main path: recall below 1.0 outside near-ties")
    col._impl.close()

    reopened = zt.open(str(path))
    again = _ids(reopened.batch_query("vec", qset[0], topk=K, output_fields=[]))
    reopened._impl.close()
    if not (again == got).all():
        raise AssertionError("durability: reopened collection returns other ids")
    log("durability: reopened collection returns identical ids")
    return launches


def phase_kernel_build_shape() -> dict:
    """K1 at the HNSW build's shape (`ops/hnsw.py::knn_build_step`): the
    queries are 2048 code rows, so each finds itself."""
    from zvec_tpu_torch.ops import flat_scan as fs
    from zvec_tpu_torch.typing import MetricType

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn((N_BUILD_PAD, D), generator=g, device=dev)
    x[N:] = 0.0
    mask = (torch.arange(N_BUILD_PAD, device=dev) < N).to(torch.int8)
    q = x[:Q_BUILD].contiguous()
    sq = (x * x).sum(1)
    out = {}
    bound = _bound(Q_BUILD, N_BUILD_PAD, D, K_BUILD, fs.pick_tile(N_BUILD_PAD, K_BUILD), x)
    lib_ms = _library_ms(q, x)
    for metric in ("L2", "COSINE"):
        norms = torch.sqrt(sq) if metric == "COSINE" else sq
        kw = dict(metric=MetricType[metric], topk=K_BUILD)
        args = (q, x, norms, mask)
        ts_k, ti_k = fs.flat_scan_stage1(*args, **kw)
        ts_p, ti_p = fs.flat_scan_stage1(*args, plain=True, **kw)
        torch.cuda.synchronize()
        s1_err = float((ts_k - ts_p).abs().max())
        s1_ok = torch.allclose(ts_k, ts_p, rtol=STAGE1_RTOL, atol=STAGE1_ATOL)
        swaps = float((ti_k != ti_p).float().mean())
        del ts_k, ti_k, ts_p, ti_p
        ks, ki = fs.flat_scan_topk(*args, **kw)
        ps, pi = fs.flat_scan_topk_plain(*args, **kw)
        bad, differ, final_err = _check_final_at_k(ks, ki, ps, pi)
        finite = bool(torch.isfinite(ks).all()) and bool((ki >= 0).all())
        del ks, ki, ps, pi
        k_ms = time_ms(lambda: fs.flat_scan_stage1(*args, **kw))
        p_ms = time_ms(lambda: fs.flat_scan_stage1(*args, plain=True, **kw))
        kf_ms = time_ms(lambda: fs.flat_scan_topk(*args, **kw))
        pf_ms = time_ms(lambda: fs.flat_scan_topk_plain(*args, **kw))
        log(
            f"kernel build shape fp32 {metric:<6} N={N_BUILD_PAD} Q={Q_BUILD} k={K_BUILD}: "
            f"stage1 max|dkey| {s1_err:.3g} id swaps {swaps:.2e}; final rows differing "
            f"{differ} (outside ties {bad}) max|dscore| {final_err:.3g}; "
            f"stage1 {k_ms:.3f} ms vs plain {p_ms:.3f} ms; "
            f"full scan {kf_ms:.3f} ms vs plain {pf_ms:.3f} ms; " + _bound_text(bound, k_ms, lib_ms)
        )
        if not (s1_ok and swaps <= STAGE1_MAX_ID_SWAPS and bad == 0 and finite):
            raise AssertionError(f"kernel disagrees with plain version at the build shape: {metric}")
        out[metric] = dict(max_abs_err=s1_err, ms=k_ms, plain_ms=p_ms,
                           full_ms=kf_ms, full_plain_ms=pf_ms, bound_ms=bound["bound_ms"],
                           bound_by=bound["bound_by"], library_ms=lib_ms,
                           roofline=bound["bound_ms"] / k_ms)
    del x, q, sq, mask
    return out


def _beam_check(engine) -> None:
    """The engine's beam on its CUDA tensors against the same beam on CPU
    copies of them: ids equal, scores within BEAM_RTOL, except rows whose
    differing ids all score within BEAM_RTOL of the row's k-th score."""
    from zvec_tpu_torch.ops.hnsw import hnsw_search

    rng = np.random.default_rng(SEED + 2)
    qs = rng.standard_normal((BEAM_CHECK_Q, D)).astype(np.float32)
    g = engine._dev
    budget = min(max(10_000, int(0.1 * engine._n)), engine._n)
    kw = dict(metric=engine._search_metric, ef=BEAM_CHECK_EF, topk=K,
              max_steps=BEAM_CHECK_EF + 64, num_levels=g["num_levels"], frontier=4,
              visited_bits=0, done_frac=1.0)

    def run(dev):
        t = lambda x: x.to(dev)  # noqa: E731
        return hnsw_search(
            torch.from_numpy(qs).to(dev), t(engine._codes), t(engine._norms), t(g["l0"]),
            [t(x) for x in g["upper_ids"]], [t(x) for x in g["upper_nbrs"]],
            [t(x) for x in g["upper_down"]], g["entry_rows"], None, budget, None, **kw,
        )

    cs, ci = (x.cpu() for x in run(torch.device("cuda")))
    t0 = time.perf_counter()
    ps, pi = run(torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    bad, differ, err = _check_final_at_k(cs, ci, ps, pi, rtol=BEAM_RTOL)
    scale = max(float(ps.abs().max()), 1.0)
    log(f"hnsw: CUDA beam vs CPU beam on {BEAM_CHECK_Q} queries at ef={BEAM_CHECK_EF}: "
        f"{differ} rows differ ({bad} outside near-ties), max |dscore| {err:.3g} "
        f"on equal rows; CPU beam {cpu_s:.2f} s")
    if bad or err > BEAM_RTOL * scale:
        raise AssertionError("hnsw: the CUDA beam disagrees with the CPU beam")


def _profiled(label: str, fn) -> None:
    """Run fn() once warm, then once under torch.profiler: print the wall
    time, the device busy share and the top device ops (self device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []  # device-side events only (kernels, copies): host ops repeat their kernels' time
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0.0)
        if dt > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            rows.append((dt / 1e3, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    log(f"profile {label}: wall {wall * 1e3:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / (wall * 1e3):.1f}%), idle {100 - 100 * busy / (wall * 1e3):.1f}%")
    for ms, count, key in rows[:8]:
        log(f"  device {ms:9.3f} ms  x{count:<6d} {key[:90]}")


def _profile_build_batch(engine, X) -> None:
    """One forward batch (`knn_build_step`: K1 + stage two + prune) and one
    merge batch (`merge_prune_step`, 2 x max_out candidates) of the 1M
    build, profiled on the build's padded codes."""
    from zvec_tpu_torch.ops.hnsw import knn_build_step, merge_prune_step

    dev = torch.device("cuda")
    codes = torch.zeros((N_BUILD_PAD, D), device=dev)
    codes[:N] = torch.from_numpy(X).to(dev)
    norms2 = (codes * codes).sum(1)
    mask = (torch.arange(N_BUILD_PAD, device=dev) < N).to(torch.int8)
    rows = torch.arange(Q_BUILD, device=dev)
    m0 = engine.m0_out()
    adj = torch.full((N, m0), -1, dtype=torch.int32, device=dev)
    kw = dict(metric=engine._search_metric, max_out=m0)
    _profiled(f"hnsw build forward batch (B={Q_BUILD}, knn_k={K_BUILD - 1})",
              lambda: knn_build_step(rows, codes, norms2, mask, adj, knn_k=K_BUILD - 1, **kw))
    l0 = engine._dev["l0"]
    cand = torch.cat([l0[rows], l0[rows + Q_BUILD]], dim=1)
    _profiled(f"hnsw build merge batch (B={Q_BUILD}, C={2 * m0})",
              lambda: merge_prune_step(rows, cand, codes, norms2, adj, **kw))


def phase_hnsw(workdir: Path, qset, X) -> int:
    """The HNSW path: build on the card, query at three ef, check, reopen."""
    import zvec_tpu_torch as zt
    from zvec_tpu_torch.ops.flat_scan import flat_scan_topk
    from zvec_tpu_torch.ops.hnsw import hnsw_search

    # HnswIndexParam's own default metric is IP; the SIFT1M shape and the
    # reference curve are L2, so only the metric is set (m, efc default)
    schema = zt.CollectionSchema(
        "hnsw1m",
        vectors=[zt.VectorSchema("vec", zt.DataType.VECTOR_FP32, D, zt.HnswIndexParam(zt.MetricType.L2))],
    )
    path = workdir / "hnsw1m"
    flat_scan_topk.launches = 0
    t0 = time.perf_counter()
    col = zt.create_and_open(str(path), schema)
    for lo in range(0, N, 1024):
        col.insert([zt.Doc(id=str(i), vectors={"vec": X[i]}) for i in range(lo, min(lo + 1024, N))])
    t_insert = time.perf_counter() - t0
    col.optimize()
    t_build = time.perf_counter() - t0 - t_insert
    col.flush()
    launches = flat_scan_topk.launches
    seg = next(s for s in col._impl._segments_snapshot() if s.doc_count > 0)
    engine = seg.engine_for("vec")
    bt = engine.build_times
    log(f"hnsw: insert {t_insert:.2f} s, optimize {t_build:.2f} s, of which the engine build "
        f"(data fetch + graph + upload) {engine.stats.last_build_secs:.2f} s: forward kNN "
        f"{bt['forward_knn']:.2f} s, reverse candidates {bt['reverse']:.2f} s, merge "
        f"{bt['merge']:.2f} s, upper levels {bt['upper_levels']:.2f} s; graph file write "
        f"{bt['dump_aux']:.2f} s; levels {engine._dev['num_levels']} above L0; K1 launches "
        f"in the build {launches}")
    if launches == 0:
        raise AssertionError("hnsw: the build never launched the flat-scan kernel")
    if not (engine._codes.is_cuda and engine._dev["l0"].is_cuda):
        raise AssertionError("hnsw: codes or the L0 adjacency are not on CUDA")

    dev = torch.device("cuda")
    _, oi = _exact_oracle(torch.from_numpy(X).to(dev), torch.from_numpy(qset[0]).to(dev))
    exp = oi[:, :K].cpu().numpy()
    recalls, first_ids = {}, None
    for ef in EFS:
        param = zt.HnswQueryParam(ef=ef, done_frac=1.0)
        first = col.batch_query("vec", qset[0], topk=K, output_fields=[], param=param)
        times = []
        for _ in range(2):
            t1 = time.perf_counter()
            out = col.batch_query_many("vec", qset, topk=K, output_fields=[], param=param)
            times.append((time.perf_counter() - t1) / len(qset))
        batch_s = min(times)
        steps = hnsw_search.last_steps
        got = _ids(first)
        scores = np.array([[d.score for d in docs] for docs in first], np.float32)
        if got.shape != (Q, K) or not np.isfinite(scores).all() or len(out) != len(qset):
            raise AssertionError("hnsw: results are not (1024, 10) finite scores")
        recalls[ef] = float(np.mean([len(set(got[r]) & set(exp[r])) for r in range(Q)]) / K)
        if ef == EFS[0]:
            first_ids = got
        log(f"hnsw: ef={ef}: {batch_s * 1e3:.2f} ms per 1024-query batch, {Q / batch_s:.1f} qps "
            f"(batch_query_many, {len(qset)} blocks, best of 2; {steps} beam steps in the last "
            f"batch); "
            f"recall@{K} {recalls[ef]:.4f} "
            f"(zvec C++ reference curve {REF_CURVE[ef]}, built with knn_k=255; knn_k here is 127)")
    if recalls[500] < MIN_RECALL_EF500:
        raise AssertionError(f"hnsw: recall@10 at ef=500 is {recalls[500]:.4f} < {MIN_RECALL_EF500}")
    param = zt.HnswQueryParam(ef=256, done_frac=1.0)
    _profiled(f"hnsw beam batch ef=256 ({Q} queries)", lambda: engine.search(qset[0], K, None, param))
    _profile_build_batch(engine, X)
    _beam_check(engine)
    col._impl.close()
    del col, seg, engine
    gc.collect()
    torch.cuda.empty_cache()

    before = flat_scan_topk.launches
    reopened = zt.open(str(path))
    again = _ids(reopened.batch_query("vec", qset[0], topk=K, output_fields=[],
                                      param=zt.HnswQueryParam(ef=EFS[0], done_frac=1.0)))
    eng2 = next(s for s in reopened._impl._segments_snapshot() if s.doc_count > 0).engine_for("vec")
    loaded = eng2._loaded_aux is not None
    reopened._impl.close()
    if flat_scan_topk.launches != before or not loaded:
        raise AssertionError("hnsw: the reopened collection rebuilt its graph")
    if not (again == first_ids).all():
        raise AssertionError("hnsw: reopened collection returns other ids")
    log("hnsw: reopened collection loads the graph from disk (no kernel launch) and returns identical ids")
    return launches


def _ivf_data():
    """bench_suite.py's config #4: make_data("clustered", ...) for vectors and
    queries, then tags and prices from default_rng(SEED + 1) with its SEED = 7."""
    from benchmarks.h2h import make_data

    rng = np.random.default_rng(7 + 1)
    X, queries = make_data("clustered", IVF_N, IVF_D, nq=Q)
    tags = rng.integers(0, 10, IVF_N)  # 'tag = tN' selects ~10%
    price = rng.random(IVF_N)
    return X, queries, tags, price


def _recall(got: np.ndarray, exp: np.ndarray) -> float:
    return float(np.mean([len(set(got[r]) & set(exp[r])) for r in range(len(got))]) / exp.shape[1])


def _probe_check(engine, queries: np.ndarray, dev: torch.device) -> None:
    """The engine's probe on its CUDA tensors against the same probe on CPU
    copies of them: ids equal, scores within PROBE_RTOL, except rows whose
    differing ids all score within PROBE_RTOL of the row's k-th score."""
    from zvec_tpu_torch.core.ivf import ivf_probe_core

    qs = queries[:PROBE_CHECK_Q]
    nprobe = PROBE_CHECK_NPROBE + engine._extra_probes

    def run(dev):
        t = lambda x: x.to(dev)  # noqa: E731
        return ivf_probe_core(
            torch.from_numpy(qs).to(dev), t(engine._centroids), t(engine._lists_codes),
            t(engine._lists_norms), t(engine._lists_ids), None, engine._dequant,
            metric=engine.metric, nprobe=nprobe, topk=2 * K, int4_packed=engine._int4_packed,
        )

    cs, ci = (x.cpu() for x in run(dev))
    t0 = time.perf_counter()
    ps, pi = run(torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    bad, differ, err = _check_final_at_k(cs, ci.long(), ps, pi.long(), rtol=PROBE_RTOL)
    scale = max(float(ps.abs().max()), 1.0)
    log(f"ivf: CUDA probe vs CPU probe on {PROBE_CHECK_Q} queries at nprobe={PROBE_CHECK_NPROBE} "
        f"(+{engine._extra_probes} for split lists), top-{2 * K}: {differ} rows differ "
        f"({bad} outside near-ties), max |dscore| {err:.3g} on equal rows; CPU probe {cpu_s:.2f} s")
    if bad or err > PROBE_RTOL * scale:
        raise AssertionError("ivf: the CUDA probe disagrees with the CPU probe")


def phase_ivf(workdir: Path, dev: torch.device) -> int:
    """The IVF path: train on the card, sweep nprobe, filter, check, reopen."""
    import zvec_tpu_torch as zt
    from zvec_tpu_torch.ops.flat_scan import flat_scan_topk
    from zvec_tpu_torch.ops.kmeans import lloyd

    X, queries, tags, price = _ivf_data()
    schema = zt.CollectionSchema(
        "deep_like",
        fields=[
            zt.FieldSchema("tag", zt.DataType.STRING, index_param=zt.InvertIndexParam()),
            zt.FieldSchema("price", zt.DataType.DOUBLE),
        ],
        vectors=[zt.VectorSchema("vec", zt.DataType.VECTOR_FP32, IVF_D,
                                 zt.IVFIndexParam(zt.MetricType.L2, use_soar=True))],
    )
    path = workdir / "ivf1m"
    flat_scan_topk.launches = 0
    t0 = time.perf_counter()
    col = zt.create_and_open(str(path), schema)
    for lo in range(0, IVF_N, 1024):
        col.insert([zt.Doc(id=str(i), vectors={"vec": X[i]},
                           fields={"tag": f"t{tags[i]}", "price": float(price[i])})
                    for i in range(lo, min(lo + 1024, IVF_N))])
    t_insert = time.perf_counter() - t0
    col.optimize()
    t_build = time.perf_counter() - t0 - t_insert
    col.flush()
    seg = next(s for s in col._impl._segments_snapshot() if s.doc_count > 0)
    engine = seg.engine_for("vec")
    bt = engine.build_times
    tensors = (engine._centroids, engine._lists_codes, engine._lists_norms, engine._lists_ids)
    list_bytes = sum(t.numel() * t.element_size() for t in tensors)
    secondaries = len(engine._trained["assign_rows"]) - IVF_N
    log(f"ivf: insert {t_insert:.2f} s, optimize {t_build:.2f} s, of which the engine build "
        f"(data fetch + training + lists + upload) {engine.stats.last_build_secs:.2f} s: k-means "
        f"(stratified + final Lloyd) {bt['kmeans']:.2f} s, top-2 assign {bt['assign_top2']:.2f} s, "
        f"spill {bt['spill']:.2f} s, list assembly + upload {bt['assemble']:.2f} s; aux write "
        f"{bt['dump_aux']:.2f} s")
    log(f"ivf: n_list {engine._trained['centroids'].shape[0]}, virtual lists "
        f"{engine._centroids.shape[0]}, bucket length {engine._lists_ids.shape[1]}, extra probes "
        f"{engine._extra_probes}, SOAR secondaries {secondaries} ({secondaries / IVF_N:.3f} per row), "
        f"lists on the card {list_bytes / 1e9:.3f} GB")
    if not all(t.device.type == dev.type for t in tensors):
        raise AssertionError(f"ivf: the centroids or the lists are not on {dev.type}")

    xd = torch.from_numpy(X).to(dev)
    _, oi = _exact_oracle(xd, torch.from_numpy(queries).to(dev))
    exp = oi[:, :K].cpu().numpy()
    ids16 = None
    for nprobe in NPROBES:
        param = zt.IVFQueryParam(nprobe=nprobe)
        first = col.batch_query("vec", queries, topk=K, output_fields=[], param=param)
        col.batch_query("vec", queries, topk=K, output_fields=[], param=param)
        times = []
        for _ in range(2):
            t1 = time.perf_counter()
            out = col.batch_query("vec", queries, topk=K, output_fields=[], param=param)
            times.append(time.perf_counter() - t1)
        batch_s = min(times)
        got = _ids(first)
        scores = np.array([[d.score for d in docs] for docs in first], np.float32)
        if got.shape != (Q, K) or not np.isfinite(scores).all() or len(out) != Q:
            raise AssertionError("ivf: results are not (1024, 10) finite scores")
        recall = _recall(got, exp)
        if nprobe == PROBE_CHECK_NPROBE:
            ids16 = got
        log(f"ivf: nprobe={nprobe} (+{engine._extra_probes}): {batch_s * 1e3:.2f} ms per 1024-query "
            f"batch, {Q / batch_s:.1f} qps (batch_query, warm twice, best of 2); recall@{K} "
            f"{recall:.4f} on {Q} queries (floor {IVF_FLOORS[nprobe]})")
        if recall < IVF_FLOORS[nprobe]:
            raise AssertionError(f"ivf: recall@10 at nprobe={nprobe} is {recall:.4f} < {IVF_FLOORS[nprobe]}")

    sel = np.flatnonzero((tags == 3) & (price < 0.5))
    fs, fi = _exact_oracle(xd[torch.from_numpy(sel).to(dev)], torch.from_numpy(queries).to(dev))
    fexp = sel[fi[:, :K].cpu().numpy()]
    fd = -fs.cpu().numpy()  # squared L2 distances, ascending
    near_tie = np.abs(fd[:, K - 1] - fd[:, K]) <= TIE_RTOL * np.abs(fd[:, K - 1])
    col._impl.debug_profiling = True
    fdocs = col.batch_query("vec", queries, topk=K, filter=IVF_FILTER, output_fields=[])
    profile_json = col._impl.last_profile or ""
    col._impl.debug_profiling = False
    times = []
    for _ in range(2):
        t1 = time.perf_counter()
        col.batch_query("vec", queries, topk=K, filter=IVF_FILTER, output_fields=[])
        times.append(time.perf_counter() - t1)
    fpath = ("brute force by keys: masked exact scan over the lists (IvfEngine._linear_scan)"
             if "bf_by_keys" in profile_json else "probe + filtered safety net")
    fgot = _ids(fdocs)
    frecall = _recall(fgot, fexp)
    short = np.array([len(set(fgot[r]) & set(fexp[r])) < K for r in range(Q)])
    log(f"ivf: filter {IVF_FILTER!r} ({len(sel)} rows, {len(sel) / IVF_N:.4f} of the corpus): "
        f"{min(times) * 1e3:.2f} ms per 1024-query batch; recall@{K} {frecall:.6f} against the "
        f"filtered oracle ({int(short.sum())} rows short, {int((short & ~near_tie).sum())} outside "
        f"near-ties); path: {fpath}")
    if (short & ~near_tie).any():
        raise AssertionError("ivf: filtered recall@10 below 1.0 outside near-ties")
    launches = flat_scan_topk.launches
    del xd
    torch.cuda.empty_cache()

    param = zt.IVFQueryParam(nprobe=PROBE_CHECK_NPROBE)
    _profiled(f"ivf probe batch nprobe={PROBE_CHECK_NPROBE} ({Q} queries)",
              lambda: engine.search(queries, K, None, param))
    _probe_check(engine, queries, dev)
    col._impl.close()
    del col, seg, engine
    gc.collect()
    torch.cuda.empty_cache()

    calls = lloyd.calls
    reopened = zt.open(str(path))
    again = _ids(reopened.batch_query("vec", queries, topk=K, output_fields=[], param=param))
    eng2 = next(s for s in reopened._impl._segments_snapshot() if s.doc_count > 0).engine_for("vec")
    loaded = eng2._loaded_aux is not None and "kmeans" not in eng2.build_times
    reopened._impl.close()
    if lloyd.calls != calls or not loaded:
        raise AssertionError("ivf: the reopened collection ran k-means again")
    if not (again == ids16).all():
        raise AssertionError("ivf: reopened collection returns other ids")
    log(f"ivf: reopened collection loads the trained lists (lloyd calls {lloyd.calls - calls}) "
        f"and returns identical ids at nprobe={PROBE_CHECK_NPROBE}")
    return launches


def main() -> None:
    smi = phase_toolchain()
    phase_build()
    case = phase_kernel_vs_plain()
    torch.cuda.empty_cache()
    build_case = phase_kernel_build_shape()
    torch.cuda.empty_cache()
    qset, X = _data()
    workdir = REPO / "zvec_tpu_torch" / "_build" / "smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        flat_launches = phase_main_path(workdir, qset, X)
        gc.collect()
        torch.cuda.empty_cache()
        hnsw_launches = phase_hnsw(workdir, qset, X)
        del qset, X
        gc.collect()
        torch.cuda.empty_cache()
        ivf_launches = phase_ivf(workdir, torch.device("cuda"))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(smi)
    print(json.dumps({"kernels": [{
        "name": "flat_scan_topk (stage one: fused scan + group-max top-k)",
        "route": "cuda",
        "source": "zvec_tpu_torch/csrc/flat_scan.cu",
        "replaces": "zvec_tpu/ops/flat_pallas.py:92",
        "launches": flat_launches + hnsw_launches + ivf_launches,
        "launches_by_path": {"flat_search": flat_launches, "hnsw_build": hnsw_launches,
                             "ivf": ivf_launches},
        "max_abs_err": case["max_abs_err"],
        "ms": case["ms"],
        "plain_ms": case["plain_ms"],
        "bound_ms": case["bound_ms"],
        "bound_by": case["bound_by"],
        "library_ms": case["library_ms"],
        "roofline": case["roofline"],
        "hnsw_build_shape": build_case,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
