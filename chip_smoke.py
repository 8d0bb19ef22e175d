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

The line before the last is a JSON object with the kernel's launches, error
and times; the last line is {"ok": true, "device": {...}}. Needs one CUDA
card; exits non-zero without one.
"""

from __future__ import annotations

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
    for ctype in ("fp32", "fp16", "int8", "int4"):
        for metric in ("L2", "IP", "COSINE"):
            codes, norms, dequant = _make_codes(x, ctype, metric)
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
                f"full scan {kf_ms:.3f} ms vs plain {pf_ms:.3f} ms"
            )
            if not (s1_ok and swaps <= STAGE1_MAX_ID_SWAPS and bad == 0 and finite):
                raise AssertionError(f"kernel disagrees with plain version: {ctype} {metric}")
            if (ctype, metric) == ("fp32", "L2"):
                main_case = dict(max_abs_err=s1_err, ms=k_ms, plain_ms=p_ms)
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


def phase_main_path(workdir: Path) -> int:
    import zvec_tpu_torch as zt
    from zvec_tpu_torch.ops.flat_scan import flat_scan_topk

    # the data of bench.py:309-312 (queries first, then the corpus)
    rng = np.random.default_rng(SEED)
    queries = rng.standard_normal((Q, D)).astype(np.float32)
    qset = [np.roll(queries, i, axis=0) for i in range(4)]
    X = rng.standard_normal((N, D), dtype=np.float32)

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


def main() -> None:
    smi = phase_toolchain()
    phase_build()
    case = phase_kernel_vs_plain()
    torch.cuda.empty_cache()
    workdir = REPO / "zvec_tpu_torch" / "_build" / "smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        launches = phase_main_path(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(smi)
    print(json.dumps({"kernels": [{
        "name": "flat_scan_topk (stage one: fused scan + group-max top-k)",
        "route": "cuda",
        "source": "zvec_tpu_torch/csrc/flat_scan.cu",
        "replaces": "zvec_tpu/ops/flat_pallas.py:92",
        "launches": launches,
        "max_abs_err": case["max_abs_err"],
        "ms": case["ms"],
        "plain_ms": case["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
