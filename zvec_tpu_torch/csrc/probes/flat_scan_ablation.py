"""Where the flat-scan kernel's time goes: ablations of `csrc/flat_scan.cu`.

Each ablation is a copy of the kernel source with one part taken out (its
outputs are then wrong; only its time counts). All are built with nvcc in
parallel, for the fp32 L2 instances only (split and one pass), and timed
with CUDA events at four shapes of `chip_smoke.py` (FLAT: 1,007,616 x 128,
Q = 1024, k = 10; HNSW build: 1,000,448 x 128, Q = 2048, k = 128; the MIPS
build's padded scan codes: 1,000,448 x 204, the same Q and k, queries
streamed; HAMMING: 1,007,616 x 256, Q = 1024, k = 10, in one pass), in
interleaved rounds so that clock drift falls on every variant alike. What
an ablation saves is an upper bound on what speeding up that part could
give. `one_pass` is no ablation: the unchanged kernel's one-TF32-product
instance (the one +-1 codes take), timed on the same gaussian rows of a
split shape, whose keys it then gets wrong.

    python3 zvec_tpu_torch/csrc/probes/flat_scan_ablation.py

Needs a CUDA card and nvcc (sm_90a). Builds into zvec_tpu_torch/_build/ablation/.
"""

import ctypes
import shutil
import statistics
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[2]
SRC = (PKG / "csrc" / "flat_scan.cu").read_text()
OUT = PKG / "_build" / "ablation"

_NO_COPY = [("    if (it + lead < n_iter) issue(it + lead);\n", "")]
_NO_FRAG = [("        load_code_frag<CT>(st, arow + 8 * h, kb, tig, v);\n",
             "        v[0] = v[1] = v[2] = v[3] = __int_as_float(it + kb + h);\n")]
_NO_EXTRACT = [
    ("  // the group-max into shared memory, one 128-lane row per query;",
     "  if (n_qb < 0) {  //"),
    ("  }\n}\n\nstruct Plan",
     "  }\n  }\n  float sg = 0.f;\n  for (int i = 0; i < 64; ++i) sg += gmax[i];\n"
     "  if (sg == 1.2345f) out_s[tid] = sg;\n}\n\nstruct Plan"),
]
ABLATIONS = {
    "kernel": [],
    "no_sort": [("    group_sort128<kEPT>(w, tq);\n", "")],  # the bitonic sort of each query's 128 lanes
    "no_extract": _NO_EXTRACT,  # group-max to shared memory, sort, output stores
    "no_copy": _NO_COPY,  # the cp.async refills of the code ring (stale codes)
    # the streamed query tiles' copies (stale tiles; D > 128 split, > 256 one pass)
    "no_qcopy": [("    if (!resident) load_queries(c, query_tiles(it, c), tid, kThreads);\n", "")],
    "mma_only": _NO_COPY + _NO_FRAG + _NO_EXTRACT,  # products, barriers and the key fold left
}
_OTHER_CASES = [f"    ZVEC_FLAT_SCAN_CASE({c}, {m})\n" for c in ("kF32", "kF16", "kI8", "kI4")
                for m in ("kL2", "kIP", "kCosine") if (c, m) != ("kF32", "kL2")]
# rows, D, queries, k, TILE_N, one pass
SHAPES = {"flat": (1007616, 128, 1024, 10, 8192, False), "build": (1000448, 128, 2048, 128, 1024, False),
          "mips": (1000448, 204, 2048, 128, 1024, False), "hamming": (1007616, 256, 1024, 10, 8192, True)}


def _patch(src, pairs):
    for a, b in pairs:
        if a not in src:
            raise SystemExit(f"ablation target not found in flat_scan.cu: {a[:60]!r}")
        src = src.replace(a, b)
    return src


def build():
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, pairs in ABLATIONS.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(_patch(SRC, pairs + [(c, "") for c in _OTHER_CASES]))
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-o", str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.zvec_flat_scan.argtypes = [vp, vp, vp, vp, i, i, vp, vp, vp, vp, i, i, i,
                                       ctypes.c_longlong, i, i, ctypes.c_float, ctypes.c_float, vp,
                                       i, i, vp]
        lib.zvec_flat_scan_scratch_floats.argtypes = [i, i, i, i]
        lib.zvec_flat_scan_scratch_floats.restype = ctypes.c_longlong
        libs[name] = lib
    libs["one_pass"] = libs["kernel"]
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("flat_scan_ablation: needs a CUDA card")
    libs = build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, (n, d, nq, k, tile, one_pass) in SHAPES.items():
        x = torch.randn((n, d), generator=g, device=dev)
        q = torch.randn((nq, d), generator=g, device=dev)
        knorm, qside, qsum = (x * x).sum(1), (q * q).sum(1), q.sum(1)
        mask = torch.ones(n, dtype=torch.int8, device=dev)
        out_s = torch.empty((n // tile, k, nq), device=dev)
        out_i = torch.empty((n // tile, k, nq), dtype=torch.int32, device=dev)
        qsplit = torch.empty(libs["kernel"].zvec_flat_scan_scratch_floats(0, nq, d, d), device=dev)

        def call(name):
            rc = libs[name].zvec_flat_scan(
                q.data_ptr(), qside.data_ptr(), qsum.data_ptr(), x.data_ptr(), 0, 0,
                knorm.data_ptr(), mask.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
                nq, d, d, n, tile, k, 1.0, 0.0, qsplit.data_ptr(), 16, int(one_pass or name == "one_pass"),
                stream)
            if rc != 0:
                raise SystemExit(f"launch failed: cudaError {rc}")

        names = [name for name in libs if not (one_pass and name == "one_pass")]
        for name in names:
            call(name)
        torch.cuda.synchronize()
        times = {name: [] for name in names}
        for rnd in range(6):
            for name in names if rnd % 2 == 0 else names[::-1]:
                for _ in range(2):
                    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    a.record()
                    call(name)
                    b.record()
                    b.synchronize()
                    times[name].append(a.elapsed_time(b))
        base = statistics.median(times["kernel"])
        for name in names:
            t = sorted(times[name])
            med = statistics.median(t)
            print(f"{shape:7s} {name:10s} {med:.3f} ms (quartiles {t[len(t) // 4]:.3f} / "
                  f"{t[3 * len(t) // 4]:.3f}); saves {base - med:.3f} ms", flush=True)
        del x, q, out_s, out_i
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
