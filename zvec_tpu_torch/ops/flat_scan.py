"""Fused flat scan: distance tile + mask + group-max top-k, then exact rescore.

Port of `zvec_tpu/ops/flat_pallas.py` (the Pallas kernel `_kernel` behind
`flat_scan_topk`). Stage one is the hand-written CUDA kernel
`csrc/flat_scan.cu` on the card and `_stage1_plain` (plain PyTorch, the same
function) on the CPU: for each tile of TILE_N code rows it keeps, per query,
the top-k of the (Q, 128) group-max of a rank-equivalent key. Stage two is
plain PyTorch, as it was plain XLA in JAX: merge the winner groups globally,
expand them to topk*GROUP candidate rows, gather those rows and rescore them
exactly in float32 under the real metric, take the final top-k.

Exactness (flat_pallas.py:27-32): every element of the true top-k is the
witness of its own group's max, so the k groups with the largest maxima cover
the answer; the rescore then gives exact float32 scores.

What bounds the kernel on an H100: at 1M x 128 fp32 codes and Q = 1024 the
scan is 0.26 TFLOP against 0.5 GB of codes, so it is bound by arithmetic, not
by device memory. The kernel runs the products on the tensor cores in split
TF32 (three TF32 products per fp32 pair, two for fp16 / int8 / int4 codes),
which keeps the keys at fp32 accuracy; see the note at the top of
`csrc/flat_scan.cu` for the error argument and the design. With
`exact_tf32=True` (fp32 +-1 codes under L2, the scan of a HAMMING or BINARY
field) one TF32 product gives the same keys exactly, and the kernel runs
that one. The code rows reach the kernel's ring by asynchronous copies of
the widest size their stride and address allow (`copy_bytes`).

The kernel is built at first use from `csrc/*.cu` with nvcc into
`_build/` (a plain C interface loaded with ctypes), keyed by a hash of the
sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..typing.enum import MetricType
from .distance import unpack_nibbles
from .runtime import NEG_INF, topk_desc

__all__ = [
    "flat_scan_topk",
    "flat_scan_topk_plain",
    "flat_scan_stage1",
    "copy_bytes",
    "pick_tile",
    "build_kernels",
]

_LANES = 128  # group-max width
_MAX_CAND = 1024  # cap on topk * GROUP rescore candidates per query
_PLAIN_CHUNK = 1 << 26  # (Q, rows) key elements the plain stage one holds at once

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_CODE_TYPES = {torch.float32: 0, torch.float16: 1, torch.int8: 2}
_METRICS = {MetricType.L2: 0, MetricType.IP: 1, MetricType.COSINE: 2}

_lib = None
_lib_lock = threading.Lock()


def pick_tile(n: int, topk: int) -> int:
    """Largest tile of {8192..1024} rows that divides n and keeps the rescore
    candidates topk*GROUP within 1024 (the rule of flat_pallas.py:71-81
    without its TPU VMEM budget)."""
    for t in (8192, 4096, 2048, 1024):
        if n % t == 0 and (t // _LANES) * topk <= _MAX_CAND:
            return t
    raise ValueError(f"N={n} must be a multiple of 1024 (topk={topk})")


def copy_bytes(row_bytes: int, data_ptr: int) -> int:
    """Bytes a cp.async of the kernel's code ring moves: 16, 8 or 4, the
    widest that divides both the row stride and the codes' address; 1 (byte
    loads) where the stride is not a multiple of 4 bytes."""
    for width in (16, 8, 4):
        if row_bytes % width == 0 and data_ptr % width == 0:
            return width
    return 1


def build_kernels() -> tuple[Path, float]:
    """Compile `csrc/*.cu` for sm_90a unless a library built from the same
    sources exists. Returns (library path, seconds spent compiling)."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)).hexdigest()[:16]
    so = _BUILD / f"libzvec_kernels_{digest}.so"
    if so.exists():
        return so, 0.0
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    _BUILD.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(tmp), *map(str, sources),
    ]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
    so.with_suffix(".log").write_text(res.stdout + res.stderr)  # ptxas report
    os.replace(tmp, so)
    return so, secs


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            so, _ = build_kernels()
            lib = ctypes.CDLL(str(so))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.zvec_flat_scan.argtypes = [
                p, p, p, p, i, i, p, p, p, p,  # q qside qsum codes ctype metric knorm mask out_s out_i
                i, i, i, ctypes.c_longlong, i, i,  # nq dk ld n tile_n topk
                ctypes.c_float, ctypes.c_float, p, i, i, p,  # scale bias qsplit copy exact stream
            ]
            lib.zvec_flat_scan.restype = ctypes.c_int
            lib.zvec_flat_scan_scratch_floats.argtypes = [i, i, i, i]  # ctype nq dk ld
            lib.zvec_flat_scan_scratch_floats.restype = ctypes.c_longlong
            _lib = lib
        return _lib


def _stage1_kernel(q_kern, qside, qsum, codes, knorm, mask, *, metric, topk,
                   tile_n, scale, bias, int4, exact_tf32=False):
    """Launch `csrc/flat_scan.cu` on CUDA tensors; raises on anything the
    kernel does not take or on a failed launch."""
    dev = codes.device
    tensors = (q_kern, qside, qsum, codes, knorm, mask)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("flat scan kernel: every input must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flat scan kernel: inputs must be contiguous")
    if codes.dtype not in _CODE_TYPES or (int4 and codes.dtype != torch.int8):
        raise ValueError(f"flat scan kernel: unsupported code dtype {codes.dtype}")
    if (q_kern.dtype, qside.dtype, qsum.dtype, knorm.dtype, mask.dtype) != (
        torch.float32, torch.float32, torch.float32, torch.float32, torch.int8
    ):
        raise ValueError("flat scan kernel: q/qside/qsum/knorm f32 and mask int8")
    n, ld = codes.shape
    nq, dk = q_kern.shape
    if dk != (2 * ld if int4 else ld) or knorm.shape != (n,) or mask.shape != (n,):
        raise ValueError("flat scan kernel: shapes disagree")
    n_tiles = n // tile_n
    out_s = torch.empty((n_tiles, topk, nq), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_tiles, topk, nq), dtype=torch.int32, device=dev)
    lib = _library()
    ctype = 3 if int4 else _CODE_TYPES[codes.dtype]
    copy = copy_bytes(ld * codes.element_size(), codes.data_ptr())
    # the kernel's split-TF32, zero-padded query halves
    qsplit = torch.empty(lib.zvec_flat_scan_scratch_floats(ctype, nq, dk, ld),
                         dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.zvec_flat_scan(
            q_kern.data_ptr(), qside.data_ptr(), qsum.data_ptr(), codes.data_ptr(),
            ctype, _METRICS[metric],
            knorm.data_ptr(), mask.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            nq, dk, ld, n, tile_n, topk, scale, bias, qsplit.data_ptr(), copy,
            int(exact_tf32), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flat scan kernel launch failed: cudaError {rc} "
                           f"(copy {copy} bytes, exact_tf32 {exact_tf32})")
    flat_scan_topk.launches += 1
    return out_s, out_i


def _codes_f32(codes: torch.Tensor, int4: bool) -> torch.Tensor:
    """Code rows as the kernel's float contraction axis ([lo | hi] for int4)."""
    if int4:
        lo, hi = unpack_nibbles(codes)
        return torch.cat([lo, hi], dim=1).float()
    return codes.float()


def _stage1_plain(q_kern, qside, qsum, codes, knorm, mask, *, metric, topk,
                  tile_n, scale, bias, int4, exact_tf32=False):
    """Stage one in plain PyTorch: the same (n_tiles, topk, Q) keys and group
    ids as the kernel, from dense (Q, rows) keys in chunks of whole tiles.
    fp32 products whatever `exact_tf32` says: the yardstick of both passes."""
    n = codes.shape[0]
    nq = q_kern.shape[0]
    n_tiles, group = n // tile_n, tile_n // _LANES
    out_s = torch.empty((n_tiles, topk, nq), dtype=torch.float32, device=codes.device)
    out_i = torch.empty((n_tiles, topk, nq), dtype=torch.int32, device=codes.device)
    step = max(1, _PLAIN_CHUNK // (nq * tile_n))
    for t0 in range(0, n_tiles, step):
        t1 = min(t0 + step, n_tiles)
        rows = slice(t0 * tile_n, t1 * tile_n)
        dots = q_kern @ _codes_f32(codes[rows], int4).T  # (Q, rows)
        nrm = knorm[rows][None, :]
        if metric == MetricType.IP:
            key = dots
        elif metric == MetricType.L2:
            key = (2.0 * scale) * dots - nrm
        else:
            real = scale * dots + bias * qsum[:, None]
            key = torch.where(nrm > 0, real * nrm, qside[:, None].expand_as(real))
        key = torch.where(mask[rows][None, :] != 0, key, torch.full_like(key, NEG_INF))
        gmax = key.view(nq, t1 - t0, group, _LANES).amax(dim=2)  # (Q, T, 128)
        m, lane = topk_desc(gmax, topk)  # ties to the lower lane, as the kernel
        base = torch.arange(t0, t1, device=codes.device)[None, :, None] * _LANES
        ids = torch.where(m > NEG_INF / 2, lane + base, torch.full_like(lane, -1))
        out_s[t0:t1] = m.permute(1, 2, 0)
        out_i[t0:t1] = ids.permute(1, 2, 0).to(torch.int32)
    return out_s, out_i


def _prepare(q, codes, norms, mask, metric, topk, dequant, int4_dim, exact_tf32=False):
    """Kernel-side inputs shared by both stage-one versions."""
    metric = MetricType(metric)
    if metric not in _METRICS:
        raise ValueError(f"flat scan: unsupported metric {metric}")
    q = q.float().contiguous()
    if exact_tf32:
        # one TF32 product is exact only for +-1 codes against +-1 queries
        # (zero rows pad a batch); the codes are the caller's to vouch for
        if codes.dtype != torch.float32 or int4_dim is not None or metric != MetricType.L2:
            raise ValueError("exact_tf32 needs fp32 codes and the L2 metric")
        if not bool(((q == 1.0) | (q == -1.0) | (q == 0.0)).all()):
            raise ValueError("exact_tf32 needs every query entry in {-1, 0, +1}")
    nq, d = q.shape
    n = codes.shape[0]
    int4 = int4_dim is not None
    if int4:
        if d != int4_dim or codes.dtype != torch.int8 or dequant is None:
            raise ValueError("packed int4 needs int8 codes, int4_dim == D and dequant")
        dp = codes.shape[1]  # ceil(D/2) packed bytes per row
        # kernel query = [q_even | q_odd]; the odd plane is zero-padded when D
        # is odd, matching the phantom high nibble that packs as 0
        qe = torch.zeros((nq, dp), dtype=torch.float32, device=q.device)
        qo = torch.zeros((nq, dp), dtype=torch.float32, device=q.device)
        qe[:, : (d + 1) // 2] = q[:, 0::2]
        qo[:, : d // 2] = q[:, 1::2]
        q_kern = torch.cat([qe, qo], dim=1)
    else:
        q_kern = q
    if not 1 <= topk <= _LANES:
        raise ValueError(f"topk={topk} must lie in [1, {_LANES}] (per-tile group width)")
    tile_n = pick_tile(n, topk)
    if metric == MetricType.L2:
        qside = (q * q).sum(1)
    elif metric == MetricType.COSINE:
        qside = torch.sqrt((q * q).sum(1))
    else:
        qside = torch.zeros(nq, dtype=torch.float32, device=q.device)
    qsum = q.sum(1)
    norms = norms.float().contiguous()
    if metric == MetricType.COSINE:
        # kernel key = real_dots * (1/||x||), 0 for zero-norm rows
        safe = torch.where(norms > 0, norms, torch.ones_like(norms))
        knorm = torch.where(norms > 0, 1.0 / safe, torch.zeros_like(norms))
    else:
        knorm = norms
    scale, bias = (1.0, 0.0) if dequant is None else (float(dequant[0]), float(dequant[1]))
    kernel_args = (q_kern, qside, qsum, codes.contiguous(), knorm,
                   mask.to(torch.int8).contiguous())
    kernel_kw = dict(metric=metric, topk=topk, tile_n=tile_n, scale=scale,
                     bias=bias, int4=int4, exact_tf32=exact_tf32)
    return q, norms, kernel_args, kernel_kw


def flat_scan_stage1(q, codes, norms, mask, *, metric, topk, dequant=None,
                     int4_dim=None, plain=False, exact_tf32=False):
    """Stage one alone: (tile_s, tile_i), each (n_tiles, topk, Q). The kernel
    for CUDA tensors (unless `plain`), the plain version for CPU tensors."""
    _, _, args, kw = _prepare(q, codes, norms, mask, metric, topk, dequant, int4_dim, exact_tf32)
    return _stage1(args, kw, plain)


def _stage1(args, kw, plain):
    if plain or args[3].device.type == "cpu":
        return _stage1_plain(*args, **kw)
    return _stage1_kernel(*args, **kw)


def _scan(q, codes, norms, mask, metric, topk, dequant, int4_dim, plain, exact_tf32=False):
    q, norms, args, kw = _prepare(q, codes, norms, mask, metric, topk, dequant, int4_dim, exact_tf32)
    tile_s, tile_i = _stage1(args, kw, plain)
    q_kern, qside, _, codes, _, mask8 = args
    metric, tile_n = kw["metric"], kw["tile_n"]
    nq, d = q.shape
    n_tiles, group = tile_s.shape[0], tile_n // _LANES

    # global merge over the per-tile winner groups ((tile, k, Q) -> (Q, tile*k));
    # keys are rank-equivalent per query, so this picks the real winner groups
    tile_s = tile_s.permute(2, 0, 1).reshape(nq, n_tiles * topk)
    tile_i = tile_i.permute(2, 0, 1).reshape(nq, n_tiles * topk).long()
    top_s, sel = topk_desc(tile_s, topk)
    gids = torch.take_along_dim(tile_i, sel, dim=1)
    valid_g = (gids >= 0) & (top_s > NEG_INF / 2)

    # group g of tile t covers rows t*TILE + (g % 128) + 128*j, j < GROUP
    safe_g = torch.where(valid_g, gids, torch.zeros_like(gids))
    offs = torch.arange(group, device=q.device)[None, None, :] * _LANES
    cand = (safe_g // _LANES)[:, :, None] * tile_n + (safe_g % _LANES)[:, :, None] + offs
    cand = cand.reshape(nq, topk * group)  # (Q, C) row ids
    cand_valid = valid_g.repeat_interleave(group, dim=1)

    # gather + exact float32 rescore of the candidate rows (real metric)
    cand_codes = codes[cand]  # (Q, C, D) or (Q, C, Dp) packed
    if kw["int4"]:
        lo, hi = unpack_nibbles(cand_codes)
        cand_codes = torch.stack([lo, hi], dim=-1).reshape(nq, cand.shape[1], -1)[:, :, :d]
    cand_codes = cand_codes.float()
    if dequant is not None:
        cand_codes = cand_codes * kw["scale"] + kw["bias"]
    cand_norms = norms[cand]
    dots = torch.bmm(cand_codes, q[:, :, None])[:, :, 0]  # (Q, C)
    if metric == MetricType.IP:
        sims = dots
    elif metric == MetricType.L2:
        sims = -(qside[:, None] + cand_norms - 2.0 * dots)
    else:
        denom = qside[:, None] * cand_norms
        safe = torch.where(denom > 0, denom, torch.ones_like(denom))
        sims = torch.where(denom > 0, dots / safe, torch.ones_like(dots))
    keep = cand_valid & (mask8[cand] != 0)
    sims = torch.where(keep, sims, torch.full_like(sims, NEG_INF))

    out_s, sel2 = topk_desc(sims, topk)
    out_i = torch.take_along_dim(cand, sel2, dim=1)
    out_i = torch.where(out_s > NEG_INF / 2, out_i, torch.full_like(out_i, -1))
    return out_s, out_i


def flat_scan_topk(q, codes, norms, mask, *, metric, topk, dequant=None, int4_dim=None,
                   exact_tf32=False):
    """Exact fused scan. Returns (sims (Q, topk) desc f32, int64 row ids, -1 pad).

    q (Q, D) f32; codes (N, D) f32 / f16 / int8, or nibble-packed int4
    (N, ceil(D/2)) int8 with `int4_dim=D`; N a multiple of 1024. norms (N,)
    f32: ||x||^2 for L2, ||x|| for COSINE, unused for IP (dequantized norms
    with `dequant=(scale, bias)`). mask (N,) nonzero = candidate.
    `exact_tf32=True` declares the codes +-1 (or zero rows): the kernel then
    runs one TF32 product, exact there; it raises unless the codes are fp32,
    the metric L2 and every query entry in {-1, 0, +1}.

    CUDA tensors run stage one in the CUDA kernel, or raise; CPU tensors run
    the plain version."""
    return _scan(q, codes, norms, mask, metric, topk, dequant, int4_dim, plain=False,
                 exact_tf32=exact_tf32)


flat_scan_topk.launches = 0  # stage-one kernel launches (not plain runs)


def flat_scan_topk_plain(q, codes, norms, mask, *, metric, topk, dequant=None,
                         int4_dim=None, exact_tf32=False):
    """`flat_scan_topk` with stage one in plain PyTorch on any device."""
    return _scan(q, codes, norms, mask, metric, topk, dequant, int4_dim, plain=True,
                 exact_tf32=exact_tf32)
