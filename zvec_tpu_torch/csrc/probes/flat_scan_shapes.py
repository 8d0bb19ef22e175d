"""Stage-one times of the flat-scan kernel of the zvec_tpu_torch package in
the current directory, at the shapes `chip_smoke.py` gives it (CUDA events,
median of 7), each checked against its plain version; one JSON line a shape.

    python3 zvec_tpu_torch/csrc/probes/flat_scan_shapes.py <tag>

Run from the root of a checkout. To compare two commits on one card, unpack
the other into a git-ignored directory (`git archive`) and run both in
turns, old, new, new, old, passing this file's path to the old checkout's
root: `(cd old && python3 /path/to/flat_scan_shapes.py old)`. Shapes that
the checkout's wrapper cannot take (one pass before it existed) are skipped.
Needs a CUDA card and nvcc (sm_90a).
"""
import inspect
import json
import statistics
import sys
import time

import torch

sys.path.insert(0, ".")
from zvec_tpu_torch.ops import flat_scan as fs  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402

tag = sys.argv[1]
t0 = time.time()
so, secs = fs.build_kernels()
fs._library()
one_pass_ok = "exact_tf32" in inspect.signature(fs.flat_scan_stage1).parameters


def time_ms(fn, reps=7):
    fn(); fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


dev = torch.device("cuda")


def case(label, n, d, nq, k, dtype=torch.float32, pm1=False, exact=False, metric="L2", int8=False):
    if exact and not one_pass_ok:
        return
    g = torch.Generator(device=dev).manual_seed(d * 7 + k)
    if pm1:
        x = (torch.randint(0, 2, (n, d), generator=g, device=dev) * 2 - 1).float()
        q = (torch.randint(0, 2, (nq, d), generator=g, device=dev) * 2 - 1).float()
    else:
        x = torch.randn((n, d), generator=g, device=dev)
        q = x[:nq].clone() if k == 128 else torch.randn((nq, d), generator=g, device=dev)
    codes = x.to(dtype).contiguous()
    norms = (codes.float() ** 2).sum(1)
    extra = {}
    if int8:
        codes = torch.clamp(torch.round(x * 30), -127, 127).to(torch.int8).contiguous()
        norms = ((codes.float() / 30) ** 2).sum(1)
        extra = dict(dequant=(1 / 30, 0.0))
    if metric == "COSINE":
        norms = norms.sqrt()
    mask = torch.ones(n, dtype=torch.int8, device=dev)
    kw = dict(metric=MetricType[metric], topk=k, **extra)
    if exact:
        kw["exact_tf32"] = True
    ks, ki = fs.flat_scan_stage1(q, codes, norms, mask, **kw)
    ps, pi = fs.flat_scan_stage1(q, codes, norms, mask, plain=True, **kw)
    torch.cuda.synchronize()
    err = float((ks - ps).abs().max())
    ok = bool(torch.allclose(ks, ps, rtol=1e-4, atol=1e-3 if not pm1 else 0.0))
    k_ms = time_ms(lambda: fs.flat_scan_stage1(q, codes, norms, mask, **kw))
    print(json.dumps(dict(tag=tag, label=label, n=n, d=d, q=nq, k=k, dtype=str(dtype), exact=exact,
                          ms=k_ms, max_dkey=err, keys_ok=ok)), flush=True)
    del x, q, codes, norms, mask, ks, ki, ps, pi
    torch.cuda.empty_cache()


case("flat", 1007616, 128, 1024, 10)
case("flat fp16", 1007616, 128, 1024, 10, dtype=torch.float16)
case("flat int8", 1007616, 128, 1024, 10, int8=True)
case("flat fp32 cosine", 1007616, 128, 1024, 10, metric="COSINE")
case("build", 1000448, 128, 2048, 128)
case("mips", 1000448, 201, 2048, 128)
case("mips padded", 1000448, 204, 2048, 128)
case("hamming 3-pass", 1007616, 256, 1024, 10, pm1=True)
case("hamming 1-pass", 1007616, 256, 1024, 10, pm1=True, exact=True)
case("hamming512 1-pass", 503808, 512, 1024, 10, pm1=True, exact=True)
case("cohere-ip", 450560, 769, 1024, 128)
case("cohere", 450560, 768, 1024, 128, metric="COSINE")
case("fp16 glove", 1007616, 100, 1024, 10, dtype=torch.float16)
print(f"{tag} total {time.time() - t0:.1f} s (build {secs:.1f} s)", flush=True)
