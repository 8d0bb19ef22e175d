"""Is one exact HNSW build step repeatable? The inputs of
tests/test_torch_hnsw_cuda.py::test_knn_build_step_launches_kernel (8,192 x 24
gaussian rows of default_rng(0), the first 2,048 as the batch, knn_k 127,
max_out 32), `ops/hnsw.py::knn_build_step` run REPS times on the card and
compared with its own first run bit for bit (the step's adjacency, and the
flat scan's scores and ids alone), then on the CPU under 1, 2, 4 and all
threads, each held to the card's first run by the share of rows that agree
(the test's measure, floor 0.99). One JSON line a metric. With `--stress`
the card runs the steps while another process multiplies 8192 x 8192
matrices on it without a pause, so that any race in the kernels meets other
timings.

    python3 zvec_tpu_torch/csrc/probes/build_step_repeat.py [REPS] [--stress]

Run from the root of a checkout. Needs a CUDA card and nvcc (sm_90a).
"""
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")
from zvec_tpu_torch.ops import hnsw as ops  # noqa: E402
from zvec_tpu_torch.ops.flat_scan import flat_scan_topk  # noqa: E402
from zvec_tpu_torch.typing import MetricType  # noqa: E402

args = [a for a in sys.argv[1:] if a != "--stress"]
REPS = int(args[0]) if args else 20
STRESS = "--stress" in sys.argv
N, KNN_K, MAX_OUT, B = 8192, 127, 32, 2048
x = np.random.default_rng(0).standard_normal((N, 24)).astype(np.float32)
norms2 = (x**2).sum(1).astype(np.float32)


def step(dev, metric):
    adj = torch.full((N, MAX_OUT), -1, dtype=torch.int32, device=dev)
    ops.knn_build_step(
        torch.arange(B, device=dev), torch.from_numpy(x).to(dev), torch.from_numpy(norms2).to(dev),
        torch.ones(N, dtype=torch.int8, device=dev), adj, metric=MetricType[metric], knn_k=KNN_K,
        max_out=MAX_OUT,
    )
    return adj[:B].cpu().numpy()


def scan(dev, metric):
    xd = torch.from_numpy(x).to(dev)
    nrm = torch.from_numpy(norms2).to(dev)
    nrm = torch.sqrt(nrm) if metric == "COSINE" else nrm
    s, i = flat_scan_topk(xd[:B], xd, nrm, torch.ones(N, dtype=torch.int8, device=dev),
                          metric=MetricType[metric], topk=KNN_K + 1)
    return s.cpu().numpy(), i.cpu().numpy()


def digest(*arrays):
    return hashlib.sha256(b"".join(a.tobytes() for a in arrays)).hexdigest()[:12]


cuda = torch.device("cuda")
cpu = torch.device("cpu")
threads = sorted({1, 2, 4, torch.get_num_threads()})
for metric in ("COSINE", "L2"):
    load = None
    if STRESS:
        load = subprocess.Popen([sys.executable, "-c", "import torch\na = torch.randn(8192, 8192, device='cuda')\n"
                                 "while True:\n    a = (a @ a).clamp_(-1, 1)"])
        time.sleep(10)  # the load's process reaches the card
    try:
        card = [step(cuda, metric) for _ in range(REPS)]
        scans = [scan(cuda, metric) for _ in range(REPS)]
    finally:
        if load is not None:
            load.kill()
            load.wait()
    ref = card[0]
    out = {
        "metric": metric,
        "card": torch.cuda.get_device_name(0),
        "reps": REPS,
        "stress": STRESS,
        "card_step_digests": sorted({digest(a) for a in card}),
        "card_step_rows_moved_max": int(max((a != ref).any(axis=1).sum() for a in card)),
        "card_scan_digests": sorted({digest(s, i) for s, i in scans}),
    }
    cpu_rows = {}
    for t in threads:
        torch.set_num_threads(t)
        runs = [step(cpu, metric) for _ in range(3)]
        cpu_rows[str(t)] = dict(
            digests=sorted({digest(a) for a in runs}),
            agree_with_card=float((runs[0] == ref).all(axis=1).mean()),
        )
    torch.set_num_threads(threads[-1])
    out["cpu_by_threads"] = cpu_rows
    out["omp_num_threads"] = os.environ.get("OMP_NUM_THREADS")
    print(json.dumps(out), flush=True)
