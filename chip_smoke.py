"""Smoke run of zvec_tpu_torch on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py [--phases kernel,flat,hnsw,ivf,clustered,live,cohere,sparse,fusion,tools,mesh,
                                    compact,mips,codes,hamming]

With no arguments every phase runs and the two JSON lines are printed; a
subset of phases (for work on one path) prints no JSON line. `mesh` reopens
the collections of `flat`, `hnsw` and `ivf`, so a subset that names it names
those three too; `live` runs on the collection of `clustered`, so a subset
that names it names `clustered` too; `compact` compacts the collection of
`hnsw` (after `mesh` when both run), so a subset that names it names `hnsw`.

Phases 1-3d run in this process, alone on the card. The later phases run in
four worker processes started together on the one card (GROUPS: flat, hnsw,
ivf, mesh, compact; clustered, live; cohere, sparse, fusion, tools, hamming;
mips, codes), each group's
phases one after another in its worker, which writes its launch counts and
kernel cases to a JSON file; each worker's log is printed when it ends. The
groups are independent, so their host-bound work runs side by side on the
host's cores; the K1 times of phases 3-3c are taken alone, those of 8c
beside the other groups. The first failing worker, or one still running
GROUP_DEADLINE_S after the start, stops them all.

Phases (any failure raises, and the exit code is non-zero):
  1. toolchain: torch / CUDA / nvcc versions and the card's name and power
     limit; the port's device (ops/runtime.device) must be the card
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
  3c. the same at the shape the Cohere build of 8b gives it, on that
     deployment's own rows: N=450,000 (padded to 450,560), D=768, Q=1024 code
     rows, k=128, fp32 COSINE
  6. the HNSW path through the public API: HnswIndexParam(L2) with the
     default m=50, ef_construction=500 -> insert the same 1M docs -> optimize
     (graph build on the card, the kernel scoring its forward kNN pass) ->
     flush -> batch_query_many over 4 blocks of 1024 queries at ef 128 / 256 /
     500 (recall@10 against the exact oracle; >= 0.85 at ef=500), one profiled
     ef=256 batch, the CUDA beam against the same beam on CPU copies of its
     tensors (64 queries), and a reopen that loads the graph from disk. The
     docs carry an int64 `grp` field of 50 values: 32 group_by_query calls
     (10 groups x 2 at ef=500, the groups harvested inside the beam) are
     compared with the same grouping of the exact oracle's top-1,000 (at
     most 2 rows per group, the best 64 rows, then the 10 groups with the
     best leaders; on gaussian data the beam's recall, 0.90 at this ef,
     bounds the agreement: floors 0.7 of the (query, group) pairs, 0.85 of
     the group leaders), and the grouped beam on the card is held to the
     same beam on CPU copies (16 queries)
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
  8. the clustered HNSW build through the public API, on the deployment of
     benchmarks/bench_10m_hnsw.py (the repo's 10M x 128 recipe, after the
     upstream Cohere-10M HNSW recipe) with its rows cut from 10,000,000 to
     2,100,000 (still above the size rule's 2,000,000): clustered L2 docs
     (210 centres), HnswIndexParam(L2, m=50,
     ef_construction=500) and no clustered_build set, so the size rule picks
     the path -> insert (batches of 1024) -> optimize (k-means buckets,
     per-bucket exact kNN, forward prune, one NN-descent round, reverse +
     merge, on bf16 build codes) -> flush -> batch_query_many over 4 blocks
     of 1024 queries at ef 32 / 64 / 128 / 256 (recall@10 against the
     exact oracle: >= 0.95 at ef=128, >= 0.965 at ef=256), no K1 launch in
     the build, the hashed visited set in the beam, 32 group_by_query calls
     at ef=256 (>= 0.9 of the (query, group) pairs equal to the exact
     grouping under the harvest buffer's rule), the CUDA beam and grouped beam against the CPU's (64 / 16
     queries), bucket_knn_all on the card against the CPU for 4
     buckets of the build, profiles of one forward-prune and one NN-descent
     batch, and a reopen that loads the graph without k-means or prune. Then
     routed traversal on the same graph: the collection's graph file loaded
     into an engine with an int8 route tier, then one with a bf16 tier (no
     graph build; the route is made from the codes), each at ef 128
     beside the unrouted engine: recall@10 (within 0.02 of the unrouted),
     ms per 1024-query batch (median of 3), the largest error of a returned
     score against its exact fp32 score (<= 1e-3 relative), the route's build
     seconds, peak device memory, a profiled ef=128 batch with the code
     gathers' share of device time (beside the unrouted engine's), and the
     routed beam on the card against the CPU on 16 queries. The docs also
     carry the live phase's fields: a `tag` string (inverted index), a
     `price` double (both drawn as benchmarks/bench_ivf10m.py::fields_arrays
     draws them) and a `gid` int (i % 997)
  8c. live: benchmarks/bench_filtered10m.py on phase 8's reopened collection,
     then its write life, with no optimize. A: the filters `price < 0.5`,
     `tag = 't3'`, `tag = 't3' AND price < 0.1` (and none) at ef 96 / 256 over
     the 1024 queries, recall@10 against an exact fp32 oracle on the card over
     the filter's rows, the batch ms, and the path each took (the HNSW beam, the
     device scan with is_linear, or the host exact scan), which must be the
     brute-force-by-keys rule's, also for one query as bench_filtered10m.py
     reads the path; a demoted filter reads 1.0 outside near-ties,
     a graph-served one >= 0.93 / 0.96 at ef 96 / 256. B: group_by_query on
     gid (group_count 10 and 50, 2 each) on 16 queries, 3 repeats, beside a
     plain query at topk group_count x 2. C: delete 1% of the pks,
     delete_by_filter('gid = 5'), upsert 10,000 pks with fresh vectors, update
     the price of 10,000 pks to 0.05 (2,000 of them upserted before), insert
     100,000 new docs: the writing segment then holds 120,000 rows and K1 scans
     it; against a plain reference of the live collection: no deleted pk and
     no superseded version in the unfiltered and the three filtered ef=256
     batches, recall@10 within 0.01 of A's unfiltered figure, the filters at
     A's floors, read-your-writes (1,000 new and 1,000 upserted docs queried
     by their own vectors return themselves at rank 1), and K1 against its
     plain version on the writing segment's codes with its live mask, with
     and without a filter. D: a reader thread runs batch_query of 64 queries
     in a loop while C's inserts run: no error, no deleted pk. E: a crash
     (the impl closed without a flush) and open: the WAL replayed, the same
     doc count, C's four batches with identical ids, the sealed graph loaded
     from its file with no K1 launch and no build, the writing segment's
     engine on the card
  8b. cohere: the deployment of benchmarks/bench_cohere10m.py (the reference's
     own Cohere-10M headline, after the upstream tools/core/README.md) with its
     rows cut from 10,000,000 to 450,000 (the time limit; VectorDBBench's
     Performance768D1M holds 1,000,000): the benchmark's generator copied
     (1024 centres x 2.0, unit-norm rows, seed 0xC0EE), VECTOR_FP32 768-d,
     HnswIndexParam(COSINE, m=50,
     ef_construction=500, quantize_type=INT8) -> insert (batches of 1024) ->
     optimize (the exact build on fp32 codes, knn_k 127, K1 in 1024-row
     batches; int8 search codes on the card) -> flush -> batch_query of the
     1000 queries at ef 64 / 96 / 128 / 250 with the fp32 refine on (the
     default) and off (recall@10 against an exact fp32 COSINE oracle on the
     card: refined >= 0.95 at ef 128, >= 0.965 at 250, refined >= unrefined at
     every ef, refined scores the exact cosine distances; where recall stops:
     done_frac 1.0, ef 500, lost queries, L0 in-degrees), recall@1/10/50/100
     at ef 250 (50 / 100 on 250 queries), the host refine's share of a batch
     (K1 at the build's shape is phase 3c), a profiled ef=128 batch, the int8 beam on the card against CPU
     copies (16 queries), and a reopen that loads the graph without a build
  9. the sparse HNSW path through the public API, on the deployment of
     benchmarks/bench_sparse1m.py with its rows cut from 1,000,000 to 200,000:
     one SPARSE_VECTOR_FP32 field, HnswIndexParam(IP, m=16,
     ef_construction=200), vocabulary 131,072, 256 topics (a 2,000-term shared
     head, 600-term tails), 96 terms a document, 16 a query -> insert (batches
     of 1024) -> optimize (from 200,000 rows on the size rule picks the clustered
     signature build: signatures, k-means, top-2 assign, bucket kNN, exact
     rescoring, one expansion round, reverse merge, medoid entries) -> flush ->
     batch_query of 1024 queries at ef 32 / 64 / 128 / 256 (recall@10 over 256
     queries against a torch.sparse product on the card, read apart for the
     queries whose topic holds one of the beam's 128 medoid entries: >= 0.80
     there at ef=128, >= 0.65 over all queries),
     the is_linear flat scan (recall >= 0.999), single-query latency, profiles
     of one beam batch and one flat batch, the beam and sparse_ip_topk (a
     65,536-row slice) on the card against the CPU on 16 queries, and a reopen
     that loads the graph and the medoid entries without k-means
 10. dense + sparse fusion through the public API, benchmarks/bench_suite.py's
     config #5 as it stands: 100,000 documents, a 64-d VECTOR_FP32 field
     (FlatIndexParam(COSINE)) and a sparse field (FlatIndexParam(IP), vocabulary
     30,000, 24 terms), RrfReRanker, 64 queries, top-10: per-query fused
     latency, batch_fused_query, the two batch_query calls the fused pair
     replaces; every fused answer equals the port's reranker over the two
     per-field answers, the fused pair was taken, and K1 was not launched
 11. tools: the command-line tools through their main(argv), as `python -m`
     runs them, on 100,000 rows of phase 4's generator (cut from 1,000,000):
     tools.io.write_vecs, tools.build --index flat and --index hnsw (m 16,
     ef_construction 200), tools.recall against ground truth from the exact
     oracle on the card (FLAT recall@10 1.0; HNSW equal to the recall of
     batch_query_many on the same collection), tools.bench for 2 s at batch 1
     and 1024 on both (qps, p50, p99), K1's launches on the FLAT path; then the
     three examples of zvec_tpu_torch/examples/ on the card, whose ids must
     equal those of a CPU run of the same examples (a process that asks for
     the CPU with ZVEC_TORCH_DEVICE=cpu and sees no card); quantized_groupby
     at 1,000 rows and ef_construction 100 in both, as the CPU test runs it
 12. mesh: graft_entry.dryrun_multichip(4) on the card, then GlobalConfig
     mesh_devices = 4 (as the JAX package's dry run turns its mesh on) and the
     collections of phases 4, 6 and 7 reopened under 4 corpus shards, all on
     the one card: FLAT (4 x 253,952 rows; batch_query_many of 4 blocks of
     1024 at top-10, recall 1.0 and phase 4's ids outside near-ties, K1
     launched on every shard); HNSW rebuilt through create_index with knn_k =
     127 (the pool phase 6's 1M layer gets from the size rule; a 250,112-row
     shard would get 500 and the blockwise scan) into 4 shard graphs on K1,
     per-shard build seconds, ef 128 recall@10 no more than 0.01 under
     phase 6's, the sharded beam on the card against CPU copies of the shards
     on 16 queries, and a reopen that loads the sharded graph file without a
     build; IVF without k-means, recall@10 at nprobe 16 no more than 0.001
     under phase 7's, the 5% filter at recall 1.0; then 12,500 of phase 9's
     documents (rows cut from 200,000 for time, widths kept) in a sparse HNSW
     field of 4 shards built by the exact per-shard pass: the sparse FLAT scan
     (is_linear) at recall >= 0.999 and the beam at ef 128 within 0.02 of an
     unsharded engine on the same documents; peak device memory

 3d. the same kernel at the shapes of phases 14 and 16, alone: the MIPS build
     (text2image-shaped rows augmented to D = 201 as ops/quantize.py's
     mips_augment does, zero-padded to 204 columns as HnswEngine pads its
     scan codes on the card, 1,000,448 rows, Q=2048 code rows, k=128, fp32
     L2; the rows share one norm, so ids swap among near-equal keys: each id
     is held to its own exact key, computed in fp64; then on the unpadded
     804-byte rows, on 4-byte copies and on the byte loads they took before,
     keys and ids bitwise those of the padded rows, and timed), the same for
     HnswIndexParam()'s default IP build of phase 3c's Cohere rows (450,560
     rows augmented to D = 769, padded to 772, Q=1024, k=128, run after 3c
     on its rows), the
     HAMMING FLAT scan (+-1 codes of 256 bits, 1,007,616 rows, Q=1024, k=10,
     L2, in the one TF32 pass FlatEngine asks for, timed also in three:
     integer keys, equal to the plain version's exactly, ids compared under
     the exact tie rule) and FP16 codes at the GloVe-100 width (1,007,616 x
     100 unit rows, COSINE, Q=1024, k=10, 8-byte copies; phase 3's rules)
 13. compact: phase 6's collection (after mesh) reopened, 100,000 random pks
     deleted and delete_by_filter('grp = 7'), then optimize: the doc count
     against a plain reference of the surviving pks, one sealed segment of
     the survivors, the graph rebuilt over them on the card (K1 launched;
     the merge's and the build's seconds, build_times), no deleted pk in 4
     batches of 1024 at ef 256, recall@10 there against the survivors'
     exact oracle no more than 0.01 under phase 6's, a reopen that loads
     the new graph without a build, and K1 against its plain version at the
     rebuild's own shape (the survivors' codes padded to 1024 rows, 2048
     code rows, k=128, as phase 3b)
 14. mips: HnswIndexParam() with no argument (IP, m 50, ef_construction 500)
     at big-ann-benchmarks' text2image-1B width and metric (200-d, inner
     product) on 1,000,000 synthetic rows (make_data clustered directions
     with lognormal norms; 1024 unit queries from their own seed with twice
     the noise; the distribution is the script's, not text2image's): the
     MIPS -> L2 augmentation (D = 201 codes), the exact build with K1,
     recall@10 at ef 64 / 128 / 256 against an exact IP oracle on the card
     (floors 0.93 / 0.97 / 0.99, just under the card's readings; on a miss a
     COSINE build of the same rows is logged first, to tell the algorithm
     from the port),
     returned scores equal to q.x of their rows, the beam card against CPU
     (64 queries), a reopen without a build
 15. codes: FLAT on phase 4's data with four fields (L2 FP16, L2 INT8, L2
     INT4, IP): K1 at k 10 on each field's codes, recall@10 against the fp32
     oracle with the refine off and on, K1's answer equal to its plain
     version on the engine's own codes (ties aside) with its time and bound;
     IVF on phase 7's deployment with an IVF-SQ8 field (L2, SOAR, INT8) and
     an IVF IP field (SOAR): nprobe 8 / 16 / 32 at phase 7's floors, the
     probe card against CPU; HNSW on bench_suite.py's config #3 (the GloVe-100
     shape, 200,000 x 100 COSINE, m 50, ef_construction 500; its generator
     copied) with INT8, FP16 and INT4 fields: raw and refined recall@10 at ef
     32 / 64 / 128 (INT8 refined >= 0.99 at 64 and 128), each beam card
     against CPU (16 queries)
 16. hamming: ann-benchmarks' sift-256-hamming shape, 256-bit codes as a
     VECTOR_BINARY32 field of 8 words from a seed (clustered: each row its
     centre with bits flipped): FlatIndexParam(HAMMING) on 1,000,000 rows
     (K1 on the +-1 codes at D = 256) and HnswIndexParam(HAMMING) on the
     first 250,000, packed queries in batches, against an exact Hamming
     oracle on the card (+-1 products, held to byte popcounts for 16
     queries): tie-aware recall (a hit is any id at a distance <= the k-th
     true one; FLAT 1.0, HNSW >= 0.90 at ef 256), returned scores equal to
     the true distances, the FLAT answers against K1's plain version under
     the exact tie rule, the beam card against CPU

Phases 3, 3b, 3c, 3d and 8c print, beside each stage-one time, K1's path
(the bytes of one code-row copy and its TF32 passes), its bound (the
larger of the split-TF32 tensor-core work over 495 TFLOP/s and the bytes
over 3.35 TB/s, with the FLOP and byte counts; one TF32 pass for the +-1
HAMMING codes, which are exact in it), the roofline share (bound / time)
and, for fp32 codes, a library yardstick: torch.matmul of the same (Q, D) x
(D, N) product in full fp32 (with TF32 on for the +-1 codes, where it is
exact), the product only (the port never calls it).

The line before the last is a JSON object with the kernel's launches, error,
times, bound and yardstick; the last line is {"ok": true, "device": {...}}. Needs one CUDA
card; exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
# phase 8: bench_10m_hnsw.py's deployment, rows cut from 10,000,000
CL_N = 2_100_000  # still above the size rule's 2,000,000 rows
CL_EFS = (32, 64, 128, 256)
CL_FLOORS = {128: 0.95, 256: 0.965}  # recall@10
# recall@10 of zvec_tpu on the uncut 10M deployment on its own chip
# (benchmarks/h2h10m_results.json); recall only, a smaller corpus should read no lower
CL_REF_CURVE_10M = {32: 0.858, 64: 0.924, 96: 0.950, 128: 0.959, 256: 0.973}
CL_BUCKETS = 4  # buckets of the real build checked card against CPU (the script's time limit)
BUCKET_RTOL = 1e-5  # width of a near-tie at a bucket's top-kc boundary
# group-by (phases 6 and 8): an int64 `grp` field of 50 values, 64 calls of 10 groups x 2
GRP_VALUES, GRP_COUNT, GRP_TOPK, GRP_Q = 50, 10, 2, 32  # 32 calls: the script's time limit
GRP_ORACLE_K = 1000
GRP_PLAIN_Q = 8  # plain top-10 queries timed beside the group-by calls
# the width of the harvest buffer, as Collection.group_by_query sizes it: the
# next power of two above max(2 * groups * members, 64), at most 1,024
GRP_CAP = min(1 << max(6, (2 * GRP_COUNT * GRP_TOPK - 1).bit_length()), 1024)
# floors on the share of (query, group) pairs, and of group leaders, equal to
# the grouping of the exact top-1,000 under the buffer's rule. A group's
# second member sits ~100 to 300 ranks deep, so the pairs follow the beam's
# recall at that depth: low on the 1M gaussian collection (recall@10 0.90 at
# ef=500; with ef=1000 0.87 of the pairs agree), near 1 on the clustered
# collection (recall@10 0.995 at ef=256)
GRP_GAUSSIAN = dict(ef=500, min_pairs=0.7, min_leaders=0.85)
GRP_CLUSTERED = dict(ef=256, min_pairs=0.9, min_leaders=0.95)
GRP_BEAM_Q, GRP_BEAM_CAP = 16, 64
# phase 9: bench_sparse1m.py's deployment, rows cut from 1,000,000
SP_N, SP_VOCAB, SP_TOPICS, SP_HEAD, SP_TAIL = 200_000, 131_072, 256, 2000, 600  # the size rule's 200,000
SP_NNZ_DOC, SP_NNZ_Q, SP_SEED, SP_CHUNK = 96, 16, 0x5A5A, 1 << 17
SP_EFS = (32, 64, 128, 256)  # the deployment's three, and one more to show where recall goes
SP_GT_Q = 256  # queries with an exact answer
# recall@10 floors at ef = 128 (tripwires: the JAX package has no number at this
# scale). 0.80 holds for the queries whose topic holds one of the beam's entries;
# the engine keeps at most 128 medoid entries (the JAX engine's cap) for 200
# clusters over 256 topics, and a query of a topic without an entry reaches it
# only through teleport edges, so over all queries the card read 0.7469 at
# 250,000 rows and 0.6426 at 500,000 rows, and the floor over all queries is 0.65
SP_MIN_RECALL_EF128 = 0.80
SP_MIN_RECALL_EF128_ALL = 0.65
SP_MIN_RECALL_FLAT = 0.999
SP_CHECK_Q, SP_CHECK_EF, SP_CHECK_ROWS = 16, 64, 65_536
SP_RTOL = 1e-5  # card vs CPU: scores, and the width of a near-tie
# phase 10: bench_suite.py's config #5 (its SEED = 7)
FU_N, FU_D, FU_VOCAB, FU_NNZ, FU_Q, FU_SEED = 100_000, 64, 30_000, 24, 64, 7 + 2
# phase 8, routed traversal: the same graph loaded into engines with an int8
# and a bf16 route tier
RT_EFS = (128,)  # one ef: the script's time limit
RT_MAX_RECALL_LOSS = 0.02  # routed recall@10 at each ef within this of the unrouted beam's
RT_SCORE_RTOL = 1e-3  # returned scores against the exact fp32 ones, relative
RT_CHECK_Q = 16  # queries of the routed beam held card against CPU
# phase tools: phase 4's generator with its rows cut from 1,000,000
TL_N, TL_GT_Q, TL_EF, TL_BENCH_S = 100_000, 64, 128, 2.0  # 64 queries, 2 s a bench: the script's time limit
# the quantized_groupby example at 1,000 rows and ef_construction 100 on the
# card and the CPU, as tests/test_torch_examples.py runs it (the script's time limit)
TL_EX_N, TL_EX_EFC = 1000, 100
# phase mesh: the collections of phases 4, 6 and 7 reopened under 4 shards
MESH_SHARDS = 4
MESH_KNN_K = 127  # the shard builds' candidate pool: what phase 6's 1M layer gets from the size rule
MESH_HNSW_EFS = (128,)  # one ef: the script's time limit
MESH_HNSW_SLACK = 0.01  # sharded recall@10 at each ef >= phase 6's unsharded, less this
MESH_IVF_NPROBE, MESH_IVF_SLACK = 16, 0.001
MESH_SP_N, MESH_SP_EF, MESH_SP_SLACK = 12_500, 128, 0.02  # phase 9's rows cut to 12,500
MESH_CHECK_Q = 16  # queries of the sharded beam held card against CPU
# phase cohere: benchmarks/bench_cohere10m.py's deployment (the reference's
# Cohere-10M headline: 768-d, COSINE, INT8 codes, HNSW m=50 efc=500, fp32
# refine), rows cut from 10,000,000 to 450,000 by the script's time limit (the
# phase takes ~275 s at VectorDBBench's Performance768D1M size of 1,000,000;
# above 400,000 rows the build keeps knn_k 127, so K1)
CO_N, CO_D, CO_NQ = 450_000, 768, 1000
CO_NCENTERS, CO_SEED, CO_GEN_BLOCK = 1024, 0xC0EE, 1 << 16
CO_N_PAD = 450_560  # CO_N rounded up to 1024 rows, as the build pads its scan
CO_Q_BUILD = 1024  # build rows per scan: the build halves its batch at D >= 512
CO_EFS = (64, 96, 128, 250)
CO_TOPKS = (1, 10, 50, 100)  # recall@k at ef 250, as the reference reports it
CO_TOPK_Q = 250  # queries of the top-50 / top-100 batches (the script's time limit)
# refined recall@10 floors over all 1000 queries. The reference's 10M figure
# less ~0.006 (0.975 at ef 250) does not hold here: below 2,000,000 rows the
# size rule takes the exact build (the 10M run took the clustered build), and
# on an NVIDIA H100 80GB HBM3 at 700 W its graph read 0.9729 at ef 250 over
# 500,000 rows and 0.9700 over 1,000,000 (0.9749 / 0.9750 with done_frac 1.0,
# 0.9869 / 0.9860 at ef 500), so the ef 250 floor sits under that reading
CO_FLOORS = {128: 0.95, 250: 0.965}
# zvec_tpu on the uncut 10M deployment on its own chip (benchmarks/
# cohere10m_results.json), recall only: refined and unrefined recall@10 by ef,
# refined recall@k at ef 250; a smaller corpus built by the exact build should read no lower
CO_REF_10M = {64: 0.9382, 96: 0.9382, 128: 0.9559, 250: 0.9809}
CO_REF_RAW_10M = {96: 0.9069, 250: 0.9406}
CO_REF_TOPK_10M = {1: 0.986, 10: 0.9809, 50: 0.987, 100: 0.9952}
CO_CHECK_Q = 16  # queries of the int8 beam held card against CPU
CO_SCORE_ATOL = 1e-5  # refined scores against the exact cosine distance (float32 sums)
# phase live: benchmarks/bench_filtered10m.py's grid on bench_ivf10m.py's fields,
# run on phase 8's collection (its rows cut as phase 8's), then the collection's
# write life: deletes, upserts, updates, a writing segment scanned by K1, a crash
LV_FIELDS_SEED = 0x1F1F  # bench_ivf10m.py's SEED: fields_arrays draws the tags, then the prices
LV_GID_MOD = 997  # gid = i % 997, bench_filtered10m.py's grouping field
LV_FILTERS = {  # the grid of bench_filtered10m.py:110-114 (~50%, ~10%, ~1%)
    "price < 0.5": lambda tag, price: price < 0.5,
    "tag = 't3'": lambda tag, price: tag == 3,
    "tag = 't3' AND price < 0.1": lambda tag, price: (tag == 3) & (price < 0.1),
}
LV_EFS = (96, 256)
# recall@10 floors for a filter the graph serves: the reference's 10M figures less ~0.01
LV_GRAPH_FLOORS = {96: 0.93, 256: 0.96}
# zvec_tpu on the uncut 10M deployment on its own chip (benchmarks/
# filtered10m_results.json): recall@10 and the path it named, history only
LV_REF_10M = {
    None: {96: (0.9504, "graph_traversal")},
    "price < 0.5": {96: (0.9426, "graph_traversal"), 256: (0.9723, "graph_traversal")},
    "tag = 't3'": {96: (0.9996, "brute_force_by_keys"), 256: (0.9996, "brute_force_by_keys")},
    "tag = 't3' AND price < 0.1": {96: (1.0, "graph_traversal"), 256: (1.0, "graph_traversal")},
}
LV_REF_GROUPED_10M = {10: 1.22, 50: 0.32}  # grouped / plain ms at group_count 10 / 50
LV_GROUP_COUNTS, LV_GROUP_Q, LV_GROUP_REPS = (10, 50), 16, 3  # bench_filtered10m.py:172-194
LV_SEED = 0x11FE  # the mutations' choices and the new rows
LV_DELETE, LV_UPSERT, LV_UPDATE, LV_UPDATE_UPSERTED = CL_N // 100, 10_000, 10_000, 2_000
LV_INSERT, LV_DBF_GID, LV_RYW = 100_000, 5, 1_000
LV_READER_Q = 64  # the concurrent reader's batch
LV_RECALL_SLACK = 0.01  # live recall@10 at ef 256 >= leg A's unfiltered figure, less this
LV_SCORE_RTOL = 1e-5  # a returned score against its pk's live vector, of |q|^2 + |x|^2
LV_REOPEN_RTOL = 1e-5  # scores after the crash and replay against leg C's
BF_RATIO, BF_HOST_WORK = 0.1, 1 << 24  # the brute-force-by-keys rule (utils/config.py, collection_impl.py)
# phase mips: big-ann-benchmarks' text2image-1B shape (the NeurIPS'21 track's
# Yandex Text-to-Image: 200-d fp32, inner product) under HnswIndexParam()'s own
# defaults (IP, m 50, ef_construction 500), rows cut from 1,000,000,000
MI_N, MI_D, MI_NQ = 1_000_000, 200, 1024
MI_NORM_SEED, MI_NORM_SIGMA = 0x7217, 0.3  # each row's norm: lognormal(0, 0.3) times a clustered direction
MI_Q_SEED, MI_Q_NOISE = 0x7218, 2.0  # text queries lie off the image corpus: twice its noise
MI_EFS = (64, 128, 256)
MI_FLOORS = {64: 0.93, 128: 0.97, 256: 0.99}  # recall@10 against the exact IP oracle, just under the card's
MI_SCORE_RTOL = 1e-4  # a returned score against q.x of its row, relative
# phase compact: phase 6's collection after `mesh`, then deletes and optimize
CP_DELETE, CP_DBF, CP_SEED = 100_000, "grp = 7", 0xC0DE
CP_RECALL_SLACK = 0.01  # recall@10 at ef 256 >= phase 6's, less this
# phase codes: FP16 / INT8 / INT4 codes on FLAT (phase 4's data), IVF (phase
# 7's deployment) and HNSW (bench_suite.py's config #3, the GloVe-100 shape)
CD_FLAT_FIELDS = {"fp16": ("L2", "FP16"), "int8": ("L2", "INT8"), "int4": ("L2", "INT4"), "ip": ("IP", None)}
CD_IVF_FIELDS = {"sq8": ("L2", "INT8"), "ip": ("IP", None)}
CD_NPROBES = (8, 16, 32)
CD_HNSW_N, CD_HNSW_D, CD_HNSW_SEED = 200_000, 100, 7  # bench_suite.py: SUITE_N_HNSW, d, SEED
CD_HNSW_FIELDS = ("int8", "fp16", "int4")
CD_EFS = (32, 64, 128)
CD_FLOORS = {64: 0.99, 128: 0.99}  # INT8 refined recall@10 (zvec_tpu read 0.9961 / 0.9988, BASELINE.md)
CD_CHECK_Q = 16  # queries of each beam held card against CPU
# phase hamming: ann-benchmarks' sift-256-hamming shape, 256-bit codes as a
# VECTOR_BINARY32 field of 8 words, from a seed; the HNSW index on a cut
HM_N, HM_HNSW_N, HM_BITS, HM_NQ = 1_000_000, 250_000, 256, 1024
HM_SEED, HM_FLIP, HM_Q_FLIP = 0xB175, 0.15, 0.2  # clustered codes: bits flipped from their centre
HM_EFS = (64, 128, 256)
HM_N_PAD = 1_007_616  # HM_N rounded up to the 8192-row tile, as FlatEngine pads it
HM_POPCOUNT_Q = 16  # queries whose matmul oracle is held to a popcount on the card
HM_HNSW_FLOOR = 0.90  # tie-aware recall@10 at ef 256 (tests/test_binary.py's floor at ef 96 on 1,500 rows)
PHASES = ("kernel", "flat", "hnsw", "ivf", "clustered", "live", "cohere", "sparse", "fusion", "tools", "mesh",
          "compact", "mips", "codes", "hamming")
MESH_NEEDS = ("flat", "hnsw", "ivf")
LIVE_NEEDS = ("clustered",)
COMPACT_NEEDS = ("hnsw",)
# the phases after `kernel`, in worker processes that run side by side; a
# phase that needs another's collection is in its group, after it
GROUPS = (("flat", "hnsw", "ivf", "mesh", "compact"), ("clustered", "live"),
          ("cohere", "sparse", "fusion", "tools", "hamming"), ("mips", "codes"))
GROUP_DEADLINE_S = 1100  # since the start: workers still running then are stopped, and the run fails
PARENT_ENV = "CHIP_SMOKE_PARENT"  # a worker's parent pid: the worker dies with it


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


def _bound(nq: int, n: int, d: int, topk: int, tile_n: int, codes: torch.Tensor, one_pass: bool = False) -> dict:
    """The least time the card could take for stage one: the larger of its
    tensor-core work (three TF32 products per fp32 pair, two for fp16 / int8 /
    int4 codes, one with `one_pass` where every code, query and sum is exact
    in TF32, as the +-1 HAMMING codes are; 2*Q*N*D FLOP each) over the TF32
    peak and its bytes (codes, norms, mask and queries read once, (tile, k,
    Q) keys and ids written once) over the memory rate."""
    passes = 1 if one_pass else 3 if codes.dtype == torch.float32 else 2
    flop = passes * 2.0 * nq * n * d
    nbytes = (codes.numel() * codes.element_size() + n * 5 + nq * d * 4
              + (n // tile_n) * topk * nq * 8)
    t_ops, t_bytes = flop / PEAK_TF32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                flop=flop, bytes=nbytes)


@contextlib.contextmanager
def _tf32(on: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _library_ms(q: torch.Tensor, codes: torch.Tensor, tf32: bool = False):
    """torch.matmul of the same (Q, D) x (D, N) fp32 product: the product
    only, without key, mask or group-max. In full fp32 (TF32 off), or with
    TF32 on where the product is exact in it (the +-1 codes). A yardstick;
    the port never calls it. None for codes other than fp32."""
    if codes.dtype != torch.float32:
        return None
    with _tf32(tf32):
        return time_ms(lambda: torch.matmul(q, codes.T))


def _bound_text(b: dict, k_ms: float, lib_ms, lib_kind: str = "fp32") -> str:
    lib = "n/a" if lib_ms is None else f"{lib_ms:.3f} ms"
    return (f"bound {b['bound_ms']:.3f} ms by {b['bound_by']} ({b['flop']:.4g} FLOP at 495 TFLOP/s, "
            f"{b['bytes']:.4g} B at 3.35 TB/s), roofline {b['bound_ms'] / k_ms:.1%}; "
            f"library {lib} (torch.matmul {lib_kind}, product only)")


def _pad4(d: int) -> int:
    """fp32 columns of 16-byte rows: HnswEngine's exact build pads its scan codes so on the card."""
    return -(-d // 4) * 4


def _k1_path(codes: torch.Tensor, exact: bool = False) -> dict:
    """How K1 takes these codes: the bytes of one asynchronous copy of a code
    row (ops/flat_scan.py::copy_bytes; 1 = byte loads) and its TF32 products
    (one with `exact`, the +-1 codes' instance)."""
    from zvec_tpu_torch.ops.flat_scan import copy_bytes

    return dict(copy_bytes=copy_bytes(codes.shape[1] * codes.element_size(), codes.data_ptr()),
                passes=1 if exact else 3 if codes.dtype == torch.float32 else 2)


def _path_text(path: dict) -> str:
    return f"copy {path['copy_bytes']} B, {path['passes']} TF32 pass{'es' if path['passes'] > 1 else ''}"


@contextlib.contextmanager
def _copy_forced(width: int):
    """K1's code copies forced to `width` bytes (an earlier path, timed beside
    the current one in the same run)."""
    from zvec_tpu_torch.ops import flat_scan as fs

    prev = fs.copy_bytes
    fs.copy_bytes = lambda row_bytes, ptr: width
    try:
        yield
    finally:
        fs.copy_bytes = prev


def phase_toolchain() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card")
    import zvec_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from zvec_tpu_torch.ops.runtime import DEVICE_ENV, device

    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True, text=True, check=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    log(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    if device().type != "cuda":
        raise AssertionError(f"the port's device is {device()}, not the card ({DEVICE_ENV}="
                             f"{os.environ.get(DEVICE_ENV)!r})")
    log(f"port device: {device()} ({DEVICE_ENV} {os.environ.get(DEVICE_ENV, 'unset')})")
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
            path = _k1_path(codes)
            log(
                f"kernel {ctype:>4} {metric:<6} mask={'30%' if mask is sparse else 'none'} ({_path_text(path)}): "
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
                                 library_ms=case_lib_ms, roofline=bound["bound_ms"] / k_ms, **path)
            del codes, norms
    return main_case


def _topk_chunks(queries: torch.Tensor, score, k: int, chunk: int = 256):
    """Top-k of score(query block) -> (block, N) scores on the card, a block
    of `chunk` queries at a time: (scores, ids)."""
    best_s, best_i = [], []
    for lo in range(0, queries.shape[0], chunk):
        s, i = torch.topk(score(queries[lo : lo + chunk]), k, dim=1)
        best_s.append(s)
        best_i.append(i)
    return torch.cat(best_s), torch.cat(best_i)


def _exact_oracle(X: torch.Tensor, queries: torch.Tensor, k: int = K + 1):
    """Exact L2 top-k (k + 1 by default) on the card: float32 products, no TF32."""
    xn = (X * X).sum(1)
    return _topk_chunks(queries, lambda qb: -((qb * qb).sum(1)[:, None] + xn[None, :] - 2.0 * (qb @ X.T)), k)


def _ids(results) -> np.ndarray:
    return np.array([[int(d.id) for d in docs] for docs in results], dtype=np.int64)


def _data():
    """The data of bench.py:309-312 (queries first, then the corpus)."""
    rng = np.random.default_rng(SEED)
    queries = rng.standard_normal((Q, D)).astype(np.float32)
    qset = [np.roll(queries, i, axis=0) for i in range(4)]
    X = rng.standard_normal((N, D), dtype=np.float32)
    return qset, X


def phase_main_path(workdir: Path, qset, X, base: dict) -> int:
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
    base.update(flat_ids=got, flat_ms=batch_s * 1e3)  # for the mesh phase
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


def _own_stage1_keys(ts, ti, q, x, norms, mask):
    """Each (key, group id) pair of an L2 stage one (tiles, k, Q) against its
    group's exact key: the max over the group's rows (group g of tile t:
    rows t * tile + g % 128 + 128 j) of 2 q.x - |x|^2, in fp64 from the same
    inputs. Returns (max |key - exact|, pairs outside stage one's
    tolerances, (tile, query) lists that hold an id twice)."""
    from zvec_tpu_torch.ops.flat_scan import NEG_INF

    tiles = ts.shape[0]
    group = x.shape[0] // tiles // 128
    xd = x.double()
    nd = torch.where(mask != 0, norms.double(), torch.full_like(norms, float("inf"), dtype=torch.float64))
    worst, outside = 0.0, 0
    for lo in range(0, q.shape[0], 128):
        qb = q[lo : lo + 128].double()
        exact = (2.0 * (qb @ xd.T) - nd).view(qb.shape[0], tiles, group, 128).amax(2).reshape(qb.shape[0], -1)
        ids = ti[:, :, lo : lo + 128].permute(2, 0, 1).reshape(qb.shape[0], -1).long()
        keys = ts[:, :, lo : lo + 128].permute(2, 0, 1).reshape(qb.shape[0], -1).double()
        valid = ids >= 0
        e = torch.gather(exact, 1, ids.clamp(min=0))
        diff = torch.where(valid, (keys - e).abs(), torch.zeros_like(keys))
        worst = max(worst, float(diff.max()))
        outside += int(((diff > STAGE1_ATOL + STAGE1_RTOL * e.abs()) & valid).sum())
        outside += int((~valid & (keys > NEG_INF / 2)).sum())
        del exact, ids, keys, valid, e, diff
    srt = torch.sort(ti, dim=1).values
    repeats = int(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum())
    return worst, outside, repeats


def _own_final_scores(ks, ki, ps, q, x, norms, width):
    """Final L2 top-k rows (Q, k): every returned id at its own exact score
    -(|q|^2 + |x|^2 - 2 q.x) (fp64, the given norms) and every score at the
    plain version's score of the same rank, each within the row's `width`;
    no id twice in a row. Returns (max |score - exact| / width, max |score -
    plain| / width, bad rows)."""
    own, rank, bad = 0.0, 0.0, 0
    srt = torch.sort(ki, dim=1).values
    bad_rows = (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    for lo in range(0, q.shape[0], 256):
        qb, ib = q[lo : lo + 256].double(), ki[lo : lo + 256].clamp(min=0)
        exact = -((qb * qb).sum(1)[:, None] + norms[ib].double()
                  - 2.0 * torch.einsum("qd,qkd->qk", qb, x[ib].double()))
        w = width[lo : lo + 256, None].double()
        d_own = (ks[lo : lo + 256].double() - exact).abs() / w
        d_rank = (ks[lo : lo + 256] - ps[lo : lo + 256]).abs().double() / w
        own, rank = max(own, float(d_own.max())), max(rank, float(d_rank.max()))
        bad_rows[lo : lo + 256] |= ((d_own > 1.0) | (d_rank > 1.0)).any(dim=1)
    return own, rank, int(bad_rows.sum())


def _k1_at_build_shape(x, mask, q, norms, metric: str, label: str, bound: dict, lib_ms,
                       own_width=None, unpadded_d=None) -> dict:
    """K1 against its plain version where the HNSW build calls it
    (`ops/hnsw.py::knn_build_step`: the queries are code rows, each finds
    itself): stage one and the final top-K_BUILD under phase 3b's
    tolerances, then the times. Raises on a disagreement.

    With `own_width` (Q,) (L2 on MIPS-augmented rows, which all share one
    norm, so ids swap among keys that cancel to a few ulps of |q|^2 + max
    |x|^2) ids are held by their own keys instead of by the share that
    moved: every stage-one id carries its group's exact key within stage
    one's tolerances, and every final id its own exact score, at the plain
    version's score of the same rank, within `own_width`.

    With `unpadded_d` (x and q are the build's scan codes, zero-padded from
    unpadded_d columns to 16-byte rows, as HnswEngine pads a MIPS build on
    the card) stage one on the unpadded rows, on their 4-byte copies and on
    byte loads (the path before), must give the same keys and ids bit for
    bit, and both are timed."""
    from zvec_tpu_torch.ops import flat_scan as fs
    from zvec_tpu_torch.typing import MetricType

    kw = dict(metric=MetricType[metric], topk=K_BUILD)
    args = (q, x, norms, mask)
    ts_k, ti_k = fs.flat_scan_stage1(*args, **kw)
    ts_p, ti_p = fs.flat_scan_stage1(*args, plain=True, **kw)
    torch.cuda.synchronize()
    s1_err = float((ts_k - ts_p).abs().max())
    s1_ok = torch.allclose(ts_k, ts_p, rtol=STAGE1_RTOL, atol=STAGE1_ATOL)
    moved = ti_k != ti_p
    swaps = float(moved.float().mean())
    unpadded = {}
    if unpadded_d is not None:
        xu, qu = x[:, :unpadded_d].contiguous(), q[:, :unpadded_d].contiguous()
        uargs = (qu, xu, norms, mask)
        for width in (None, 1):
            with contextlib.nullcontext() if width is None else _copy_forced(width):
                us, ui = fs.flat_scan_stage1(*uargs, **kw)
                if not (torch.equal(us, ts_k) and torch.equal(ui, ti_k)):
                    raise AssertionError(f"{label}: stage one on the unpadded rows differs from the padded one "
                                         f"(copy {width or _k1_path(xu)['copy_bytes']} B)")
                key = f"unpadded_copy{width or _k1_path(xu)['copy_bytes']}_ms"
                unpadded[key] = time_ms(lambda: fs.flat_scan_stage1(*uargs, **kw))
        del xu, qu, uargs, us, ui
    if own_width is None:
        ids_ok, s1_text = swaps <= STAGE1_MAX_ID_SWAPS, f"id swaps {swaps:.2e}"
    else:
        moved_dkey = float((ts_k - ts_p).abs()[moved].max()) if bool(moved.any()) else 0.0
        own_err, outside, repeats = _own_stage1_keys(ts_k, ti_k, q, x, norms, mask)
        ids_ok = outside == 0 and repeats == 0
        s1_text = (f"ids moved {int(moved.sum())} ({swaps:.2e}), max |dkey| among them {moved_dkey:.3g}; "
                   f"max |key - exact key of its id| {own_err:.3g} ({outside} outside tolerance, {repeats} "
                   f"repeated ids)")
    del ts_k, ti_k, ts_p, ti_p, moved
    ks, ki = fs.flat_scan_topk(*args, **kw)
    ps, pi = fs.flat_scan_topk_plain(*args, **kw)
    if own_width is None:
        bad, differ, final_err = _check_final_at_k(ks, ki, ps, pi)
        final_text = f"final rows differing {differ} (outside ties {bad}) max|dscore| {final_err:.3g}"
    else:
        _, differ, final_err = _check_final_at_k(ks, ki, ps, pi)
        own_r, rank_r, bad = _own_final_scores(ks, ki, ps, q, x, norms, own_width)
        final_text = (f"final rows differing {differ}, max|dscore| where equal {final_err:.3g}; of the width "
                      f"(median {float(own_width.median()):.3g}): max |score - exact score of its id| "
                      f"{own_r:.3f}, max |score - plain score at its rank| {rank_r:.3f}; bad rows {bad}")
    finite = bool(torch.isfinite(ks).all()) and bool((ki >= 0).all())
    del ks, ki, ps, pi
    k_ms = time_ms(lambda: fs.flat_scan_stage1(*args, **kw))
    p_ms = time_ms(lambda: fs.flat_scan_stage1(*args, plain=True, **kw))
    kf_ms = time_ms(lambda: fs.flat_scan_topk(*args, **kw))
    pf_ms = time_ms(lambda: fs.flat_scan_topk_plain(*args, **kw))
    path = _k1_path(x)
    log(
        f"kernel {label} fp32 {metric:<6} N={x.shape[0]} D={x.shape[1]} Q={q.shape[0]} k={K_BUILD} "
        f"({_path_text(path)}): stage1 max|dkey| {s1_err:.3g} {s1_text}; {final_text}; "
        f"stage1 {k_ms:.3f} ms vs plain {p_ms:.3f} ms"
        + "".join(f"; on the {unpadded_d} unpadded columns, keys and ids bitwise the same, "
                  f"{k.split('_')[1][4:]}-byte copies {v:.3f} ms" for k, v in unpadded.items()) + "; "
        f"full scan {kf_ms:.3f} ms vs plain {pf_ms:.3f} ms; " + _bound_text(bound, k_ms, lib_ms)
    )
    if not (s1_ok and ids_ok and bad == 0 and finite):
        raise AssertionError(f"kernel disagrees with plain version at the {label}: {metric}")
    return dict(max_abs_err=s1_err, ms=k_ms, plain_ms=p_ms, full_ms=kf_ms, full_plain_ms=pf_ms,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"], library_ms=lib_ms,
                roofline=bound["bound_ms"] / k_ms, **path, **unpadded)


def phase_kernel_build_shape() -> dict:
    """K1 at the 1M x 128 HNSW build's shape: 2048 code rows a scan."""
    from zvec_tpu_torch.ops import flat_scan as fs

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn((N_BUILD_PAD, D), generator=g, device=dev)
    x[N:] = 0.0
    mask = (torch.arange(N_BUILD_PAD, device=dev) < N).to(torch.int8)
    q = x[:Q_BUILD].contiguous()
    sq = (x * x).sum(1)
    bound = _bound(Q_BUILD, N_BUILD_PAD, D, K_BUILD, fs.pick_tile(N_BUILD_PAD, K_BUILD), x)
    lib_ms = _library_ms(q, x)
    out = {metric: _k1_at_build_shape(x, mask, q, torch.sqrt(sq) if metric == "COSINE" else sq,
                                      metric, "build shape", bound, lib_ms)
           for metric in ("L2", "COSINE")}
    del x, q, sq, mask
    return out


def _beam_on(engine, qs: np.ndarray, dev: torch.device, cpu_cache: dict, **kw):
    """The engine's beam on `dev`, on CPU copies of its tensors for the CPU. A
    routed engine's beam walks its route tier and re-ranks on the fp32 codes."""
    from zvec_tpu_torch.ops.hnsw import hnsw_search

    g = engine._dev
    if dev.type == "cpu" and not cpu_cache:
        route = engine._route
        cpu_cache.update(
            codes=engine._codes.cpu(), norms=engine._norms.cpu(), l0=g["l0"].cpu(),
            route=None if route is None else (route[0].cpu(), route[1].cpu(), route[2]),
            **{k: [x.cpu() for x in g[k]] for k in ("upper_ids", "upper_nbrs", "upper_down")},
        )
    t = cpu_cache if dev.type == "cpu" else dict(g, codes=engine._codes, norms=engine._norms,
                                                  route=engine._route)
    if t["route"] is None:
        walk, refine = (t["codes"], t["norms"], engine._dequant), (None, None)
    else:
        walk, refine = t["route"], (t["codes"], t["norms"])
    if kw.get("group_codes") is not None:
        kw["group_codes"] = kw["group_codes"].to(dev)
    budget = min(max(10_000, int(0.1 * engine._n)), engine._n)
    return hnsw_search(
        torch.from_numpy(qs).to(dev), walk[0], walk[1], t["l0"], t["upper_ids"],
        t["upper_nbrs"], t["upper_down"], g["entry_rows"], None, budget, walk[2], *refine,
        metric=engine._search_metric, ef=BEAM_CHECK_EF, max_steps=BEAM_CHECK_EF + 64,
        num_levels=g["num_levels"], frontier=4, done_frac=1.0,
        int4_packed=t["route"] is None and engine._int4_packed, **kw,
    )


def _beam_check(engine, qs: np.ndarray, label: str, visited_bits: int = 0, group_codes=None) -> None:
    """The engine's beam on its CUDA tensors against the same beam on CPU
    copies of them: ids equal, scores within BEAM_RTOL, except rows whose
    differing ids all score within BEAM_RTOL of the row's k-th score. With
    `group_codes`, the grouped beam's harvest buffers are held alike."""
    cpu_cache: dict = {}
    kw = dict(topk=K, visited_bits=visited_bits)
    cuda = [x.cpu() for x in _beam_on(engine, qs, torch.device("cuda"), cpu_cache, **kw)]
    t0 = time.perf_counter()
    cpu = _beam_on(engine, qs, torch.device("cpu"), cpu_cache, **kw)
    cpu_s = time.perf_counter() - t0
    what = [("beam", cuda, cpu)]
    if group_codes is not None:
        gq = qs[:GRP_BEAM_Q]
        gkw = dict(topk=1, visited_bits=visited_bits, group_codes=group_codes,
                   group_cap=GRP_BEAM_CAP, group_topk=GRP_TOPK)
        gc_ = [x.cpu() for x in _beam_on(engine, gq, torch.device("cuda"), cpu_cache, **gkw)]
        gp = _beam_on(engine, gq, torch.device("cpu"), cpu_cache, **gkw)
        if not torch.equal(torch.where(gc_[3] >= 0, gc_[4], -1), gc_[4]):
            raise AssertionError(f"{label}: the grouped beam kept a group code on an empty lane")
        what.append((f"grouped beam (cap {GRP_BEAM_CAP}, {GRP_TOPK} per group)", gc_[2:4], gp[2:4]))
    for name, (cs, ci), (ps, pi) in ((n, a[:2], b[:2]) for n, a, b in what):
        bad, differ, err = _check_final_at_k(cs, ci, ps, pi, rtol=BEAM_RTOL)
        valid = ps > -1e30
        scale = max(float(ps[valid].abs().max()), 1.0)
        log(f"{label}: CUDA {name} vs CPU {name} on {len(cs)} queries at ef={BEAM_CHECK_EF}, "
            f"visited_bits={visited_bits}: {differ} rows differ ({bad} outside near-ties), "
            f"max |dscore| {err:.3g} on equal rows; CPU beam {cpu_s:.2f} s")
        if bad or err > BEAM_RTOL * scale:
            raise AssertionError(f"{label}: the CUDA {name} disagrees with the CPU {name}")


def _profiled(label: str, fn, gather_shape=None):
    """Run fn() once warm, then once under torch.profiler: print the wall
    time, the device busy share and the top device ops (self device time).
    With `gather_shape` (rows, cols of a code table), also return the share of
    device time spent in gathers from tables of that shape (`aten::index` on
    it: the beam's code gathers and, when routed, the refine's fp32 gather)."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=gather_shape is not None) as prof:
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
    if gather_shape is None:
        return None
    gather = 0.0
    for ev in prof.key_averages(group_by_input_shape=True):
        shapes = getattr(ev, "input_shapes", None) or [[]]
        if ev.key == "aten::index" and list(shapes[0]) == list(gather_shape):
            dt = getattr(ev, "device_time_total", None)
            gather += (getattr(ev, "cuda_time_total", 0.0) if dt is None else dt) / 1e3
    if gather <= 0.0:
        log(f"  code gathers from ({gather_shape[0]}, {gather_shape[1]}) tables: not measured "
            f"(no device time on aten::index with that input shape)")
        return None
    log(f"  code gathers from ({gather_shape[0]}, {gather_shape[1]}) tables: {gather:.3f} ms, "
        f"{100 * gather / busy:.1f}% of device time")
    return gather / busy


def _profile_build_batch(engine, X) -> None:
    """One forward batch (`knn_build_step`: K1 + stage two + prune) of the 1M
    build, profiled on the build's padded codes."""
    from zvec_tpu_torch.ops.hnsw import knn_build_step

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


def _group_by_check(col, X, grp: np.ndarray, queries: np.ndarray, label: str, *,
                    ef: int, min_pairs: float, min_leaders: float) -> None:
    """group_by_query (the groups harvested inside the beam) against the
    same grouping worked out from the exact oracle's top-GRP_ORACLE_K: at
    most GRP_TOPK rows per group, of those the best GRP_CAP rows (the harvest
    buffer's width; a group whose second member ranks past it keeps one), then
    the GRP_COUNT groups with the best leaders. A (query, group) pair agrees
    when the oracle's group is returned with the oracle's members; its leader
    agrees when the group's best member does. The share of pairs equal to the
    grouping with no buffer limit is printed beside it."""
    import zvec_tpu_torch as zt

    dev = torch.device("cuda")
    qs = queries[:GRP_Q]
    _, oi = _exact_oracle(torch.from_numpy(X).to(dev), torch.from_numpy(qs).to(dev), k=GRP_ORACLE_K)
    param = zt.HnswQueryParam(ef=ef, done_frac=1.0)
    passes = []
    orig = col._impl._grouped_beam_pass
    col._impl._grouped_beam_pass = lambda *a, **k: passes.append(orig(*a, **k)) or passes[-1]
    pairs = unlimited = leaders = total = 0
    times = []
    for r, row in enumerate(oi.cpu().numpy()):
        full: dict = {}  # group -> members, groups in order of their best member
        kept = []  # the rows a group's quota admits, best first
        for i in row:
            members = full.setdefault(int(grp[i]), [])
            if len(members) < GRP_TOPK:
                members.append(int(i))
                kept.append(int(i))
        want: dict = {}
        for i in kept[:GRP_CAP]:
            want.setdefault(int(grp[i]), []).append(i)
        if sum(len(m) == GRP_TOPK for m in want.values()) < GRP_COUNT:
            want = full  # too few full groups in the buffer: the query deepens instead
        want = dict(list(want.items())[:GRP_COUNT])
        full = dict(list(full.items())[:GRP_COUNT])
        t0 = time.perf_counter()
        docs = col.group_by_query(
            zt.VectorQuery("vec", vector=qs[r], param=param), group_by_field="grp",
            group_count=GRP_COUNT, group_topk=GRP_TOPK, output_fields=["grp"],
        )
        times.append(time.perf_counter() - t0)
        got: dict = {}
        for d in docs:
            got.setdefault(int(d.fields["grp"]), []).append(int(d.id))
        if len(got) != GRP_COUNT or any(len(v) > GRP_TOPK for v in got.values()):
            raise AssertionError(f"{label} group-by: wrong number of groups or members")
        pairs += sum(got.get(g) == members for g, members in want.items())
        unlimited += sum(got.get(g) == members for g, members in full.items())
        leaders += sum(got.get(g, [-1])[0] == members[0] for g, members in want.items())
        total += len(want)
    del col._impl._grouped_beam_pass
    t0 = time.perf_counter()
    for r in range(GRP_PLAIN_Q):
        col.query(zt.VectorQuery("vec", vector=qs[r], param=param), topk=K, output_fields=[])
    plain_ms = (time.perf_counter() - t0) / GRP_PLAIN_Q * 1e3
    in_beam = sum(p is not None for p in passes)
    log(f"{label} group-by: ef={ef}: {GRP_Q} group_by_query calls ({GRP_COUNT} groups x {GRP_TOPK}, "
        f"{GRP_VALUES} values): {pairs}/{total} (query, group) pairs ({pairs / total:.4f}, floor "
        f"{min_pairs}) equal the grouping of the exact top-{GRP_ORACLE_K} through a buffer of "
        f"{GRP_CAP} rows ({unlimited / total:.4f} with no buffer limit), {leaders}/{total} group "
        f"leaders ({leaders / total:.4f}, floor {min_leaders}); {statistics.median(times) * 1e3:.2f} ms "
        f"per call (median; a plain top-{K} query {plain_ms:.2f} ms, mean of {GRP_PLAIN_Q}); in-beam passes {in_beam} of "
        f"{len(passes)}")
    if in_beam != GRP_Q:
        raise AssertionError(f"{label} group-by: a call did not take the in-beam pass")
    if pairs < min_pairs * total or leaders < min_leaders * total:
        raise AssertionError(f"{label} group-by: the grouping is too far from the exact oracle's")


def phase_hnsw(workdir: Path, qset, X, base: dict) -> int:
    """The HNSW path: build on the card, query at three ef, group by, check, reopen."""
    import zvec_tpu_torch as zt
    from zvec_tpu_torch.ops.flat_scan import flat_scan_topk
    from zvec_tpu_torch.ops.hnsw import hnsw_search

    # HnswIndexParam's own default metric is IP; the SIFT1M shape and the
    # reference curve are L2, so only the metric is set (m, efc default)
    schema = zt.CollectionSchema(
        "hnsw1m",
        fields=[zt.FieldSchema("grp", zt.DataType.INT64)],
        vectors=[zt.VectorSchema("vec", zt.DataType.VECTOR_FP32, D, zt.HnswIndexParam(zt.MetricType.L2))],
    )
    grp = np.random.default_rng(SEED + 3).integers(0, GRP_VALUES, N)
    path = workdir / "hnsw1m"
    flat_scan_topk.launches = 0
    t0 = time.perf_counter()
    col = zt.create_and_open(str(path), schema)
    for lo in range(0, N, 1024):
        col.insert([zt.Doc(id=str(i), vectors={"vec": X[i]}, fields={"grp": int(grp[i])})
                    for i in range(lo, min(lo + 1024, N))])
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
    base["hnsw_recall"] = recalls
    param = zt.HnswQueryParam(ef=256, done_frac=1.0)
    _profiled(f"hnsw beam batch ef=256 ({Q} queries)", lambda: engine.search(qset[0], K, None, param))
    _profile_build_batch(engine, X)
    _group_by_check(col, X, grp, qset[0], "hnsw", **GRP_GAUSSIAN)
    beam_qs = np.random.default_rng(SEED + 2).standard_normal((BEAM_CHECK_Q, D)).astype(np.float32)
    _beam_check(engine, beam_qs, "hnsw", group_codes=torch.from_numpy(grp.astype(np.int32)))
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


def make_clustered(n: int, dim: int, nq: int):
    """`benchmarks/h2h.py::make_data("clustered", n, dim, nq)`, copied draw
    for draw (its SEED = 1234): well-separated centres, one per 10,000 rows
    and at least 32, plus unit noise."""
    rng = np.random.default_rng(1234)
    k = max(32, n // 10_000)
    centers = rng.standard_normal((k, dim)).astype(np.float32) * 5.0
    asn = rng.integers(0, k, n)
    X = centers[asn] + rng.standard_normal((n, dim)).astype(np.float32)
    qn = rng.integers(0, k, nq)
    queries = centers[qn] + rng.standard_normal((nq, dim)).astype(np.float32)
    return X, queries


def mips_data(n: int, nq: int):
    """The text2image shape: make_data("clustered", n, MI_D)'s rows as
    directions, each scaled to a lognormal norm (so IP, COSINE and L2 rank
    differently), and unit queries near the same centres with twice the
    corpus's noise, drawn from their own seed (text queries lie off an image
    corpus)."""
    X, _ = make_clustered(n, MI_D, 0)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    X *= np.random.default_rng(MI_NORM_SEED).lognormal(0.0, MI_NORM_SIGMA, n).astype(np.float32)[:, None]
    k = max(32, n // 10_000)
    centers = np.random.default_rng(1234).standard_normal((k, MI_D)).astype(np.float32) * 5.0  # make_data's
    rng = np.random.default_rng(MI_Q_SEED)
    Q = centers[rng.integers(0, k, nq)] + MI_Q_NOISE * rng.standard_normal((nq, MI_D)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=1, keepdims=True)  # unit queries: IP ranks by norm x cosine, L2 does not
    return X, Q


def config3_data(n: int, nq: int):
    """`benchmarks/bench_suite.py::stage_int8_hnsw`'s GloVe-100-shaped rows
    and queries, copied draw for draw (its SEED = 7)."""
    rng = np.random.default_rng(CD_HNSW_SEED)
    kc = max(16, n // 10_000)
    centers = rng.standard_normal((kc, CD_HNSW_D)).astype(np.float32) * 3.0
    asn = rng.integers(0, kc, n)
    X = (centers[asn] + rng.standard_normal((n, CD_HNSW_D)).astype(np.float32)).astype(np.float32)
    Q = (centers[rng.integers(0, kc, nq)]
         + rng.standard_normal((nq, CD_HNSW_D)).astype(np.float32)).astype(np.float32)
    return X, Q


def hamming_data(n: int, nq: int):
    """(n, HM_BITS) and (nq, HM_BITS) 0/1 codes: one random centre per
    10,000 rows (at least 32), each row its centre with every bit flipped
    with probability HM_FLIP (queries HM_Q_FLIP)."""
    rng = np.random.default_rng(HM_SEED)
    k = max(32, n // 10_000)
    centers = rng.integers(0, 2, (k, HM_BITS), dtype=np.uint8)
    asn = rng.integers(0, k, n)
    X = np.empty((n, HM_BITS), np.uint8)
    for lo in range(0, n, 1 << 17):
        hi = min(lo + (1 << 17), n)
        X[lo:hi] = centers[asn[lo:hi]] ^ (rng.random((hi - lo, HM_BITS), dtype=np.float32) < HM_FLIP)
    Q = centers[rng.integers(0, k, nq)] ^ (rng.random((nq, HM_BITS), dtype=np.float32) < HM_Q_FLIP)
    return X, Q.astype(np.uint8)


def _ivf_data():
    """bench_suite.py's config #4: make_data("clustered", ...) for vectors and
    queries, then tags and prices from default_rng(SEED + 1) with its SEED = 7."""
    rng = np.random.default_rng(7 + 1)
    X, queries = make_clustered(IVF_N, IVF_D, nq=Q)
    tags = rng.integers(0, 10, IVF_N)  # 'tag = tN' selects ~10%
    price = rng.random(IVF_N)
    return X, queries, tags, price


def _recall(got: np.ndarray, exp: np.ndarray) -> float:
    return float(np.mean([len(set(got[r]) & set(exp[r])) for r in range(len(got))]) / exp.shape[1])


def _probe_check(engine, queries: np.ndarray, dev: torch.device, label: str = "ivf") -> None:
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
    log(f"{label}: CUDA probe vs CPU probe on {PROBE_CHECK_Q} queries at nprobe={PROBE_CHECK_NPROBE} "
        f"(+{engine._extra_probes} for split lists), top-{2 * K}: {differ} rows differ "
        f"({bad} outside near-ties), max |dscore| {err:.3g} on equal rows; CPU probe {cpu_s:.2f} s")
    if bad or err > PROBE_RTOL * scale:
        raise AssertionError(f"{label}: the CUDA probe disagrees with the CPU probe")


def phase_ivf(workdir: Path, dev: torch.device, base: dict) -> int:
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
            base["ivf_recall16"] = recall
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


def _bucket_knn_check(engine, X: np.ndarray, dev: torch.device) -> None:
    """bucket_knn_all on the card against the same call on CPU copies, for the
    first buckets of the real build on bf16 codes: per half-row the same id
    set, except ids whose similarity lies within BUCKET_RTOL of the row's
    kc-th (a near-tie at the boundary)."""
    from zvec_tpu_torch.ops.hnsw import bucket_knn_all

    info = engine.build_info
    rows_bkt, slot_bkt = (a[:CL_BUCKETS] for a in info["bucket_sample"])
    kc = info["kc"]
    # the buckets' members in a compact row space: the same products, small tables
    uniq, inv = np.unique(rows_bkt[rows_bkt >= 0], return_inverse=True)
    rows_c = np.full(rows_bkt.shape, -1, np.int32)
    rows_c[rows_bkt >= 0] = inv
    n = len(uniq)
    codes = torch.from_numpy(X[uniq]).bfloat16()
    norms2 = torch.from_numpy((X[uniq] ** 2).sum(1))
    out = {}
    for d in (dev, torch.device("cpu")):
        cand = torch.full((n + 1, 2 * kc), -1, dtype=torch.int32, device=d)
        t0 = time.perf_counter()
        bucket_knn_all(torch.from_numpy(rows_c).to(d), torch.from_numpy(slot_bkt).to(d), cand,
                       codes.to(d), norms2.to(d), metric=engine._search_metric, kc=kc)
        out[d.type] = (cand[:n].cpu().numpy(), time.perf_counter() - t0)
    got, ref = out[dev.type][0], out["cpu"][0]
    vals = codes.double().numpy()
    differ = bad = 0
    for half in (0, 1):
        g, r = got[:, half * kc : (half + 1) * kc], ref[:, half * kc : (half + 1) * kc]
        rows = np.flatnonzero((np.sort(g, 1) != np.sort(r, 1)).any(1))
        differ += len(rows)
        for i in rows:
            sim = lambda ids: -((vals[ids] - vals[i]) ** 2).sum(1)  # noqa: E731
            kth = sim(r[i][r[i] >= 0]).min()
            odd = np.array(sorted(set(g[i].tolist()) ^ set(r[i].tolist())))
            bad += bool((odd < 0).any()) or bool((np.abs(sim(odd) - kth) > BUCKET_RTOL * abs(kth)).any())
    filled = int((ref >= 0).any(1).sum())
    log(f"hnsw clustered: bucket_knn_all card vs CPU on {CL_BUCKETS} buckets of the build "
        f"(mp {rows_bkt.shape[1]}, kc {kc}, {n} members, bf16 codes): {differ} of {2 * n} half-rows "
        f"differ ({bad} outside near-ties); card {out[dev.type][1]:.3f} s, CPU {out['cpu'][1]:.2f} s")
    if bad or filled != n:
        raise AssertionError("hnsw clustered: bucket_knn_all on the card disagrees with the CPU")


def _profile_clustered_batch(engine, X: np.ndarray, dev: torch.device) -> None:
    """One forward-prune batch and one NN-descent batch of the clustered build
    (B = 2048 rows, bf16 codes), profiled. The build's own candidate table and
    first adjacency are gone by now; the final graph's rows stand in for them
    (a row's neighbours plus those of its best neighbour, 128 lanes)."""
    from zvec_tpu_torch.ops.hnsw import merge_prune_batch_out, nn_descent_round

    n, m0 = engine._n, engine.m0_out()
    codes = torch.from_numpy(X).to(dev).bfloat16()
    norms2 = torch.from_numpy((X * X).sum(1)).to(dev)
    l0 = engine._dev["l0"][:n]
    fwd = torch.cat([l0, torch.full((1, m0), -1, dtype=l0.dtype, device=dev)])
    kc = engine.build_info["kc"]
    cand = torch.cat([l0, l0[l0[:, 0].long().clamp_min(0)][:, : 2 * kc - m0]], dim=1)
    cand = torch.cat([cand, torch.full((1, 2 * kc), -1, dtype=l0.dtype, device=dev)])
    rows = torch.arange(Q_BUILD, device=dev)[None, :]
    kw = dict(metric=engine._search_metric, max_out=m0)
    expand = max(1, min(4, 256 // m0))
    _profiled(f"hnsw clustered forward-prune batch (B={Q_BUILD}, C={2 * kc})",
              lambda: merge_prune_batch_out(rows, cand, codes, norms2, **kw))
    _profiled(f"hnsw clustered NN-descent batch (B={Q_BUILD}, expand={expand}, "
              f"C={m0 * (1 + expand)} -> window {2 * m0})",
              lambda: nn_descent_round(rows, fwd, codes, norms2, expand=expand, **kw))


def _search_timed(engine, queries: np.ndarray, ef: int):
    """The engine's own search at ef with every other knob at its default:
    (sims, ids, median ms of 3 batches after the first)."""
    import zvec_tpu_torch as zt

    param = zt.HnswQueryParam(ef=ef)
    sims, idx = engine.search(queries, K, None, param)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.search(queries, K, None, param)
        times.append(time.perf_counter() - t0)
    return sims, idx, statistics.median(times) * 1e3


def _routed_sweep(engine, path: Path, X: np.ndarray, queries: np.ndarray, exp: np.ndarray,
                  vbits: int) -> None:
    """Routed traversal on the clustered graph: the collection's graph file
    loaded into an engine with an int8 route tier, then one with a bf16 tier
    (no graph build), each swept at RT_EFS beside the unrouted engine: recall@10
    against the exact oracle, ms per 1024-query batch, the largest error of a
    returned score against its exact fp32 score, the route's build seconds,
    peak device memory, a profiled ef=128 batch (the code gathers' share of
    device time) and the routed beam card against CPU on RT_CHECK_Q queries."""
    import zvec_tpu_torch as zt
    from zvec_tpu_torch.core.hnsw import HnswEngine
    from zvec_tpu_torch.ops.kmeans import lloyd

    aux = next(path.rglob("hnsw_*.npz"))
    shape = tuple(engine._codes.shape)
    base = {}
    for ef in RT_EFS:
        _, idx, ms = _search_timed(engine, queries, ef)
        base[ef] = (_recall(idx, exp), ms)
    param = zt.HnswQueryParam(ef=128)
    base_share = _profiled(f"hnsw clustered beam ef=128, unrouted ({Q} queries)",
                           lambda: engine.search(queries, K, None, param), gather_shape=shape)
    xq = queries.astype(np.float64)
    calls = lloyd.calls
    for mode in ("int8", "bf16"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = HnswEngine(zt.MetricType.L2, D, zt.HnswIndexParam(
            zt.MetricType.L2, m=50, ef_construction=500, route_quantize=mode))
        eng.load_aux(str(aux.parent), {"file": aux.name})
        eng.bind_data(lambda: X, lambda: 1)
        t0 = time.perf_counter()
        eng._ensure_fresh()
        load_s = time.perf_counter() - t0
        route = eng._route
        if route is None or route[0].device != engine._codes.device or set(eng.build_times) != {"route"}:
            raise AssertionError(f"hnsw clustered route {mode}: no route tier on the card, or a graph build")
        if lloyd.calls != calls or not np.array_equal(eng._graph.l0, engine._graph.l0):
            raise AssertionError(f"hnsw clustered route {mode}: the engine did not load the collection's graph")
        log(f"hnsw clustered route {mode}: {aux.name} loaded into a routed engine in {load_s:.2f} s "
            f"(route tier {route[0].dtype} {tuple(route[0].shape)}, built in {eng.build_times['route']:.2f} s)")
        worst_abs = worst_rel = 0.0
        for ef in RT_EFS:
            sims, idx, ms = _search_timed(eng, queries, ef)
            rec = _recall(idx, exp)
            if idx.shape != (Q, K) or (idx < 0).any() or not np.isfinite(sims).all():
                raise AssertionError(f"hnsw clustered route {mode}: results are not (1024, 10) finite scores")
            exact = -((X[idx].astype(np.float64) - xq[:, None, :]) ** 2).sum(-1)
            err = np.abs(sims - exact)
            worst_abs = max(worst_abs, float(err.max()))
            worst_rel = max(worst_rel, float((err / np.maximum(np.abs(exact), 1.0)).max()))
            b_rec, b_ms = base[ef]
            log(f"hnsw clustered route {mode}: ef={ef}: {ms:.2f} ms per {Q}-query batch (median of 3; "
                f"unrouted {b_ms:.2f} ms), recall@{K} {rec:.4f} (unrouted {b_rec:.4f}, "
                f"{rec - b_rec:+.4f})")
            if rec < b_rec - RT_MAX_RECALL_LOSS:
                raise AssertionError(f"hnsw clustered route {mode}: recall@10 at ef={ef} is {rec:.4f}, "
                                     f"more than {RT_MAX_RECALL_LOSS} below the unrouted {b_rec:.4f}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"hnsw clustered route {mode}: max |score - exact fp32 score| {worst_abs:.3g} "
            f"({worst_rel:.3g} relative); route build {eng.build_times['route']:.2f} s; peak device "
            f"memory {peak_gb:.3f} GB (the unrouted collection still resident)")
        if worst_rel > RT_SCORE_RTOL:
            raise AssertionError(f"hnsw clustered route {mode}: scores are not fp32-exact")
        share = _profiled(f"hnsw clustered beam ef=128, {mode} route ({Q} queries)",
                          lambda: eng.search(queries, K, None, param), gather_shape=shape)
        if share is not None and base_share is not None:
            log(f"hnsw clustered route {mode}: code gathers {100 * share:.1f}% of device time at ef=128 "
                f"(unrouted {100 * base_share:.1f}%)")
        _beam_check(eng, queries[:RT_CHECK_Q], f"hnsw clustered route {mode}", visited_bits=vbits)
        del eng, route
    gc.collect()
    torch.cuda.empty_cache()


def live_fields(n: int):
    """`benchmarks/bench_ivf10m.py::fields_arrays` with its N = n, copied draw
    for draw (its SEED = 0x1F1F): a tag in 0..9 (`tag = 'tN'` selects ~10%),
    then a price in [0, 1)."""
    rng = np.random.default_rng(LV_FIELDS_SEED)
    tags = rng.integers(0, 10, n)
    price = rng.random(n)
    return tags, price


def clustered_fresh(n: int, dim: int, count: int, seed: int) -> np.ndarray:
    """`count` new rows of `make_clustered(n, dim, ...)`'s corpus: the same
    centres (its first draw), fresh assignments and noise from `seed`."""
    k = max(32, n // 10_000)
    centers = np.random.default_rng(1234).standard_normal((k, dim)).astype(np.float32) * 5.0
    rng = np.random.default_rng(seed)
    return centers[rng.integers(0, k, count)] + rng.standard_normal((count, dim)).astype(np.float32)


def phase_hnsw_clustered(workdir: Path, dev: torch.device, base: dict, keep: bool = False) -> int:
    """The clustered build at CL_N rows, picked by the size rule: build, sweep
    ef, check the build's pieces card against CPU, reopen. With `keep`, the
    reopened collection goes on to the live phase (in `base`), open."""
    import zvec_tpu_torch as zt
    from zvec_tpu_torch.ops.flat_scan import flat_scan_topk
    from zvec_tpu_torch.ops.hnsw import hnsw_search
    from zvec_tpu_torch.ops.kmeans import lloyd

    X, queries = make_clustered(CL_N, D, nq=Q)
    qset = [np.roll(queries, i, axis=0) for i in range(4)]
    grp = np.random.default_rng(SEED + 3).integers(0, GRP_VALUES, CL_N)
    tags, price = live_fields(CL_N)  # the live phase's fields, bench_filtered10m.py's
    schema = zt.CollectionSchema(
        "hnsw_clustered",
        fields=[
            zt.FieldSchema("grp", zt.DataType.INT64),
            zt.FieldSchema("tag", zt.DataType.STRING, index_param=zt.InvertIndexParam()),
            zt.FieldSchema("price", zt.DataType.DOUBLE),
            zt.FieldSchema("gid", zt.DataType.INT32),
        ],
        vectors=[zt.VectorSchema("vec", zt.DataType.VECTOR_FP32, D,
                                 zt.HnswIndexParam(zt.MetricType.L2, m=50, ef_construction=500))],
    )
    path = workdir / "hnsw_clustered"
    flat_scan_topk.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    col = zt.create_and_open(str(path), schema)
    for lo in range(0, CL_N, 1024):
        col.insert([zt.Doc(id=str(i), vectors={"vec": X[i]},
                           fields={"grp": int(grp[i]), "tag": f"t{tags[i]}", "price": float(price[i]),
                                   "gid": i % LV_GID_MOD})
                    for i in range(lo, min(lo + 1024, CL_N))])
    t_insert = time.perf_counter() - t0
    col.optimize()
    t_build = time.perf_counter() - t0 - t_insert
    col.flush()
    launches = flat_scan_topk.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    seg = next(s for s in col._impl._segments_snapshot() if s.doc_count > 0)
    engine = seg.engine_for("vec")
    bt, info = engine.build_times, engine.build_info
    log(f"hnsw clustered: {CL_N} x {D}: insert {t_insert:.2f} s, optimize {t_build:.2f} s, of which "
        f"the engine build (data fetch + graph + upload) {engine.stats.last_build_secs:.2f} s: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in bt.items() if k != "dump_aux")
        + f"; graph file write {bt['dump_aux']:.2f} s; peak device memory {peak_gb:.3f} GB")
    log(f"hnsw clustered: build codes {info.get('codes')}, K {info.get('K')} buckets of mp "
        f"{info.get('mp')} rows, kc {info.get('kc')}, members dropped past mp {info.get('dropped')} "
        f"of {2 * CL_N}; levels {engine._dev['num_levels']} above L0; K1 launches in the build {launches}")
    if "bucket_knn" not in bt or not info.get("clustered"):
        raise AssertionError("hnsw clustered: the size rule did not take the clustered build")
    if info["codes"] != "bfloat16":
        raise AssertionError(f"hnsw clustered: build codes were {info['codes']}, not bfloat16")
    if launches != 0:
        raise AssertionError("hnsw clustered: the clustered build launched the flat-scan kernel")
    if not (engine._codes.is_cuda and engine._dev["l0"].is_cuda):
        raise AssertionError("hnsw clustered: codes or the L0 adjacency are not on CUDA")
    vbits = engine._visited_bits(engine._query_knobs(None))
    if engine._codes.shape[0] <= (1 << 21) or vbits != 21:
        raise AssertionError("hnsw clustered: the beam does not use the hashed visited set")

    xd = torch.from_numpy(X).to(dev)
    _, oi = _exact_oracle(xd, torch.from_numpy(queries).to(dev))
    del xd
    torch.cuda.empty_cache()
    exp = oi[:, :K].cpu().numpy()
    recalls, ids_by_ef = {}, {}
    col.batch_query_many("vec", qset, topk=K, output_fields=[], param=zt.HnswQueryParam(ef=CL_EFS[0]))  # warm
    for ef in CL_EFS:
        param = zt.HnswQueryParam(ef=ef)  # the recipe's own: every other knob at its default
        first = col.batch_query("vec", queries, topk=K, output_fields=[], param=param)
        times = []
        for _ in range(2):
            t1 = time.perf_counter()
            out = col.batch_query_many("vec", qset, topk=K, output_fields=[], param=param)
            times.append((time.perf_counter() - t1) / len(qset))
        batch_s = min(times)
        got = _ids(first)
        scores = np.array([[d.score for d in docs] for docs in first], np.float32)
        if got.shape != (Q, K) or not np.isfinite(scores).all() or len(out) != len(qset):
            raise AssertionError("hnsw clustered: results are not (1024, 10) finite scores")
        recalls[ef], ids_by_ef[ef] = _recall(got, exp), got
        log(f"hnsw clustered: ef={ef}: {batch_s * 1e3:.2f} ms per 1024-query batch, "
            f"{Q / batch_s:.1f} qps (batch_query_many, {len(qset)} blocks, best of 2; "
            f"{hnsw_search.last_steps} beam steps in the last batch, visited_bits {vbits}); "
            f"recall@{K} {recalls[ef]:.4f} on {Q} queries (zvec_tpu at 10M rows: {CL_REF_CURVE_10M[ef]})")
    for ef, floor in CL_FLOORS.items():
        if recalls[ef] < floor:
            raise AssertionError(f"hnsw clustered: recall@10 at ef={ef} is {recalls[ef]:.4f} < {floor}")
    _routed_sweep(engine, path, X, queries, exp, vbits)

    _group_by_check(col, X, grp, queries, "hnsw clustered", **GRP_CLUSTERED)
    _beam_check(engine, queries[:BEAM_CHECK_Q], "hnsw clustered", visited_bits=vbits,
                group_codes=torch.from_numpy(grp.astype(np.int32)))
    _bucket_knn_check(engine, X, dev)
    _profile_clustered_batch(engine, X, dev)
    col._impl.close()
    del col, seg, engine
    gc.collect()
    torch.cuda.empty_cache()

    calls = lloyd.calls
    reopened = zt.open(str(path))
    again = _ids(reopened.batch_query("vec", queries, topk=K, output_fields=[],
                                      param=zt.HnswQueryParam(ef=CL_EFS[-1])))
    eng2 = next(s for s in reopened._impl._segments_snapshot() if s.doc_count > 0).engine_for("vec")
    loaded = eng2._loaded_aux is not None and not eng2.build_times
    if lloyd.calls != calls or not loaded or flat_scan_topk.launches != launches:
        raise AssertionError("hnsw clustered: the reopened collection rebuilt its graph")
    if not (again == ids_by_ef[CL_EFS[-1]]).all():
        raise AssertionError("hnsw clustered: reopened collection returns other ids")
    log("hnsw clustered: reopened collection loads the graph from disk (no k-means, no prune, "
        "no kernel launch) and returns identical ids")
    if keep:
        base["clustered"] = dict(col=reopened, X=X, queries=queries, grp=grp, tags=tags, price=price,
                                 recall256=recalls[256])
    else:
        reopened._impl.close()
    return launches


def _live_branches(profile: str) -> dict:
    """Per segment id, the branch a query batch took, from its profile:
    `index` (the segment's engine: the HNSW beam of a sealed segment, the flat
    scan of the writing one; stage `vector_scan`), `device scan` (brute force
    by keys: the whole segment scanned with is_linear, stage `bf_by_keys`) or
    `host exact` (a filtered segment with neither stage: `_exact_over_rows`)."""
    names = {"filter": "host exact", "vector_scan": "index", "bf_by_keys": "device scan"}
    out = {}

    def walk(node):
        kind, _, seg = node["stage"].partition(" ")
        if kind in names and out.get(seg) in (None, "host exact"):
            out[seg] = names[kind]
        for child in node.get("children", []):
            walk(child)

    walk(json.loads(profile))
    return out


def _rule_branch(n_rows: int, n_alive: int, nq: int, filtered: bool) -> str:
    """The branch the brute-force-by-keys rule (`_query_field_dispatch`) must
    pick for a segment of n_rows rows of which n_alive pass the filter."""
    if not filtered or n_alive > max(1, int(BF_RATIO * n_rows)):
        return "index"
    return "host exact" if nq * n_alive * D <= BF_HOST_WORK else "device scan"


def _live_oracle(vd: torch.Tensor, rows: np.ndarray, qd: torch.Tensor):
    """Exact L2 top-(K + 1) on the card over the rows `rows` of vd: (pks of
    the top-K, near-tie flags at the K-th row)."""
    if len(rows) <= K:
        raise AssertionError("live: a filter keeps fewer than 11 rows")
    s, i = _exact_oracle(vd[torch.from_numpy(rows).to(vd.device)], qd)
    d = -s.cpu().numpy()  # squared L2 distances, ascending
    near_tie = np.abs(d[:, K - 1] - d[:, K]) <= TIE_RTOL * np.abs(d[:, K - 1])
    return rows[i[:, :K].cpu().numpy()], near_tie


def _live_answers(docs, qs: np.ndarray, live_vec: np.ndarray, ok: np.ndarray, label: str):
    """Every returned (pk, score) of a batch is a pk that `ok` admits (alive,
    and passing the filter on its live fields) scored against its live vector
    (no deleted pk, no superseded version). Returns (ids, scores, max error)."""
    ids = np.array([[int(d.id) for d in row] for row in docs], np.int64)
    sc = np.array([[d.score for d in row] for row in docs], np.float64)
    if ids.shape != (len(qs), K) or (ids < 0).any() or not np.isfinite(sc).all():
        raise AssertionError(f"live {label}: results are not ({len(qs)}, {K}) finite scores")
    if not ok[ids].all():
        raise AssertionError(f"live {label}: {int((~ok[ids]).sum())} results are deleted pks or fail the filter")
    v = live_vec[ids].astype(np.float64)
    q = qs.astype(np.float64)[:, None, :]
    exact = ((v - q) ** 2).sum(-1)
    scale = (v * v).sum(-1) + (q * q).sum(-1)
    err = np.abs(sc - exact)
    if (err > LV_SCORE_RTOL * scale).any():
        raise AssertionError(f"live {label}: {int((err > LV_SCORE_RTOL * scale).sum())} scores are not "
                             f"their pk's live vector's (a superseded version)")
    return ids, sc, float(err.max())


def _live_recall(ids: np.ndarray, exp: np.ndarray, near_tie: np.ndarray):
    short = np.array([len(set(ids[r]) & set(exp[r])) < K for r in range(len(ids))])
    return _recall(ids, exp), int(short.sum()), int((short & ~near_tie).sum())


def _k1_at_writing_shape(engine, alive: np.ndarray, fmask: np.ndarray, queries: np.ndarray) -> dict:
    """K1 against its plain version on the writing segment's own device codes
    (its FlatEngine state), with its live delete mask and with that mask and a
    filter's: stage one and the final top-K under phase 3's tolerances, then
    the times with bound and the torch.matmul yardstick (live mask)."""
    from zvec_tpu_torch.ops import flat_scan as fs
    from zvec_tpu_torch.typing import MetricType

    st = engine._st
    dev = st.codes.device
    q = torch.from_numpy(queries).to(dev)
    out = None
    for label, m in (("live mask", alive), ("live mask and filter", alive & fmask)):
        mask = torch.zeros(st.n_pad, dtype=torch.int8, device=dev)
        mask[: st.n] = torch.from_numpy(m[: st.n].astype(np.int8)).to(dev)
        kw = dict(metric=MetricType.L2, topk=K)
        args = (q, st.codes, st.norms, mask)
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
        if label == "live mask":
            bound = _bound(q.shape[0], st.n_pad, D, K, fs.pick_tile(st.n_pad, K), st.codes)
            lib_ms = _library_ms(q, st.codes)
            k_ms = time_ms(lambda: fs.flat_scan_stage1(*args, **kw))
            p_ms = time_ms(lambda: fs.flat_scan_stage1(*args, plain=True, **kw))
            kf_ms = time_ms(lambda: fs.flat_scan_topk(*args, **kw))
            pf_ms = time_ms(lambda: fs.flat_scan_topk_plain(*args, **kw))
            out = dict(max_abs_err=s1_err, ms=k_ms, plain_ms=p_ms, full_ms=kf_ms, full_plain_ms=pf_ms,
                       bound_ms=bound["bound_ms"], bound_by=bound["bound_by"], library_ms=lib_ms,
                       roofline=bound["bound_ms"] / k_ms)
            times = (f"; stage1 {k_ms:.3f} ms vs plain {p_ms:.3f} ms; full scan {kf_ms:.3f} ms vs plain "
                     f"{pf_ms:.3f} ms; " + _bound_text(bound, k_ms, lib_ms))
        else:
            times = ""
        log(f"live kernel writing segment fp32 L2 N={st.n_pad} ({st.n} rows, {int(m[: st.n].sum())} "
            f"{label}) D={D} Q={q.shape[0]} k={K}: stage1 max|dkey| {s1_err:.3g} id swaps {swaps:.2e}; "
            f"final rows differing {differ} (outside ties {bad}) max|dscore| {final_err:.3g}" + times)
        if not (s1_ok and swaps <= STAGE1_MAX_ID_SWAPS and bad == 0 and finite):
            raise AssertionError(f"live: the kernel disagrees with its plain version ({label})")
    return out


def phase_live(dev: torch.device, base: dict) -> tuple:
    """The live, filtered collection on phase 8's collection (the reopened
    one, 2.1M rows with tag / price / gid): A. the filter grid with the path
    each filter took; B. group-by on gid; C. deletes, delete_by_filter,
    upserts, updates and 100,000 inserts into the writing segment (which K1
    then scans), checked against a plain reference of the live collection;
    D. a reader thread querying while C's inserts run; E. a crash (the impl
    closed without a flush) and the WAL replay at open. Returns (K1 launches
    in the phase, K1 against its plain version at the writing segment's
    shape)."""
    import threading

    import zvec_tpu_torch as zt
    from zvec_tpu_torch.core.flat import kernel_takes
    from zvec_tpu_torch.db.collection_impl import CollectionImpl
    from zvec_tpu_torch.ops.flat_scan import flat_scan_topk
    from zvec_tpu_torch.ops.kmeans import lloyd

    cl = base.pop("clustered")
    col = cl.pop("col")
    X, queries, grp, tags, price = cl["X"], cl["queries"], cl["grp"], cl["tags"], cl["price"]
    n = X.shape[0]
    n_all = n + LV_INSERT
    flat_scan_topk.launches = 0
    sealed_id = f"seg_{col._impl.segments[0].meta.segment_id}"
    qd = torch.from_numpy(queries).to(dev)

    # ---- A. the filter grid ----
    xd = torch.from_numpy(X).to(dev)
    profiled = False
    for flt in (None,) + tuple(LV_FILTERS):
        sel = np.ones(n, bool) if flt is None else LV_FILTERS[flt](tags, price)
        rows = np.flatnonzero(sel)
        exp, near_tie = _live_oracle(xd, rows, qd)
        want = _rule_branch(n, len(rows), Q, flt is not None)
        for ef in LV_EFS:
            param = zt.HnswQueryParam(ef=ef)
            col._impl.debug_profiling = True
            docs = col.batch_query("vec", queries, topk=K, filter=flt, output_fields=[], param=param)
            path = _live_branches(col._impl.last_profile)
            col._impl.debug_profiling = False
            t0 = time.perf_counter()
            col.batch_query("vec", queries, topk=K, filter=flt, output_fields=[], param=param)
            ms = (time.perf_counter() - t0) * 1e3
            ids = _ids(docs)
            if flt is not None and not sel[ids].all():
                raise AssertionError(f"live A: {flt!r} returned rows that fail the filter")
            rec, short, bad = _live_recall(ids, exp, near_tie)
            ref = LV_REF_10M.get(flt, {}).get(ef)
            log(f"live A: filter {flt!r} (selectivity {len(rows) / n:.4f}, {len(rows)} rows) ef={ef}: "
                f"recall@{K} {rec:.4f} ({short} rows short, {bad} outside near-ties), {ms:.2f} ms per "
                f"{Q}-query batch (after one warm batch); path {path.get(sealed_id)} (the rule: {want}); "
                f"zvec_tpu at 10M: " + ("none" if ref is None else f"{ref[0]} ({ref[1]})"))
            if path.get(sealed_id) != want:
                raise AssertionError(f"live A: {flt!r} took {path.get(sealed_id)}, the rule says {want}")
            if ef == LV_EFS[0]:
                # one query, as bench_filtered10m.py reads the path: with Q = 1 a
                # demoted filter of at most 2^24 / D rows takes the host exact branch
                col._impl.debug_profiling = True
                one = col.query(zt.VectorQuery("vec", vector=queries[0], param=param), topk=K, filter=flt,
                                output_fields=[])
                one_path = _live_branches(col._impl.last_profile)
                col._impl.debug_profiling = False
                one_want = _rule_branch(n, len(rows), 1, flt is not None)
                one_rec, _, one_bad = _live_recall(_ids([one]), exp[:1], near_tie[:1])
                log(f"live A: filter {flt!r}, one query: recall@{K} {one_rec:.4f}; path "
                    f"{one_path.get(sealed_id)} (the rule: {one_want})")
                if one_path.get(sealed_id) != one_want or (one_want != "index" and one_bad):
                    raise AssertionError(f"live A: {flt!r} for one query took {one_path.get(sealed_id)} "
                                         f"(the rule: {one_want}) or read below 1.0")
            if want == "device scan" and not profiled:
                profiled = True
                _profiled(f"live A: filter {flt!r}, the device scan ({Q} queries)",
                          lambda: col.batch_query("vec", queries, topk=K, filter=flt, output_fields=[], param=param))
            if flt is not None and want != "index" and bad:
                raise AssertionError(f"live A: the demoted filter {flt!r} reads below 1.0 outside near-ties")
            if flt is not None and want == "index" and rec < LV_GRAPH_FLOORS[ef]:
                raise AssertionError(f"live A: {flt!r} at ef={ef} reads {rec:.4f} < {LV_GRAPH_FLOORS[ef]}")
    del xd
    torch.cuda.empty_cache()

    # ---- B. group-by on gid ----
    for gc_ in LV_GROUP_COUNTS:
        times = []
        for _ in range(LV_GROUP_REPS):
            t0 = time.perf_counter()
            for i in range(LV_GROUP_Q):
                docs = col.group_by_query(zt.VectorQuery("vec", vector=queries[i]), group_by_field="gid",
                                          group_count=gc_, group_topk=2, output_fields=["gid"])
                groups: dict = {}
                for d in docs:
                    groups.setdefault(int(d.fields["gid"]), []).append(int(d.id))
                if len(groups) != gc_ or any(len(v) > 2 for v in groups.values()) or any(
                        int(i) % LV_GID_MOD != g for g, v in groups.items() for i in v):
                    raise AssertionError(f"live B: group_count={gc_}: wrong groups or members")
            times.append((time.perf_counter() - t0) / LV_GROUP_Q)
        t0 = time.perf_counter()
        for i in range(LV_GROUP_Q):
            col.query(zt.VectorQuery("vec", vector=queries[i]), topk=gc_ * 2, output_fields=[])
        plain = (time.perf_counter() - t0) / LV_GROUP_Q
        grouped = statistics.median(times)
        log(f"live B: group_by_query gid (997 values) group_count={gc_} group_topk=2 on {LV_GROUP_Q} "
            f"queries, {LV_GROUP_REPS} repeats: {grouped * 1e3:.2f} ms per call (median), a plain "
            f"top-{gc_ * 2} query {plain * 1e3:.2f} ms, ratio {grouped / plain:.2f} (zvec_tpu at 10M: "
            f"{LV_REF_GROUPED_10M[gc_]}); every group <= 2 docs of one gid")

    # ---- C. mutations, and D. a reader while the inserts run ----
    rng = np.random.default_rng(LV_SEED)
    live_vec = np.concatenate([X, clustered_fresh(n, D, LV_INSERT, LV_SEED + 1)])
    fresh = clustered_fresh(n, D, LV_UPSERT, LV_SEED + 2)
    l_tags = np.concatenate([tags, rng.integers(0, 10, LV_INSERT)])
    l_price = np.concatenate([price, rng.random(LV_INSERT)])
    l_grp = np.concatenate([grp, rng.integers(0, GRP_VALUES, LV_INSERT)])

    def fields(i):  # pk i's fields as the reference holds them now
        return {"grp": int(l_grp[i]), "tag": f"t{l_tags[i]}", "price": float(l_price[i]), "gid": int(i % LV_GID_MOD)}

    def written(statuses, what):
        bad = [st for st in statuses if not st.is_ok()]
        if bad:
            raise AssertionError(f"live C: {len(bad)} of {len(statuses)} {what} failed: {bad[0]}")
    alive = np.zeros(n_all, bool)
    alive[:n] = True
    pks = np.arange(n_all)
    t0 = time.perf_counter()
    deleted = np.sort(rng.choice(n, LV_DELETE, replace=False))
    for lo in range(0, LV_DELETE, 1024):
        written(col.delete([str(i) for i in deleted[lo : lo + 1024]]), "deletes")
    alive[deleted] = False
    t_del = time.perf_counter()
    col.delete_by_filter(f"gid = {LV_DBF_GID}")
    dbf = np.flatnonzero(pks[:n] % LV_GID_MOD == LV_DBF_GID)
    alive[dbf] = False
    gone = np.flatnonzero(~alive[:n])
    t_dbf = time.perf_counter()
    upserted = np.sort(rng.choice(np.flatnonzero(alive[:n]), LV_UPSERT, replace=False))
    for lo in range(0, LV_UPSERT, 1024):
        written(col.upsert([zt.Doc(id=str(i), vectors={"vec": fresh[lo + j]}, fields=fields(i))
                            for j, i in enumerate(upserted[lo : lo + 1024])]), "upserts")
    live_vec[upserted] = fresh
    t_ups = time.perf_counter()
    others = np.setdiff1d(np.flatnonzero(alive[:n]), upserted)
    updated = np.sort(np.concatenate([rng.choice(others, LV_UPDATE - LV_UPDATE_UPSERTED, replace=False),
                                      rng.choice(upserted, LV_UPDATE_UPSERTED, replace=False)]))
    for lo in range(0, LV_UPDATE, 1024):
        written(col.update([zt.Doc(id=str(i), fields={"price": 0.05}) for i in updated[lo : lo + 1024]]),
                "updates")
    l_price[updated] = 0.05
    t_upd = time.perf_counter()

    stop, errors, reader = threading.Event(), [], dict(batches=0, leaks=0)
    rq = queries[:LV_READER_Q]

    def read():
        try:
            while not stop.is_set():
                docs = col.batch_query("vec", rq, topk=K, output_fields=[], param=zt.HnswQueryParam(ef=96))
                reader["leaks"] += int(np.isin(_ids(docs), gone).sum())
                reader["batches"] += 1
        except BaseException as exc:  # noqa: BLE001  (reported by the main thread)
            errors.append(exc)

    thread = threading.Thread(target=read)
    thread.start()
    new = np.arange(n, n_all)
    try:
        for lo in range(0, LV_INSERT, 1024):
            written(col.insert([zt.Doc(id=str(i), vectors={"vec": live_vec[i]}, fields=fields(i))
                                for i in new[lo : lo + 1024]]), "inserts")
    finally:
        stop.set()
        thread.join()
    alive[new] = True
    t_ins = time.perf_counter()
    log(f"live C: delete {LV_DELETE} pks {t_del - t0:.2f} s, delete_by_filter 'gid = {LV_DBF_GID}' "
        f"({len(dbf)} rows) {t_dbf - t_del:.2f} s, upsert {LV_UPSERT} {t_ups - t_dbf:.2f} s, update "
        f"{LV_UPDATE} prices to 0.05 ({LV_UPDATE_UPSERTED} of them upserted) {t_upd - t_ups:.2f} s, insert "
        f"{LV_INSERT} {t_ins - t_upd:.2f} s")
    log(f"live D: a reader thread ran {reader['batches']} batch_query calls of {LV_READER_Q} queries "
        f"(ef 96) during the inserts; errors {len(errors)}, deleted pks returned {reader['leaks']}")
    if errors:
        raise AssertionError(f"live D: the reader raised {errors[0]!r}") from errors[0]
    if reader["leaks"] or not reader["batches"]:
        raise AssertionError("live D: the reader returned deleted pks, or ran no batch")

    impl = col._impl
    writing = impl.writing
    weng = writing.engine_for("vec")
    w_alive = impl.deletes.alive_mask(writing.doc_id_start, writing.doc_count)
    count = col.stats.doc_count
    log(f"live C: doc count {count} (reference {int(alive.sum())}); sealed {impl.segments[0].doc_count} rows, "
        f"writing segment {writing.doc_count} rows ({int((~w_alive).sum())} deleted), its engine on "
        f"{weng._st.codes.device}, K1 takes its scan: {kernel_takes(weng._st.codes, None, weng._st.n, K)}")
    if count != int(alive.sum()):
        raise AssertionError("live C: the doc count is not the reference's")
    if not (weng._st.codes.device.type == dev.type and kernel_takes(weng._st.codes, None, weng._st.n, K)):
        raise AssertionError("live C: the writing segment's scan is not K1's")
    # which rows each segment holds: the writing segment has the upserts, the
    # updates and the inserts, in that order; an upserted pk updated later
    # left a dead row there
    w_pks = np.concatenate([upserted, updated, new])
    if writing.doc_count != len(w_pks):
        raise AssertionError(f"live C: the writing segment holds {writing.doc_count} rows, not {len(w_pks)}")
    in_writing = np.zeros(n_all, bool)
    in_writing[w_pks] = True
    seg_rows = {sealed_id: (n, alive & ~in_writing), f"seg_{writing.meta.segment_id}": (writing.doc_count, in_writing)}
    lv = torch.from_numpy(live_vec[alive]).to(dev)
    live_rows = np.flatnonzero(alive)
    batches = {}
    param = zt.HnswQueryParam(ef=LV_EFS[-1])
    for flt in (None,) + tuple(LV_FILTERS):
        ok = alive if flt is None else alive & LV_FILTERS[flt](l_tags, l_price)
        sub = np.flatnonzero(ok[live_rows])
        exp, near_tie = _live_oracle(lv, sub, qd)
        exp = live_rows[exp]
        want = {s: _rule_branch(nr, int((ok & m).sum()), Q, flt is not None) for s, (nr, m) in seg_rows.items()}
        col._impl.debug_profiling = True
        docs = col.batch_query("vec", queries, topk=K, filter=flt, output_fields=[], param=param)
        path = _live_branches(col._impl.last_profile)
        col._impl.debug_profiling = False
        ids, sc, err = _live_answers(docs, queries, live_vec, ok, f"C {flt!r}")
        batches[flt] = (ids, sc)
        if flt is None:
            _profiled(f"live C: unfiltered ef={LV_EFS[-1]}, the masked beam and K1 on the writing segment "
                      f"({Q} queries)", lambda: col.batch_query("vec", queries, topk=K, output_fields=[], param=param))
        rec, short, bad = _live_recall(ids, exp, near_tie)
        log(f"live C: filter {flt!r} after the mutations ({int(ok.sum())} live rows) ef={LV_EFS[-1]}: recall@{K} "
            f"{rec:.4f} against the live oracle ({short} rows short, {bad} outside near-ties); paths "
            + ", ".join(f"{s} {path.get(s)} (the rule: {w})" for s, w in want.items())
            + f"; no deleted pk and no superseded version (max |score - live vector's| {err:.3g})")
        if path != want:
            raise AssertionError(f"live C: {flt!r} took {path}, the rule says {want}")
        if flt is None and rec < cl["recall256"] - LV_RECALL_SLACK:
            raise AssertionError(f"live C: recall@10 {rec:.4f} is more than {LV_RECALL_SLACK} under "
                                 f"the unmutated {cl['recall256']:.4f}")
        if flt is not None and want[sealed_id] != "index" and bad:
            raise AssertionError(f"live C: the demoted filter {flt!r} reads below 1.0 outside near-ties")
        if flt is not None and want[sealed_id] == "index" and rec < LV_GRAPH_FLOORS[LV_EFS[-1]]:
            raise AssertionError(f"live C: {flt!r} reads {rec:.4f} < {LV_GRAPH_FLOORS[LV_EFS[-1]]}")
    del lv
    torch.cuda.empty_cache()
    for label, rows in (("new docs", new), ("upserted docs", upserted)):
        pick = np.sort(rng.choice(rows, LV_RYW, replace=False))
        qs = live_vec[pick]
        docs = col.batch_query("vec", qs, topk=K, output_fields=[], param=param)
        ids, sc, err = _live_answers(docs, qs, live_vec, alive, f"C read-your-writes {label}")
        first = int((ids[:, 0] == pick).sum())
        log(f"live C: read-your-writes, {LV_RYW} {label} queried by their own vectors: {first} at rank 1, "
            f"max |score| {float(np.abs(sc[:, 0]).max()):.3g} (exact 0), max |score - live vector's| {err:.3g}")
        if first != LV_RYW:
            raise AssertionError(f"live C: {LV_RYW - first} {label} are not their own nearest")
    launches = flat_scan_topk.launches
    log(f"live C: K1 launches in the phase so far {launches} (the writing segment's scans)")
    if launches == 0:
        raise AssertionError("live C: K1 never scanned the writing segment")
    fmask = LV_FILTERS["tag = 't3' AND price < 0.1"](l_tags[w_pks], l_price[w_pks])
    k1_case = _k1_at_writing_shape(weng, w_alive, fmask, queries)
    flat_scan_topk.launches = launches  # the checks' launches are not the path's

    # ---- E. a crash and the WAL replay ----
    path = impl.path
    impl.close()
    del col, impl, writing, weng
    gc.collect()
    torch.cuda.empty_cache()
    replay = {}
    orig = CollectionImpl._replay_wal

    def timed(self, seg):
        t = time.perf_counter()
        orig(self, seg)
        replay["s"] = time.perf_counter() - t

    calls = lloyd.calls
    CollectionImpl._replay_wal = timed
    try:
        t0 = time.perf_counter()
        col = zt.open(path)
        t_open = time.perf_counter() - t0
    finally:
        CollectionImpl._replay_wal = orig
    seng = col._impl.segments[0].engine_for("vec")
    seng._ensure_fresh()
    weng = col._impl.writing.engine_for("vec")
    weng._ensure_fresh()
    t_load = time.perf_counter() - t0
    loaded = seng._loaded_aux is not None and not seng.build_times
    log(f"live E: crash (closed without a flush) and open: {t_open:.2f} s, of which the WAL replay "
        f"{replay.get('s', float('nan')):.2f} s; with the engines loaded {t_load:.2f} s (graph from its "
        f"file: {loaded}, K1 launches {flat_scan_topk.launches - launches}, lloyd calls {lloyd.calls - calls}; "
        f"writing segment {col._impl.writing.doc_count} rows, its engine on {weng._st.codes.device}); doc "
        f"count {col.stats.doc_count}")
    if not loaded or flat_scan_topk.launches != launches or lloyd.calls != calls:
        raise AssertionError("live E: the reopen built an index or launched K1")
    if weng._st.codes.device.type != dev.type or col._impl.writing.doc_count != len(w_pks):
        raise AssertionError("live E: the replayed writing segment is not the one written, on the card")
    if col.stats.doc_count != count:
        raise AssertionError("live E: the doc count changed across the crash")
    worst = 0.0
    for flt, (ids, sc) in batches.items():
        docs = col.batch_query("vec", queries, topk=K, filter=flt, output_fields=[], param=param)
        ids2 = _ids(docs)
        sc2 = np.array([[d.score for d in row] for row in docs], np.float64)
        worst = max(worst, float(np.abs(sc2 - sc).max()))
        if not (ids2 == ids).all() or (np.abs(sc2 - sc) > LV_REOPEN_RTOL * np.maximum(np.abs(sc), 1.0)).any():
            raise AssertionError(f"live E: {flt!r} answers otherwise after the replay")
    log(f"live E: leg C's four batches return identical ids after the replay, max |dscore| {worst:.3g}")
    col._impl.close()
    log(f"live: K1 launches in the phase {flat_scan_topk.launches} (the writing segment's scans)")
    return flat_scan_topk.launches, k1_case


def cohere_centers() -> np.ndarray:
    """`benchmarks/bench_cohere10m.py::_centers`, copied draw for draw."""
    rng = np.random.default_rng(CO_SEED)
    return (rng.standard_normal((CO_NCENTERS, CO_D)) * 2.0).astype(np.float32)


def cohere_gen_chunk(centers: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """`bench_cohere10m.py::gen_chunk`, copied draw for draw: rows [lo, hi) of
    the unit-norm corpus, each CO_GEN_BLOCK-aligned block seeded by its index
    and drawn whole, so any window gives the same rows."""
    out = np.empty((hi - lo, CO_D), np.float32)
    for b in range(lo // CO_GEN_BLOCK, (hi - 1) // CO_GEN_BLOCK + 1):
        rng = np.random.default_rng(CO_SEED + 1 + b)
        blo, bhi = b * CO_GEN_BLOCK, (b + 1) * CO_GEN_BLOCK
        x = centers[rng.integers(0, CO_NCENTERS, CO_GEN_BLOCK)] + rng.standard_normal(
            (CO_GEN_BLOCK, CO_D), dtype=np.float32
        )
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        s, e = max(lo, blo), min(hi, bhi)
        out[s - lo : e - lo] = x[s - blo : e - blo]
    return out


def cohere_queries(centers: np.ndarray) -> np.ndarray:
    """`bench_cohere10m.py::queries`, copied draw for draw (without its file cache)."""
    rng = np.random.default_rng(CO_SEED + 999_983)
    q = centers[rng.integers(0, CO_NCENTERS, CO_NQ)] + rng.standard_normal(
        (CO_NQ, CO_D), dtype=np.float32
    )
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q


def _cosine_oracle(xd: torch.Tensor, qd: torch.Tensor, k: int):
    """Exact fp32 COSINE top-k on the card (TF32 off), scored as the refine
    scores: dot / (|q| |x|)."""
    xn = xd.norm(dim=1)
    s, i = _topk_chunks(qd, lambda qb: (qb @ xd.T) / (qb.norm(dim=1)[:, None] * xn[None, :]), k, chunk=250)
    return s.cpu().numpy(), i.cpu().numpy()


def cohere_corpus():
    """The deployment's CO_N rows and CO_NQ queries, from the copied generator."""
    centers = cohere_centers()
    # one generator block per thread (numpy's generators and ufuncs release the
    # GIL); any window gives the same rows, so this equals one serial call
    X = np.empty((CO_N, CO_D), np.float32)

    def fill(lo):
        X[lo : lo + CO_GEN_BLOCK] = cohere_gen_chunk(centers, lo, min(lo + CO_GEN_BLOCK, CO_N))

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        list(pool.map(fill, range(0, CO_N, CO_GEN_BLOCK)))
    return X, cohere_queries(centers)


def phase_kernel_cohere_shape() -> tuple:
    """K1 where the Cohere build calls it, on the deployment's own rows: 1024
    code rows a scan, k 128, fp32 COSINE at D = 768 (taken here, alone on the
    card, for its times); then where HnswIndexParam()'s default IP build of
    the same rows calls it (phase 3d): the rows MIPS-augmented to D = 769 as
    ops/quantize.py's mips_augment does and padded to 772 columns as
    HnswEngine pads its scan codes, fp32 L2, held by each id's own key as the
    MIPS build shape is, then timed on the unpadded 3076-byte rows."""
    from zvec_tpu_torch.ops import flat_scan as fs

    dev = torch.device("cuda")
    X, _ = cohere_corpus()
    x = torch.zeros((CO_N_PAD, CO_D), device=dev)
    x[:CO_N] = torch.from_numpy(X).to(dev)
    mask = (torch.arange(CO_N_PAD, device=dev) < CO_N).to(torch.int8)
    q = x[:CO_Q_BUILD].contiguous()
    bound = _bound(CO_Q_BUILD, CO_N_PAD, CO_D, K_BUILD, fs.pick_tile(CO_N_PAD, K_BUILD), x)
    k1 = _k1_at_build_shape(x, mask, q, x.norm(dim=1), "COSINE", "cohere build shape", bound,
                            _library_ms(q, x))
    del q
    xa = torch.zeros((CO_N_PAD, _pad4(CO_D + 1)), device=dev)  # as HnswEngine pads its scan codes
    xa[:, :CO_D] = x
    del x
    sq = (xa * xa).sum(1)
    xa[:CO_N, CO_D] = torch.sqrt(torch.clamp(sq[:CO_N].max() - sq[:CO_N], min=0.0))
    norms = (xa * xa).sum(1)
    q = xa[:CO_Q_BUILD].contiguous()
    bound = _bound(CO_Q_BUILD, CO_N_PAD, CO_D + 1, K_BUILD, fs.pick_tile(CO_N_PAD, K_BUILD), xa[:, : CO_D + 1])
    ip = _k1_at_build_shape(xa, mask, q, norms, "L2", "cohere default-IP build shape", bound,
                            _library_ms(q[:, : CO_D + 1], xa[:, : CO_D + 1]),
                            own_width=TIE_RTOL * (norms[:CO_Q_BUILD] + norms.max()), unpadded_d=CO_D + 1)
    del xa, mask, q, sq, norms
    return k1, ip


def phase_cohere(workdir: Path, dev: torch.device) -> int:
    """bench_cohere10m.py's deployment at CO_N rows through the public API:
    build (the exact build, K1 at D = 768), the refined and unrefined sweeps
    against the exact oracle, recall@k at ef 250, the int8 beam card against
    CPU, reopen. Returns K1's launches in the build."""
    import zvec_tpu_torch as zt
    import zvec_tpu_torch.core.hnsw as core_hnsw
    from zvec_tpu_torch.ops import flat_scan as fs
    from zvec_tpu_torch.ops.hnsw import hnsw_search
    from zvec_tpu_torch.typing import QuantizeType

    t0 = time.perf_counter()
    X, queries = cohere_corpus()
    log(f"cohere: {CO_N} x {CO_D} unit-norm rows ({CO_NCENTERS} centres x 2.0, seed {CO_SEED:#x}) and "
        f"{CO_NQ} queries made in {time.perf_counter() - t0:.2f} s")
    schema = zt.CollectionSchema("cohere", vectors=[zt.VectorSchema(
        "vec", zt.DataType.VECTOR_FP32, CO_D,
        zt.HnswIndexParam(zt.MetricType.COSINE, m=50, ef_construction=500,
                          quantize_type=QuantizeType.INT8))])
    path = workdir / "cohere"
    fs.flat_scan_topk.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    col = zt.create_and_open(str(path), schema)
    for lo in range(0, CO_N, 1024):
        col.insert([zt.Doc(id=str(i), vectors={"vec": X[i]}) for i in range(lo, min(lo + 1024, CO_N))])
    t_insert = time.perf_counter() - t0
    col.optimize()
    t_opt = time.perf_counter() - t0 - t_insert
    col.flush()
    launches = fs.flat_scan_topk.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    engine = next(s for s in col._impl._segments_snapshot() if s.doc_count > 0).engine_for("vec")
    bt, info = engine.build_times, engine.build_info
    log(f"cohere: insert {t_insert:.2f} s, optimize {t_opt:.2f} s, of which the engine build (data "
        f"fetch + graph + int8 codes + upload) {engine.stats.last_build_secs:.2f} s: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in bt.items() if k != "dump_aux")
        + f"; graph file write {bt.get('dump_aux', 0.0):.2f} s; levels {engine._dev['num_levels']} above "
        f"L0; peak device memory {peak_gb:.3f} GB")
    log(f"cohere: build codes {info.get('codes')} (clustered {info.get('clustered')}); search codes "
        f"{engine._codes.dtype} {tuple(engine._codes.shape)} on {engine._codes.device}, dequant "
        f"{engine._dequant}; K1 launches in the build {launches} "
        f"({-(-CO_N // CO_Q_BUILD)} batches of {CO_Q_BUILD} rows)")
    if info.get("clustered") or info.get("codes") != "float32":
        raise AssertionError(f"cohere: the build took {info} instead of the exact build on fp32 codes")
    if engine._codes.dtype != torch.int8 or {engine._codes.device.type, engine._dev["l0"].device.type} != {dev.type}:
        raise AssertionError(f"cohere: the search codes are not int8, or not on {dev}")
    if launches == 0:
        raise AssertionError("cohere: the build never launched the flat-scan kernel")

    xd = torch.from_numpy(X).to(dev)
    gs, gi = _cosine_oracle(xd, torch.from_numpy(queries).to(dev), max(CO_TOPKS) + 1)
    del xd
    gc.collect()
    torch.cuda.empty_cache()

    spent = []  # seconds in the host fp32 refine, per call
    orig_refine = core_hnsw.refine

    def timed_refine(*a, **kw):
        t1 = time.perf_counter()
        out = orig_refine(*a, **kw)
        spent.append(time.perf_counter() - t1)
        return out

    core_hnsw.refine = timed_refine
    recalls, ids_by_ef, score_errs = {}, {}, {}
    try:
        for ef in CO_EFS:
            for refined in (True, False):
                param = zt.HnswQueryParam(ef=ef, is_using_refiner=refined)
                first = col.batch_query("vec", queries, topk=K, output_fields=[], param=param)
                spent.clear()
                times = []
                for _ in range(2):
                    t1 = time.perf_counter()
                    col.batch_query("vec", queries, topk=K, output_fields=[], param=param)
                    times.append(time.perf_counter() - t1)
                got = _ids(first)
                scores = np.array([[d.score for d in docs] for docs in first], np.float32)
                if got.shape != (CO_NQ, K) or not np.isfinite(scores).all():
                    raise AssertionError("cohere: results are not (1000, 10) finite scores")
                recalls[ef, refined] = _recall(got, gi[:, :K])
                score_note = ""
                if refined:  # the refine's scores are exact fp32 cosine distances
                    ids_by_ef[ef] = got
                    exact = 1.0 - np.einsum("qd,qkd->qk", queries.astype(np.float64),
                                            X[got].astype(np.float64))
                    score_errs[ef] = float(np.abs(scores - exact).max())
                    score_note = f", max |score - exact cosine distance| {score_errs[ef]:.3g}"
                ref = CO_REF_10M[ef] if refined else CO_REF_RAW_10M.get(ef)
                refine_ms = f"{statistics.median(spent) * 1e3:.2f} ms of it the host refine" if refined \
                    else "no refine"
                log(f"cohere: ef={ef} refine {'on ' if refined else 'off'}: "
                    f"{statistics.median(times) * 1e3:.2f} ms per {CO_NQ}-query batch (median of 2, "
                    f"{refine_ms}; {hnsw_search.last_steps} beam steps in the last batch); recall@{K} "
                    f"{recalls[ef, refined]:.4f} (zvec_tpu at 10M rows: "
                    f"{'not run' if ref is None else ref}){score_note}")
    finally:
        core_hnsw.refine = orig_refine
    for ef in CO_EFS:
        log(f"cohere: ef={ef}: recall@{K} refined {recalls[ef, True]:.4f}, unrefined "
            f"{recalls[ef, False]:.4f} ({recalls[ef, True] - recalls[ef, False]:+.4f})")
    # where the refined recall stops: the beam's early stop (done_frac), a
    # wider beam, and true neighbours no L0 edge points to
    top = CO_EFS[-1]
    for label, param in ((f"ef={top} done_frac=1.0", zt.HnswQueryParam(ef=top, done_frac=1.0)),
                         (f"ef={2 * top} done_frac=1.0", zt.HnswQueryParam(ef=2 * top, done_frac=1.0))):
        got = _ids(col.batch_query("vec", queries, topk=K, output_fields=[], param=param))
        log(f"cohere: {label}, refine on: recall@{K} {_recall(got, gi[:, :K]):.4f}")
    l0 = engine._graph.l0[:CO_N]
    indeg = np.bincount(l0[l0 >= 0].ravel(), minlength=CO_N)
    missed = np.array([t for r in range(CO_NQ) for t in set(gi[r, :K]) - set(ids_by_ef[top][r])], np.int64)
    lost = sum(not set(gi[r, :K]) & set(ids_by_ef[top][r]) for r in range(CO_NQ))
    log(f"cohere: queries whose refined top-{K} at ef={top} holds none of their true top-{K}: {lost} "
        f"of {CO_NQ}")
    log(f"cohere: L0 rows no edge points to: {int((indeg == 0).sum())} of {CO_N}; of the {len(missed)} "
        f"true top-{K} ids the refined beam misses at ef={top}, {int((indeg[missed] == 0).sum())} have no "
        f"in-edge (median in-degree {int(np.median(indeg[missed])) if len(missed) else 0} there, "
        f"{int(np.median(indeg))} over all rows)")
    for ef, floor in CO_FLOORS.items():
        if recalls[ef, True] < floor:
            raise AssertionError(f"cohere: refined recall@10 at ef={ef} is {recalls[ef, True]:.4f} < {floor}")
    if any(recalls[ef, True] < recalls[ef, False] for ef in CO_EFS):
        raise AssertionError("cohere: the refined recall reads lower than the unrefined at some ef")
    if max(score_errs.values()) > CO_SCORE_ATOL:
        raise AssertionError("cohere: the refined scores are not the exact fp32 cosine distances")

    param = zt.HnswQueryParam(ef=top)
    for tk in CO_TOPKS:
        qs = queries if tk <= K else queries[:CO_TOPK_Q]
        t1 = time.perf_counter()
        got = _ids(col.batch_query("vec", qs, topk=tk, output_fields=[], param=param))
        dt = time.perf_counter() - t1
        log(f"cohere: ef={top} top-{tk}: recall@{tk} {_recall(got, gi[: len(qs), :tk]):.4f} on {len(qs)} "
            f"queries (zvec_tpu at 10M rows: {CO_REF_TOPK_10M[tk]}), {dt * 1e3:.2f} ms for the batch (first call)")
    _profiled(f"cohere batch ef=128, refine on ({CO_NQ} queries)",
              lambda: engine.search(queries, K, None, zt.HnswQueryParam(ef=128)))
    _beam_check(engine, queries[:CO_CHECK_Q], "cohere int8")
    log(f"cohere: peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    col._impl.close()
    del col, engine
    gc.collect()
    torch.cuda.empty_cache()

    before = fs.flat_scan_topk.launches
    t0 = time.perf_counter()
    reopened = zt.open(str(path))
    again = _ids(reopened.batch_query("vec", queries, topk=K, output_fields=[],
                                      param=zt.HnswQueryParam(ef=128)))
    t_reopen = time.perf_counter() - t0
    eng2 = next(s for s in reopened._impl._segments_snapshot() if s.doc_count > 0).engine_for("vec")
    loaded = eng2._loaded_aux is not None
    reopened._impl.close()
    del reopened, eng2
    shutil.rmtree(path, ignore_errors=True)
    if fs.flat_scan_topk.launches != before or not loaded:
        raise AssertionError("cohere: the reopened collection rebuilt its graph")
    if not (again == ids_by_ef[128]).all():
        raise AssertionError("cohere: reopened collection returns other ids")
    log(f"cohere: reopened collection loads the graph from disk (no kernel launch) and returns "
        f"identical ids at ef=128; open + first batch {t_reopen:.2f} s")
    return launches


def sparse_topic_model():
    """`benchmarks/bench_sparse1m.py::_topic_model`, copied draw for draw:
    per-topic term pools, a head shared corpus-wide plus a tail per topic."""
    rng = np.random.default_rng(SP_SEED)
    head = np.arange(SP_HEAD)
    pools = []
    for _ in range(SP_TOPICS):
        tail = rng.choice(SP_VOCAB - SP_HEAD, SP_TAIL, replace=False) + SP_HEAD
        pools.append(np.concatenate([head, tail]))
    return pools


def sparse_make_rows(pools, count: int, nnz: int, seed: int, head_frac=0.3):
    """`benchmarks/bench_sparse1m.py::_make_rows`, copied draw for draw: `count`
    sparse rows as (idx (count, nnz) int32, val (count, nnz) f32), each sorted
    by term, a repeated term voided (idx -1, val 0). Head terms get low
    (idf-like) weights, tail terms high ones."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, SP_TOPICS, count)
    n_head = int(nnz * head_frac)
    n_tail = nnz - n_head
    head_idx = rng.integers(0, SP_HEAD, (count, n_head)).astype(np.int32)
    tail_pick = rng.integers(0, SP_TAIL, (count, n_tail))
    pool_mat = np.stack([p[SP_HEAD:] for p in pools])
    tail_idx = pool_mat[t[:, None], tail_pick].astype(np.int32)
    idx = np.concatenate([head_idx, tail_idx], axis=1)
    val = np.concatenate(
        [
            (rng.random((count, n_head)) * 0.3 + 0.05).astype(np.float32),
            (rng.random((count, n_tail)) + 0.5).astype(np.float32),
        ],
        axis=1,
    )
    order = np.argsort(idx, axis=1, kind="stable")
    si = np.take_along_axis(idx, order, 1)
    sv = np.take_along_axis(val, order, 1)
    dup = np.zeros_like(si, dtype=bool)
    dup[:, 1:] = si[:, 1:] == si[:, :-1]
    return np.where(dup, -1, si), np.where(dup, 0.0, sv)


def sparse_rows_to_dicts(idx: np.ndarray, val: np.ndarray):
    """`benchmarks/bench_sparse1m.py::rows_to_dicts`."""
    out = []
    for i in range(idx.shape[0]):
        m = idx[i] >= 0
        out.append(dict(zip(idx[i][m].tolist(), val[i][m].astype(float).tolist())))
    return out


def _sparse_oracle(chunks, q_idx: np.ndarray, q_val: np.ndarray, dev: torch.device, k: int):
    """Exact sparse IP top-k on the card, by a torch.sparse product per chunk
    of rows (no code of ops/sparse.py): (scores desc, row ids), each (Q, k)."""
    nq = q_idx.shape[0]
    qd = torch.zeros((SP_VOCAB, nq), device=dev)
    qm = q_idx >= 0
    qd[torch.from_numpy(q_idx[qm]).long().to(dev),
       torch.from_numpy(np.nonzero(qm)[0]).to(dev)] = torch.from_numpy(q_val[qm]).to(dev)
    best_s = torch.full((nq, k), -torch.inf, device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.long, device=dev)
    lo = 0
    for idx, val in chunks:
        m = idx >= 0
        rows = np.repeat(np.arange(idx.shape[0]), m.sum(1))
        coo = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([rows, idx[m].astype(np.int64)])).to(dev),
            torch.from_numpy(val[m]).to(dev), size=(idx.shape[0], SP_VOCAB),
        )
        sims = torch.sparse.mm(coo, qd).T  # (Q, rows of the chunk)
        ids = torch.arange(lo, lo + idx.shape[0], device=dev).expand(nq, -1)
        best_s, sel = torch.topk(torch.cat([best_s, sims], dim=1), k, dim=1)
        best_i = torch.cat([best_i, ids], dim=1).gather(1, sel)
        lo += idx.shape[0]
    return best_s.cpu().numpy(), best_i.cpu().numpy()


def _sparse_topics(pools, idx: np.ndarray) -> np.ndarray:
    """The topic of each generated row: the one whose tail pool holds most of
    the row's tail terms."""
    member = np.zeros((SP_TOPICS, SP_VOCAB), dtype=bool)
    for t, pool in enumerate(pools):
        member[t, pool[SP_HEAD:]] = True
    tail = idx >= SP_HEAD
    hits = (member[:, np.where(tail, idx, 0)] & tail[None]).sum(-1)  # (topics, rows)
    return hits.argmax(0)


def _sparse_card_vs_cpu(engine, q_idx: np.ndarray, q_val: np.ndarray) -> None:
    """The sparse beam and `sparse_ip_topk` (on a slice of the rows) on the
    engine's CUDA tensors against the same calls on CPU copies: ids equal,
    scores within SP_RTOL, except rows whose differing ids all score within
    SP_RTOL of the row's k-th score."""
    from zvec_tpu_torch.ops.hnsw_sparse import hnsw_sparse_search
    from zvec_tpu_torch.ops.sparse import sparse_ip_topk

    tensors = (engine._doc_idx, engine._doc_val, engine._l0, engine._entries)
    budget = min(max(10_000, int(0.1 * engine._n)), engine._n)

    def beam(dev):
        return hnsw_sparse_search(
            torch.from_numpy(q_idx).to(dev), torch.from_numpy(q_val).to(dev),
            *(x.to(dev) for x in tensors), None, budget, ef=SP_CHECK_EF, topk=K,
            max_steps=SP_CHECK_EF + 64, vocab=engine._vocab, frontier=4,
        )

    def scan(dev):
        return sparse_ip_topk(
            torch.from_numpy(q_idx).to(dev), torch.from_numpy(q_val).to(dev),
            engine._doc_idx[:SP_CHECK_ROWS].to(dev), engine._doc_val[:SP_CHECK_ROWS].to(dev),
            None, topk=K, vocab=engine._vocab,
        )

    for name, fn in (("beam", beam), (f"sparse_ip_topk ({SP_CHECK_ROWS} rows)", scan)):
        cs, ci = (x[:SP_CHECK_Q].cpu() for x in fn(torch.device("cuda")))  # drop the batch padding
        t0 = time.perf_counter()
        ps, pi = (x[:SP_CHECK_Q] for x in fn(torch.device("cpu")))
        cpu_s = time.perf_counter() - t0
        bad, differ, err = _check_final_at_k(cs, ci, ps, pi, rtol=SP_RTOL)
        scale = max(float(ps.abs().max()), 1.0)
        log(f"sparse: CUDA {name} vs CPU on {len(cs)} queries: {differ} rows differ "
            f"({bad} outside near-ties), max |dscore| {err:.3g} on equal rows; CPU {cpu_s:.2f} s")
        if bad or err > SP_RTOL * scale:
            raise AssertionError(f"sparse: the CUDA {name} disagrees with the CPU's")


def phase_sparse(workdir: Path, dev: torch.device) -> int:
    """The sparse HNSW path at SP_N documents: the clustered signature
    build picked by the size rule, the beam at three ef, the flat scan, reopen."""
    import zvec_tpu_torch as zt
    from zvec_tpu_torch.core.hnsw_sparse import SparseHnswEngine
    from zvec_tpu_torch.ops.flat_scan import flat_scan_topk
    from zvec_tpu_torch.ops.hnsw_sparse import hnsw_sparse_search
    from zvec_tpu_torch.ops.kmeans import lloyd

    pools = sparse_topic_model()
    schema = zt.CollectionSchema(
        "sparse1m",
        vectors=[zt.VectorSchema("sv", zt.DataType.SPARSE_VECTOR_FP32, 0,
                                 zt.HnswIndexParam(zt.MetricType.IP, m=16, ef_construction=200))],
    )
    path = workdir / "sparse"
    flat_scan_topk.launches = 0
    torch.cuda.reset_peak_memory_stats()
    col = zt.create_and_open(str(path), schema)
    chunks, t_make, t_insert = [], 0.0, 0.0
    for glo in range(0, SP_N, SP_CHUNK):
        cnt = min(SP_CHUNK, SP_N - glo)
        t0 = time.perf_counter()
        idx, val = sparse_make_rows(pools, cnt, SP_NNZ_DOC, SP_SEED + 1 + glo)
        dicts = sparse_rows_to_dicts(idx, val)
        chunks.append((idx, val))
        t1 = time.perf_counter()
        for lo in range(0, cnt, 1024):
            col.insert([zt.Doc(id=str(glo + lo + i), vectors={"sv": dicts[lo + i]})
                        for i in range(min(1024, cnt - lo))])
        t_make += t1 - t0
        t_insert += time.perf_counter() - t1
    del dicts
    t0 = time.perf_counter()
    col.optimize()
    t_build = time.perf_counter() - t0
    col.flush()
    launches = flat_scan_topk.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    seg = next(s for s in col._impl._segments_snapshot() if s.doc_count > 0)
    engine = seg.engine_for("sv")
    bt, info = engine.build_times, engine.build_info
    log(f"sparse: {SP_N} docs x {SP_NNZ_DOC} terms, vocab {SP_VOCAB}: rows made in {t_make:.2f} s, "
        f"insert {t_insert:.2f} s, optimize {t_build:.2f} s, of which the engine build (data fetch + "
        f"graph + upload) {engine.stats.last_build_secs:.2f} s: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in bt.items() if k != "dump_aux")
        + f"; graph file write {bt.get('dump_aux', 0.0):.2f} s; peak device memory {peak_gb:.3f} GB")
    log(f"sparse: K {info.get('K')} buckets of mp {info.get('mp')} rows, kc {info.get('kc')}, members "
        f"dropped past mp {info.get('dropped')} of {2 * SP_N}; {len(engine._entries)} medoid entries; "
        f"rows on the card {tuple(engine._doc_idx.shape)}, vocab {engine._vocab}; K1 launches {launches}")
    if type(engine) is not SparseHnswEngine or engine._l0 is None:
        raise AssertionError("sparse: the field did not build the sparse graph engine")
    if not info.get("clustered") or "kmeans" not in bt:
        raise AssertionError("sparse: the size rule did not take the clustered signature build")
    if not (engine._doc_idx.is_cuda and engine._l0.is_cuda and engine._entries.is_cuda):
        raise AssertionError("sparse: the rows, the graph or the entries are not on CUDA")
    if launches != 0:
        raise AssertionError("sparse: the sparse path launched the flat-scan kernel")

    q_idx, q_val = sparse_make_rows(pools, Q, SP_NNZ_Q, SP_SEED + 77, head_frac=0.25)
    qdicts = sparse_rows_to_dicts(q_idx, q_val)
    # the beam starts from at most 128 medoids (the JAX engine's cap) while the
    # build made K clusters over 256 topics: a query whose topic holds no entry
    # reaches it only through teleport edges, so recall is read for both kinds
    entry_rows = engine._entries.cpu().numpy()
    entry_idx = np.stack([chunks[e // SP_CHUNK][0][e % SP_CHUNK] for e in entry_rows])
    covered = np.isin(_sparse_topics(pools, q_idx[:SP_GT_Q]), _sparse_topics(pools, entry_idx))
    log(f"sparse: {len(entry_rows)} entries lie in {len(set(_sparse_topics(pools, entry_idx).tolist()))} "
        f"of {SP_TOPICS} topics; {int(covered.sum())} of the {SP_GT_Q} oracle queries are of such a topic")
    t0 = time.perf_counter()
    gs, gi = _sparse_oracle(chunks, q_idx[:SP_GT_Q], q_val[:SP_GT_Q], dev, K + 1)
    log(f"sparse: exact oracle (torch.sparse product on the card, {SP_GT_Q} queries) in "
        f"{time.perf_counter() - t0:.2f} s")
    del chunks
    exp = gi[:, :K]
    ids_by_ef = {}
    recalls, covered_recalls = {}, {}
    for ef in SP_EFS:
        param = zt.HnswQueryParam(ef=ef)
        first = col.batch_query("sv", qdicts, topk=K, output_fields=[], param=param)
        times = []
        for _ in range(3):
            t1 = time.perf_counter()
            out = col.batch_query("sv", qdicts, topk=K, output_fields=[], param=param)
            times.append(time.perf_counter() - t1)
        got = _ids(first)
        scores = np.array([[d.score for d in docs] for docs in first], np.float32)
        if got.shape != (Q, K) or not np.isfinite(scores).all() or len(out) != Q:
            raise AssertionError("sparse: results are not (1024, 10) finite scores")
        recalls[ef], ids_by_ef[ef] = _recall(got[:SP_GT_Q], exp), got
        rec_in = _recall(got[:SP_GT_Q][covered], exp[covered])
        rec_out = _recall(got[:SP_GT_Q][~covered], exp[~covered])
        covered_recalls[ef] = rec_in
        med = statistics.median(times)
        log(f"sparse: ef={ef}: {med * 1e3:.2f} ms per 1024-query batch (median of 3, "
            f"{min(times) * 1e3:.2f} to {max(times) * 1e3:.2f}), {Q / med:.1f} qps; "
            f"{hnsw_sparse_search.last_steps} beam steps in the last batch; recall@{K} "
            f"{recalls[ef]:.4f} on {SP_GT_Q} queries ({rec_in:.4f} where the topic holds an entry, "
            f"{rec_out:.4f} where it does not)")
    if covered_recalls[128] < SP_MIN_RECALL_EF128 or recalls[128] < SP_MIN_RECALL_EF128_ALL:
        raise AssertionError(
            f"sparse: recall@10 at ef=128 is {covered_recalls[128]:.4f} where the topic holds an entry "
            f"(floor {SP_MIN_RECALL_EF128}), {recalls[128]:.4f} over all queries (floor {SP_MIN_RECALL_EF128_ALL})")

    lin = zt.HnswQueryParam(ef=64, is_linear=True)
    flat_first = col.batch_query("sv", qdicts[:SP_GT_Q], topk=K, output_fields=[], param=lin)
    t1 = time.perf_counter()
    col.batch_query("sv", qdicts[:SP_GT_Q], topk=K, output_fields=[], param=lin)
    flat_s = time.perf_counter() - t1
    fgot = _ids(flat_first)
    fscores = np.array([[d.score for d in docs] for docs in flat_first], np.float32)
    near_tie = np.abs(gs[:, K - 1] - gs[:, K]) <= TIE_RTOL * np.abs(gs[:, K - 1])
    short = np.array([len(set(fgot[r]) & set(exp[r])) < K for r in range(SP_GT_Q)])
    frecall = _recall(fgot, exp)
    log(f"sparse: flat scan (is_linear): {flat_s * 1e3:.2f} ms per {SP_GT_Q}-query batch, "
        f"{SP_GT_Q / flat_s:.1f} qps; recall@{K} {frecall:.6f} ({int(short.sum())} rows short, "
        f"{int((short & ~near_tie).sum())} outside near-ties); max |score - oracle| "
        f"{float(np.abs(fscores - gs[:, :K]).max()):.3g}")
    if frecall < SP_MIN_RECALL_FLAT or (short & ~near_tie).any():
        raise AssertionError("sparse: the flat scan misses the exact answer")

    param = zt.HnswQueryParam(ef=64)
    col.query(zt.VectorQuery("sv", vector=qdicts[0], param=param), topk=K)
    lat = []
    for i in range(24):
        t1 = time.perf_counter()
        col.query(zt.VectorQuery("sv", vector=qdicts[i], param=param), topk=K)
        lat.append((time.perf_counter() - t1) * 1e3)
    log(f"sparse: single query at ef=64: p50 {np.percentile(lat, 50):.2f} ms, p99 "
        f"{np.percentile(lat, 99):.2f} ms over 24 calls")
    _profiled(f"sparse beam batch ef=64 ({Q} queries)", lambda: engine.search(qdicts, K, None, param))
    _profiled(f"sparse flat batch ({SP_GT_Q} queries)",
              lambda: engine.search(qdicts[:SP_GT_Q], K, None, lin))
    cq_idx, cq_val = engine._queries_from_rows(qdicts[:SP_CHECK_Q])
    _sparse_card_vs_cpu(engine, cq_idx, cq_val)
    entries = engine._entries.cpu().numpy()
    col._impl.close()
    del col, seg, engine
    gc.collect()
    torch.cuda.empty_cache()

    calls = lloyd.calls
    t0 = time.perf_counter()
    reopened = zt.open(str(path))
    again = _ids(reopened.batch_query("sv", qdicts, topk=K, output_fields=[],
                                      param=zt.HnswQueryParam(ef=128)))
    t_reopen = time.perf_counter() - t0
    eng2 = next(s for s in reopened._impl._segments_snapshot() if s.doc_count > 0).engine_for("sv")
    loaded = eng2._loaded_aux is not None and "kmeans" not in eng2.build_times
    same_entries = np.array_equal(eng2._entries.cpu().numpy(), entries)
    reopened._impl.close()
    if lloyd.calls != calls or not loaded or not same_entries:
        raise AssertionError("sparse: the reopened collection rebuilt its graph or lost its entries")
    if not (again == ids_by_ef[128]).all():
        raise AssertionError("sparse: reopened collection returns other ids")
    log(f"sparse: reopened collection loads the graph and the medoid entries (lloyd calls "
        f"{lloyd.calls - calls}) and returns identical ids at ef=128; open + first batch "
        f"{t_reopen:.2f} s")
    return launches


def phase_fusion(workdir: Path) -> int:
    """Dense + sparse fusion, bench_suite.py's config #5: per-query and
    batched fused queries against the per-field answers."""
    import zvec_tpu_torch as zt
    from zvec_tpu_torch.ops.flat_scan import flat_scan_topk

    rng = np.random.default_rng(FU_SEED)
    X = rng.standard_normal((FU_N, FU_D), dtype=np.float32)

    def rand_sparse():
        dims = rng.choice(FU_VOCAB, FU_NNZ, replace=False)
        vals = (rng.random(FU_NNZ) + 0.1).astype(np.float32)
        return {int(a): float(b) for a, b in zip(dims, vals)}

    SV = [rand_sparse() for _ in range(FU_N)]
    schema = zt.CollectionSchema(
        "fusion",
        vectors=[
            zt.VectorSchema("dense", zt.DataType.VECTOR_FP32, FU_D, zt.FlatIndexParam(zt.MetricType.COSINE)),
            zt.VectorSchema("sparse", zt.DataType.SPARSE_VECTOR_FP32, 0, zt.FlatIndexParam(zt.MetricType.IP)),
        ],
    )
    t0 = time.perf_counter()
    col = zt.create_and_open(str(workdir / "fusion"), schema)
    for lo in range(0, FU_N, 1024):
        col.insert([zt.Doc(id=str(i), vectors={"dense": X[i], "sparse": SV[i]})
                    for i in range(lo, min(lo + 1024, FU_N))])
    t_insert = time.perf_counter() - t0
    col.optimize()
    col.flush()
    t_build = time.perf_counter() - t0 - t_insert
    qd = rng.standard_normal((FU_Q, FU_D), dtype=np.float32)
    qs = [rand_sparse() for _ in range(FU_Q)]
    rr = zt.RrfReRanker()
    groups = [[zt.VectorQuery("dense", vector=qd[i]), zt.VectorQuery("sparse", vector=qs[i])]
              for i in range(FU_Q)]

    impl = col._impl
    taken = []
    orig = impl.fused_pair_dispatch
    impl.fused_pair_dispatch = lambda *a, **k: taken.append(orig(*a, **k)) or taken[-1]

    def fused(i):
        return col.query(groups[i], topk=K, reranker=rr, output_fields=[])

    flat_scan_topk.launches = 0
    fused(0)  # warm both engines
    fused(1)
    lats, answers = [], []
    for i in range(FU_Q):
        t1 = time.perf_counter()
        answers.append(fused(i))
        lats.append((time.perf_counter() - t1) * 1e3)
    col.batch_fused_query(groups, topk=K, reranker=rr, output_fields=[])  # warm
    t1 = time.perf_counter()
    batched = col.batch_fused_query(groups, topk=K, reranker=rr, output_fields=[])
    batched_s = time.perf_counter() - t1
    launches = flat_scan_topk.launches
    del impl.fused_pair_dispatch
    if len(taken) != FU_Q + 4 or any(fin is None for fin in taken):
        raise AssertionError("fusion: a fused query did not take fused_pair_dispatch")
    if launches != 0:
        raise AssertionError("fusion: the fused pair launched the flat-scan kernel")

    # the two per-field batches the fused pair replaces (the dense one runs K1)
    col.batch_query("dense", qd, topk=K + 1, output_fields=[])
    col.batch_query("sparse", qs, topk=K + 1, output_fields=[])
    t1 = time.perf_counter()
    dense_docs = col.batch_query("dense", qd, topk=K + 1, output_fields=[])
    sparse_docs = col.batch_query("sparse", qs, topk=K + 1, output_fields=[])
    per_field_s = time.perf_counter() - t1
    per_field_k1 = flat_scan_topk.launches - launches

    def near_tie(docs):
        sc = np.array([d.score for d in docs], np.float64)
        return bool((np.abs(np.diff(sc)) <= SP_RTOL * np.abs(sc[1:])).any())

    excused = 0
    for i in range(FU_Q):
        want = rr.rerank({"dense": dense_docs[i][:K], "sparse": sparse_docs[i][:K]})
        for got in (answers[i], batched[i]):
            if len(got) != K or not all(np.isfinite(d.score) for d in got):
                raise AssertionError("fusion: a fused answer is not 10 finite scores")
            same = [d.id for d in got] == [d.id for d in want] and np.allclose(
                [d.score for d in got], [d.score for d in want], rtol=1e-6)
            if not same:
                # the fused dense half is the blockwise scan, the per-field one K1:
                # two scores closer than SP_RTOL may swap ranks
                if not (near_tie(dense_docs[i]) or near_tie(sparse_docs[i])):
                    raise AssertionError(f"fusion: query {i} differs from the reranked per-field answers")
                excused += 1
    log(f"fusion: {FU_N} docs ({FU_D}-d COSINE flat + sparse IP flat, vocab {FU_VOCAB}, {FU_NNZ} terms): "
        f"insert {t_insert:.2f} s, optimize + flush {t_build:.2f} s; fused query p50 "
        f"{np.percentile(lats, 50):.2f} ms, p99 {np.percentile(lats, 99):.2f} ms over {FU_Q} calls; "
        f"batch_fused_query {batched_s * 1e3:.2f} ms for {FU_Q} queries ({FU_Q / batched_s:.1f} qps); the two "
        f"batch_query calls it replaces {per_field_s * 1e3:.2f} ms ({per_field_k1} K1 launches there); "
        f"fused answers equal to the reranked per-field answers on {2 * FU_Q - excused} of {2 * FU_Q} "
        f"({excused} excused by a near-tie); fused_pair_dispatch taken {len(taken)} times; K1 launches "
        f"on the fused path {launches}")
    col._impl.close()
    return launches


def _run_tool(mod, argv) -> dict:
    """A tool's main(argv), as `python -m` runs it: its JSON output, parsed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(argv)
    return json.loads(buf.getvalue())


# the CPU run of the examples, in a process that asks for the CPU and sees no card
_EXAMPLES_ON_CPU = (
    "import functools, json\n"
    "import zvec_tpu_torch as zt\n"
    "from zvec_tpu_torch.ops.runtime import device\n"
    "from zvec_tpu_torch.examples import hybrid_multivector, quantized_groupby, quickstart\n"
    "assert device().type == 'cpu'\n"
    f"quantized_groupby.N = {TL_EX_N}\n"
    f"quantized_groupby.HnswIndexParam = functools.partial(zt.HnswIndexParam, ef_construction={TL_EX_EFC})\n"
    "print(json.dumps({m.__name__.rsplit('.', 1)[1]: m.main() "
    "for m in (quickstart, hybrid_multivector, quantized_groupby)}))\n"
)


def _tools_bench(col: str, qf: str, label: str, extra=()) -> None:
    from zvec_tpu_torch.tools import bench

    for batch in (1, Q):
        out = _run_tool(bench, ["--collection", col, "--field", "emb", "--queries", qf,
                                "--batch", str(batch), "--seconds", str(TL_BENCH_S), *extra])
        log(f"tools {label}: tools.bench --batch {batch} for {TL_BENCH_S:g} s: {out['qps']:.1f} qps, "
            f"p50 {out['p50']:.3f} ms, p99 {out['p99']:.3f} ms per call ({out['queries']} queries)")
        if out["qps"] <= 0:
            raise AssertionError(f"tools {label}: bench measured nothing")


def phase_tools(workdir: Path, dev: torch.device) -> int:
    """The command-line tools through their main(argv), as `python -m` runs
    them, on TL_N rows of phase 4's generator: write the vectors, build a FLAT
    and an HNSW collection, read their recall against ground truth from the
    exact oracle on the card, bench them; then the three examples on the card
    against a CPU run of the same examples. Returns K1's launches on the FLAT
    collection's path (build, recall, bench)."""
    import zvec_tpu_torch as zt
    from zvec_tpu_torch.examples import hybrid_multivector, quantized_groupby, quickstart
    from zvec_tpu_torch.ops.flat_scan import flat_scan_topk
    from zvec_tpu_torch.tools import build, recall
    from zvec_tpu_torch.tools.io import write_vecs

    qset, X = _data()
    queries, X = qset[0], np.ascontiguousarray(X[:TL_N])
    del qset
    d = workdir / "tools"
    d.mkdir()
    base, qf, gtf = str(d / "base.fvecs"), str(d / "queries.fvecs"), str(d / "gt.ivecs")
    t0 = time.perf_counter()
    write_vecs(base, X)
    write_vecs(qf, queries)
    _, oi = _exact_oracle(torch.from_numpy(X).to(dev), torch.from_numpy(queries[:TL_GT_Q]).to(dev), k=K)
    gt = oi.cpu().numpy().astype(np.int32)
    write_vecs(gtf, gt)
    log(f"tools: {TL_N} x {D} rows and {Q} queries written with tools.io.write_vecs, ground truth of "
        f"{TL_GT_Q} queries from the exact oracle on the card, in {time.perf_counter() - t0:.2f} s")
    rec_args = ["--field", "emb", "--queries", qf, "--ground-truth", gtf, "--topk", "1,10",
                "--limit", str(TL_GT_Q)]

    flat = str(d / "flat")
    flat_scan_topk.launches = 0
    out = _run_tool(build, ["--output", flat, "--vectors", base, "--index", "flat"])
    log(f"tools flat: tools.build --index flat: {out['docs']} docs, insert {out['insert_s']} s, "
        f"index build {out['index_build_s']} s")
    rec = _run_tool(recall, ["--collection", flat, *rec_args])
    log(f"tools flat: tools.recall: recall@1 {rec['recall@1']:.4f}, recall@10 {rec['recall@10']:.4f} on "
        f"{rec['queries']} queries, {rec['avg_latency_ms']:.3f} ms per query")
    _tools_bench(flat, qf, "flat")
    launches = flat_scan_topk.launches
    log(f"tools flat: K1 launches on the FLAT collection's path (build, recall, bench) {launches}")
    if rec["recall@10"] != 1.0 or rec["queries"] != TL_GT_Q:
        raise AssertionError("tools flat: recall@10 of the exact scan is not 1.0")
    if launches == 0:
        raise AssertionError("tools flat: the FLAT query path never launched the flat-scan kernel")

    hnsw = str(d / "hnsw")
    flat_scan_topk.launches = 0
    out = _run_tool(build, ["--output", hnsw, "--vectors", base, "--index", "hnsw"])
    log(f"tools hnsw: tools.build --index hnsw (m 16, ef_construction 200): {out['docs']} docs, insert "
        f"{out['insert_s']} s, index build {out['index_build_s']} s; K1 launches in the build "
        f"{flat_scan_topk.launches} (knn_k 200 > 127 takes the blockwise scan)")
    rec = _run_tool(recall, ["--collection", hnsw, *rec_args, "--ef", str(TL_EF)])
    col = zt.open(hnsw)
    res = col.batch_query_many("emb", [queries[:TL_GT_Q]], topk=K, output_fields=[],
                               param=zt.HnswQueryParam(ef=TL_EF, done_frac=1.0))[0]
    col._impl.close()
    api = recall.compute_recall(_ids(res), gt.astype(np.int64), [1, 10])
    log(f"tools hnsw: tools.recall --ef {TL_EF}: recall@1 {rec['recall@1']:.4f}, recall@10 "
        f"{rec['recall@10']:.4f}, {rec['avg_latency_ms']:.3f} ms per query; batch_query_many on the same "
        f"collection: recall@1 {api['recall@1']:.4f}, recall@10 {api['recall@10']:.4f}")
    if (rec["recall@1"], rec["recall@10"]) != (api["recall@1"], api["recall@10"]):
        raise AssertionError("tools hnsw: tools.recall and the API read another recall")
    _tools_bench(hnsw, qf, "hnsw", ("--ef", str(TL_EF)))

    env = dict(os.environ, ZVEC_TORCH_DEVICE="cpu", CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    proc = subprocess.Popen([sys.executable, "-c", _EXAMPLES_ON_CPU], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    quantized_groupby.N = TL_EX_N
    quantized_groupby.HnswIndexParam = functools.partial(zt.HnswIndexParam, ef_construction=TL_EX_EFC)
    try:
        card, secs = {}, {}
        for mod in (quickstart, hybrid_multivector, quantized_groupby):
            name = mod.__name__.rsplit(".", 1)[1]
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                card[name] = json.loads(json.dumps(mod.main(str(d / f"example_{name}"))))
            secs[name] = time.perf_counter() - t0
        stdout, stderr = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"tools: the CPU run of the examples failed: {stderr[-2000:]}")
    cpu = json.loads(stdout.strip().splitlines()[-1])
    for name, ids in card.items():
        log(f"tools: example {name} on the card in {secs[name]:.2f} s: {ids}; "
            f"{'the same ids' if cpu[name] == ids else 'OTHER ids'} on the CPU")
    if cpu != card:
        raise AssertionError("tools: an example printed other ids on the card than on the CPU")
    return launches


def _shard_text(tensors) -> str:
    return ", ".join(f"{t.device} {t.shape[0]}" for t in tensors)


def _mesh_beam_check(engine, qs: np.ndarray, ef: int) -> None:
    """The sharded beam on the engine's CUDA shards against the same sharded
    search on CPU copies of every shard's tensors (a CPU mesh): ids equal,
    scores within BEAM_RTOL, except rows whose differing ids all score within
    BEAM_RTOL of the row's k-th score."""
    from zvec_tpu_torch.parallel.mesh import make_mesh, sharded_hnsw_search

    d = engine._dev
    R = d["R"]

    def move(v, to):  # a shard's graph dict: tensors, lists of tensors, ints
        if torch.is_tensor(v):
            return to(v)
        return [move(x, to) for x in v] if isinstance(v, list) else v

    def run(mesh, to):
        shards = [{k: move(v, to) for k, v in sh.items()} for sh in d["shards"]]
        return sharded_hnsw_search(
            mesh, torch.from_numpy(qs), [to(c) for c in engine._codes], [to(n) for n in engine._norms],
            [sh["l0"] for sh in shards], [sh["upper_ids"] for sh in shards],
            [sh["upper_nbrs"] for sh in shards], [sh["upper_down"] for sh in shards],
            [sh["entry_rows"] for sh in shards], None, min(max(10_000, int(0.1 * R)), R),
            metric=engine._search_metric, ef=ef, topk=K, max_steps=ef + 64,
            num_levels=[sh["num_levels"] for sh in shards], frontier=4,
        )

    cs, ci = (x.cpu() for x in run(d["mesh"], lambda t: t))
    t0 = time.perf_counter()
    ps, pi = run(make_mesh(MESH_SHARDS, device="cpu"), lambda t: t.cpu())
    cpu_s = time.perf_counter() - t0
    bad, differ, err = _check_final_at_k(cs, ci, ps, pi, rtol=BEAM_RTOL)
    scale = max(float(ps.abs().max()), 1.0)
    log(f"mesh hnsw: CUDA sharded beam vs the same on CPU copies of the {MESH_SHARDS} shards, {len(qs)} "
        f"queries at ef={ef}: {differ} rows differ ({bad} outside near-ties), max |dscore| {err:.3g} "
        f"on equal rows; CPU {cpu_s:.2f} s")
    if bad or err > BEAM_RTOL * scale:
        raise AssertionError("mesh hnsw: the CUDA sharded beam disagrees with the CPU's")


def phase_mesh(workdir: Path, dev: torch.device, base: dict) -> dict:
    """The collections of phases 4, 6 and 7 reopened under MESH_SHARDS shards
    (GlobalConfig.mesh_devices, as the JAX package's dryrun turns its mesh
    on), after graft_entry.dryrun_multichip; then the sparse engines on 12,500
    of phase 9's documents. `base` holds what the unsharded phases read.
    Returns K1's launches on the sharded FLAT queries
    and on the sharded HNSW build."""
    import zvec_tpu_torch as zt
    from zvec_tpu_torch import graft_entry
    from zvec_tpu_torch.core.hnsw_sparse import SparseHnswEngine
    from zvec_tpu_torch.ops.flat_scan import flat_scan_topk
    from zvec_tpu_torch.ops.kmeans import lloyd
    from zvec_tpu_torch.utils.config import GlobalConfig

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = graft_entry.dryrun_multichip(MESH_SHARDS)
    log(f"mesh: graft_entry.dryrun_multichip({MESH_SHARDS}) in {time.perf_counter() - t0:.2f} s: "
        f"mesh {out['mesh']}, shards {out['shards']}")
    if any(not d.startswith("cuda") for v in out["shards"].values() for d in v):
        raise AssertionError("mesh: a dry-run shard is not on the card")
    config = GlobalConfig.instance()
    config.mesh_devices = MESH_SHARDS
    launches = {}
    try:
        # ---- FLAT: phase 4's collection ----
        qset, X = _data()
        col = zt.open(str(workdir / "bench1m"))
        flat_scan_topk.launches = 0
        first = col.batch_query("vec", qset[0], topk=K, output_fields=[])
        iters = 8
        times = []
        for _ in range(2):
            t1 = time.perf_counter()
            col.batch_query_many("vec", [qset[i % 4] for i in range(iters)], topk=K, output_fields=[])
            times.append((time.perf_counter() - t1) / iters)
        launches["mesh_flat"] = flat_scan_topk.launches
        st = next(s for s in col._impl._segments_snapshot() if s.doc_count > 0).engine_for("vec")._st
        log(f"mesh flat: {N} x {D} in {len(st.codes)} shards ({_shard_text(st.codes)} rows); "
            f"{min(times) * 1e3:.2f} ms per 1024-query batch (batch_query_many, {iters} blocks, best of "
            f"2; unsharded phase 4 {base['flat_ms']:.2f} ms); K1 launches {launches['mesh_flat']}")
        if st.mesh is None or len(st.codes) != MESH_SHARDS or not all(c.is_cuda for c in st.codes):
            raise AssertionError("mesh flat: the codes are not in 4 shards on the card")
        if launches["mesh_flat"] == 0:
            raise AssertionError("mesh flat: the sharded scan never launched the flat-scan kernel")
        got = _ids(first)
        os_, oi = _exact_oracle(torch.from_numpy(X).to(dev), torch.from_numpy(qset[0]).to(dev))
        exp, ps = oi.cpu().numpy(), -os_.cpu().numpy()
        near_tie = np.abs(ps[:, K - 1] - ps[:, K]) <= TIE_RTOL * np.abs(ps[:, K - 1])
        hit = np.array([len(set(got[r]) & set(exp[r, :K])) for r in range(Q)])
        other = (got != base["flat_ids"]).any(axis=1)
        log(f"mesh flat: recall@{K} {hit.sum() / (Q * K):.6f} ({int(((hit < K) & ~near_tie).sum())} rows "
            f"short outside near-ties); {int(other.sum())} rows differ from phase 4's ids "
            f"({int((other & ~near_tie).sum())} outside near-ties)")
        if ((hit < K) & ~near_tie).any() or (other & ~near_tie).any():
            raise AssertionError("mesh flat: recall below 1.0 or other ids than phase 4 outside near-ties")
        col._impl.close()
        del col, st
        gc.collect()
        torch.cuda.empty_cache()

        # ---- HNSW: phase 6's collection; its graph file holds no shards ----
        col = zt.open(str(workdir / "hnsw1m"))
        flat_scan_topk.launches = 0
        t1 = time.perf_counter()
        col.create_index("vec", zt.HnswIndexParam(zt.MetricType.L2, knn_k=MESH_KNN_K))
        t_build = time.perf_counter() - t1
        launches["mesh_hnsw_build"] = flat_scan_topk.launches
        engine = next(s for s in col._impl._segments_snapshot() if s.doc_count > 0).engine_for("vec")
        d = engine._dev
        log(f"mesh hnsw: create_index(knn_k={MESH_KNN_K}) built {MESH_SHARDS} shard graphs in {t_build:.2f} s "
            f"(shards {_shard_text(engine._codes)} rows; levels {[sh['num_levels'] for sh in d['shards']]}); "
            f"K1 launches {launches['mesh_hnsw_build']}; graph file {engine.build_times.get('dump_aux', 0):.2f} s")
        for i, bt in enumerate(engine.shard_build_times):
            log(f"mesh hnsw: shard {i}: " + ", ".join(f"{k} {v:.2f} s" for k, v in bt.items()))
        if not d.get("sharded") or not all(c.is_cuda for c in engine._codes):
            raise AssertionError("mesh hnsw: the engine is not sharded on the card")
        if launches["mesh_hnsw_build"] == 0:
            raise AssertionError("mesh hnsw: the shard builds never launched the flat-scan kernel")
        _, oi = _exact_oracle(torch.from_numpy(X).to(dev), torch.from_numpy(qset[0]).to(dev))
        exp = oi[:, :K].cpu().numpy()
        ids_128 = None
        for ef in MESH_HNSW_EFS:
            param = zt.HnswQueryParam(ef=ef, done_frac=1.0)
            got = _ids(col.batch_query("vec", qset[0], topk=K, output_fields=[], param=param))
            times = []
            for _ in range(2):
                t1 = time.perf_counter()
                col.batch_query_many("vec", qset, topk=K, output_fields=[], param=param)
                times.append((time.perf_counter() - t1) / len(qset))
            rec, ref = _recall(got, exp), base["hnsw_recall"][ef]
            ids_128 = got if ids_128 is None else ids_128
            log(f"mesh hnsw: ef={ef}: {min(times) * 1e3:.2f} ms per 1024-query batch (batch_query_many, "
                f"{len(qset)} blocks, best of 2); recall@{K} {rec:.4f} (unsharded phase 6 {ref:.4f}, "
                f"floor {ref - MESH_HNSW_SLACK:.4f})")
            if rec < ref - MESH_HNSW_SLACK:
                raise AssertionError(f"mesh hnsw: recall@10 at ef={ef} is {rec:.4f} < {ref - MESH_HNSW_SLACK:.4f}")
        beam_qs = np.random.default_rng(SEED + 2).standard_normal((MESH_CHECK_Q, D)).astype(np.float32)
        _mesh_beam_check(engine, beam_qs, BEAM_CHECK_EF)
        col._impl.close()
        del col, engine, d
        gc.collect()
        torch.cuda.empty_cache()
        before = flat_scan_topk.launches
        t1 = time.perf_counter()
        col = zt.open(str(workdir / "hnsw1m"))
        again = _ids(col.batch_query("vec", qset[0], topk=K, output_fields=[],
                                     param=zt.HnswQueryParam(ef=MESH_HNSW_EFS[0], done_frac=1.0)))
        t_open = time.perf_counter() - t1
        eng2 = next(s for s in col._impl._segments_snapshot() if s.doc_count > 0).engine_for("vec")
        loaded = int(eng2._loaded_aux.get("shards", 0)) == MESH_SHARDS and not eng2.build_times
        col._impl.close()
        log(f"mesh hnsw: reopened under {MESH_SHARDS} shards in {t_open:.2f} s (open + first batch): the "
            f"sharded graph file loaded without a build ({flat_scan_topk.launches - before} K1 launches); "
            f"{'identical' if (again == ids_128).all() else 'OTHER'} ids at ef={MESH_HNSW_EFS[0]}")
        if not loaded or flat_scan_topk.launches != before or not (again == ids_128).all():
            raise AssertionError("mesh hnsw: the sharded graph file did not reload as written")
        del col, eng2, X, qset
        gc.collect()
        torch.cuda.empty_cache()

        # ---- IVF: phase 7's collection ----
        X, queries, tags, price = _ivf_data()
        calls = lloyd.calls
        t1 = time.perf_counter()
        col = zt.open(str(workdir / "ivf1m"))
        param = zt.IVFQueryParam(nprobe=MESH_IVF_NPROBE)
        got = _ids(col.batch_query("vec", queries, topk=K, output_fields=[], param=param))
        t_open = time.perf_counter() - t1
        times = []
        for _ in range(2):
            t1 = time.perf_counter()
            col.batch_query("vec", queries, topk=K, output_fields=[], param=param)
            times.append(time.perf_counter() - t1)
        engine = next(s for s in col._impl._segments_snapshot() if s.doc_count > 0).engine_for("vec")
        xd = torch.from_numpy(X).to(dev)
        _, oi = _exact_oracle(xd, torch.from_numpy(queries).to(dev))
        rec, ref = _recall(got, oi[:, :K].cpu().numpy()), base["ivf_recall16"]
        log(f"mesh ivf: lists in {len(engine._lists_codes)} shards ({_shard_text(engine._lists_codes)} "
            f"virtual lists); open + first batch {t_open:.2f} s, lloyd calls {lloyd.calls - calls}; "
            f"nprobe={MESH_IVF_NPROBE}: {min(times) * 1e3:.2f} ms per 1024-query batch; recall@{K} {rec:.4f} "
            f"(unsharded phase 7 {ref:.4f}, floor {ref - MESH_IVF_SLACK:.4f})")
        if engine._smesh is None or lloyd.calls != calls:
            raise AssertionError("mesh ivf: the lists are not sharded, or k-means ran again")
        if rec < ref - MESH_IVF_SLACK:
            raise AssertionError(f"mesh ivf: recall@10 {rec:.4f} < {ref - MESH_IVF_SLACK:.4f}")
        sel = np.flatnonzero((tags == 3) & (price < 0.5))
        fs, fi = _exact_oracle(xd[torch.from_numpy(sel).to(dev)], torch.from_numpy(queries).to(dev))
        fexp, fd = sel[fi[:, :K].cpu().numpy()], -fs.cpu().numpy()
        near_tie = np.abs(fd[:, K - 1] - fd[:, K]) <= TIE_RTOL * np.abs(fd[:, K - 1])
        fgot = _ids(col.batch_query("vec", queries, topk=K, filter=IVF_FILTER, output_fields=[]))
        short = np.array([len(set(fgot[r]) & set(fexp[r])) < K for r in range(Q)])
        log(f"mesh ivf: filter {IVF_FILTER!r}: recall@{K} {_recall(fgot, fexp):.6f} against the filtered "
            f"oracle ({int(short.sum())} rows short, {int((short & ~near_tie).sum())} outside near-ties)")
        if (short & ~near_tie).any():
            raise AssertionError("mesh ivf: filtered recall@10 below 1.0 outside near-ties")
        col._impl.close()
        del col, engine, xd, X
        gc.collect()
        torch.cuda.empty_cache()

        # ---- sparse: 12,500 of phase 9's documents, its widths kept ----
        pools = sparse_topic_model()
        idx, val = sparse_make_rows(pools, MESH_SP_N, SP_NNZ_DOC, SP_SEED + 1)
        dicts = sparse_rows_to_dicts(idx, val)
        schema = zt.CollectionSchema("sparse_mesh", vectors=[
            zt.VectorSchema("sv", zt.DataType.SPARSE_VECTOR_FP32, 0,
                            zt.HnswIndexParam(zt.MetricType.IP, m=16, ef_construction=200))])
        t1 = time.perf_counter()
        col = zt.create_and_open(str(workdir / "sparse_mesh"), schema)
        for lo in range(0, MESH_SP_N, 1024):
            col.insert([zt.Doc(id=str(lo + i), vectors={"sv": dicts[lo + i]})
                        for i in range(min(1024, MESH_SP_N - lo))])
        t_insert = time.perf_counter() - t1
        col.optimize()
        t_build = time.perf_counter() - t1 - t_insert
        engine = next(s for s in col._impl._segments_snapshot() if s.doc_count > 0).engine_for("sv")
        q_idx, q_val = sparse_make_rows(pools, SP_GT_Q, SP_NNZ_Q, SP_SEED + 77, head_frac=0.25)
        qdicts = sparse_rows_to_dicts(q_idx, q_val)
        _, gi = _sparse_oracle([(idx, val)], q_idx, q_val, dev, K)
        lin = zt.HnswQueryParam(ef=64, is_linear=True)
        flat_rec = _recall(_ids(col.batch_query("sv", qdicts, topk=K, output_fields=[], param=lin)), gi)
        param = zt.HnswQueryParam(ef=MESH_SP_EF)
        t1 = time.perf_counter()
        beam_rec = _recall(_ids(col.batch_query("sv", qdicts, topk=K, output_fields=[], param=param)), gi)
        t_beam = time.perf_counter() - t1
        config.mesh_devices = 0
        single = SparseHnswEngine(params=zt.HnswIndexParam(zt.MetricType.IP, m=16, ef_construction=200))
        single.bind_data(lambda: dicts, lambda: 1)
        t1 = time.perf_counter()
        single._ensure_fresh()
        t_single = time.perf_counter() - t1
        _, s_ids = single.search(qdicts, K, None, param)
        single_rec = _recall(s_ids, gi)
        config.mesh_devices = MESH_SHARDS
        log(f"mesh sparse: {MESH_SP_N} docs x {SP_NNZ_DOC} terms (phase 9's generator, rows cut from "
            f"{SP_N}): insert {t_insert:.2f} s, optimize {t_build:.2f} s (shards "
            f"{_shard_text(engine._doc_idx)} rows, exact forward pass per shard "
            f"{engine.build_times.get('forward_knn', 0):.2f} s); sparse FLAT (is_linear) recall@{K} "
            f"{flat_rec:.4f} (floor {SP_MIN_RECALL_FLAT}); sparse HNSW ef={MESH_SP_EF}: recall@{K} "
            f"{beam_rec:.4f}, {t_beam * 1e3:.2f} ms for {SP_GT_Q} queries; unsharded engine on the same "
            f"docs (built in {t_single:.2f} s) {single_rec:.4f} (floor {single_rec - MESH_SP_SLACK:.4f})")
        if engine._smesh is None or len(engine._l0) != MESH_SHARDS or not all(t.is_cuda for t in engine._l0):
            raise AssertionError("mesh sparse: the graph is not in 4 shards on the card")
        if flat_rec < SP_MIN_RECALL_FLAT or beam_rec < single_rec - MESH_SP_SLACK:
            raise AssertionError("mesh sparse: recall below its floor")
        col._impl.close()
        del col, engine, single
    finally:
        config.mesh_devices = 0
    log(f"mesh: peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    return launches


def _first_engine(col, field: str = "vec"):
    return next(s for s in col._impl._segments_snapshot() if s.doc_count > 0).engine_for(field)


def _ip_oracle(xd: torch.Tensor, qd: torch.Tensor, k: int):
    """Exact fp32 inner-product top-k on the card (TF32 off)."""
    return _topk_chunks(qd, lambda qb: qb @ xd.T, k)


def _timed_batch(col, field: str, queries: np.ndarray, param, reps: int = 2):
    """One batch_query for the answer, then the best of `reps` timed ones:
    (ids, scores, seconds)."""
    first = col.batch_query(field, queries, topk=K, output_fields=[], param=param)
    times = []
    for _ in range(reps):
        t1 = time.perf_counter()
        col.batch_query(field, queries, topk=K, output_fields=[], param=param)
        times.append(time.perf_counter() - t1)
    ids = _ids(first)
    scores = np.array([[d.score for d in docs] for docs in first], np.float64)
    if ids.shape != (len(queries), K) or not np.isfinite(scores).all():
        raise AssertionError(f"{field}: results are not ({len(queries)}, {K}) finite scores")
    return ids, scores, min(times)


def _insert_all(col, n: int, make_doc) -> float:
    t0 = time.perf_counter()
    for lo in range(0, n, 1024):
        col.insert([make_doc(i) for i in range(lo, min(lo + 1024, n))])
    return time.perf_counter() - t0


def _reopen_check(path: Path, field: str, queries: np.ndarray, param, want: np.ndarray, label: str) -> None:
    """Open the collection again: the index file loads with no K1 launch and
    no build, and the answers equal `want`."""
    import zvec_tpu_torch as zt
    from zvec_tpu_torch.ops.flat_scan import flat_scan_topk

    before = flat_scan_topk.launches
    t0 = time.perf_counter()
    reopened = zt.open(str(path))
    again = _ids(reopened.batch_query(field, queries, topk=K, output_fields=[], param=param))
    t_open = time.perf_counter() - t0
    loaded = _first_engine(reopened, field)._loaded_aux is not None
    reopened._impl.close()
    if flat_scan_topk.launches != before or not loaded:
        raise AssertionError(f"{label}: the reopened collection rebuilt its graph")
    if not (again == want).all():
        raise AssertionError(f"{label}: reopened collection returns other ids")
    log(f"{label}: reopened collection loads the graph from disk (no kernel launch) and returns identical "
        f"ids; open + first batch {t_open:.2f} s")


def phase_kernel_new_shapes() -> dict:
    """K1 at the shapes the matrix adds, alone on the card: the MIPS build
    (the text2image rows augmented to D = 201 and padded to 204 columns, as
    the build scans them on the card, 2048 code rows a scan, k 128, fp32 L2;
    then on the unpadded 804-byte rows, by 4-byte copies and by the byte
    loads they took before), the HAMMING FLAT scan (+-1 codes of 256 bits, Q 1024,
    k 10, L2, the one-pass instance the engine asks for, also timed in three
    passes; every key an integer, equal to the plain version's, ids compared
    under the tie rule) and the FP16 FLAT scan at the GloVe-100 width
    (200-byte rows on 8-byte copies)."""
    from zvec_tpu_torch.ops import flat_scan as fs
    from zvec_tpu_torch.typing import MetricType

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    kc = max(32, MI_N // 10_000)
    centers = torch.randn((kc, MI_D), generator=g, device=dev) * 5.0
    x = centers[torch.randint(0, kc, (MI_N,), generator=g, device=dev)]
    x += torch.randn((MI_N, MI_D), generator=g, device=dev)
    x *= torch.exp(MI_NORM_SIGMA * torch.randn((MI_N, 1), generator=g, device=dev)) / x.norm(dim=1, keepdim=True)
    sq = (x * x).sum(1)
    xa = torch.zeros((N_BUILD_PAD, _pad4(MI_D + 1)), device=dev)  # as HnswEngine pads its scan codes
    xa[:MI_N, :MI_D] = x
    xa[:MI_N, MI_D] = torch.sqrt(torch.clamp(sq.max() - sq, min=0.0))  # ops/quantize.py::mips_augment
    del x, sq, centers
    mask = (torch.arange(N_BUILD_PAD, device=dev) < MI_N).to(torch.int8)
    q = xa[:Q_BUILD].contiguous()
    bound = _bound(Q_BUILD, N_BUILD_PAD, MI_D + 1, K_BUILD, fs.pick_tile(N_BUILD_PAD, K_BUILD), xa[:, : MI_D + 1])
    norms = (xa * xa).sum(1)
    # -(|q|^2 + |x|^2 - 2 q.x) cancels: every augmented row has |x|^2 = max
    # |x|^2, so a score is good to a few ulps of |q|^2 + max |x|^2, not of itself
    width = TIE_RTOL * (norms[:Q_BUILD] + norms.max())
    out = {"mips_build_shape": _k1_at_build_shape(xa, mask, q, norms, "L2", "mips build shape", bound,
                                                  _library_ms(q[:, : MI_D + 1], xa[:, : MI_D + 1]),
                                                  own_width=width, unpadded_d=MI_D + 1)}
    del xa, q, mask, norms
    torch.cuda.empty_cache()

    centers = torch.randint(0, 2, (max(32, HM_N // 10_000), HM_BITS), generator=g, device=dev)
    rows = centers[torch.randint(0, centers.shape[0], (HM_N,), generator=g, device=dev)]
    rows ^= (torch.rand((HM_N, HM_BITS), generator=g, device=dev) < HM_FLIP).long()
    x = torch.zeros((HM_N_PAD, HM_BITS), device=dev)
    x[:HM_N] = rows.float() * 2.0 - 1.0
    qb = centers[torch.randint(0, centers.shape[0], (Q,), generator=g, device=dev)]
    qb ^= (torch.rand((Q, HM_BITS), generator=g, device=dev) < HM_Q_FLIP).long()
    q = qb.float() * 2.0 - 1.0
    del rows, qb, centers
    mask = (torch.arange(HM_N_PAD, device=dev) < HM_N).to(torch.int8)
    norms = (x * x).sum(1)
    kw = dict(metric=MetricType.L2, topk=K, exact_tf32=True)  # as FlatEngine asks for +-1 codes
    args = (q, x, norms, mask)
    ts_k, _ = fs.flat_scan_stage1(*args, **kw)
    ts_p, _ = fs.flat_scan_stage1(*args, plain=True, **kw)
    torch.cuda.synchronize()
    s1_err = float((ts_k - ts_p).abs().max())  # integer keys: 0 unless a key is wrong
    del ts_k, ts_p
    ks, ki = fs.flat_scan_topk(*args, **kw)
    ps, pi = fs.flat_scan_topk_plain(*args, **kw)
    bad, differ, final_err = _check_final_at_k(ks, ki, ps, pi, rtol=0.0)
    k_ms = time_ms(lambda: fs.flat_scan_stage1(*args, **kw))
    p_ms = time_ms(lambda: fs.flat_scan_stage1(*args, plain=True, **kw))
    three_ms = time_ms(lambda: fs.flat_scan_stage1(*args, **{**kw, "exact_tf32": False}))
    bound = _bound(Q, HM_N_PAD, HM_BITS, K, fs.pick_tile(HM_N_PAD, K), x, one_pass=True)
    path = _k1_path(x, exact=True)
    with _tf32(False):
        full = q @ x[:65536].T
    with _tf32(True):  # +-1 products and their sums (|.| <= 256) are exact in one TF32 pass
        tf32_exact = torch.equal(q @ x[:65536].T, full)
    del full
    lib_ms = _library_ms(q, x, tf32=True)
    log(f"kernel hamming shape fp32 L2 on +-1 codes N={HM_N_PAD} D={HM_BITS} Q={Q} k={K} ({_path_text(path)}): "
        f"stage1 max|dkey| {s1_err:.3g}; final rows differing {differ} (outside exact ties {bad}) max|dscore| "
        f"{final_err:.3g}; stage1 {k_ms:.3f} ms (three passes {three_ms:.3f} ms) vs plain {p_ms:.3f} ms; TF32 "
        f"product equal to the fp32 one on 65,536 rows {tf32_exact}; "
        + _bound_text(bound, k_ms, lib_ms, "TF32, exact here"))
    if s1_err != 0.0 or bad or final_err != 0.0 or not tf32_exact:
        raise AssertionError("kernel disagrees with plain version at the hamming shape")
    out["hamming_flat_shape"] = dict(max_abs_err=s1_err, ms=k_ms, plain_ms=p_ms, bound_ms=bound["bound_ms"],
                                     bound_by=bound["bound_by"], library_ms=lib_ms, roofline=bound["bound_ms"] / k_ms,
                                     three_pass_ms=three_ms, **path)
    del x, q, mask, norms, args
    torch.cuda.empty_cache()
    out["fp16_glove_flat_shape"] = _k1_fp16_glove_shape(g)
    return out


def _k1_fp16_glove_shape(g: torch.Generator) -> dict:
    """K1 on FP16 codes of the GloVe-100 width (config #3's D = 100, COSINE:
    unit rows stored in fp16, 200-byte rows on 8-byte copies) over N_PAD rows,
    Q 1024, k 10, as FlatEngine scans an FP16 field: stage one and the final
    top-k under phase 3's rules, then the times (no library call: the codes
    would widen first)."""
    from zvec_tpu_torch.ops import flat_scan as fs
    from zvec_tpu_torch.typing import MetricType

    dev = torch.device("cuda")
    x = torch.randn((N_PAD, CD_HNSW_D), generator=g, device=dev)
    x[N:] = 0.0
    x = torch.nn.functional.normalize(x, dim=1)  # unit rows; the padding stays zero
    q = torch.randn((Q, CD_HNSW_D), generator=g, device=dev)
    codes, norms, _ = _make_codes(x, "fp16", "COSINE")
    del x
    mask = (torch.arange(N_PAD, device=dev) < N).to(torch.int8)
    kw = dict(metric=MetricType.COSINE, topk=K)
    args = (q, codes, norms, mask)
    ts_k, ti_k = fs.flat_scan_stage1(*args, **kw)
    ts_p, ti_p = fs.flat_scan_stage1(*args, plain=True, **kw)
    torch.cuda.synchronize()
    s1_err = float((ts_k - ts_p).abs().max())
    s1_ok = torch.allclose(ts_k, ts_p, rtol=STAGE1_RTOL, atol=STAGE1_ATOL)
    swaps = float((ti_k != ti_p).float().mean())
    del ts_k, ti_k, ts_p, ti_p
    ks, ki = fs.flat_scan_topk(*args, **kw)
    ps, pi = fs.flat_scan_topk_plain(*args, **{**kw, "topk": K + 1})
    bad, differ, final_err = _check_final(ks, ki, ps, pi)
    finite = bool(torch.isfinite(ks).all()) and bool((ki >= 0).all())
    k_ms = time_ms(lambda: fs.flat_scan_stage1(*args, **kw))
    p_ms = time_ms(lambda: fs.flat_scan_stage1(*args, plain=True, **kw))
    bound = _bound(Q, N_PAD, CD_HNSW_D, K, fs.pick_tile(N_PAD, K), codes)
    path = _k1_path(codes)
    log(f"kernel fp16 GloVe-100 shape COSINE N={N_PAD} D={CD_HNSW_D} Q={Q} k={K} ({_path_text(path)}): stage1 "
        f"max|dkey| {s1_err:.3g} id swaps {swaps:.2e}; final rows differing {differ} (outside ties {bad}) "
        f"max|dscore| {final_err:.3g}; stage1 {k_ms:.3f} ms vs plain {p_ms:.3f} ms; "
        + _bound_text(bound, k_ms, None))
    if not (s1_ok and swaps <= STAGE1_MAX_ID_SWAPS and bad == 0 and finite):
        raise AssertionError("kernel disagrees with plain version at the fp16 GloVe-100 shape")
    del codes, norms, mask, q, args
    return dict(max_abs_err=s1_err, ms=k_ms, plain_ms=p_ms, bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                library_ms=None, roofline=bound["bound_ms"] / k_ms, **path)


def phase_mips(workdir: Path, dev: torch.device) -> int:
    """The default HNSW index (HnswIndexParam(): IP, m 50, efc 500) on the
    text2image shape at MI_N rows: the MIPS augmentation, the build with K1
    at D = 201, recall against the exact IP oracle at MI_EFS, scores as inner
    products, the beam card against CPU, reopen. Returns K1's launches in the build."""
    import zvec_tpu_torch as zt
    from zvec_tpu_torch.ops.flat_scan import flat_scan_topk
    from zvec_tpu_torch.ops.hnsw import hnsw_search
    from zvec_tpu_torch.ops.quantize import mips_augment_query

    t0 = time.perf_counter()
    X, queries = mips_data(MI_N, MI_NQ)
    norms = np.linalg.norm(X, axis=1)
    log(f"mips: {MI_N} x {MI_D} rows (make_data clustered directions, lognormal(0, {MI_NORM_SIGMA}) norms: "
        f"min {norms.min():.4f} median {np.median(norms):.4f} max {norms.max():.4f}) and {MI_NQ} unit queries "
        f"made in {time.perf_counter() - t0:.2f} s")
    param = zt.HnswIndexParam()
    if (param.metric_type, param.m, param.ef_construction) != (zt.MetricType.IP, 50, 500):
        raise AssertionError(f"mips: HnswIndexParam()'s defaults moved: {param}")
    schema = zt.CollectionSchema("t2i", vectors=[zt.VectorSchema("vec", zt.DataType.VECTOR_FP32, MI_D, param)])
    path = workdir / "t2i"
    flat_scan_topk.launches = 0
    col = zt.create_and_open(str(path), schema)
    t_insert = _insert_all(col, MI_N, lambda i: zt.Doc(id=str(i), vectors={"vec": X[i]}))
    t0 = time.perf_counter()
    col.optimize()
    t_opt = time.perf_counter() - t0
    col.flush()
    launches = flat_scan_topk.launches
    engine = _first_engine(col)
    bt = engine.build_times
    log(f"mips: insert {t_insert:.2f} s, optimize {t_opt:.2f} s, of which the engine build "
        f"{engine.stats.last_build_secs:.2f} s: " + ", ".join(f"{k} {v:.2f} s" for k, v in bt.items())
        + f"; codes {engine._codes.dtype} {tuple(engine._codes.shape)} (D + 1: the augmented column), max |x|^2 "
        f"{engine._mips_max_norm2:.4f}, search metric {engine._search_metric.name}, {engine.build_info}; "
        f"K1 launches in the build {launches}")
    if not engine._mips or engine._codes.shape[1] != MI_D + 1 or engine._search_metric != zt.MetricType.L2:
        raise AssertionError("mips: the index did not take the MIPS -> L2 augmentation")
    if launches == 0:
        raise AssertionError("mips: the build never launched the flat-scan kernel")

    _, gi = _ip_oracle(torch.from_numpy(X).to(dev), torch.from_numpy(queries).to(dev), K)
    exp = gi.cpu().numpy()
    recalls, ids128 = {}, None
    for ef in MI_EFS:
        ids, scores, batch_s = _timed_batch(col, "vec", queries, zt.HnswQueryParam(ef=ef))
        recalls[ef] = _recall(ids, exp)
        exact = np.einsum("qd,qkd->qk", queries.astype(np.float64), X[ids].astype(np.float64))
        err = float((np.abs(scores - exact) / np.maximum(np.abs(exact), 1e-6)).max())
        ids128 = ids if ef == 128 else ids128
        log(f"mips: ef={ef}: {batch_s * 1e3:.2f} ms per {MI_NQ}-query batch (best of 2; "
            f"{hnsw_search.last_steps} beam steps in the last batch); recall@{K} {recalls[ef]:.4f} against the "
            f"exact IP oracle; max |score - q.x| / |q.x| {err:.3g}")
        if err > MI_SCORE_RTOL or (np.diff(scores, axis=1) > 1e-6).any():
            raise AssertionError("mips: the scores are not the rows' inner products, best first")
    _profiled(f"mips beam batch ef=128 ({MI_NQ} queries)",
              lambda: engine.search(queries, K, None, zt.HnswQueryParam(ef=128)))
    _beam_check(engine, mips_augment_query(queries[:BEAM_CHECK_Q]), "mips")
    col._impl.close()
    del col, engine
    gc.collect()
    torch.cuda.empty_cache()
    missed = {ef: r for ef, r in recalls.items() if r < MI_FLOORS[ef]}
    if missed:  # the control first, so that the log tells the algorithm from the port
        _mips_cosine_control(workdir, X, queries, dev, recalls[MI_EFS[-1]])
        raise AssertionError(f"mips: recall@10 below its floor at ef {sorted(missed)}: {missed}, floors {MI_FLOORS}")
    _reopen_check(path, "vec", queries, zt.HnswQueryParam(ef=128), ids128, "mips")
    shutil.rmtree(path, ignore_errors=True)
    return launches


def _mips_cosine_control(workdir: Path, X: np.ndarray, queries: np.ndarray, dev: torch.device, ip_recall: float):
    """The same rows under COSINE (no augmentation), logged: if the port's
    graph and beam read the floor there, the IP shortfall is the
    augmentation's."""
    import zvec_tpu_torch as zt

    schema = zt.CollectionSchema("t2i_cos", vectors=[zt.VectorSchema(
        "vec", zt.DataType.VECTOR_FP32, MI_D, zt.HnswIndexParam(zt.MetricType.COSINE))])
    path = workdir / "t2i_cos"
    col = zt.create_and_open(str(path), schema)
    _insert_all(col, MI_N, lambda i: zt.Doc(id=str(i), vectors={"vec": X[i]}))
    col.optimize()
    _, gi = _cosine_oracle(torch.from_numpy(X).to(dev), torch.from_numpy(queries).to(dev), K)
    ids = _ids(col.batch_query("vec", queries, topk=K, output_fields=[], param=zt.HnswQueryParam(ef=MI_EFS[-1])))
    cos = _recall(ids, gi)
    col._impl.close()
    shutil.rmtree(path, ignore_errors=True)
    log(f"mips: COSINE control on the same rows at ef={MI_EFS[-1]}: recall@{K} {cos:.4f} against the exact "
        f"COSINE oracle (IP through the augmentation {ip_recall:.4f}, floor {MI_FLOORS[MI_EFS[-1]]})")


def phase_compact(workdir: Path, dev: torch.device, base: dict) -> tuple:
    """Phase 6's 1M HNSW collection after `mesh`: delete CP_DELETE random pks,
    delete_by_filter(CP_DBF), optimize (the merge without the deleted docs,
    then the graph rebuilt over the survivors on K1), against a plain
    reference of the surviving pks; K1 against its plain version at the
    rebuild's shape; recall at ef 256 beside phase 6's; reopen. Returns
    (K1's launches in the rebuild, the K1 case)."""
    import zvec_tpu_torch as zt
    from zvec_tpu_torch.ops import flat_scan as fs
    from zvec_tpu_torch.ops.flat_scan import flat_scan_topk

    qset, X = _data()
    grp = np.random.default_rng(SEED + 3).integers(0, GRP_VALUES, N)  # phase 6's field
    gone = np.random.default_rng(CP_SEED).choice(N, CP_DELETE, replace=False)
    alive = np.ones(N, bool)
    alive[gone] = False
    alive &= grp != 7
    survivors = np.flatnonzero(alive)
    path = workdir / "hnsw1m"
    t0 = time.perf_counter()
    col = zt.open(str(path))
    t_open = time.perf_counter() - t0
    if col.stats.doc_count != N:
        raise AssertionError(f"compact: phase 6's collection holds {col.stats.doc_count} docs, not {N}")
    t0 = time.perf_counter()
    statuses = [st for lo in range(0, CP_DELETE, 1024)  # a write batch holds at most 1024
                for st in col.delete([str(i) for i in gone[lo : lo + 1024]])]
    t_del = time.perf_counter() - t0
    col.delete_by_filter(CP_DBF)
    t_dbf = time.perf_counter() - t0 - t_del
    if not all(statuses) or col.stats.doc_count != len(survivors):
        raise AssertionError(f"compact: {col.stats.doc_count} docs after the deletes, the reference says "
                             f"{len(survivors)}")
    impl = col._impl
    segs_before = [(s.meta.segment_id, s.doc_count) for s in impl._segments_snapshot() if s.doc_count > 0]
    built = []
    build = impl._build_indexes_for

    def timed_build(seg):
        t1 = time.perf_counter()
        build(seg)
        built.append(time.perf_counter() - t1)

    impl._build_indexes_for = timed_build
    flat_scan_topk.launches = 0
    t0 = time.perf_counter()
    try:
        col.optimize()
    finally:
        del impl._build_indexes_for
    t_opt = time.perf_counter() - t0
    col.flush()
    launches = flat_scan_topk.launches
    segs = [s for s in impl._segments_snapshot() if s.doc_count > 0]
    engine = segs[0].engine_for("vec")
    bt = engine.build_times
    log(f"compact: open {t_open:.2f} s; delete {CP_DELETE} pks {t_del:.2f} s, delete_by_filter({CP_DBF!r}) "
        f"{t_dbf:.2f} s; {col.stats.doc_count} docs (reference {len(survivors)}); optimize {t_opt:.2f} s: the "
        f"merge (sealed store read, filtered, written) {t_opt - sum(built):.2f} s, the index build "
        f"{sum(built):.2f} s (" + ", ".join(f"{k} {v:.2f} s" for k, v in bt.items())
        + f"); segments {segs_before} -> {[(s.meta.segment_id, s.doc_count) for s in segs]}, writing "
        f"{impl.writing.doc_count}; {engine.build_info}; K1 launches in the rebuild {launches}")
    if len(segs) != 1 or segs[0].doc_count != len(survivors) or impl.writing.doc_count != 0 or len(built) != 1:
        raise AssertionError("compact: the merge did not leave one sealed segment of the survivors")
    if launches == 0:
        raise AssertionError("compact: the rebuild never launched the flat-scan kernel")
    # K1 where the rebuild called it: the survivors' own codes and norms
    # padded to 1024 rows as the build pads them, 2048 code rows a scan
    n = segs[0].doc_count
    n_pad = -(-n // 1024) * 1024
    x = torch.zeros((n_pad, D), device=dev)
    x[:n] = engine._codes[:n]
    sq = torch.zeros(n_pad, device=dev)
    sq[:n] = engine._norms[:n]
    mask = (torch.arange(n_pad, device=dev) < n).to(torch.int8)
    q = x[:Q_BUILD].contiguous()
    if engine._codes.dtype != torch.float32 or engine._search_metric != zt.MetricType.L2:
        raise AssertionError("compact: the rebuilt engine does not hold fp32 L2 codes")
    bound = _bound(Q_BUILD, n_pad, D, K_BUILD, fs.pick_tile(n_pad, K_BUILD), x)
    case = _k1_at_build_shape(x, mask, q, sq, "L2", "compaction rebuild shape (beside the other workers)", bound,
                              _library_ms(q, x))
    flat_scan_topk.launches = launches  # the comparison's launches are not the path's
    del x, sq, mask, q

    _, oi = _exact_oracle(torch.from_numpy(X[survivors]).to(dev), torch.from_numpy(qset[0]).to(dev))
    exp = survivors[oi[:, :K].cpu().numpy()]
    param = zt.HnswQueryParam(ef=256, done_frac=1.0)
    first = _ids(col.batch_query("vec", qset[0], topk=K, output_fields=[], param=param))
    t1 = time.perf_counter()
    out = col.batch_query_many("vec", qset, topk=K, output_fields=[], param=param)
    batch_s = (time.perf_counter() - t1) / len(qset)
    returned = np.concatenate([_ids(r).ravel() for r in out])
    dead = int((~alive[returned]).sum())
    recall = _recall(first, exp)
    ref = base["hnsw_recall"][256]
    log(f"compact: ef=256: {batch_s * 1e3:.2f} ms per 1024-query batch ({len(qset)} blocks); deleted pks "
        f"returned {dead} of {returned.size}; recall@{K} {recall:.4f} against the survivors' exact oracle "
        f"(phase 6 before the deletes {ref:.4f}, floor {ref - CP_RECALL_SLACK:.4f})")
    if dead:
        raise AssertionError("compact: a deleted pk came back")
    if recall < ref - CP_RECALL_SLACK:
        raise AssertionError(f"compact: recall@10 {recall:.4f} < phase 6's {ref:.4f} less {CP_RECALL_SLACK}")
    col._impl.close()
    del col, engine, segs
    gc.collect()
    torch.cuda.empty_cache()
    _reopen_check(path, "vec", qset[0], param, first, "compact")
    return launches, case


def _codes_flat(workdir: Path, dev: torch.device) -> int:
    """FLAT with FP16 / INT8 / INT4 codes and IP, four fields on phase 4's
    data: K1 on each field's codes (refine off), recall with and without the
    refine, and K1's answer equal to its plain version on the engine's own
    device codes, ties aside. Returns K1's launches on the fields' queries."""
    import zvec_tpu_torch as zt
    from zvec_tpu_torch.model.param.param import FlatQueryParam
    from zvec_tpu_torch.ops import flat_scan as fs

    qset, X = _data()
    queries = qset[0]
    quant = {None: zt.QuantizeType.UNDEFINED, "FP16": zt.QuantizeType.FP16, "INT8": zt.QuantizeType.INT8,
             "INT4": zt.QuantizeType.INT4}
    schema = zt.CollectionSchema("codes_flat", vectors=[
        zt.VectorSchema(f, zt.DataType.VECTOR_FP32, D, zt.FlatIndexParam(zt.MetricType[m], quantize_type=quant[q]))
        for f, (m, q) in CD_FLAT_FIELDS.items()])
    path = workdir / "codes_flat"
    col = zt.create_and_open(str(path), schema)
    t_insert = _insert_all(col, N, lambda i: zt.Doc(id=str(i), vectors={f: X[i] for f in CD_FLAT_FIELDS}))
    col.optimize()
    col.flush()
    log(f"codes flat: {N} x {D} docs into {len(CD_FLAT_FIELDS)} fields in {t_insert:.2f} s")
    xd, qd = torch.from_numpy(X).to(dev), torch.from_numpy(queries).to(dev)
    oracle = {"L2": _exact_oracle(xd, qd)[1][:, :K].cpu().numpy(), "IP": _ip_oracle(xd, qd, K)[1].cpu().numpy()}
    del xd
    launches = 0
    fs.flat_scan_topk.launches = 0
    for f, (m, q) in CD_FLAT_FIELDS.items():
        engine = _first_engine(col, f)
        for refine in ((False, True) if q else (None,)):
            before = fs.flat_scan_topk.launches
            t0 = time.perf_counter()
            ids, scores, batch_s = _timed_batch(col, f, queries, FlatQueryParam(is_using_refiner=refine))
            k1 = fs.flat_scan_topk.launches - before
            st = engine._st  # built by the first query
            log(f"codes flat {f} ({m}, {q or 'fp32'}): refine {'off' if refine is False else 'on' if q else 'n/a'}: "
                f"{batch_s * 1e3:.2f} ms per 1024-query batch (best of 2; first call with the engine build "
                f"{time.perf_counter() - t0 - 2 * batch_s:.2f} s); recall@{K} {_recall(ids, oracle[m]):.4f} against "
                f"the exact fp32 {m} oracle; codes {st.codes.dtype} {tuple(st.codes.shape)}, dequant {st.dequant}; "
                f"K1 launches {k1}")
            if refine is not True and k1 == 0:
                raise AssertionError(f"codes flat {f}: the scan at k = {K} never launched the flat-scan kernel")
            if refine is None and _recall(ids, oracle[m]) < 1.0 - 1e-3:
                raise AssertionError(f"codes flat {f}: the exact fp32 scan reads below 1.0")
        launches = fs.flat_scan_topk.launches
        # K1's answer (the engine's own scan, refine off) against its plain
        # version on the same device codes, norms and mask
        sims, idx = engine.search(queries, K, None, FlatQueryParam(is_using_refiner=False))
        mask = (torch.arange(st.n_pad, device=dev) < st.n).to(torch.int8)
        kw = dict(metric=zt.MetricType[m], dequant=st.dequant, int4_dim=D if st.int4_packed else None)
        ps, pi = fs.flat_scan_topk_plain(qd, st.codes, st.norms, mask, topk=K + 1, **kw)
        bad, differ, err = _check_final(torch.from_numpy(sims), torch.from_numpy(idx), ps.cpu(), pi.cpu())
        k_ms = time_ms(lambda: fs.flat_scan_stage1(qd, st.codes, st.norms, mask, topk=K, **kw))
        p_ms = time_ms(lambda: fs.flat_scan_stage1(qd, st.codes, st.norms, mask, topk=K, plain=True, **kw))
        bound = _bound(Q, st.n_pad, D, K, fs.pick_tile(st.n_pad, K), st.codes)
        log(f"codes flat {f}: K1 on the engine's codes vs its plain version: rows differing {differ} (outside "
            f"near-ties {bad}), max |dscore| {err:.3g}; stage1 {k_ms:.3f} ms vs plain {p_ms:.3f} ms (beside the "
            f"other workers); " + _bound_text(bound, k_ms, _library_ms(qd, st.codes)))
        fs.flat_scan_topk.launches = launches  # the comparison's launches are not the path's
        if bad:
            raise AssertionError(f"codes flat {f}: K1 disagrees with its plain version on the engine's codes")
    col._impl.close()
    shutil.rmtree(path, ignore_errors=True)
    return launches


def _codes_ivf(workdir: Path, dev: torch.device) -> None:
    """IVF-SQ8 (L2, SOAR, INT8 lists) and IVF IP (SOAR, fp32 lists) on
    phase 7's deployment: nprobe CD_NPROBES at phase 7's floors (the same
    lists), the probe card against CPU."""
    import zvec_tpu_torch as zt

    X, queries, _, _ = _ivf_data()
    quant = {None: zt.QuantizeType.UNDEFINED, "INT8": zt.QuantizeType.INT8}
    schema = zt.CollectionSchema("codes_ivf", vectors=[zt.VectorSchema(
        f, zt.DataType.VECTOR_FP32, IVF_D, zt.IVFIndexParam(zt.MetricType[m], use_soar=True, quantize_type=quant[q]))
        for f, (m, q) in CD_IVF_FIELDS.items()])
    path = workdir / "codes_ivf"
    col = zt.create_and_open(str(path), schema)
    t_insert = _insert_all(col, IVF_N, lambda i: zt.Doc(id=str(i), vectors={f: X[i] for f in CD_IVF_FIELDS}))
    t0 = time.perf_counter()
    col.optimize()
    t_opt = time.perf_counter() - t0
    col.flush()
    xd, qd = torch.from_numpy(X).to(dev), torch.from_numpy(queries).to(dev)
    oracle = {"L2": _exact_oracle(xd, qd)[1][:, :K].cpu().numpy(), "IP": _ip_oracle(xd, qd, K)[1].cpu().numpy()}
    del xd
    log(f"codes ivf: {IVF_N} x {IVF_D} docs into {len(CD_IVF_FIELDS)} fields: insert {t_insert:.2f} s, optimize "
        f"{t_opt:.2f} s")
    for f, (m, q) in CD_IVF_FIELDS.items():
        engine = _first_engine(col, f)
        bt = engine.build_times
        log(f"codes ivf {f} ({m}, {q or 'fp32'}): build " + ", ".join(f"{k} {v:.2f} s" for k, v in bt.items())
            + f"; lists {engine._lists_codes.dtype} {tuple(engine._lists_codes.shape)}, dequant {engine._dequant}")
        if (engine._lists_codes.dtype == torch.int8) != (q == "INT8"):
            raise AssertionError(f"codes ivf {f}: the lists are {engine._lists_codes.dtype}")
        for nprobe in CD_NPROBES:
            ids, _, batch_s = _timed_batch(col, f, queries, zt.IVFQueryParam(nprobe=nprobe))
            recall, floor = _recall(ids, oracle[m]), IVF_FLOORS[nprobe]
            log(f"codes ivf {f}: nprobe={nprobe}: {batch_s * 1e3:.2f} ms per 1024-query batch (best of 2); "
                f"recall@{K} {recall:.4f} against the exact fp32 {m} oracle (floor {floor})")
            if recall < floor:
                raise AssertionError(f"codes ivf {f}: recall@10 at nprobe={nprobe} is {recall:.4f} < {floor}")
        _probe_check(engine, queries, dev, label=f"codes ivf {f}")
    col._impl.close()
    shutil.rmtree(path, ignore_errors=True)


def _codes_hnsw(workdir: Path, dev: torch.device) -> None:
    """bench_suite.py's config #3 (GloVe-100 shape, COSINE, m 50, efc 500) at
    CD_HNSW_N rows with INT8, FP16 and INT4 fields: raw and refined recall at
    CD_EFS against the exact COSINE oracle, INT8 refined at CD_FLOORS, each
    code type's beam card against CPU."""
    import zvec_tpu_torch as zt

    X, queries = config3_data(CD_HNSW_N, Q)
    schema = zt.CollectionSchema("glove_like", vectors=[zt.VectorSchema(
        f, zt.DataType.VECTOR_FP32, CD_HNSW_D, zt.HnswIndexParam(
            zt.MetricType.COSINE, m=50, ef_construction=500, quantize_type=zt.QuantizeType[f.upper()]))
        for f in CD_HNSW_FIELDS])
    path = workdir / "codes_hnsw"
    col = zt.create_and_open(str(path), schema)
    t_insert = _insert_all(col, CD_HNSW_N, lambda i: zt.Doc(id=str(i), vectors={f: X[i] for f in CD_HNSW_FIELDS}))
    t0 = time.perf_counter()
    col.optimize()
    t_opt = time.perf_counter() - t0
    col.flush()
    _, gi = _cosine_oracle(torch.from_numpy(X).to(dev), torch.from_numpy(queries).to(dev), K)
    log(f"codes hnsw: {CD_HNSW_N} x {CD_HNSW_D} docs into {len(CD_HNSW_FIELDS)} fields: insert {t_insert:.2f} s, "
        f"optimize (three graph builds) {t_opt:.2f} s")
    recalls = {}
    for f in CD_HNSW_FIELDS:
        engine = _first_engine(col, f)
        log(f"codes hnsw {f}: build " + ", ".join(f"{k} {v:.2f} s" for k, v in engine.build_times.items())
            + f"; {engine.build_info}; search codes {engine._codes.dtype} {tuple(engine._codes.shape)}, dequant "
            f"{engine._dequant}, int4 packed {engine._int4_packed}")
        for ef in CD_EFS:
            for refined in (False, True):
                ids, _, batch_s = _timed_batch(col, f, queries, zt.HnswQueryParam(ef=ef, is_using_refiner=refined))
                recalls[f, ef, refined] = _recall(ids, gi)
            log(f"codes hnsw {f}: ef={ef}: recall@{K} raw {recalls[f, ef, False]:.4f}, refined "
                f"{recalls[f, ef, True]:.4f} against the exact fp32 COSINE oracle over {Q} queries; refined "
                f"{batch_s * 1e3:.2f} ms per batch (best of 2)")
        _beam_check(engine, queries[:CD_CHECK_Q], f"codes hnsw {f}")
    for ef, floor in CD_FLOORS.items():
        if recalls["int8", ef, True] < floor:
            raise AssertionError(f"codes hnsw int8: refined recall@10 at ef={ef} is "
                                 f"{recalls['int8', ef, True]:.4f} < {floor}")
    col._impl.close()
    shutil.rmtree(path, ignore_errors=True)


def phase_codes(workdir: Path, dev: torch.device) -> int:
    """FP16 / INT8 / INT4 codes on the three engines. Returns K1's launches
    on the FLAT fields' scans."""
    t0 = time.perf_counter()
    launches = _codes_flat(workdir, dev)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    _codes_ivf(workdir, dev)
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    _codes_hnsw(workdir, dev)
    log(f"codes: flat {t1 - t0:.1f} s, ivf {t2 - t1:.1f} s, hnsw {time.perf_counter() - t2:.1f} s")
    return launches


def _hamming_oracle(xpm: torch.Tensor, qpm: torch.Tensor, k: int):
    """Exact Hamming distances of the k nearest, from +-1 products on the
    card (integers, exact in fp32): (distances (Q, k) ascending, ids)."""
    s, i = _topk_chunks(qpm, lambda qb: (qb @ xpm.T - HM_BITS) * 0.5, k)
    return -s, i


def _popcount_check(xpm: torch.Tensor, packed: np.ndarray, qpacked: np.ndarray, dev: torch.device) -> None:
    """The +-1 product oracle against popcounts of XORed code bytes on the
    card, over every row, for HM_POPCOUNT_Q queries."""
    lut = torch.tensor([bin(b).count("1") for b in range(256)], dtype=torch.int32, device=dev)
    xb = torch.from_numpy(packed.view(np.uint8)).to(dev)
    for r in range(HM_POPCOUNT_Q):
        qb = torch.from_numpy(qpacked[r].view(np.uint8)).to(dev)
        pop = lut[(xb ^ qb).long()].sum(1)
        qpm = torch.from_numpy(np.unpackbits(qpacked[r].view(np.uint8), bitorder="little")).to(dev).float() * 2 - 1
        ham = ((HM_BITS - xpm @ qpm) * 0.5).round().int()
        if not torch.equal(pop, ham):
            raise AssertionError("hamming: the +-1 product oracle disagrees with the popcount")


def phase_hamming(workdir: Path, dev: torch.device) -> int:
    """Binary codes: HM_BITS-bit VECTOR_BINARY32 fields, FLAT(HAMMING) over
    HM_N rows (K1 on the +-1 codes) and HNSW(HAMMING) over the first
    HM_HNSW_N, against an exact Hamming oracle on the card with tie-aware
    recall (a hit is any id at a distance <= the k-th true distance). Returns
    K1's launches on the FLAT field's queries."""
    import zvec_tpu_torch as zt
    from zvec_tpu_torch.ops import flat_scan as fs
    from zvec_tpu_torch.ops.quantize import bits_to_pm1, pack_bits

    t0 = time.perf_counter()
    bits, qbits = hamming_data(HM_N, HM_NQ)
    packed, qpacked = pack_bits(bits, 32), pack_bits(qbits, 32)
    log(f"hamming: {HM_N} x {HM_BITS}-bit codes ({packed.shape[1]} uint32 words a row) and {HM_NQ} queries made "
        f"in {time.perf_counter() - t0:.2f} s")
    xpm = torch.from_numpy(bits).to(dev).float() * 2 - 1
    qpm = torch.from_numpy(bits_to_pm1(qbits)).to(dev)
    _popcount_check(xpm, packed, qpacked, dev)

    def tie_recall(ids, scores, kth):
        true = (qbits[:, None, :] != bits[ids]).sum(-1)
        if not (scores == true).all():
            raise AssertionError("hamming: a returned score is not the row's Hamming distance")
        return float((true <= kth[:, None]).mean())

    launches, recalls = 0, {}
    for index, n in (("flat", HM_N), ("hnsw", HM_HNSW_N)):
        kth = _hamming_oracle(xpm[:n], qpm, K)[0][:, K - 1].cpu().numpy()  # the k-th true distance
        param = (zt.FlatIndexParam(zt.MetricType.HAMMING) if index == "flat"
                 else zt.HnswIndexParam(zt.MetricType.HAMMING))
        schema = zt.CollectionSchema(f"ham_{index}", vectors=[
            zt.VectorSchema("code", zt.DataType.VECTOR_BINARY32, HM_BITS, param)])
        path = workdir / f"ham_{index}"
        col = zt.create_and_open(str(path), schema)
        t_insert = _insert_all(col, n, lambda i: zt.Doc(id=str(i), vectors={"code": packed[i]}))
        t0 = time.perf_counter()
        col.optimize()
        t_opt = time.perf_counter() - t0
        col.flush()
        engine = _first_engine(col, "code")
        fs.flat_scan_topk.launches = 0
        if index == "flat":
            ids, scores, batch_s = _timed_batch(col, "code", qpacked, None)
            launches = fs.flat_scan_topk.launches
            recall = tie_recall(ids, scores, kth)
            st = engine._st
            log(f"hamming flat: {n} rows: insert {t_insert:.2f} s, optimize {t_opt:.2f} s; {batch_s * 1e3:.2f} ms "
                f"per {HM_NQ}-query batch of packed queries (best of 2); tie-aware recall@{K} {recall:.6f}; codes "
                f"{st.codes.dtype} {tuple(st.codes.shape)} (+-1); K1 launches {launches}")
            if launches == 0 or recall != 1.0:
                raise AssertionError("hamming flat: K1 was not launched, or the tie-aware recall is below 1.0")
            # the card's answer against K1's plain version on the engine's codes, under the tie rule
            mask = (torch.arange(st.n_pad, device=dev) < st.n).to(torch.int8)
            ps, pi = fs.flat_scan_topk_plain(qpm, st.codes, st.norms, mask, metric=zt.MetricType.L2, topk=K)
            bad, differ, err = _check_final_at_k(torch.from_numpy(-scores).float(), torch.from_numpy(ids),
                                                 ps.cpu() * 0.25, pi.cpu(), rtol=0.0)
            log(f"hamming flat: the card's answers vs K1's plain version on its codes: {differ} rows differ "
                f"({bad} outside exact ties), max |dscore| {err:.3g}")
            if bad or err:
                raise AssertionError("hamming flat: the card's answers disagree with the plain version")
            fs.flat_scan_topk.launches = launches
        else:
            bt = engine.build_times
            log(f"hamming hnsw: {n} rows: insert {t_insert:.2f} s, optimize {t_opt:.2f} s: "
                + ", ".join(f"{k} {v:.2f} s" for k, v in bt.items()) + f"; {engine.build_info}")
            for ef in HM_EFS:
                ids, scores, batch_s = _timed_batch(col, "code", qpacked, zt.HnswQueryParam(ef=ef))
                recalls[ef] = recall = tie_recall(ids, scores, kth)
                log(f"hamming hnsw: ef={ef}: {batch_s * 1e3:.2f} ms per {HM_NQ}-query batch (best of 2); "
                    f"tie-aware recall@{K} {recall:.4f}")
            _beam_check(engine, bits_to_pm1(qbits[:BEAM_CHECK_Q]), "hamming hnsw")
            if recalls[HM_EFS[-1]] < HM_HNSW_FLOOR:
                raise AssertionError(f"hamming hnsw: tie-aware recall@10 at ef={HM_EFS[-1]} is "
                                     f"{recalls[HM_EFS[-1]]:.4f} < {HM_HNSW_FLOOR}")
        col._impl.close()
        del col, engine
        gc.collect()
        shutil.rmtree(path, ignore_errors=True)
    return launches


def _lap_printer(label: str):
    """lap(name) prints a phase's wall seconds since the last lap, for the time limit."""
    t_run = time.perf_counter()
    mark = [t_run]

    def lap(name: str) -> None:
        now = time.perf_counter()
        log(f"phase {name}: {now - mark[0]:.1f} s ({now - t_run:.1f} s since {label})")
        mark[0] = now

    return lap


def run_group(phases: tuple, workdir: Path) -> dict:
    """One group's phases, one after another in this process: their launch
    counts by path and the K1 cases they measured."""
    lap = _lap_printer("the worker's start")
    dev = torch.device("cuda")
    launches, cases = {}, {}
    base = {}  # what the unsharded phases 4, 6 and 7 read, for the mesh phase
    if "flat" in phases or "hnsw" in phases:
        qset, X = _data()
        if "flat" in phases:
            launches["flat_search"] = phase_main_path(workdir, qset, X, base)
            gc.collect()
            torch.cuda.empty_cache()
            lap("flat")
        if "hnsw" in phases:
            launches["hnsw_build"] = phase_hnsw(workdir, qset, X, base)
            lap("hnsw")
        del qset, X
        gc.collect()
        torch.cuda.empty_cache()
    if "ivf" in phases:
        launches["ivf"] = phase_ivf(workdir, dev, base)
        gc.collect()
        torch.cuda.empty_cache()
        lap("ivf")
    if "clustered" in phases:
        launches["hnsw_clustered_build"] = phase_hnsw_clustered(workdir, dev, base, keep="live" in phases)
        gc.collect()
        torch.cuda.empty_cache()
        lap("clustered")
    if "live" in phases:
        launches["live"], cases["live_writing_shape"] = phase_live(dev, base)
        gc.collect()
        torch.cuda.empty_cache()
        lap("live")
    if "cohere" in phases:
        launches["cohere_build"] = phase_cohere(workdir, dev)
        gc.collect()
        torch.cuda.empty_cache()
        lap("cohere")
    if "sparse" in phases:
        launches["sparse"] = phase_sparse(workdir, dev)
        gc.collect()
        torch.cuda.empty_cache()
        lap("sparse")
    if "fusion" in phases:
        launches["fusion"] = phase_fusion(workdir)
        gc.collect()
        lap("fusion")
    if "tools" in phases:
        launches["tools_flat"] = phase_tools(workdir, dev)
        lap("tools")
    if "mesh" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        launches.update(phase_mesh(workdir, dev, base))
        lap("mesh")
    if "compact" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        launches["compact_build"], cases["compact_rebuild_shape"] = phase_compact(workdir, dev, base)
        lap("compact")
    if "hamming" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        launches["hamming_flat"] = phase_hamming(workdir, dev)
        lap("hamming")
    if "mips" in phases:
        launches["mips_build"] = phase_mips(workdir, dev)
        gc.collect()
        torch.cuda.empty_cache()
        lap("mips")
    if "codes" in phases:
        launches["codes_flat"] = phase_codes(workdir, dev)
        gc.collect()
        torch.cuda.empty_cache()
        lap("codes")
    return dict(launches=launches, cases=cases)


def _die_with_parent() -> None:
    """A worker gets SIGKILL when the process that started it ends (Linux
    prctl PR_SET_PDEATHSIG), so no worker outlives the script."""
    import ctypes
    import signal

    ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL))
    if os.getppid() != int(os.environ[PARENT_ENV]):
        os._exit(1)  # the parent ended before the prctl


def worker_main(phases: tuple, out: Path) -> None:
    _die_with_parent()
    out.write_text(json.dumps(run_group(phases, out.parent)))


def run_groups(phases: tuple, workdir: Path, t_run: float) -> dict:
    """Start one worker per group of `phases`, all at once; print each
    worker's log when it ends; stop every worker at the first failure or
    GROUP_DEADLINE_S after t_run. Returns the workers' results merged."""
    groups = [g for g in (tuple(p for p in grp if p in phases) for grp in GROUPS) if g]
    if not groups:
        return dict(launches={}, cases={})
    threads = str(max(1, len(os.sched_getaffinity(0)) // len(groups)))
    env = dict(os.environ, **{PARENT_ENV: str(os.getpid()), "OMP_NUM_THREADS": threads,
                              "OPENBLAS_NUM_THREADS": threads, "MKL_NUM_THREADS": threads})
    procs, printed, merged = [], set(), dict(launches={}, cases={})

    def show(i: int, status: str) -> None:
        printed.add(i)
        log(f"== worker {i} ({','.join(groups[i])}): {status}")
        logf = workdir / f"group{i}.log"
        if logf.exists():
            sys.stdout.write(logf.read_text())
        log(f"== end of worker {i}")

    try:
        for i, g in enumerate(groups):
            with open(workdir / f"group{i}.log", "w") as logf:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--worker", ",".join(g),
                     str(workdir / f"group{i}.json")],
                    stdout=logf, stdin=subprocess.DEVNULL, env=env))
        while len(printed) < len(procs):
            for i, p in enumerate(procs):
                if i in printed or p.poll() is None:
                    continue
                show(i, f"exit {p.returncode} at {time.perf_counter() - t_run:.1f} s since the start")
                if p.returncode != 0:
                    raise SystemExit(f"chip_smoke: worker {i} ({','.join(groups[i])}) "
                                     f"failed with exit code {p.returncode}")
                res = json.loads((workdir / f"group{i}.json").read_text())
                merged["launches"].update(res["launches"])
                merged["cases"].update(res["cases"])
            if len(printed) < len(procs) and time.perf_counter() - t_run > GROUP_DEADLINE_S:
                raise SystemExit(f"chip_smoke: workers still running {GROUP_DEADLINE_S} s after the start")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for i in range(len(procs)):
            if i not in printed:
                show(i, f"stopped (exit {procs[i].returncode})")
    # launches by path in the order of PHASES, whichever worker ended first
    order = {path: n for n, path in enumerate(("flat_search", "hnsw_build", "ivf", "hnsw_clustered_build",
                                               "live", "cohere_build", "sparse", "fusion", "tools_flat",
                                               "mesh_flat", "mesh_hnsw_build", "compact_build", "mips_build",
                                               "codes_flat", "hamming_flat"))}
    merged["launches"] = dict(sorted(merged["launches"].items(), key=lambda kv: order.get(kv[0], len(order))))
    return merged


def main() -> None:
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        worker_main(tuple(sys.argv[2].split(",")), Path(sys.argv[3]))
        return
    phases = PHASES
    if len(sys.argv) > 1:
        phases = tuple(sys.argv[2].split(",")) if len(sys.argv) == 3 else ()
        if (sys.argv[1] != "--phases" or not phases or not set(phases) <= set(PHASES)
                or ("mesh" in phases and not set(MESH_NEEDS) <= set(phases))
                or ("live" in phases and not set(LIVE_NEEDS) <= set(phases))
                or ("compact" in phases and not set(COMPACT_NEEDS) <= set(phases))):
            raise SystemExit(f"usage: chip_smoke.py [--phases {','.join(PHASES)}] "
                             f"(mesh reopens the collections of {','.join(MESH_NEEDS)}, live runs on "
                             f"the collection of {','.join(LIVE_NEEDS)} and compact on that of "
                             f"{','.join(COMPACT_NEEDS)}: name them too)")
    t_run = time.perf_counter()
    lap = _lap_printer("the start")

    smi = phase_toolchain()
    phase_build()
    lap("build")
    case = build_case = cohere_case = cohere_ip_case = None
    new_cases = {}
    if "kernel" in phases:
        case = phase_kernel_vs_plain()
        torch.cuda.empty_cache()
        build_case = phase_kernel_build_shape()
        torch.cuda.empty_cache()
        cohere_case, cohere_ip_case = phase_kernel_cohere_shape()
        torch.cuda.empty_cache()
        new_cases = phase_kernel_new_shapes()
        torch.cuda.empty_cache()
        lap("kernel")
    workdir = REPO / "zvec_tpu_torch" / "_build" / "smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        merged = run_groups(phases, workdir, t_run)
        lap("groups")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    launches, cases = merged["launches"], merged["cases"]
    log(smi)
    if phases != PHASES:
        log(f"partial run ({','.join(phases)}): no result line")
        return
    print(json.dumps({"kernels": [{
        "name": "flat_scan_topk (stage one: fused scan + group-max top-k)",
        "route": "cuda",
        "source": "zvec_tpu_torch/csrc/flat_scan.cu",
        "replaces": "zvec_tpu/ops/flat_pallas.py:92",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": case["max_abs_err"],
        "ms": case["ms"],
        "plain_ms": case["plain_ms"],
        "bound_ms": case["bound_ms"],
        "bound_by": case["bound_by"],
        "library_ms": case["library_ms"],
        "roofline": case["roofline"],
        "hnsw_build_shape": build_case,
        "cohere_build_shape": cohere_case,
        "cohere_ip_build_shape": cohere_ip_case,
        "live_writing_shape": cases.get("live_writing_shape"),
        "compact_rebuild_shape": cases.get("compact_rebuild_shape"),
        **new_cases,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
