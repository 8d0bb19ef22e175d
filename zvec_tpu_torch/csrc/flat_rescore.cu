// Fused flat scan, stage two: the candidate gather, the exact fp32 rescore
// under the real metric and the final top-k, for Hopper (sm_90a).
//
// Replaces the end of `zvec_tpu/ops/flat_pallas.py::flat_scan_topk`
// (`:259-301`: the merge's k winner groups expanded to k * GROUP candidate
// rows, `jnp.take` of their codes, int4 unpack and affine dequant, one fp32
// `dot_general` at HIGHEST, the metric, one `lax.top_k`) and keeps the
// contract of the plain PyTorch version
// `zvec_tpu_torch/ops/flat_scan.py::_rescore_plain`:
//   inputs   q (Q, d) f32; qside (Q,) f32 (|q|^2 for L2, |q| for COSINE);
//            codes (N, ld) f32 / f16 / int8, or int4 nibble-packed (N,
//            ceil(d / 2)) int8 (element 2i the low nibble of byte i);
//            norms (N,) f32, the real ||x||^2 (L2) or ||x|| (COSINE); mask
//            (N,) int8; the merge's top_s (Q, k) f32 and gids (Q, k) int64
//   work     group r of query i is valid when gids >= 0 and top_s >
//            NEG_INF / 2; it covers rows (g / 128) * tile_n + g % 128 + 128 j,
//            j < GROUP = tile_n / 128, at candidate positions p = r * GROUP +
//            j. A candidate's codes are widened to fp32 (int4 cut to d
//            columns), dequantized per element as c * scale + bias (when the
//            caller gives a dequant), dotted with q in fp32 and scored:
//            IP dot; L2 -((qside + norm) - 2 dot); COSINE dot / (qside *
//            norm) where that product is > 0, else 1. An invalid group or a
//            masked row scores NEG_INF.
//   outputs  out_s (Q, k) f32, the k largest scores, descending, equal
//            scores by the lower p, -0.0 and +0.0 one key (the order of a
//            stable descending sort), each copied from its position with
//            its sign; out_i (Q, k) int64 the rows, -1 where the score is <=
//            NEG_INF / 2.
//
// What bounds it: the bytes. A query reads C = k * GROUP <= 1024 code rows
// (its norms and mask bytes beside them) and does 2 d FLOP a row, far under
// the fp32 rate; at the HNSW build shape (Q 2048, C 1024, 512-byte rows) one
// read per (query, candidate) is 1.07 GB, 0.32 ms at 3.35 TB/s, and the rows
// the batch needs are fewer (neighbouring queries share candidates), which
// only the L2 cache can exploit here. The plain version writes all of it
// again as a (Q, C, d) fp32 copy and reads it back; this kernel keeps the C
// scores on chip.
//
// Design (right first; wgmma, TMA and row reuse across queries are later
// work): a block owns one query. Its threads first resolve the C candidate
// rows (group id, validity, mask) and their norms into shared memory, then
// each of its 8 warps takes a candidate at a time: the lanes load the row in
// chunks of the widest size its stride and address allow (16 / 8 / 4 / 2 / 1
// bytes, chosen by the caller), widen, unpack and dequantize in registers
// (the dequant as a separate multiply and add, as the plain version rounds),
// accumulate q * c by fp32 FMA against the query row in shared memory and
// reduce across the warp. No TF32 anywhere. The C scores become (order word,
// position) 64-bit words (-0.0 as +0.0; a larger word is a larger score or,
// on equal scores, a lower position), a bitonic network sorts them
// descending in shared memory, and the first k are read back by position.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;     // group-max width of stage one
constexpr int kMaxCand = 1024;  // k * GROUP
constexpr int kMaxK = 128;
constexpr int kMaxSmem = 232448;  // what a block may opt in to on an H100

enum CodeType { kF32 = 0, kF16 = 1, kI8 = 2, kI4 = 3 };
enum Metric { kL2 = 0, kIP = 1, kCos = 2 };

// Elements of one chunk of W bytes.
template <int CT, int W>
__host__ __device__ constexpr int chunk_elems() {
  return CT == kF32 ? W / 4 : CT == kF16 ? W / 2 : CT == kI8 ? W : 2 * W;
}

// The query row's floats in shared memory: d, padded to whole chunks of a row
// (int4 rows hold 2 * ld elements) and to 4 floats.
__host__ __device__ inline int q_floats(int ctype, int d, int ld) {
  const int elems = ctype == kI4 ? 2 * ld : d;
  return (elems + 3) / 4 * 4;
}

__host__ __device__ inline int pow2_at_least(int c) {
  int p = 1;
  while (p < c) p <<= 1;
  return p;
}

__host__ __device__ inline size_t smem_bytes(int ctype, int d, int ld, int cand) {
  // q floats, then rows (int64) and norms (f32) and scores (f32) per
  // candidate, then the sort's words
  return static_cast<size_t>(q_floats(ctype, d, ld)) * 4 + static_cast<size_t>(cand) * (8 + 4 + 4) +
         static_cast<size_t>(pow2_at_least(cand)) * 8;
}

// The key's bits made monotone: a larger word is a larger key; -0.0 is +0.0
// (as csrc/flat_merge.cu).
__device__ __forceinline__ uint32_t order_bits(float key) {
  const uint32_t b = __float_as_uint(key == 0.f ? 0.f : key);
  return b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
}

// One chunk of W bytes as 32-bit words (the low bytes of w[0] below 4 bytes).
template <int W>
__device__ __forceinline__ void load_chunk(const uint8_t* p, uint32_t (&w)[W >= 4 ? W / 4 : 1]) {
  if constexpr (W == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (W == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else if constexpr (W == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (W == 2) {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    w[0] = __ldg(p);
  }
}

// Element i of a chunk, widened to fp32 (int4: the low nibble sign-extended
// as ((c & 0xF) ^ 8) - 8, the high nibble c >> 4 of the signed byte).
template <int CT>
__device__ __forceinline__ float elem(const uint32_t* w, int i) {
  if constexpr (CT == kF32) {
    return __uint_as_float(w[i]);
  } else if constexpr (CT == kF16) {
    const unsigned short h = static_cast<unsigned short>((w[i >> 1] >> (16 * (i & 1))) & 0xffffu);
    return __half2float(__ushort_as_half(h));
  } else if constexpr (CT == kI8) {
    return static_cast<float>(static_cast<int8_t>((w[i >> 2] >> (8 * (i & 3))) & 0xffu));
  } else {
    const int b = i >> 1;
    const int c = static_cast<int8_t>((w[b >> 2] >> (8 * (b & 3))) & 0xffu);
    return static_cast<float>((i & 1) ? (c >> 4) : (((c & 0xF) ^ 8) - 8));
  }
}

// q . row in fp32 over the row's bytes, lane by lane, reduced across the warp
// (every lane returns the sum).
template <int CT, int W>
__device__ __forceinline__ float row_dot(const uint8_t* __restrict__ row, const float* __restrict__ qs,
                                         int row_bytes, int d, bool dequant, float scale, float bias,
                                         int lane) {
  constexpr int E = chunk_elems<CT, W>();
  float acc = 0.f;
#pragma unroll 4
  for (int off = lane * W; off < row_bytes; off += 32 * W) {
    uint32_t w[W >= 4 ? W / 4 : 1];
    load_chunk<W>(row + off, w);
    const int e0 = (CT == kI4 ? 2 * off : off / (CT == kF32 ? 4 : CT == kF16 ? 2 : 1));
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (CT == kI4 && e0 + i >= d) break;  // the phantom high nibble of odd d: cut, as the plain version
      float c = elem<CT>(w, i);
      if (dequant) c = __fadd_rn(__fmul_rn(c, scale), bias);  // rounded as two ops, not an FMA
      acc = fmaf(qs[e0 + i], c, acc);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

__device__ __forceinline__ float metric_score(int metric, float dot, float qside, float nrm) {
  if (metric == kIP) return dot;
  if (metric == kL2) return -__fsub_rn(__fadd_rn(qside, nrm), __fmul_rn(2.f, dot));
  const float den = __fmul_rn(qside, nrm);
  return den > 0.f ? __fdiv_rn(dot, den) : 1.f;
}

template <int CT, int W>
__global__ void __launch_bounds__(kThreads) flat_rescore_kernel(
    const float* __restrict__ q, const float* __restrict__ qside, const uint8_t* __restrict__ codes,
    const float* __restrict__ norms, const int8_t* __restrict__ mask, const float* __restrict__ top_s,
    const int64_t* __restrict__ gids, float* __restrict__ out_s, int64_t* __restrict__ out_i, int d, int ld,
    long long n, int tile_n, int k, int metric, int dequant, float scale, float bias) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int group = tile_n / kLanes, cand = k * group, cand2 = pow2_at_least(cand);
  const int nqf = q_floats(CT, d, ld);
  float* qs = reinterpret_cast<float*>(smem);
  int64_t* rows = reinterpret_cast<int64_t*>(qs + nqf);  // nqf is a multiple of 4: 16-byte aligned
  float* nrm = reinterpret_cast<float*>(rows + cand);
  float* score = nrm + cand;
  uint64_t* words = reinterpret_cast<uint64_t*>(score + cand);  // at 16 * (nqf / 4 + cand) bytes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qi = blockIdx.x;
  const int elem_bytes = CT == kF32 ? 4 : CT == kF16 ? 2 : 1;
  const int row_bytes = ld * elem_bytes;

  for (int e = tid; e < nqf; e += kThreads) qs[e] = e < d ? q[static_cast<long long>(qi) * d + e] : 0.f;
  // each candidate's row (-1: invalid group, masked or out of range) and norm
  for (int p = tid; p < cand; p += kThreads) {
    const int r = p / group, j = p % group;
    const long long g = gids[static_cast<long long>(qi) * k + r];
    const float gs = top_s[static_cast<long long>(qi) * k + r];
    long long row = -1;
    if (g >= 0 && gs > -FLT_MAX / 2) {
      row = (g / kLanes) * tile_n + g % kLanes + static_cast<long long>(kLanes) * j;
      if (row >= n || mask[row] == 0) row = -1;
    }
    rows[p] = row;
    nrm[p] = (row >= 0 && metric != kIP) ? norms[row] : 0.f;
  }
  __syncthreads();

  const float qsd = qside[qi];
  const bool deq = dequant != 0;
  for (int p = warp; p < cand; p += kWarps) {
    const long long row = rows[p];
    float s = -FLT_MAX;
    if (row >= 0) {
      const float dot = row_dot<CT, W>(codes + row * row_bytes, qs, row_bytes, d, deq, scale, bias, lane);
      s = metric_score(metric, dot, qsd, nrm[p]);
    }
    if (lane == 0) score[p] = s;
  }
  __syncthreads();

  // (order word, position) words, sorted descending; slots past C hold 0,
  // below every real word (NEG_INF's word is 0x00800000 << 32)
  for (int p = tid; p < cand2; p += kThreads)
    words[p] = p < cand ? (static_cast<uint64_t>(order_bits(score[p])) << 32) | (0xffffffffu - p) : 0ull;
  __syncthreads();
#pragma unroll 1
  for (int s = 2; s <= cand2; s <<= 1) {
#pragma unroll 1
    for (int h = s >> 1; h > 0; h >>= 1) {
      for (int i = tid; i < cand2 / 2; i += kThreads) {
        const int a = (i / h) * 2 * h + i % h, b = a + h;
        const uint64_t x = words[a], y = words[b];
        if ((x < y) == ((a & s) == 0)) {
          words[a] = y;
          words[b] = x;
        }
      }
      __syncthreads();
    }
  }

  for (int j = tid; j < k; j += kThreads) {
    const int p = static_cast<int>(0xffffffffu - static_cast<uint32_t>(words[j]));
    const float s = score[p];
    const long long o = static_cast<long long>(qi) * k + j;
    out_s[o] = s;
    out_i[o] = s > -FLT_MAX / 2 ? rows[p] : -1;
  }
}

template <int CT, int W>
cudaError_t launch(const float* q, const float* qside, const void* codes, const float* norms,
                   const int8_t* mask, const float* top_s, const int64_t* gids, float* out_s, int64_t* out_i,
                   int nq, int d, int ld, long long n, int tile_n, int k, int metric, int dequant, float scale,
                   float bias, size_t smem, cudaStream_t stream) {
  auto kernel = flat_rescore_kernel<CT, W>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(nq), kThreads, smem, stream>>>(
      q, qside, static_cast<const uint8_t*>(codes), norms, mask, top_s, gids, out_s, out_i, d, ld, n, tile_n, k,
      metric, dequant, scale, bias);
  return cudaGetLastError();
}

template <int CT>
cudaError_t launch_width(int load, const float* q, const float* qside, const void* codes, const float* norms,
                         const int8_t* mask, const float* top_s, const int64_t* gids, float* out_s,
                         int64_t* out_i, int nq, int d, int ld, long long n, int tile_n, int k, int metric,
                         int dequant, float scale, float bias, size_t smem, cudaStream_t stream) {
#define ZVEC_RESCORE_LAUNCH(W)                                                                               \
  return launch<CT, W>(q, qside, codes, norms, mask, top_s, gids, out_s, out_i, nq, d, ld, n, tile_n, k, metric, \
                       dequant, scale, bias, smem, stream)
  switch (load) {
    case 16:
      ZVEC_RESCORE_LAUNCH(16);
    case 8:
      ZVEC_RESCORE_LAUNCH(8);
    case 4:
      ZVEC_RESCORE_LAUNCH(4);
    case 2:
      if constexpr (CT != kF32) ZVEC_RESCORE_LAUNCH(2);
      break;
    case 1:
      if constexpr (CT == kI8 || CT == kI4) ZVEC_RESCORE_LAUNCH(1);
      break;
  }
#undef ZVEC_RESCORE_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches stage two on `stream`; returns the cudaError_t of the launch.
// ctype 0 f32, 1 f16, 2 int8, 3 int4 (nibble-packed int8, ld = ceil(d / 2));
// metric 0 L2, 1 IP, 2 COSINE; `load` the bytes of one row load (16, 8, 4,
// 2 or 1), which must divide the row stride and the codes' address and be at
// least an element. out_s (nq, topk) f32, out_i (nq, topk) int64.
extern "C" int zvec_flat_rescore(const float* q, const float* qside, const void* codes, int ctype, int metric,
                                 const float* norms, const int8_t* mask, const float* top_s, const int64_t* gids,
                                 float* out_s, int64_t* out_i, int nq, int d, int ld, long long n, int tile_n,
                                 int topk, int dequant, float scale, float bias, int load, void* stream) {
  const int elem_bytes = ctype == kF32 ? 4 : ctype == kF16 ? 2 : 1;
  const long long row_bytes = static_cast<long long>(ld) * elem_bytes;
  const bool ok_shape = nq > 0 && d > 0 && ctype >= kF32 && ctype <= kI4 && metric >= kL2 && metric <= kCos &&
                        ld == (ctype == kI4 ? (d + 1) / 2 : d) && topk >= 1 && topk <= kMaxK && tile_n > 0 &&
                        tile_n % kLanes == 0 && n > 0 && n % tile_n == 0 &&
                        topk * (tile_n / kLanes) <= kMaxCand;
  const bool ok_load = (load == 16 || load == 8 || load == 4 || load == 2 || load == 1) && load >= elem_bytes &&
                       row_bytes % load == 0 && reinterpret_cast<uintptr_t>(codes) % load == 0;
  if (!ok_shape || !ok_load) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(ctype, d, ld, topk * (tile_n / kLanes));
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ctype) {
    case kF32:
      return static_cast<int>(launch_width<kF32>(load, q, qside, codes, norms, mask, top_s, gids, out_s, out_i,
                                                 nq, d, ld, n, tile_n, topk, metric, dequant, scale, bias, smem,
                                                 s));
    case kF16:
      return static_cast<int>(launch_width<kF16>(load, q, qside, codes, norms, mask, top_s, gids, out_s, out_i,
                                                 nq, d, ld, n, tile_n, topk, metric, dequant, scale, bias, smem,
                                                 s));
    case kI8:
      return static_cast<int>(launch_width<kI8>(load, q, qside, codes, norms, mask, top_s, gids, out_s, out_i,
                                                nq, d, ld, n, tile_n, topk, metric, dequant, scale, bias, smem,
                                                s));
    default:
      return static_cast<int>(launch_width<kI4>(load, q, qside, codes, norms, mask, top_s, gids, out_s, out_i,
                                                nq, d, ld, n, tile_n, topk, metric, dequant, scale, bias, smem,
                                                s));
  }
}
