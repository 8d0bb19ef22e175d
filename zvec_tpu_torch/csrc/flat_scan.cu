// Fused flat scan, stage one: distance tile + rank key + mask + group-max
// top-k, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `zvec_tpu/ops/flat_pallas.py::_kernel` and keeps
// its contract, so that the JAX kernel, this kernel and the plain PyTorch
// version (`zvec_tpu_torch/ops/flat_scan.py::_stage1_plain`) compare one for
// one:
//   inputs   q (Q, DK) f32, qside (Q,), qsum (Q,), codes (N, LD), knorm (N,),
//            mask (N,) int8
//   outputs  tile_s / tile_i (n_tiles, topk, Q): per tile of TILE_N rows, the
//            top-k group keys and group ids tile*128 + lane (-1 where the key
//            is <= NEG_INF/2). Group `lane` of a tile is rows
//            {lane + 128*j : j < TILE_N/128}. Ties go to the lowest lane.
// Rank keys (per-query constants dropped, see flat_pallas.py:18-25):
//   L2      key = 2*scale*dot - ||x||^2
//   IP      key = dot
//   COSINE  key = (scale*dot + bias*sum(q)) * (1/||x||); zero-norm rows ||q||
// Code types: f32, f16, int8 (affine dequant folded into the key) and int4
// packed two per byte; an int4 row is read as the contraction axis
// [lo nibbles | hi nibbles] against a query permuted to [q_even | q_odd].
//
// What bounds it: at 1M x 128 fp32 codes and Q = 1024 the scan is 0.27 TFLOP
// against 0.5 GB of codes, ~500 FLOP per byte, so it is bound by fp32 FMA, not
// by device memory. The design keeps fp32 exact (no tensor cores: TF32 would
// lose digits the exact-search contract needs) and feeds the FMA units from
// shared memory with a register tile: each block stages 64 queries and a
// 128-row sub-tile in D chunks of 32, each thread computes a 4 x 8 block of
// dots with two float4 code loads and one float4 query load per 32 FMAs, and
// the (64, 128) group-max never leaves registers. The query blocks of one tile
// are launched next to each other so that the tile's codes are read from L2,
// not from device memory, after the first. wgmma, TMA and a persistent grid
// are later work.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>
#include <climits>

namespace {

constexpr int kLanes = 128;               // group-max width (rows per sub-tile)
constexpr int kQB = 64;                   // queries per block
constexpr int kDK = 32;                   // contraction chunk in shared memory
constexpr int kTX = 16;                   // threads across lanes
constexpr int kTY = 16;                   // threads across queries
constexpr int kRQ = kQB / kTY;            // 4 queries per thread
constexpr int kRL = kLanes / kTX;         // 8 lanes per thread
constexpr int kThreads = kTX * kTY;       // 256
constexpr int kQPad = kQB + 4;            // row pitch keeps float4 alignment
constexpr int kLPad = kLanes + 4;
constexpr float kNegInf = -FLT_MAX;       // float32 min, as NEG_INF in runtime.py

enum CodeType { kF32 = 0, kF16 = 1, kI8 = 2, kI4 = 3 };
enum Metric { kL2 = 0, kIP = 1, kCosine = 2 };

template <int CT>
__device__ __forceinline__ float load_code(const void* __restrict__ codes,
                                           int64_t row, int col, int ld) {
  if constexpr (CT == kF32) {
    return static_cast<const float*>(codes)[row * ld + col];
  } else if constexpr (CT == kF16) {
    return __half2float(static_cast<const __half*>(codes)[row * ld + col]);
  } else if constexpr (CT == kI8) {
    return static_cast<float>(static_cast<const int8_t*>(codes)[row * ld + col]);
  } else {
    // packed int4: columns [0, ld) are the low nibbles, [ld, 2*ld) the high
    // ones. Shift as unsigned, then arithmetic right shift to sign-extend.
    const bool hi = col >= ld;
    const int32_t c =
        static_cast<const int8_t*>(codes)[row * ld + (hi ? col - ld : col)];
    const int32_t v = hi ? (c >> 4)
                         : (static_cast<int32_t>(static_cast<uint32_t>(c) << 28) >> 28);
    return static_cast<float>(v);
  }
}

template <int CT, int METRIC>
__global__ void __launch_bounds__(kThreads)
flat_scan_kernel(const float* __restrict__ q, const float* __restrict__ qside,
                 const float* __restrict__ qsum, const void* __restrict__ codes,
                 const float* __restrict__ knorm, const int8_t* __restrict__ mask,
                 float* __restrict__ out_s, int32_t* __restrict__ out_i, int nq,
                 int dk, int ld, int tile_n, int topk, int n_qb, float scale,
                 float bias) {
  __shared__ __align__(16) float qs[kDK][kQPad];
  __shared__ __align__(16) float cs[kDK][kLPad];

  const int tid = threadIdx.x;
  const int tx = tid % kTX;  // lanes 8*tx .. 8*tx+7
  const int ty = tid / kTX;  // queries 4*ty .. 4*ty+3 of the block
  const int qb = blockIdx.x % n_qb;
  const int tile = blockIdx.x / n_qb;
  const int q0 = qb * kQB;
  const int64_t row0 = static_cast<int64_t>(tile) * tile_n;
  const int group = tile_n / kLanes;

  float side[kRQ], qsm[kRQ];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    const int qr = q0 + ty * kRQ + i;
    side[i] = qr < nq ? qside[qr] : 0.f;
    qsm[i] = qr < nq ? qsum[qr] : 0.f;
  }

  float gmax[kRQ][kRL];
#pragma unroll
  for (int i = 0; i < kRQ; ++i)
#pragma unroll
    for (int j = 0; j < kRL; ++j) gmax[i][j] = kNegInf;

  for (int sub = 0; sub < group; ++sub) {
    const int64_t sub0 = row0 + static_cast<int64_t>(sub) * kLanes;
    float acc[kRQ][kRL];
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
      for (int j = 0; j < kRL; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < dk; k0 += kDK) {
      // stage the sub-tile's codes and the block's queries, transposed so
      // that the inner loop reads both as float4; the ragged D edge is zero
      for (int e = tid; e < kLanes * kDK; e += kThreads) {
        const int r = e / kDK, kk = e % kDK, col = k0 + kk;
        cs[kk][r] = col < dk ? load_code<CT>(codes, sub0 + r, col, ld) : 0.f;
      }
      for (int e = tid; e < kQB * kDK; e += kThreads) {
        const int r = e / kDK, kk = e % kDK, col = k0 + kk, qr = q0 + r;
        qs[kk][r] = (qr < nq && col < dk) ? q[static_cast<int64_t>(qr) * dk + col] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kDK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[kk][ty * kRQ]);
        const float4 b0 = *reinterpret_cast<const float4*>(&cs[kk][tx * kRL]);
        const float4 b1 = *reinterpret_cast<const float4*>(&cs[kk][tx * kRL + 4]);
        const float av[kRQ] = {a.x, a.y, a.z, a.w};
        const float bv[kRL] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kRQ; ++i)
#pragma unroll
          for (int j = 0; j < kRL; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // rank-key epilogue + mask, folded into the running group-max
#pragma unroll
    for (int j = 0; j < kRL; ++j) {
      const int64_t row = sub0 + tx * kRL + j;
      const float nrm = knorm[row];
      const bool keep = mask[row] != 0;
#pragma unroll
      for (int i = 0; i < kRQ; ++i) {
        float key;
        if constexpr (METRIC == kIP) {
          key = acc[i][j];
        } else if constexpr (METRIC == kL2) {
          key = (2.f * scale) * acc[i][j] - nrm;
        } else {
          const float real = scale * acc[i][j] + bias * qsm[i];
          key = nrm > 0.f ? real * nrm : side[i];
        }
        gmax[i][j] = fmaxf(gmax[i][j], keep ? key : kNegInf);
      }
    }
  }

  // k arg-max passes over the (64, 128) group-max. One query's 128 lanes sit
  // in the 16 threads of a half-warp, so a 4-step xor shuffle finds the max;
  // ties go to the lower lane, as jnp.argmax does.
  for (int p = 0; p < topk; ++p) {
#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
      float best = gmax[i][0];
      int lane = tx * kRL;
#pragma unroll
      for (int j = 1; j < kRL; ++j) {
        if (gmax[i][j] > best) {
          best = gmax[i][j];
          lane = tx * kRL + j;
        }
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int ol = __shfl_xor_sync(0xffffffffu, lane, off);
        if (ob > best || (ob == best && ol < lane)) {
          best = ob;
          lane = ol;
        }
      }
#pragma unroll
      for (int j = 0; j < kRL; ++j) {
        if (tx * kRL + j == lane) gmax[i][j] = kNegInf;
      }
      const int qr = q0 + ty * kRQ + i;
      if (tx == 0 && qr < nq) {
        const int64_t o = (static_cast<int64_t>(tile) * topk + p) * nq + qr;
        out_s[o] = best;
        out_i[o] = best > kNegInf / 2 ? tile * kLanes + lane : -1;
      }
    }
  }
}

template <int CT, int METRIC>
cudaError_t launch(const float* q, const float* qside, const float* qsum,
                   const void* codes, const float* knorm, const int8_t* mask,
                   float* out_s, int32_t* out_i, int nq, int dk, int ld,
                   int tile_n, int topk, int n_qb, int blocks, float scale,
                   float bias, cudaStream_t stream) {
  flat_scan_kernel<CT, METRIC><<<blocks, kThreads, 0, stream>>>(
      q, qside, qsum, codes, knorm, mask, out_s, out_i, nq, dk, ld, tile_n,
      topk, n_qb, scale, bias);
  return cudaGetLastError();
}

}  // namespace

// Launches stage one on `stream`; returns the cudaError_t of the launch.
// code_type: 0 f32, 1 f16, 2 int8, 3 packed int4 (dk = 2*ld).
// metric: 0 L2, 1 IP, 2 COSINE.
extern "C" int zvec_flat_scan(const float* q, const float* qside,
                              const float* qsum, const void* codes,
                              int code_type, int metric, const float* knorm,
                              const int8_t* mask, float* out_s, int32_t* out_i,
                              int nq, int dk, int ld, long long n, int tile_n,
                              int topk, float scale, float bias, void* stream) {
  if (nq <= 0 || dk <= 0 || tile_n <= 0 || tile_n % kLanes != 0 || n <= 0 ||
      n % tile_n != 0 || topk < 1 || topk > kLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_tiles = n / tile_n;
  const int n_qb = (nq + kQB - 1) / kQB;
  if (n_tiles * n_qb > INT_MAX || n_tiles * kLanes > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = static_cast<int>(n_tiles * n_qb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ZVEC_FLAT_SCAN_CASE(CT, M)                                              \
  case CT * 3 + M:                                                              \
    return static_cast<int>(launch<CT, M>(q, qside, qsum, codes, knorm, mask,   \
                                          out_s, out_i, nq, dk, ld, tile_n,     \
                                          topk, n_qb, blocks, scale, bias, s));
  switch (code_type * 3 + metric) {
    ZVEC_FLAT_SCAN_CASE(kF32, kL2)
    ZVEC_FLAT_SCAN_CASE(kF32, kIP)
    ZVEC_FLAT_SCAN_CASE(kF32, kCosine)
    ZVEC_FLAT_SCAN_CASE(kF16, kL2)
    ZVEC_FLAT_SCAN_CASE(kF16, kIP)
    ZVEC_FLAT_SCAN_CASE(kF16, kCosine)
    ZVEC_FLAT_SCAN_CASE(kI8, kL2)
    ZVEC_FLAT_SCAN_CASE(kI8, kIP)
    ZVEC_FLAT_SCAN_CASE(kI8, kCosine)
    ZVEC_FLAT_SCAN_CASE(kI4, kL2)
    ZVEC_FLAT_SCAN_CASE(kI4, kIP)
    ZVEC_FLAT_SCAN_CASE(kI4, kCosine)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ZVEC_FLAT_SCAN_CASE
}
