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
// What bounds it: at 1M x 128 fp32 codes and Q = 1024 the scan is 0.26 TFLOP
// against 0.5 GB of codes, ~500 FLOP per byte, so it is bound by arithmetic.
// The products run on the tensor cores in split TF32 ("3xTF32"), the port of
// the TPU kernel's Precision.HIGHEST (a multi-pass bf16 product on the MXU,
// flat_pallas.py:122-126): each fp32 operand x becomes big = tf32(x) plus
// small = tf32(x - big), and big*big + big*small + small*big are summed in
// fp32. Only small*small (~2^-22 relative per product) and the rounding of
// small (~2^-22) are lost, the order of fp32 rounding over D terms, so the
// keys keep the fp32 tolerances and the exactness argument of
// flat_pallas.py:27-32 stands; one TF32 pass alone (~2^-11) would not. fp16,
// int8 and int4 codes are exact in TF32 (11-bit significand, fp32 exponent),
// so they take two products, q_big*c + q_small*c. The bound is three (or two)
// TF32 passes at the tensor cores' 495 TFLOP/s: 1.6 ms at the FLAT shape.
//
// Route: wgmma (m64n128k8 tf32), the full-rate route; mma.sync's TF32 rate
// on an H100 is well below it (`csrc/probes/tf32_rate.cu` measures both). The
// codes are wgmma's A operand, taken from registers, so that they are decoded
// and split as they leave shared memory, with no converted copy; the queries
// are B, split once per call by `split_queries` into swizzled K-major tiles
// that wgmma reads from shared memory. A thread's A fragment for one 8-column
// k-step holds code columns 4t + 2s and 4t + 2s + 1 (t its column group) of a
// 16-column half, so that one 16-, 8- or 4-byte load gives two k-steps; the
// query tiles are written in the same column order (`tile_column`).
//
// Tiling: a block (two warpgroups, 256 threads) owns 128 queries and one
// TILE_N code tile. Warpgroup w multiplies lanes 64w..64w+63 of each 128-row
// sub-tile against all 128 queries, in contraction chunks of 32 columns, so
// any D works (the ragged D edge is zero-filled on both sides). Each
// warpgroup streams its own half of the code rows through its own 4-stage
// cp.async ring (deeper rings ran slower on the H100) and synchronises on its
// own named barrier, so the two take turns on the tensor cores; within a
// warpgroup, the fragments of the next
// chunk are loaded and split into a second register set while the current
// chunk's products run. The (64 x 128) accumulator and the running
// group-max stay in registers in wgmma's layout; the rank-key epilogue and
// the mask fold into the group-max after each sub-tile. The query tiles stay
// resident in shared memory when they fit (D <= 128); otherwise each
// warpgroup streams them with its code chunks (a 2-stage ring). Rows whose
// length is not a multiple of 16 bytes are copied by plain loads. The query
// blocks of one tile are launched next to each other, so that the tile's
// codes come from L2 after the first.
//
// Extraction: a query's 128 (key, lane) pairs become 64-bit rank words (the
// key's bits made monotone, then 127 - lane), so one unsigned compare gives
// the order of k arg-max passes: key descending, ties to the lower lane. Two
// threads of a warp hold a query's 128 words, 64 each, and a bitonic network
// sorts them; only its steps of distance 64 shuffle, and a warp sorts its 16
// queries at once. The sort serves every k (there is no second path): at k =
// 128 it is the whole answer, and at k = 10 it costs a few percent of a
// tile. The first topk are written through shared memory so that the stores
// of one k are coalesced over the queries.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>
#include <climits>

namespace {

constexpr int kLanes = 128;               // group-max width (rows per sub-tile)
constexpr int kQB = 128;                  // queries per block (wgmma's N)
constexpr int kWGRows = 64;               // code rows per warpgroup (wgmma's M)
constexpr int kKC = 32;                   // contraction columns per chunk (128 B of fp32)
constexpr int kThreads = 256;             // two warpgroups
constexpr int kQHalf = kQB * 128;         // one swizzled (128 x 32) fp32 query tile
constexpr int kQChunkBytes = 2 * kQHalf;  // its big and small halves
constexpr int kResidentQChunks = 4;       // queries stay resident up to D = 128
constexpr int kStagesResident = 4;        // per-warpgroup ring depth, queries resident
constexpr int kStagesStreamed = 2;        // the same when queries stream
static_assert((kStagesResident & (kStagesResident - 1)) == 0 && (kStagesStreamed & (kStagesStreamed - 1)) == 0,
              "ring slots are taken as it & (stages - 1)");
constexpr int kGPitch = kLanes + 4;       // group-max row pitch (floats) for the sort
constexpr int kGBytes = kQB * kGPitch * 4;
constexpr float kNegInf = -FLT_MAX;       // float32 min, as NEG_INF in runtime.py

enum CodeType { kF32 = 0, kF16 = 1, kI8 = 2, kI4 = 3 };
enum Metric { kL2 = 0, kIP = 1, kCosine = 2 };

// Bytes of one code row in one chunk of 32 contraction columns (int4: 16
// bytes give 16 low and 16 high nibbles).
__host__ __device__ constexpr int chunk_row_bytes(int ct) {
  return ct == kF32 ? 128 : ct == kF16 ? 64 : ct == kI8 ? 32 : 16;
}

// Code ring: 16-byte unit u of row r lives at unit u ^ swz, so that the rows
// one fragment load touches together fall on disjoint banks.
template <int UNITS>
__device__ __forceinline__ int swizzle(int u, int r) {
  constexpr int shift = UNITS == 8 ? 0 : UNITS == 4 ? 1 : UNITS == 2 ? 2 : 3;
  return u ^ (((r >> shift) & 1) * (UNITS / 2));
}

// Query tiles: byte offset of 16-byte unit u (columns 4u..4u+3) of row r in
// a K-major tile of 128-byte rows in wgmma's SWIZZLE_128B layout.
__host__ __device__ constexpr int sw128(int r, int u) { return r * 128 + ((u ^ (r & 7)) << 4); }

// float32 -> TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties away from
// zero, 10 mantissa bits kept) for finite values, in two integer operations:
// half an ulp of the 10-bit mantissa is added to the magnitude bits and the 13
// low bits cleared.
__device__ __forceinline__ float to_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// Small integers to float without the conversion unit: the biased value u
// (0 <= u < 2^23) is placed in the mantissa of 2^23 and the bias subtracted.
__device__ __forceinline__ float biased_int_to_float(uint32_t u, float bias) {
  return __uint_as_float(0x4b000000u | u) - (8388608.f + bias);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma descriptor of a K-major SWIZZLE_128B tile at `p` (1024-byte aligned):
// rows 128 B apart, 8-row groups 1024 B apart (SBO); k-step kk adds 32 bytes.
__device__ __forceinline__ uint64_t tile_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3ffff) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d += a * b, or d = a * b without ACCUMULATE; a (64 x 8) from registers in
// the mma.m16n8k8 A layout per warp, b (8 x 128) from the tile at desc_b
template <bool ACCUMULATE = true>
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 t;\nmov.b32 t, %69;\nsetp.ne.b32 p, t, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(ACCUMULATE ? 1 : 0));
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// generic-proxy writes to shared memory visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// barrier of one warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// Query column order inside a 32-column chunk: k-step kk = 2*half + s reads
// the code columns 16*half + 4t + 2s + e (t = 0..3, e = 0..1) as its k index
// t + 4e, so the B tile holds code column pc at k-column lc(pc).
__host__ __device__ constexpr int tile_column(int pc) {
  return (2 * (pc / 16) + (pc % 4) / 2) * 8 + (pc % 16) / 4 + 4 * (pc % 2);
}

// Query halves, split and zero-padded, as the shared tiles wgmma reads: for
// chunk c and half h (0 big, 1 small), rows 0..nq_pad-1 in the layout of
// sw128, columns in tile_column order. For int4 chunk c holds
// q_even[16c..16c+16) then q_odd[16c..16c+16), matching the 16 packed bytes
// of the code chunk.
__global__ void split_queries(const float* __restrict__ q, float* __restrict__ qsplit,
                              int nq, int nq_pad, int dk, int ld, int nch, bool int4) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(nq_pad) * nch * kKC) return;
  const int r = static_cast<int>(e / (nch * kKC));
  const int cc = static_cast<int>(e % (nch * kKC));  // column in chunk-major order
  const int c = cc / kKC, j = cc % kKC;
  float x = 0.f;
  if (r < nq) {
    if (int4) {
      const int i = c * 16 + j % 16;
      if (i < ld) x = q[static_cast<int64_t>(r) * dk + (j / 16) * ld + i];
    } else if (cc < dk) {
      x = q[static_cast<int64_t>(r) * dk + cc];
    }
  }
  const float big = to_tf32(x);
  char* base = reinterpret_cast<char*>(qsplit) + static_cast<int64_t>(c) * 2 * nq_pad * 128;
  const int lc = tile_column(j);
  const int64_t o = sw128(r, lc >> 2) + (lc & 3) * 4;
  *reinterpret_cast<float*>(base + o) = big;
  *reinterpret_cast<float*>(base + static_cast<int64_t>(nq_pad) * 128 + o) = to_tf32(x - big);
}

// One code row's 4 contraction values of half `kb` of a chunk, for thread
// column `tig`: columns 16*kb + 4*tig + {0..3} (int4: the low nibbles of
// bytes 4*tig.. for kb = 0, the high ones for kb = 1).
template <int CT>
__device__ __forceinline__ void load_code_frag(const char* stage, int r, int kb,
                                               int tig, float (&v)[4]) {
  constexpr int RB = chunk_row_bytes(CT);
  constexpr int U = RB / 16;
  if constexpr (CT == kF32) {
    const float4 x = *reinterpret_cast<const float4*>(
        stage + r * RB + swizzle<U>(kb * 4 + tig, r) * 16);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (CT == kF16) {
    const uint2 w = *reinterpret_cast<const uint2*>(
        stage + r * RB + swizzle<U>(kb * 2 + (tig >> 1), r) * 16 + (tig & 1) * 8);
    const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&w.x));
    const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&w.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else if constexpr (CT == kI8) {
    // bytes x + 128 (xor of the sign bit), each moved into 0x4b0000uu
    const uint32_t w = *reinterpret_cast<const uint32_t*>(
        stage + r * RB + swizzle<U>(kb, r) * 16 + tig * 4) ^ 0x80808080u;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = biased_int_to_float(__byte_perm(w, 0u, 0x4440 | e), 128.f);
  } else {
    // nibbles x + 8 (xor of the sign bit): low ones for kb = 0, high for kb = 1
    const uint32_t w = *reinterpret_cast<const uint32_t*>(stage + r * RB + tig * 4) ^ 0x88888888u;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = biased_int_to_float((w >> (8 * e + 4 * kb)) & 0xfu, 8.f);
  }
}

// (key, lane) as one integer that orders as the ranking does: the key's bits
// made monotone in the high word (-0 as +0, since the two compare equal),
// 127 - lane in the low word, so that a larger value is a larger key or, on
// equal keys, a lower lane.
__device__ __forceinline__ uint64_t rank_word(float key, int lane) {
  uint32_t b = __float_as_uint(key == 0.f ? 0.f : key);
  b ^= (b >> 31) ? 0xffffffffu : 0x80000000u;
  return (static_cast<uint64_t>(b) << 32) | static_cast<uint32_t>(kLanes - 1 - lane);
}
__device__ __forceinline__ float rank_key(uint64_t w) {
  uint32_t b = static_cast<uint32_t>(w >> 32);
  b ^= (b >> 31) ? 0x80000000u : 0xffffffffu;
  return __uint_as_float(b);
}
__device__ __forceinline__ int rank_lane(uint64_t w) {
  return kLanes - 1 - static_cast<int>(static_cast<uint32_t>(w));
}

// Sorts a query's 128 rank words into descending order with a bitonic
// network: the 128 / EPT threads of an aligned group hold positions
// EPT*t .. EPT*t + EPT - 1 (t = lane % (128 / EPT)), so the compare-exchanges
// of distance < EPT stay in registers and only the rest shuffle; a warp sorts
// 32 * EPT / 128 queries at once. The stages are a loop, not unrolled: the
// unrolled network is several times larger and ran slower on the H100.
template <int EPT>
__device__ __forceinline__ void group_sort128(uint64_t (&v)[EPT], int t) {
#pragma unroll 1
  for (int s = 2; s <= kLanes; s <<= 1) {
#pragma unroll 1
    for (int d = s >> 1; d >= EPT; d >>= 1) {  // across threads
      const int td = d / EPT;
#pragma unroll
      for (int j = 0; j < EPT; ++j) {
        const bool desc = ((EPT * t + j) & s) == 0;
        const uint64_t o = __shfl_xor_sync(0xffffffffu, static_cast<unsigned long long>(v[j]), td);
        // the lower position keeps the larger word in a descending run
        const bool keep_max = ((t & td) == 0) == desc;
        v[j] = keep_max == (o > v[j]) ? o : v[j];
      }
    }
#pragma unroll
    for (int d = EPT / 2; d > 0; d >>= 1) {  // in registers
      if (d >= s) continue;
#pragma unroll
      for (int j = 0; j < EPT; ++j) {
        if ((j & d) == 0) {
          const bool desc = ((EPT * t + j) & s) == 0;
          const int jj = j | d;
          const uint64_t a = v[j], b = v[jj];
          const bool swap = (b > a) == desc;
          v[j] = swap ? b : a;
          v[jj] = swap ? a : b;
        }
      }
    }
  }
}

// Shared memory (1024-byte aligned): the resident query tiles, the per-query
// constants, then each warpgroup's ring of stages (its 64 code rows of a
// chunk, and the chunk's query tiles when they stream).
struct Layout {
  int stages, stage_bytes, consts, rings, total;
};

__host__ __device__ inline Layout make_layout(int ct, int nch, bool resident) {
  Layout s;
  s.stages = resident ? kStagesResident : kStagesStreamed;
  const int codes = kWGRows * chunk_row_bytes(ct);
  s.stage_bytes = resident ? codes : kQChunkBytes + ((codes + 1023) / 1024) * 1024;
  s.consts = resident ? nch * kQChunkBytes : 0;
  s.rings = s.consts + 2 * kQB * 4;
  s.rings = ((s.rings + 1023) / 1024) * 1024;
  const int main_bytes = s.rings + 2 * s.stages * s.stage_bytes;
  s.total = (main_bytes > 2 * kGBytes ? main_bytes : 2 * kGBytes) + 1024;
  return s;
}

template <int CT, int METRIC>
__global__ void __launch_bounds__(kThreads, 1)
flat_scan_kernel(const float* __restrict__ qsplit, const float* __restrict__ qside,
                 const float* __restrict__ qsum, const char* __restrict__ codes,
                 const float* __restrict__ knorm, const int8_t* __restrict__ mask,
                 float* __restrict__ out_s, int32_t* __restrict__ out_i, int nq,
                 int nq_pad, int nch, int row_bytes, int tile_n, int topk, int n_qb,
                 bool resident, bool vec, float scale, float bias) {
  constexpr int RB = chunk_row_bytes(CT);
  constexpr int U = RB / 16;
  constexpr int kPasses = CT == kF32 ? 3 : 2;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L = make_layout(CT, nch, resident);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, ln = tid & 31;
  const int wg = warp >> 2, wt = tid & 127;  // warpgroup, thread in it
  const int g = ln >> 2, tig = ln & 3;
  const int arow = 16 * (warp & 3) + g;      // A rows arow, arow + 8 of the warpgroup
  const int qb = blockIdx.x % n_qb;
  const int tile = blockIdx.x / n_qb;
  const int q0 = qb * kQB;
  const int64_t row0 = static_cast<int64_t>(tile) * tile_n;
  const int n_iter = (tile_n / kLanes) * nch;
  float* c_side = reinterpret_cast<float*>(smem + L.consts);
  float* c_sum = c_side + kQB;
  char* ring = smem + L.rings + wg * L.stages * L.stage_bytes;
  const int code_off = resident ? 0 : kQChunkBytes;  // streamed: the query tiles come first

  // the swizzled query tiles of chunk c (both halves, all 128 rows) to dst
  auto load_queries = [&](int c, char* dst, int t0, int nt) {
    const char* src = reinterpret_cast<const char*>(qsplit) + static_cast<int64_t>(c) * 2 * nq_pad * 128;
    for (int e = t0; e < kQChunkBytes / 16; e += nt) {
      const int h = e / (kQB * 8), rest = e % (kQB * 8);
      cp_async16(dst + e * 16, src + (static_cast<int64_t>(h) * nq_pad + q0) * 128 + rest * 16, 16);
    }
  };
  // this warpgroup's 64 rows of code chunk `it` (and its query tiles when
  // they stream) into stage it % stages
  auto issue = [&](int it) {
    const int sub = it / nch, c = it - sub * nch;
    char* st = ring + (it & (L.stages - 1)) * L.stage_bytes;
    char* dst = st + code_off;
    // thread wt copies unit wt % U of rows wt / U + k * (128 / U)
    constexpr int kRowStep = 128 / U;
    const int u = wt % U, r1 = wt / U;
    const int off = c * RB + u * 16;
    const int valid = min(max(row_bytes - off, 0), 16);  // 0: zero fill
    const char* src = codes + (row0 + static_cast<int64_t>(sub) * kLanes + wg * kWGRows + r1) * row_bytes +
                      (valid > 0 ? off : 0);
#pragma unroll
    for (int k = 0; k < (kWGRows + kRowStep - 1) / kRowStep; ++k) {
      const int r = r1 + k * kRowStep;
      if (r >= kWGRows) break;
      const char* sk = src + static_cast<int64_t>(k) * kRowStep * row_bytes;
      char* d = dst + r * RB + swizzle<U>(u, r) * 16;
      if (vec) {
        cp_async16(d, sk, valid);
      } else {
        for (int b = 0; b < 16; ++b) d[b] = b < valid ? sk[b] : 0;
      }
    }
    if (!resident) load_queries(c, st, wt, 128);
  };

  if (tid < kQB) {
    const int qr = q0 + tid;
    c_side[tid] = qr < nq ? qside[qr] : 0.f;
    c_sum[tid] = qr < nq ? qsum[qr] : 0.f;
  }
  if (resident) {
    for (int c = 0; c < nch; ++c) load_queries(c, smem + c * kQChunkBytes, tid, kThreads);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
  }
  __syncthreads();

  // knorm and mask of this thread's two A rows of sub-tile s, a sub-tile ahead
  float pf_norm[2] = {0.f, 0.f}, nrm[2];
  bool pf_keep[2] = {false, false}, keep[2];
  auto next_nm = [&](int s) {  // pf (sub-tile s - 1) -> nrm / keep; pf <- sub-tile s
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      nrm[h] = pf_norm[h];
      keep[h] = pf_keep[h];
      if (s < tile_n / kLanes) {
        const int64_t row = row0 + static_cast<int64_t>(s) * kLanes + wg * kWGRows + arow + 8 * h;
        pf_norm[h] = knorm[row];
        pf_keep[h] = mask[row] != 0;
      }
    }
  };
  next_nm(0);
  next_nm(1);

  for (int i = 0; i < L.stages - 1; ++i) {
    if (i < n_iter) issue(i);
    cp_async_commit();
  }

  // A fragments of one chunk: [half kb][row h][4 columns], split when fp32
  struct Frag {
    uint32_t big[2][2][4], small[2][2][4];
  };
  // chunk `it` of the ring into registers; refills the ring slot freed by chunk it - 1
  auto prepare = [&](int it, Frag& a) {
    if (resident) {
      cp_async_wait<kStagesResident - 2>();
    } else {
      cp_async_wait<kStagesStreamed - 2>();
      fence_proxy_async();
    }
    warpgroup_sync(wg);  // stage it landed; stage it - 1 is free
    if (it + L.stages - 1 < n_iter) issue(it + L.stages - 1);
    cp_async_commit();
    const char* st = ring + (it & (L.stages - 1)) * L.stage_bytes + code_off;
#pragma unroll
    for (int kb = 0; kb < 2; ++kb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[4];
        load_code_frag<CT>(st, arow + 8 * h, kb, tig, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (CT == kF32) {
            const float big = to_tf32(v[e]);
            a.big[kb][h][e] = __float_as_uint(big);
            a.small[kb][h][e] = __float_as_uint(to_tf32(v[e] - big));
          } else {
            a.big[kb][h][e] = __float_as_uint(v[e]);  // exact in tf32
          }
        }
      }
  };

  float acc[64] = {}, gmax[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) gmax[i] = kNegInf;
  // chunk `it` (column chunk c of its sub-tile) into the accumulator, asynchronously
  auto multiply = [&](int it, int c, const Frag& a) {
    const char* qt = resident ? smem + c * kQChunkBytes : ring + (it & (L.stages - 1)) * L.stage_bytes;
    const uint64_t qb_d = tile_desc(qt), qs_d = tile_desc(qt + kQHalf);
    fence_operands(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kKC / 8; ++kk) {
      const int kb = kk >> 1, s = kk & 1;
      const uint64_t k2 = 2 * kk;  // 32 bytes, in 16-byte units
      // fragment k index tig <-> column 4*tig + 2s, tig + 4 <-> 4*tig + 2s + 1
      const uint32_t ab[4] = {a.big[kb][0][2 * s], a.big[kb][1][2 * s],
                              a.big[kb][0][2 * s + 1], a.big[kb][1][2 * s + 1]};
      if (kk == 0 && c == 0) {
        wgmma_tf32<false>(acc, ab, qs_d + k2);  // a sub-tile's first product overwrites
      } else {
        wgmma_tf32(acc, ab, qs_d + k2);
      }
      if constexpr (kPasses == 3) {
        const uint32_t as[4] = {a.small[kb][0][2 * s], a.small[kb][1][2 * s],
                                a.small[kb][0][2 * s + 1], a.small[kb][1][2 * s + 1]};
        wgmma_tf32(acc, as, qb_d + k2);
      }
      wgmma_tf32(acc, ab, qb_d + k2);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };

  // Chunk it multiplies while the fragments of chunk it + 1 are prepared in
  // the other register set; n_iter is even (a tile has an even number of
  // sub-tiles), so the two sets alternate at compile time.
  Frag frag[2];
  prepare(0, frag[0]);
  int sub = 0, c = 0;
  for (int it = 0; it < n_iter; it += 2) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      multiply(it + b, c, frag[b]);
      // the products of chunk it + b - 1 are done (all, when the queries
      // stream: their tiles share the ring slot prepare refills)
      if (resident) {
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      } else {
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      }
      if (it + b + 1 < n_iter) prepare(it + b + 1, frag[b ^ 1]);
      if (c == nch - 1) {
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_operands(acc);
        // rank-key epilogue + mask, folded into the running group-max
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = 8 * j + 2 * tig + e;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float dot = acc[4 * j + 2 * h + e];
              float key;
              if constexpr (METRIC == kIP) {
                key = dot;
              } else if constexpr (METRIC == kL2) {
                key = (2.f * scale) * dot - nrm[h];
              } else {
                const float real = scale * dot + bias * c_sum[qi];
                key = nrm[h] > 0.f ? real * nrm[h] : c_side[qi];
              }
              float& m = gmax[4 * j + 2 * h + e];
              m = fmaxf(m, keep[h] ? key : kNegInf);
            }
          }
        c = 0;
        ++sub;
        next_nm(sub + 1);
      } else {
        ++c;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the group-max into shared memory, one 128-lane row per query; then sort
  // each query's row, keys back in place, ids beside
  float* gm = reinterpret_cast<float*>(smem);
  int32_t* gi = reinterpret_cast<int32_t*>(smem + kGBytes);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        gm[(8 * j + 2 * tig + e) * kGPitch + wg * kWGRows + arow + 8 * h] = gmax[4 * j + 2 * h + e];
  __syncthreads();
  // a warp sorts its 16 queries at once, two threads each (64 positions per
  // thread: the network's steps of distance 64 shuffle, the rest stay in
  // registers); warps whose queries all lie past nq skip it
  constexpr int kEPT = 64;
  constexpr int kTPQ = kLanes / kEPT;
  static_assert(32 / kTPQ == kQB / (kThreads / 32), "one round of a warp covers its queries");
  const int tq = ln % kTPQ;
  const int qi = warp * (32 / kTPQ) + ln / kTPQ;
  if (q0 + warp * (32 / kTPQ) < nq) {
    uint64_t w[kEPT];
#pragma unroll
    for (int v = 0; v < kEPT / 4; ++v) {
      const float4 kv = *reinterpret_cast<const float4*>(gm + qi * kGPitch + kEPT * tq + 4 * v);
      const float k4[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) w[4 * v + e] = rank_word(k4[e], kEPT * tq + 4 * v + e);
    }
    group_sort128<kEPT>(w, tq);
#pragma unroll
    for (int v = 0; v < kEPT / 4; ++v) {
      float k4[4];
      int id[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        k4[e] = rank_key(w[4 * v + e]);
        id[e] = k4[e] > kNegInf / 2 ? tile * kLanes + rank_lane(w[4 * v + e]) : -1;
      }
      *reinterpret_cast<float4*>(gm + qi * kGPitch + kEPT * tq + 4 * v) =
          make_float4(k4[0], k4[1], k4[2], k4[3]);
      *reinterpret_cast<int4*>(gi + qi * kGPitch + kEPT * tq + 4 * v) =
          make_int4(id[0], id[1], id[2], id[3]);
    }
  }
  __syncthreads();
  // a thread takes 4 consecutive ranks of one query (one conflict-free
  // 16-byte read each); the stores of one rank are coalesced over the queries
  for (int e = tid; e < (topk + 3) / 4 * kQB; e += kThreads) {
    const int p0 = 4 * (e / kQB), qi = e % kQB, qr = q0 + qi;
    if (qr >= nq) continue;
    const float4 ks = *reinterpret_cast<const float4*>(gm + qi * kGPitch + p0);
    const int4 is = *reinterpret_cast<const int4*>(gi + qi * kGPitch + p0);
    const float kv[4] = {ks.x, ks.y, ks.z, ks.w};
    const int iv[4] = {is.x, is.y, is.z, is.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (p0 + r < topk) {
        const int64_t o = (static_cast<int64_t>(tile) * topk + p0 + r) * nq + qr;
        out_s[o] = kv[r];
        out_i[o] = iv[r];
      }
    }
  }
}

struct Plan {
  int nch, nq_pad, n_qb, row_bytes;
  bool resident;
  int smem;
};

Plan make_plan(int code_type, int nq, int dk, int ld) {
  Plan p;
  p.nch = code_type == kI4 ? (ld + 15) / 16 : (dk + kKC - 1) / kKC;
  p.n_qb = (nq + kQB - 1) / kQB;
  p.nq_pad = p.n_qb * kQB;
  const int elem = code_type == kF32 ? 4 : code_type == kF16 ? 2 : 1;
  p.row_bytes = ld * elem;
  p.resident = p.nch <= kResidentQChunks;
  p.smem = make_layout(code_type, p.nch, p.resident).total;
  return p;
}

template <int CT, int METRIC>
cudaError_t launch(const float* q, const float* qside, const float* qsum,
                   const void* codes, const float* knorm, const int8_t* mask,
                   float* out_s, int32_t* out_i, int nq, int dk, int ld,
                   long long n_tiles, int tile_n, int topk, float scale,
                   float bias, float* qsplit, cudaStream_t stream) {
  const Plan p = make_plan(CT, nq, dk, ld);
  if (n_tiles * p.n_qb > INT_MAX || n_tiles * kLanes > INT_MAX) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(p.nq_pad) * p.nch * kKC;
  split_queries<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      q, qsplit, nq, p.nq_pad, dk, ld, p.nch, CT == kI4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = flat_scan_kernel<CT, METRIC>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  const bool vec = p.row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  kernel<<<static_cast<unsigned>(n_tiles * p.n_qb), kThreads, p.smem, stream>>>(
      qsplit, qside, qsum, static_cast<const char*>(codes), knorm, mask, out_s, out_i,
      nq, p.nq_pad, p.nch, p.row_bytes, tile_n, topk, p.n_qb, p.resident, vec, scale, bias);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch that zvec_flat_scan needs for the split queries.
extern "C" long long zvec_flat_scan_scratch_floats(int code_type, int nq, int dk, int ld) {
  const Plan p = make_plan(code_type, nq, dk, ld);
  return 2LL * p.nq_pad * p.nch * kKC;
}

// Launches stage one on `stream`; returns the cudaError_t of the launches.
// code_type: 0 f32, 1 f16, 2 int8, 3 packed int4 (dk = 2*ld).
// metric: 0 L2, 1 IP, 2 COSINE. qsplit: zvec_flat_scan_scratch_floats floats.
extern "C" int zvec_flat_scan(const float* q, const float* qside,
                              const float* qsum, const void* codes,
                              int code_type, int metric, const float* knorm,
                              const int8_t* mask, float* out_s, int32_t* out_i,
                              int nq, int dk, int ld, long long n, int tile_n,
                              int topk, float scale, float bias, float* qsplit,
                              void* stream) {
  if (nq <= 0 || dk <= 0 || tile_n <= 0 || tile_n % kLanes != 0 || n <= 0 ||
      n % tile_n != 0 || topk < 1 || topk > kLanes ||
      dk != (code_type == kI4 ? 2 * ld : ld)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_tiles = n / tile_n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ZVEC_FLAT_SCAN_CASE(CT, M)                                              \
  case CT * 3 + M:                                                              \
    return static_cast<int>(launch<CT, M>(q, qside, qsum, codes, knorm, mask,   \
                                          out_s, out_i, nq, dk, ld, n_tiles,    \
                                          tile_n, topk, scale, bias, qsplit, s));
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
