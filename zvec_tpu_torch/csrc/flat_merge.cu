// Fused flat scan, the global merge: the top-k of stage one's per-tile
// winner groups, for Hopper (sm_90a).
//
// Replaces the merge inside `zvec_tpu/ops/flat_pallas.py::flat_scan_topk`
// (`:255-258`: the (tile, k, Q) winners transposed to (Q, tile * k), one
// `lax.top_k`, the ids gathered at the picks) and keeps the contract of the
// plain PyTorch version `zvec_tpu_torch/ops/flat_scan.py::_merge_plain`, bit
// for bit:
//   inputs   tile_s / tile_i (n_tiles, k, Q) f32 / int32, as stage one
//            (`csrc/flat_scan.cu`) writes them; each tile's k keys sorted
//            descending (stage one sorts them, kernel and plain version alike)
//   outputs  top_s (Q, k) f32 and gids (Q, k) int64: the k largest keys of a
//            query over its P = n_tiles * k positions p = t * k + r, key
//            descending, equal keys by the lower p (the order of a stable
//            descending sort), each with the id at its position. -0.0 and
//            +0.0 are one key (as torch.sort holds them), and a key is
//            copied from its position, so its sign bit is the input's.
//
// What bounds it: the bytes. A merge that reads every key moves Q * P * 4
// bytes, 1.02 GB at the HNSW build shape (Q 2048, P 125,056), 0.31 ms at
// 3.35 TB/s; the sorted tiles let it read far less. Each tile's keys are
// sorted, so the k-th largest of a query's tile maxima (row r = 0 of every
// tile) is a lower bound L on its k-th largest key, and only each tile's
// prefix of keys >= L can hold a winner: at the build shape a query reads its
// 977 maxima and a few hundred keys more. The work is then latency, not
// bandwidth: a short dependent walk down each tile.
//
// Design: a block owns 8 consecutive queries, so that one (t, r) row of them
// is one 32-byte sector, and 16 warps walk 64 tiles at a time (a lane: one
// query of one tile). Keys become order-preserving 32-bit words (-0.0 as
// +0.0). Two radix selects of four 8-bit digits each find, per query, first
// L over rows r < ceil(k / n_tiles) (row 0 when n_tiles >= k), then the
// k-th largest key T over the keys >= L; the histograms are (digit, query)
// counters in shared memory, and a warp per query scans its 256 bins. A walk
// stops at the first key below max(L, the digits fixed so far), so later
// passes walk less. The last walk collects every key > T (exactly k - e of
// them, e from the select) and the first e keys equal to T in position
// order: equal keys are contiguous in a tile, and a scan over the tiles of
// each 64-tile chunk, carried from chunk to chunk, ranks them. The k (key,
// position) words of a query are sorted in shared memory by a bitonic
// network (key descending, then position ascending), and the keys and ids
// are read back at their positions. Nothing depends on P fitting anywhere:
// P reaches 1.25M keys a query at 10M rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>

namespace {

constexpr int kQ = 8;                   // queries per block: one 32-byte sector of a row
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kSub = 32 / kQ;           // tiles a warp walks at once
constexpr int kChunk = kWarps * kSub;   // tiles a block walks at once
constexpr int kMaxK = 128;
constexpr int kBins = 256;              // one 8-bit digit
static_assert(kChunk == 64, "the rank scan gives each lane two tiles of a chunk");
static_assert(kQ * kMaxK / 2 == kThreads, "the sort gives each thread one pair a step");

struct Smem {
  uint32_t hist[kBins][kQ];   // a digit's counts, (digit, query)
  uint64_t words[kQ][kMaxK];  // the collected (key, position) words
  int rank[kQ][kChunk];       // equal keys per tile of a chunk, then their first rank
  uint32_t prefix[kQ];        // the digits fixed so far
  uint32_t floor[kQ];         // the select's lower bound on its keys (L, or 0)
  int want[kQ];               // rank sought inside the prefix's bucket (1-based)
  int n_above[kQ];            // slots taken by keys above the threshold
  int carry[kQ];              // equal keys in the chunks before
};

// The key's bits made monotone: a larger word is a larger key; -0.0 is +0.0.
__device__ __forceinline__ uint32_t order_bits(float key) {
  const uint32_t b = __float_as_uint(key == 0.f ? 0.f : key);
  return b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
}

// A larger word is a larger key or, on equal keys, a lower position.
__device__ __forceinline__ uint64_t rank_word(uint32_t bits, uint32_t pos) {
  return (static_cast<uint64_t>(bits) << 32) | (0xffffffffu - pos);
}

// One radix pass: histograms digit `shift` of the keys in rows r < rmax of
// every tile whose words are >= floor and whose digits above `shift` equal
// the prefix, then fixes each query's digit.
__device__ void select_digit(Smem& sm, const float* __restrict__ ts, int nq, long long n_tiles, int k,
                             int rmax, int shift) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qq = lane % kQ, sub = lane / kQ;
  const int q = blockIdx.x * kQ + qq;
  for (int i = tid; i < kBins * kQ; i += kThreads) (&sm.hist[0][0])[i] = 0u;
  __syncthreads();
  const uint32_t pre = sm.prefix[qq];
  const uint32_t fixed = shift == 24 ? 0u : 0xffffffffu << (shift + 8);
  const uint32_t lo = max(sm.floor[qq], pre);
  if (q < nq) {
    for (long long t = warp * kSub + sub; t < n_tiles; t += kChunk) {
      const float* p = ts + t * k * nq + q;
      for (int r = 0; r < rmax; ++r) {
        const uint32_t w = order_bits(__ldg(p + static_cast<long long>(r) * nq));
        if (w < lo) break;  // the tile's later keys are no larger
        if ((w & fixed) == pre) atomicAdd(&sm.hist[(w >> shift) & 0xffu][qq], 1u);
      }
    }
  }
  __syncthreads();
  if (warp < kQ) {
    // lane l holds bins 255 - 8l - i, i < 8: the bins in descending order
    uint32_t c[8], sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      c[i] = sm.hist[kBins - 1 - 8 * lane - i][warp];
      sum += c[i];
    }
    const int want = sm.want[warp];
    const uint32_t pre_w = sm.prefix[warp];
    __syncwarp();
    uint32_t incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    uint32_t cum = incl - sum;  // keys in the bins above this lane's
    if (cum < static_cast<uint32_t>(want) && static_cast<uint32_t>(want) <= incl) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (cum + c[i] >= static_cast<uint32_t>(want)) {
          sm.prefix[warp] = pre_w | (static_cast<uint32_t>(kBins - 1 - 8 * lane - i) << shift);
          sm.want[warp] = want - static_cast<int>(cum);
          break;
        }
        cum += c[i];
      }
    }
  }
  __syncthreads();
}

// The want-th largest word of the select's keys, four digits from the top.
__device__ void radix_select(Smem& sm, const float* __restrict__ ts, int nq, long long n_tiles, int k,
                             int rmax) {
#pragma unroll 1
  for (int shift = 24; shift >= 0; shift -= 8) select_digit(sm, ts, nq, n_tiles, k, rmax, shift);
}

__global__ void __launch_bounds__(kThreads) flat_merge_kernel(
    const float* __restrict__ ts, const int32_t* __restrict__ ti, float* __restrict__ out_s,
    int64_t* __restrict__ out_i, int nq, long long n_tiles, int k) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qq = lane % kQ, sub = lane / kQ;
  const int q0 = blockIdx.x * kQ, q = q0 + qq;
  const long long positions = n_tiles * k;

  // L: the k-th largest key of rows r < ceil(k / n_tiles), >= k keys
  if (tid < kQ) {
    sm.prefix[tid] = 0u;
    sm.floor[tid] = 0u;
    sm.want[tid] = k;
  }
  __syncthreads();
  const int rmax_l = static_cast<int>(min(static_cast<long long>(k), (k + n_tiles - 1) / n_tiles));
  radix_select(sm, ts, nq, n_tiles, k, rmax_l);
  // T: the k-th largest key of those >= L (every key >= T is >= L)
  if (tid < kQ) {
    sm.floor[tid] = sm.prefix[tid];
    sm.prefix[tid] = 0u;
    sm.want[tid] = k;
    sm.n_above[tid] = 0;
    sm.carry[tid] = 0;
  }
  for (int i = tid; i < kQ * kMaxK; i += kThreads) (&sm.words[0][0])[i] = 0ull;
  __syncthreads();
  radix_select(sm, ts, nq, n_tiles, k, k);

  // collect the keys > T and the first `need` keys == T in position order
  const uint32_t thr = sm.prefix[qq];
  const int need = sm.want[qq], above = k - need;
  const int slot = warp * kSub + sub;
#pragma unroll 1
  for (long long base = 0; base < n_tiles; base += kChunk) {
    const long long t = base + slot;
    int n_eq = 0, r_eq = 0;
    if (q < nq && t < n_tiles) {
      const float* p = ts + t * k * nq + q;
      for (int r = 0; r < k; ++r) {
        const uint32_t w = order_bits(__ldg(p + static_cast<long long>(r) * nq));
        if (w < thr) break;
        const uint32_t pos = static_cast<uint32_t>(t * k + r);
        if (w > thr) {
          const int s = atomicAdd(&sm.n_above[qq], 1);
          if (s < above) sm.words[qq][s] = rank_word(w, pos);
        } else {
          if (n_eq == 0) r_eq = r;
          ++n_eq;
        }
      }
    }
    sm.rank[qq][slot] = n_eq;
    __syncthreads();
    if (warp < kQ) {  // exclusive scan of the chunk's counts in tile order, plus the carry
      const int a = sm.rank[warp][2 * lane], b = sm.rank[warp][2 * lane + 1];
      const int carry = sm.carry[warp];
      __syncwarp();
      int incl = a + b;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      const int excl = carry + incl - a - b;
      sm.rank[warp][2 * lane] = excl;
      sm.rank[warp][2 * lane + 1] = excl + a;
      if (lane == 31) sm.carry[warp] = carry + incl;
    }
    __syncthreads();
    if (n_eq > 0) {
      const int first = sm.rank[qq][slot];
      for (int j = 0; j < n_eq && first + j < need; ++j)
        sm.words[qq][above + first + j] = rank_word(thr, static_cast<uint32_t>(t * k + r_eq + j));
    }
    __syncthreads();
  }

  // sort each query's words descending (slots past k hold 0, the smallest word)
#pragma unroll 1
  for (int s = 2; s <= kMaxK; s <<= 1) {
#pragma unroll 1
    for (int d = s >> 1; d > 0; d >>= 1) {
      const int qb = tid / (kMaxK / 2), i = tid % (kMaxK / 2);
      const int a = (i / d) * 2 * d + i % d, b = a + d;
      const uint64_t x = sm.words[qb][a], y = sm.words[qb][b];
      if ((x < y) == ((a & s) == 0)) {
        sm.words[qb][a] = y;
        sm.words[qb][b] = x;
      }
      __syncthreads();
    }
  }

  // keys and ids at the picked positions; stores coalesced over (query, rank)
  for (int e = tid; e < kQ * k; e += kThreads) {
    const int qb = e / k, j = e % k, qg = q0 + qb;
    if (qg >= nq) continue;
    const long long pos = 0xffffffffu - static_cast<uint32_t>(sm.words[qb][j]);
    const long long o = static_cast<long long>(qg) * k + j;
    if (pos < positions) {
      out_s[o] = ts[pos * nq + qg];
      out_i[o] = ti[pos * nq + qg];
    } else {  // only if the tiles were not sorted: never for stage one's output
      out_s[o] = -FLT_MAX;
      out_i[o] = -1;
    }
  }
}

}  // namespace

// Launches the merge on `stream`; returns the cudaError_t of the launch.
// tile_s / tile_i: (n_tiles, topk, nq), each tile's keys sorted descending.
// out_s (nq, topk) f32, out_i (nq, topk) int64.
extern "C" int zvec_flat_merge(const float* tile_s, const int32_t* tile_i, float* out_s,
                               int64_t* out_i, long long n_tiles, int topk, int nq, void* stream) {
  if (nq <= 0 || n_tiles <= 0 || topk < 1 || topk > kMaxK || n_tiles * topk >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flat_merge_kernel<<<static_cast<unsigned>((nq + kQ - 1) / kQ), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(tile_s, tile_i, out_s, out_i, nq, n_tiles,
                                                           topk);
  return static_cast<int>(cudaGetLastError());
}
