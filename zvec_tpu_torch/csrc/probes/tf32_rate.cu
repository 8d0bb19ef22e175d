// Tensor-core TF32 rate of one H100, by instruction route: mma.sync
// m16n8k8 and wgmma m64n128k8 with A from registers (RS) or shared memory
// (SS), each in a loop of independent products on zeroed operands. It is the
// yardstick behind the choice of route in ../flat_scan.cu.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o tf32_rate tf32_rate.cu && ./tf32_rate
//
// Prints TFLOP/s per route (2 * M * N * K per product).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdio>

namespace {

constexpr int kBlocks = 132 * 4;  // four blocks of 256 threads per SM

__global__ void mma_sync_loop(float* out, int iters) {
  float c[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, 2u, 3u, 4u}, b0 = 5u, b1 = 6u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int k = 0; k < 8; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__device__ __forceinline__ uint64_t tile_desc(const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 t;\nmov.b32 t, 1;\nsetp.ne.b32 p, t, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 t;\nmov.b32 t, 1;\nsetp.ne.b32 p, t, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b));
}

// 12 products per wait, as the flat-scan kernel issues for one fp32 chunk
template <bool RS>
__global__ void __launch_bounds__(256, 1) wgmma_loop(float* out, int iters) {
  extern __shared__ char smem_raw[];
  char* s = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  for (int i = threadIdx.x; i < 65536 / 4; i += 256) reinterpret_cast<float*>(s)[i] = 0.f;
  __syncthreads();
  float d[64] = {};
  const uint32_t a[4] = {0u, 0u, 0u, 0u};
  const uint64_t db = tile_desc(s), da = tile_desc(s + 32768 + (threadIdx.x / 128) * 8192);
  for (int i = 0; i < iters; ++i) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      if (RS) {
        wgmma_rs(d, a, db + 2 * (k & 3));
      } else {
        wgmma_ss(d, da + 2 * (k & 3), db + 2 * (k & 3));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  float t = 0.f;
  for (int i = 0; i < 64; ++i) t += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}

template <typename K>
void run(const char* name, K kernel, int smem, double flop_per_iter_per_block) {
  float* out;
  cudaMalloc(&out, sizeof(float) * kBlocks * 256);
  if (smem) cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int iters = 2000;
  kernel<<<kBlocks, 256, smem>>>(out, 10);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  kernel<<<kBlocks, 256, smem>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  const double flop = flop_per_iter_per_block * kBlocks * iters;
  printf("%-24s %8.3f ms  %6.1f TFLOP/s  (%s)\n", name, ms, flop / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

}  // namespace

int main() {
  run("mma.sync m16n8k8", mma_sync_loop, 0, 8.0 * 8 * (2.0 * 16 * 8 * 8));
  const int smem = 66 * 1024 + 1024;
  run("wgmma m64n128k8 RS", wgmma_loop<true>, smem, 2.0 * 12 * (2.0 * 64 * 128 * 8));
  run("wgmma m64n128k8 SS", wgmma_loop<false>, smem, 2.0 * 12 * (2.0 * 64 * 128 * 8));
  return 0;
}
