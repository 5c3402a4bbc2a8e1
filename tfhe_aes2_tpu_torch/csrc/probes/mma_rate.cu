// What int8 rate can a kernel whose matrix instruction has N = 8 reach on
// this card? A standalone probe behind the design of nc_mma.cuh, whose
// instructions have N = 8 because a block owns 8 batch lanes.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_rate mma_rate.cu
//   ./mma_rate
//
// It times, on every SM at once, with 4, 8 and 16 warps a block and one or
// two blocks an SM:
//   pure   mma.sync.m16n8k32.s8 alone, 8 independent accumulators a warp;
//   loop   the same 8 instructions with what nc::mma_row puts between
//          them (4 + 4 shared loads, 6 register moves), and the same with
//          the loads replaced by integer adds;
//   wgmma  wgmma.mma_async.m64n8k32.s8 with A from registers and B from
//          shared memory, 8 accumulators a warp, one group in flight;
//   wide   wgmma.m64nNk32.s8 for N = 32, 64, 128 (rates only);
// and prints each as TOPS and as a share of the H100's 1,979 TOPS dense
// int8 peak. Before timing it checks the wgmma operand forms against a host
// reference: A's register fragment is mma.sync's with rows 16·warp + ..,
// B is two 8 x 16-byte core matrices 128 bytes apart (leading byte offset
// 128, no swizzle).
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <cuda_runtime.h>

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo,
                                              int sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_n8(int32_t (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1));
}
// The same instruction at wider N: rates only (operands are not checked).
__device__ __forceinline__ void wgmma_n32(int32_t (&d)[16], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1));
}
__device__ __forceinline__ void wgmma_n64(int32_t (&d)[32], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1));
}
__device__ __forceinline__ void wgmma_n128(int32_t (&d)[64], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1));
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int NACC>
__device__ __forceinline__ int32_t fold(const int32_t (&acc)[NACC][4]) {
  int32_t s = 0;
#pragma unroll
  for (int q = 0; q < NACC; ++q) s += acc[q][0] + acc[q][1] + acc[q][2] + acc[q][3];
  return s;
}

__global__ void pure_kernel(int iters, int32_t* out, uint32_t seed) {
  int32_t acc[8][4] = {};
  const uint32_t a0 = seed + threadIdx.x, a1 = a0 * 3, a2 = a0 * 5,
                 a3 = a0 * 7, b0 = a0 * 11, b1 = a0 * 13;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int q = 0; q < 8; ++q) mma_s8(acc[q], a0, a1, a2, a3, b0, b1);
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = fold(acc);
}

// One (key plane, k-step) of nc::mma_row at ND = 2 per iteration.
template <bool LOADS>
__global__ void loop_kernel(int iters, int32_t* out, uint32_t seed) {
  extern __shared__ uint32_t sm[];
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) sm[i] = i * seed;
  __syncthreads();
  int32_t acc[8][4] = {};
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const uint32_t* at = sm + 512 + 4 * tig - gid;
  const uint32_t* dg = sm + 4096 + gid * 132 + tig;
  uint32_t v[10];
#pragma unroll
  for (int p = 4; p < 10; ++p) v[p] = at[-8 * p];
  for (int i = 0; i < iters; ++i) {
    const int off = (i & 15) * 32;
    uint32_t b[2][2];
    if (LOADS) {
#pragma unroll
      for (int p = 0; p < 4; ++p) v[p] = at[off - 8 * p];
      b[0][0] = dg[off / 4];
      b[0][1] = dg[off / 4 + 4];
      b[1][0] = dg[off / 4 + 1056];
      b[1][1] = dg[off / 4 + 1060];
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) v[p] = v[p + 4] + i;
      b[0][0] = v[0]; b[0][1] = v[1]; b[1][0] = v[2]; b[1][1] = v[3];
    }
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        mma_s8(acc[ii * 4 + q], v[2 * q + 2], v[2 * q + 3], v[2 * q],
               v[2 * q + 1], b[ii][0], b[ii][1]);
#pragma unroll
    for (int p = 9; p >= 4; --p) v[p] = v[p - 4];
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = fold(acc);
}

__global__ void wgmma_kernel(int iters, int32_t* out, uint32_t seed) {
  __shared__ __align__(128) uint8_t sb[4096];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) sb[i] = i * seed;
  __syncthreads();
  int32_t acc[8][4] = {};
  const uint32_t a0 = seed + threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7;
  const uint64_t desc = smem_desc(sb, 128, 256);
  for (int i = 0; i < iters; ++i) {
    wg_fence();
#pragma unroll
    for (int q = 0; q < 8; ++q)
      wgmma_n8(acc[q], a0, a1, a2, a3, desc + (q & 3) * 16);
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
  out[blockIdx.x * blockDim.x + threadIdx.x] = fold(acc);
}

// wgmma.m64nNk32 with A from registers, GROUPS independent accumulators a
// warpgroup, one commit group in flight: does a wider N reach more of the
// peak than N = 8?
template <int N, int GROUPS>
__global__ void wgmma_wide_kernel(int iters, int32_t* out, uint32_t seed) {
  __shared__ __align__(128) uint8_t sb[8192];
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) sb[i] = i * seed;
  __syncthreads();
  int32_t acc[GROUPS][N / 2] = {};
  const uint32_t a0 = seed + threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7;
  const uint64_t desc = smem_desc(sb, 128, 256);
  for (int i = 0; i < iters; ++i) {
    wg_fence();
#pragma unroll
    for (int q = 0; q < GROUPS; ++q) {
      if constexpr (N == 32) wgmma_n32(acc[q], a0, a1, a2, a3, desc + q * 16);
      if constexpr (N == 64) wgmma_n64(acc[q], a0, a1, a2, a3, desc + q * 16);
      if constexpr (N == 128)
        wgmma_n128(acc[q], a0, a1, a2, a3, desc + q * 16);
    }
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
  int32_t s = 0;
#pragma unroll
  for (int q = 0; q < GROUPS; ++q)
#pragma unroll
    for (int c = 0; c < N / 2; ++c) s += acc[q][c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// One warpgroup, one wgmma, for the layout check.
__global__ void wgmma_once(const uint32_t* a_regs, const uint8_t* b_bytes,
                           int32_t* d_out) {
  __shared__ __align__(128) uint8_t sb[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) sb[i] = b_bytes[i];
  __syncthreads();
  int32_t d[4] = {0, 0, 0, 0};
  const uint32_t* a = a_regs + threadIdx.x * 4;
  wg_fence();
  wgmma_n8(d, a[0], a[1], a[2], a[3], smem_desc(sb, 128, 256));
  wg_commit();
  wg_wait<0>();
  for (int c = 0; c < 4; ++c) d_out[threadIdx.x * 4 + c] = d[c];
}

static int check_wgmma_layout() {
  std::vector<uint32_t> a(128 * 4);
  std::vector<uint8_t> b(256);
  srand(1);
  for (auto& x : a) x = (uint32_t)rand() * 2654435761u;
  for (auto& x : b) x = (uint8_t)rand();
  uint32_t* da; uint8_t* db; int32_t* dd;
  cudaMalloc(&da, a.size() * 4); cudaMalloc(&db, 256); cudaMalloc(&dd, 2048);
  cudaMemcpy(da, a.data(), a.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(db, b.data(), 256, cudaMemcpyHostToDevice);
  wgmma_once<<<1, 128>>>(da, db, dd);
  std::vector<int32_t> d(512);
  cudaMemcpy(d.data(), dd, 2048, cudaMemcpyDeviceToHost);
  int bad = 0;
  for (int t = 0; t < 128; ++t) {
    const int warp = t / 32, gid = (t % 32) / 4, tig = t % 4;
    for (int c = 0; c < 4; ++c) {
      const int row = gid + 8 * (c >> 1), col = 2 * tig + (c & 1);
      int64_t sum = 0;
      for (int k = 0; k < 32; ++k) {
        // A[16·warp + row][k]: thread (row % 8, (k % 16) / 4) of the warp,
        // register row / 8 + 2·(k / 16), byte k % 4
        const int owner = warp * 32 + (row % 8) * 4 + (k % 16) / 4;
        const int reg = row / 8 + 2 * (k / 16);
        const int8_t av = (int8_t)((a[owner * 4 + reg] >> (8 * (k % 4))) & 0xFF);
        const int8_t bv = (int8_t)b[(k / 16) * 128 + col * 16 + k % 16];
        sum += (int)av * (int)bv;
      }
      bad += (int32_t)sum != d[t * 4 + c];
    }
  }
  printf("wgmma m64n8k32 layout check: %d mismatches of 512 (cudaError %d)\n",
         bad, (int)cudaGetLastError());
  return bad;
}

template <typename K>
static void run(const char* name, K kern, int threads, int blocks,
                size_t smem, double macs_warp_iter = 8 * 4096) {
  int32_t* out;
  cudaMalloc(&out, 4 * (size_t)threads * blocks);
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int iters = 20000;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  kern<<<blocks, threads, smem>>>(100, out, 1);
  cudaEventRecord(e0);
  kern<<<blocks, threads, smem>>>(iters, out, 1);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  // multiply-adds a warp an iteration: 8 x (16 x 8 x 32) unless given
  const double macs = (double)iters * macs_warp_iter * (threads / 32) * blocks;
  const double tops = 2 * macs / (ms * 1e-3) / 1e12;
  printf("%-22s %3d threads x %3d blocks: %8.3f ms  %7.1f TOPS  %5.1f%% of "
         "1979 (cudaError %d)\n", name, threads, blocks, ms, tops,
         tops / 19.79, (int)cudaGetLastError());
  cudaFree(out);
}

int main() {
  if (check_wgmma_layout()) return 1;
  for (int blocks : {132, 264})
    for (int threads : {128, 256, 512}) {
      run("pure mma.sync", pure_kernel, threads, blocks, 0);
      run("loop, shared loads", loop_kernel<true>, threads, blocks, 40000);
      run("loop, adds for loads", loop_kernel<false>, threads, blocks, 40000);
      run("wgmma m64n8k32 RS", wgmma_kernel, threads, blocks, 0);
    }
  // a warp's share of one m64nNk32 is 16 x N x 32 multiply-adds
  for (int blocks : {132, 264})
    for (int threads : {128, 256}) {
      run("wgmma m64n32k32 RS x4", wgmma_wide_kernel<32, 4>, threads, blocks,
          0, 4.0 * 16 * 32 * 32);
      run("wgmma m64n64k32 RS x2", wgmma_wide_kernel<64, 2>, threads, blocks,
          0, 2.0 * 16 * 64 * 32);
      run("wgmma m64n128k32 RS x2", wgmma_wide_kernel<128, 2>, threads,
          blocks, 0, 2.0 * 16 * 128 * 32);
    }
  return 0;
}
