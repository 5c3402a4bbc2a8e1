// K4: the exact limb-plane contraction behind keyswitch and pfKS on Hopper.
//
// Replaces the Pallas kernel tfhe_aes2_tpu/ops/pallas/matmul.py::
// fused_limb_matmul, for every shape (the TPU kernel took only MXU-tileable
// ones):
//
//   out[b, n] = Σ_{i, j>=js} 2^(8(i+j)) Σ_k d_i[b, k] · m_j[k, n]   mod 2^64
//
// d: int8 [ND][B][ldd] limb planes of gadget digits, K-contiguous (ldd = K
// rounded up to 16, the tail zero); m: int8 limb planes of the keyswitch
// key, K-contiguous too: plane j's column n at m + (j·N + n)·ldm (ldm >= K,
// a multiple of 16; ops/kernels/matmul.py lays the prepared keys out so).
// At PARAMS_SQRD_LVL_64 the keyswitch is B x 8192 x 678 with ND=1 and 3 key
// planes, the pfKS B x 4098 x 12800 with ND=3 and 7 key planes (18 plane
// pairs).
//
// What bounds it on the H100: int8 operations for the pfKS at B >= ~100
// (B = 288: 288·4098·12800·18 ≈ 2.7e11 multiply-adds, 0.275 ms at the int8
// peak, against 367 MB of key planes, 0.11 ms); the key bytes for the pfKS
// at B = 9 and for the keyswitch (16.7 MB, ~5 us). Design:
//   - Tensor cores: mma.sync.m16n8k32 int8 -> int32, A = digits (16 rows of
//     the batch), B = key (8 columns). A warp owns a 32 x 16 output tile
//     (2 x 2 instructions) and one int32 bucket per weight 2^(8s) for each
//     of its outputs: 8-JS buckets x 16 = 112 registers at JS=1. Rows rather
//     than columns, because the key has 7 planes and the digits 3: a k-step
//     reads 2·ND + NJ ldmatrix.x4 (13) for 4·pairs mma (72).
//   - Block: 3 x 4 warps = 96 rows x 64 columns, one block an SM. 96 rows
//     divide B = 288 exactly, so the key is read from L2 three times and
//     from DRAM once: the grid's x (row tiles) runs fastest, the row tiles
//     of one column slab are neighbours in launch order.
//   - Both operands K-major, as the int8 instruction needs four consecutive
//     k in each register on both sides, so every 64-k slice of each arrives
//     by cp.async straight into its shared tile: rows of 64 bytes whose
//     16-byte chunks are XOR-swizzled by the row, so that ldmatrix's eight
//     rows hit eight different bank groups. (Transposing N-major key planes
//     in shared memory instead cost a third of the kernel's time and left
//     no room for more than two stages: PERF.md, PR 5.)
//   - STAGES = 4 slices in flight: slice t+3 is copied while slice t's mma
//     run; one __syncthreads a slice.
//   - Ragged edges are zero-filled: rows past B, columns past N and chunks
//     from k >= K by cp.async with no source bytes (the bytes of a chunk
//     past K meet zero digits). Warps whose rows or columns all lie past
//     the edge skip their mma.
//   - Few tiles (the keyswitch: 3 x 11 at B = 288) split K across blocks
//     (grid z); each block adds its recombined uint64 partial into the
//     zeroed output with a 64-bit atomicAdd, exact in any order mod 2^64.
//     The wrapper picks the split from the shape.
// ND = 4 (lvl1's pfKS, gadget (1, 24): digits up to 2^23) is built for K4
// alone. Its k-step walks the warp's two 16-row tiles one after the other
// (mma_slice_by_rows): 16 A registers live instead of 32, each key fragment
// loaded twice, so that the buckets stay in registers.
// A bucket sums at most ND products of K terms of at most 2^7·2^7, the
// int32 bound that tfhe_aes2_tpu/ops/torus.py guards (ND·K·2^14 < 2^31;
// 2.0e8 for the pfKS) and that the Python wrapper checks. The emulation in
// tests/test_torch_limb_mma_layout.py follows this file index by index.
#include "nc_mma.cuh"   // cp_async16, mma_s8, NC_DISPATCH

namespace {

// Warps along the rows of a block tile, and slices in flight;
// probes/limb_variants.py builds other values and times them against these.
#ifndef K4_MW
#define K4_MW 3
#endif
#ifndef K4_STAGES
#define K4_STAGES 4
#endif
constexpr int MW = K4_MW, NW = 4;         // warps along rows, columns
constexpr int BM = 32 * MW;               // 96 output rows a block
constexpr int BN = 16 * NW;               // 64 output columns a block
constexpr int KT = 64;                    // contraction slice (two k-steps)
constexpr int THREADS = 32 * MW * NW;     // 384
constexpr int STAGES = K4_STAGES;         // slices in shared memory

__host__ __device__ constexpr int b_bytes(int nj) { return nj * BN * KT; }
__host__ __device__ constexpr int a_bytes(int nd) { return nd * BM * KT; }
__host__ __device__ constexpr int stage_bytes(int nd, int nj) {
  return b_bytes(nj) + a_bytes(nd);
}

// Byte offset of 16-byte chunk c (0..3) of row `row` in a K-major tile of
// 64-byte rows: chunks XOR-swizzled so that any eight consecutive rows
// starting at a multiple of 8 put one chunk index in eight bank groups.
__device__ __forceinline__ int swz(int row, int c) {
  return row * KT + 16 * (c ^ (((row >> 1) ^ (row >> 3)) & 3));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const unsigned char* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One slice's tiles, k0 = KT·t: key plane j, block column n, chunk c holds
// m_j[k0 + 16c .. +15][n0 + n]; digit plane i, block row `row`, chunk c
// holds d_i[b0 + row][k0 + 16c .. +15].
template <int ND, int NJ>
__device__ __forceinline__ void copy_slice(unsigned char* stage,
                                           const int8_t* __restrict__ d,
                                           const int8_t* __restrict__ m,
                                           int B, int K, int N, int ldd,
                                           int ldm, int b0, int n0, int k0) {
  unsigned char* bt = stage;
  unsigned char* a = stage + b_bytes(NJ);
  for (int idx = threadIdx.x; idx < NJ * BN * 4; idx += THREADS) {
    const int c = idx & 3;
    const int n = (idx >> 2) % BN;
    const int j = idx / (4 * BN);
    const int k = k0 + 16 * c;
    const bool ok = n0 + n < N && k < K;
    nc::cp_async16(bt + j * BN * KT + swz(n, c),
                   ok ? m + ((size_t)j * N + n0 + n) * ldm + k : m,
                   ok ? 16 : 0);
  }
  for (int idx = threadIdx.x; idx < ND * BM * 4; idx += THREADS) {
    const int c = idx & 3;
    const int row = (idx >> 2) % BM;
    const int i = idx / (4 * BM);
    const int k = k0 + 16 * c;
    const bool ok = b0 + row < B && k < K;
    nc::cp_async16(a + i * BM * KT + swz(row, c),
                   ok ? d + ((size_t)i * B + b0 + row) * ldd + k : d,
                   ok ? 16 : 0);
  }
}

// One slice's products into the buckets: acc[mt][nt][s] is the D fragment
// of the warp's 16 x 8 tile (mt, nt) for weight 2^(8(s+JS)).
template <int ND, int JS>
__device__ __forceinline__ void mma_slice(int32_t (&acc)[2][2][8 - JS][4],
                                          const unsigned char* stage, int wm,
                                          int wn) {
  const unsigned char* bt = stage;
  const unsigned char* a = stage + b_bytes(8 - JS);
  const int lane = threadIdx.x & 31;
  // ldmatrix: lane l gives the address of row l % 8 of matrix l / 8
  const int a_row = 32 * wm + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_hi = lane >> 4;                 // k 16..31 of the k-step
  const int b_row = 16 * wn + (lane & 7) + 8 * (lane >> 4);
  const int b_hi = (lane >> 3) & 1;
#pragma unroll
  for (int kt = 0; kt < KT / 32; ++kt) {
    uint32_t af[ND][2][4];
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[i][mt],
                    a + i * BM * KT + swz(a_row + 16 * mt, 2 * kt + a_hi));
#pragma unroll
    for (int j = JS; j < 8; ++j) {
      uint32_t bf[4];
      ldmatrix_x4(bf, bt + (j - JS) * BN * KT + swz(b_row, 2 * kt + b_hi));
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        if (i + j < 8) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              nc::mma_s8(acc[mt][nt][i + j - JS], af[i][mt][0], af[i][mt][1],
                         af[i][mt][2], af[i][mt][3], bf[2 * nt],
                         bf[2 * nt + 1]);
        }
      }
    }
  }
}

// mma_slice for ND = 4: the same products, one 16-row tile of the warp at a
// time, so that only that tile's A fragments are live.
template <int ND, int JS>
__device__ __forceinline__ void mma_slice_by_rows(
    int32_t (&acc)[2][2][8 - JS][4], const unsigned char* stage, int wm,
    int wn) {
  const unsigned char* bt = stage;
  const unsigned char* a = stage + b_bytes(8 - JS);
  const int lane = threadIdx.x & 31;
  const int a_row = 32 * wm + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_hi = lane >> 4;
  const int b_row = 16 * wn + (lane & 7) + 8 * (lane >> 4);
  const int b_hi = (lane >> 3) & 1;
#pragma unroll
  for (int kt = 0; kt < KT / 32; ++kt) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      uint32_t af[ND][4];
#pragma unroll
      for (int i = 0; i < ND; ++i)
        ldmatrix_x4(af[i],
                    a + i * BM * KT + swz(a_row + 16 * mt, 2 * kt + a_hi));
#pragma unroll
      for (int j = JS; j < 8; ++j) {
        uint32_t bf[4];
        ldmatrix_x4(bf, bt + (j - JS) * BN * KT + swz(b_row, 2 * kt + b_hi));
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          if (i + j < 8) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              nc::mma_s8(acc[mt][nt][i + j - JS], af[i][0], af[i][1],
                         af[i][2], af[i][3], bf[2 * nt], bf[2 * nt + 1]);
          }
        }
      }
    }
  }
}

// Grid (ceil(B/BM), ceil(N/BN), splits), block THREADS. Block z of `splits`
// takes slices [z·T/splits, (z+1)·T/splits) of the T = ceil(K/KT).
template <int ND, int JS>
__global__ void __launch_bounds__(THREADS, 1)
fused_limb_matmul_kernel(const int8_t* __restrict__ d,
                         const int8_t* __restrict__ m,
                         uint64_t* __restrict__ out, int B, int K, int N,
                         int ldd, int ldm) {
  constexpr int NJ = 8 - JS;
  constexpr int SB = stage_bytes(ND, NJ);
  extern __shared__ __align__(16) unsigned char smem[];   // [STAGES][SB]
  const int b0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / NW, wn = warp % NW;
  const bool busy = b0 + 32 * wm < B && n0 + 16 * wn < N;
  const int slices = (K + KT - 1) / KT;
  const int t0 = (int)((long long)blockIdx.z * slices / gridDim.z);
  const int cnt = (int)((long long)(blockIdx.z + 1) * slices / gridDim.z) - t0;

  int32_t acc[2][2][NJ][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int s = 0; s < NJ; ++s)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][s][c] = 0;

  // one commit group a slice, empty past the last, so that the wait at
  // slice r leaves only the groups of slices r+1 .. r+STAGES-2 in flight
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < cnt)
      copy_slice<ND, NJ>(smem + s * SB, d, m, B, K, N, ldd, ldm, b0, n0,
                         KT * (t0 + s));
    nc::cp_async_commit();
  }
  for (int r = 0; r < cnt; ++r) {
    cp_async_wait_group<STAGES - 2>();
    // slice r has landed for every thread, and every warp is past slice
    // r-1's mma, whose stage the next copy takes
    __syncthreads();
    const int next = r + STAGES - 1;
    if (next < cnt)
      copy_slice<ND, NJ>(smem + (next % STAGES) * SB, d, m, B, K, N, ldd,
                         ldm, b0, n0, KT * (t0 + next));
    nc::cp_async_commit();
    if (busy) {
      if constexpr (ND <= 3)
        mma_slice<ND, JS>(acc, smem + (r % STAGES) * SB, wm, wn);
      else
        mma_slice_by_rows<ND, JS>(acc, smem + (r % STAGES) * SB, wm, wn);
    }
  }
  cp_async_wait_group<0>();

  // register c of tile (mt, nt) is row 16mt + gid + 8(c/2), column
  // 8nt + 2tig + c%2 of the warp's 32 x 16 tile
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int b = b0 + 32 * wm + 16 * mt + gid + 8 * (c >> 1);
        const int n = n0 + 16 * wn + 8 * nt + 2 * tig + (c & 1);
        if (b >= B || n >= N) continue;
        int32_t bucket[NJ];
#pragma unroll
        for (int s = 0; s < NJ; ++s) bucket[s] = acc[mt][nt][s][c];
        const uint64_t sum = nc::recombine<JS>(bucket);
        uint64_t* o = out + (size_t)b * N + n;
        if (gridDim.z > 1)
          atomicAdd(reinterpret_cast<unsigned long long*>(o),
                    (unsigned long long)sum);
        else
          *o = sum;
      }
}

template <int ND, int JS>
int launch(const int8_t* d, const int8_t* m, int64_t* out, int B, int K,
           int N, int ldd, int ldm, int splits, cudaStream_t stream) {
  const int smem = STAGES * stage_bytes(ND, 8 - JS);
  auto kern = fused_limb_matmul_kernel<ND, JS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + BM - 1) / BM, (N + BN - 1) / BN, splits);
  kern<<<grid, THREADS, smem, stream>>>(
      d, m, reinterpret_cast<uint64_t*>(out), B, K, N, ldd, ldm);
  return (int)cudaGetLastError();
}

}  // namespace

// out must be zeroed when splits > 1 (the blocks add into it). nd runs to 4
// here alone: the ND = 4 cases are K4's own, not NC_DISPATCH's.
extern "C" int tfhe_fused_limb_matmul(const int8_t* d, const int8_t* m,
                                      int64_t* out, int B, int K, int N,
                                      int ldd, int ldm, int splits, int nd,
                                      int js, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define MM_CALL(ND, JS) \
  launch<ND, JS>(d, m, out, B, K, N, ldd, ldm, splits, s)
  if (nd == 4) {
    switch (js) {
      case 0: return MM_CALL(4, 0); case 1: return MM_CALL(4, 1);
      case 2: return MM_CALL(4, 2); case 3: return MM_CALL(4, 3);
      case 4: return MM_CALL(4, 4); case 5: return MM_CALL(4, 5);
      case 6: return MM_CALL(4, 6); case 7: return MM_CALL(4, 7);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  NC_DISPATCH(nd, js, MM_CALL)
#undef MM_CALL
}
