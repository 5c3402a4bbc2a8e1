// K1 and K2: the blind-rotate CMux step on Hopper.
//
// K1 (tfhe_extprod_step2g) replaces the Pallas kernel
// tfhe_aes2_tpu/ops/pallas/extprod.py::extprod_step2g; K2
// (tfhe_rot_diff_digits) replaces extprod.py::rot_diff_digits. One CMux step
// of the 677-step blind rotation at PARAMS_SQRD_LVL_64 is, per component o:
//
//   acc[o] += Σ_r Σ_{i, j>=js} 2^(8(i+j)) dig_i[r] · NC(BSK plane j)[r][o]
//   next_dig = int8 limb planes of decompose(X^t_next·acc - acc)
//
// and K1 does both in one launch: the block that finishes a row of the new
// accumulator holds the whole polynomial (all N columns of its ROWS batch
// lanes), so the next step's rotation, difference, gadget decomposition and
// limb split (the "glue", K2's body) run from shared memory without another
// pass over device memory. K2 is that glue alone, for step 0.
//
// What bounds it on the H100: int8 operations. At B = 256 lanes a step is
// 256·5·15·512²·11 ≈ 5.5e10 multiply-adds against ~15 MB of operands, far
// above the card's operations-per-byte balance. This first version feeds
// the products through __dp4a (4 int8 multiply-adds per instruction on the
// CUDA cores) from shared-memory S-tables (nc_common.cuh), not through the
// tensor cores, so it runs well below the 1,979 TOPS int8 tensor peak; the
// negacirculant is built on chip from the 2N-byte ext row, never stored.
// Moving the products onto mma/wgmma is the next step for this kernel.
#include "nc_common.cuh"

namespace {

// Grid (ceil(B/ROWS), O), block N/2.
// dig     int8  [R][ND][B][N]       this step's digit limb planes (R = O·L)
// ext     int8  [O][R][8-JS][2N]    this step's BSK limb planes
// acc     int64 [O][B][N]           updated in place
// t_next  int32 [B]                 next step's mod-switched mask element
// dig_out int8  [O][L][ND][B][N]    next step's digits
template <int ND, int JS>
__global__ void
extprod_step2g_kernel(const int8_t* __restrict__ dig,
                      const int8_t* __restrict__ ext,
                      uint64_t* __restrict__ acc,
                      const int32_t* __restrict__ t_next,
                      int8_t* __restrict__ dig_out, int B, int n, int R,
                      int levels, int base_log) {
  constexpr int NJ = 8 - JS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int o = blockIdx.y;
  const int b0 = blockIdx.x * nc::ROWS;
  const int rows = min(nc::ROWS, B - b0);

  int32_t part[nc::ROWS][nc::COLS][NJ];
  const nc::Operands op{dig + (size_t)b0 * n, (size_t)ND * B * n,
                        (size_t)B * n, (size_t)n,
                        ext + (size_t)o * R * NJ * 2 * n,
                        (size_t)NJ * 2 * n, (size_t)2 * n};
  nc::contract<ND, JS>(part, smem, op, R, rows, n);

  __syncthreads();                      // shared memory now holds the tile
  uint64_t* tile = reinterpret_cast<uint64_t*>(smem);   // [ROWS][N]
#pragma unroll
  for (int row = 0; row < nc::ROWS; ++row) {
#pragma unroll
    for (int c = 0; c < nc::COLS; ++c) {
      const int m = threadIdx.x + c * blockDim.x;
      uint64_t v = 0;
      if (row < rows) {
        uint64_t* p = acc + ((size_t)o * B + b0 + row) * n + m;
        v = *p + nc::recombine<JS>(part[row][c]);
        *p = v;
      }
      tile[row * n + m] = v;
    }
  }
  __syncthreads();
  for (int row = 0; row < rows; ++row) {
    const int t = t_next[b0 + row];
    for (int c = 0; c < nc::COLS; ++c) {
      const int m = threadIdx.x + c * blockDim.x;
      nc::glue<ND>(tile + row * n, t, m, n, levels, base_log,
                   dig_out + (((size_t)o * levels * ND) * B + b0 + row) * n,
                   (size_t)ND * B * n, (size_t)B * n);
    }
  }
}

// Grid (ceil(B/ROWS), O), block N/2: the glue alone.
template <int ND>
__global__ void
rot_diff_digits_kernel(const uint64_t* __restrict__ acc,
                       const int32_t* __restrict__ t,
                       int8_t* __restrict__ dig_out, int B, int n, int levels,
                       int base_log) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* tile = reinterpret_cast<uint64_t*>(smem);
  const int o = blockIdx.y;
  const int b0 = blockIdx.x * nc::ROWS;
  const int rows = min(nc::ROWS, B - b0);
  for (int idx = threadIdx.x; idx < rows * n; idx += blockDim.x)
    tile[idx] = acc[((size_t)o * B + b0) * n + idx];
  __syncthreads();
  for (int row = 0; row < rows; ++row) {
    for (int c = 0; c < nc::COLS; ++c) {
      const int m = threadIdx.x + c * blockDim.x;
      nc::glue<ND>(tile + row * n, t[b0 + row], m, n, levels, base_log,
                   dig_out + (((size_t)o * levels * ND) * B + b0 + row) * n,
                   (size_t)ND * B * n, (size_t)B * n);
    }
  }
}

template <int ND, int JS>
int launch_step(const int8_t* dig, const int8_t* ext, int64_t* acc,
                const int32_t* t_next, int8_t* dig_out, int B, int n, int O,
                int R, int levels, int base_log, cudaStream_t stream) {
  const size_t smem_main = nc::contraction_smem(ND, 8 - JS, n);
  const size_t smem_tile = (size_t)nc::ROWS * n * 8;
  const size_t smem = smem_main > smem_tile ? smem_main : smem_tile;
  auto kern = extprod_step2g_kernel<ND, JS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + nc::ROWS - 1) / nc::ROWS, O);
  kern<<<grid, n / nc::COLS, smem, stream>>>(
      dig, ext, reinterpret_cast<uint64_t*>(acc), t_next, dig_out, B, n, R,
      levels, base_log);
  return (int)cudaGetLastError();
}

template <int ND>
int launch_glue(const int64_t* acc, const int32_t* t, int8_t* dig_out, int B,
                int n, int O, int levels, int base_log, cudaStream_t stream) {
  const size_t smem = (size_t)nc::ROWS * n * 8;
  auto kern = rot_diff_digits_kernel<ND>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + nc::ROWS - 1) / nc::ROWS, O);
  kern<<<grid, n / nc::COLS, smem, stream>>>(
      reinterpret_cast<const uint64_t*>(acc), t, dig_out, B, n, levels,
      base_log);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tfhe_extprod_step2g(const int8_t* dig, const int8_t* ext,
                                   int64_t* acc, const int32_t* t_next,
                                   int8_t* dig_out, int B, int n, int O, int R,
                                   int levels, int nd, int js, int base_log,
                                   void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define STEP_CALL(ND, JS)                                                   \
  launch_step<ND, JS>(dig, ext, acc, t_next, dig_out, B, n, O, R, levels,  \
                      base_log, s)
  NC_DISPATCH(nd, js, STEP_CALL)
#undef STEP_CALL
}

extern "C" int tfhe_rot_diff_digits(const int64_t* acc, const int32_t* t,
                                    int8_t* dig_out, int B, int n, int O,
                                    int levels, int nd, int base_log,
                                    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (nd) {
    case 1: return launch_glue<1>(acc, t, dig_out, B, n, O, levels, base_log, s);
    case 2: return launch_glue<2>(acc, t, dig_out, B, n, O, levels, base_log, s);
    case 3: return launch_glue<3>(acc, t, dig_out, B, n, O, levels, base_log, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
