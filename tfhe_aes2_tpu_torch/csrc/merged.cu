// K9: the whole blind-rotate CMux step in one launch, on Hopper.
//
// K9 (tfhe_cmux_step_merged) replaces the Pallas kernel
// tfhe_aes2_tpu/ops/pallas/extprod.py::cmux_step_merged. Per component o:
//
//   dig     = int8 limb planes of decompose(X^t·acc - acc)   (all O components)
//   new[o]  = acc[o] + Σ_r Σ_{i, j>=js} 2^(8(i+j)) dig_i[r] · NC(BSK plane j)[r][o]
//
// What defines it: one launch a step, and the digits never touch device
// memory. Row r = u·L + l of the contraction is a digit of component u, so a
// block that produces component o needs the glue of ALL O components of the
// OLD accumulator. The TPU kernel ran its grid in order and kept a copy of
// the accumulator tile on chip; here blocks run in no order, so a block
// that wrote acc[o] in place would race with the blocks still reading it
// for their glue. The design: a block owns ROWS lanes of one component, as
// in K1; it first computes the glue of all O components of its lanes from
// the old accumulator into shared memory (R·ND·ROWS·N bytes: 120 KiB at
// PARAMS_SQRD_LVL_64, beside a 32 KiB region that holds one accumulator
// tile during the glue and the S-tables afterwards), then contracts from
// there, and writes the new accumulator to a SECOND buffer. The glue is
// recomputed by the O blocks of a lane tile; that costs O times a short
// phase and keeps O times the blocks on the card that one block per lane
// tile looping over the components would.
//
// What bounds it on the H100: int8 operations, as for K1 (cmux.cu); the
// products are nc::accumulate of nc_common.cuh, __dp4a from shared-memory
// S-tables.
#include "nc_common.cuh"

namespace {

// Bytes of the region that holds an accumulator tile, then the S-tables.
__host__ __device__ inline size_t front_bytes(int nj, int n) {
  const size_t tables = (size_t)nj * 2 * n * 4;
  const size_t tile = (size_t)nc::ROWS * n * 8;
  return tables > tile ? tables : tile;
}

// Grid (ceil(B/ROWS), O), block N/2.
// t       int32 [B]               this step's mod-switched mask element
// ext     int8  [O][R][8-JS][2N]  this step's BSK limb planes
// acc_in  int64 [O][B][N]         read only
// acc_out int64 [O][B][N]         acc_in + the external product
template <int ND, int JS>
__global__ void
cmux_step_merged_kernel(const int32_t* __restrict__ t,
                        const int8_t* __restrict__ ext,
                        const uint64_t* __restrict__ acc_in,
                        uint64_t* __restrict__ acc_out, int B, int n, int O,
                        int levels, int base_log) {
  constexpr int NJ = 8 - JS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int o = blockIdx.y;
  const int b0 = blockIdx.x * nc::ROWS;
  const int rows = min(nc::ROWS, B - b0);
  const int R = O * levels;
  const int nw = n >> 2;

  uint64_t* tile = reinterpret_cast<uint64_t*>(smem);          // [ROWS][N]
  uint32_t* s_tab = reinterpret_cast<uint32_t*>(smem);         // [NJ][2N]
  int8_t* dig_s = reinterpret_cast<int8_t*>(smem + front_bytes(NJ, n));
  // dig_s: [R][ND][ROWS][N], the tile layout of nc::accumulate for each r

  // the glue of every component of the old accumulator, into shared memory;
  // lanes past the batch edge glue a zero row (all-zero digits)
  for (int u = 0; u < O; ++u) {
    __syncthreads();                 // the previous component's tile is read
    for (int idx = threadIdx.x; idx < nc::ROWS * n; idx += blockDim.x)
      tile[idx] = idx < rows * n ? acc_in[((size_t)u * B + b0) * n + idx] : 0;
    __syncthreads();
    for (int row = 0; row < nc::ROWS; ++row) {
      const int tt = row < rows ? t[b0 + row] : 0;
      for (int c = 0; c < nc::COLS; ++c) {
        const int m = threadIdx.x + c * blockDim.x;
        nc::glue<ND>(tile + row * n, tt, m, n, levels, base_log,
                     dig_s + ((size_t)u * levels * ND * nc::ROWS + row) * n,
                     (size_t)ND * nc::ROWS * n, (size_t)nc::ROWS * n);
      }
    }
  }

  int32_t part[nc::ROWS][nc::COLS][NJ];
#pragma unroll
  for (int row = 0; row < nc::ROWS; ++row)
#pragma unroll
    for (int c = 0; c < nc::COLS; ++c)
#pragma unroll
      for (int s = 0; s < NJ; ++s) part[row][c][s] = 0;
  const uint32_t* dig_w = reinterpret_cast<const uint32_t*>(dig_s);
  const int8_t* ext_o = ext + (size_t)o * R * NJ * 2 * n;
  for (int r = 0; r < R; ++r) {
    __syncthreads();       // the glue (r = 0) or the last row's products
    nc::build_s_tables<NJ>(s_tab, ext_o + (size_t)r * NJ * 2 * n,
                           (size_t)2 * n, n);
    __syncthreads();
    nc::accumulate<ND, JS>(part, s_tab, dig_w + (size_t)r * ND * nc::ROWS * nw,
                           n);
  }

#pragma unroll
  for (int row = 0; row < nc::ROWS; ++row) {
    if (row < rows) {
#pragma unroll
      for (int c = 0; c < nc::COLS; ++c) {
        const int m = threadIdx.x + c * blockDim.x;
        const size_t at = ((size_t)o * B + b0 + row) * n + m;
        acc_out[at] = acc_in[at] + nc::recombine<JS>(part[row][c]);
      }
    }
  }
}

template <int ND, int JS>
int launch_merged(const int32_t* t, const int8_t* ext, const int64_t* acc_in,
                  int64_t* acc_out, int B, int n, int O, int levels,
                  int base_log, cudaStream_t stream) {
  const size_t smem = front_bytes(8 - JS, n) +
                      (size_t)O * levels * ND * nc::ROWS * n;
  auto kern = cmux_step_merged_kernel<ND, JS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + nc::ROWS - 1) / nc::ROWS, O);
  kern<<<grid, n / nc::COLS, smem, stream>>>(
      t, ext, reinterpret_cast<const uint64_t*>(acc_in),
      reinterpret_cast<uint64_t*>(acc_out), B, n, O, levels, base_log);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tfhe_cmux_step_merged(const int32_t* t, const int8_t* ext,
                                     const int64_t* acc_in, int64_t* acc_out,
                                     int B, int n, int O, int levels, int nd,
                                     int js, int base_log, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define MERGED_CALL(ND, JS)                                               \
  launch_merged<ND, JS>(t, ext, acc_in, acc_out, B, n, O, levels, base_log, s)
  NC_DISPATCH(nd, js, MERGED_CALL)
#undef MERGED_CALL
}
