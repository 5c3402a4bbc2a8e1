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
// the old accumulator into shared memory (R·ND·ROWS·(N+16) bytes: 123.75 KiB
// at PARAMS_SQRD_LVL_64, each row padded as nc_mma.cuh's digit tile; the
// accumulator tile of the glue lies over the idle S-table stages), then
// contracts from there, and writes the new accumulator to a SECOND buffer.
// The glue is recomputed by the O blocks of a lane tile; that costs O times
// a short phase and keeps O times the blocks on the card that one block per
// lane tile looping over the components would. This layout takes N <= 512;
// at N = 1024 a lane tile's blocks share the glue out as one cluster
// (merged_wide.cu).
//
// What bounds it on the H100: int8 operations, as for K1 (cmux.cu). The
// products are nc::contract_mma of nc_mma.cuh: mma.sync.m16n8k32 int8 on the
// tensor cores, A fragments read from the S-tables, B fragments from the
// resident digit tile, the key rows staged by cp.async one contraction row
// ahead. One block an SM (the resident digits leave room for no second);
// as in K1 what is left above the bound is the instruction rate of mma.sync, and
// the O glues and the accumulator tiles they read cost ~25 us a block.
#include "nc_mma.cuh"

namespace {

// Bytes before the resident digit tiles: the two stages of S-tables and raw
// key rows, or the accumulator tile of the glue phase.
__host__ __device__ inline size_t front_bytes(int nj, int n) {
  const size_t stages =
      2 * (size_t)(nc::tab_bytes(nj, n) + nc::raw_bytes(nj, n));
  const size_t tile = (size_t)nc::ROWS * n * 8;
  return stages > tile ? stages : tile;
}

// Grid (ceil(B/ROWS), O), block N/2 (one warp per 64 columns).
// t       int32 [B]               this step's mod-switched mask element
// ext     int8  [O][R][8-JS][2N]  this step's BSK limb planes
// acc_in  int64 [O][B][N]         read only
// acc_out int64 [O][B][N]         acc_in + the external product
template <int ND, int JS>
__global__ void __launch_bounds__(256)
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
  const size_t row_bytes = n + nc::DIG_PAD;

  uint64_t* tile = reinterpret_cast<uint64_t*>(smem);          // [ROWS][N]
  int8_t* dig_s = reinterpret_cast<int8_t*>(smem + front_bytes(NJ, n));
  // dig_s: [R][ND][ROWS][N + DIG_PAD], one padded digit tile per row r

  // the glue of every component of the old accumulator, into shared memory;
  // lanes past the batch edge glue a zero row (all-zero digits). A thread
  // moves ROWS·COLS tile values a component (blockDim = N / COLS) and holds
  // the next component's in registers while it glues this one's.
  constexpr int PER = nc::ROWS * nc::COLS;
  uint64_t next[PER];
  int tt[nc::ROWS];
#pragma unroll
  for (int row = 0; row < nc::ROWS; ++row)
    tt[row] = row < rows ? t[b0 + row] : 0;
  auto fetch = [&](int u) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = threadIdx.x + k * blockDim.x;
      next[k] = idx < rows * n ? acc_in[((size_t)u * B + b0) * n + idx] : 0;
    }
  };
  fetch(0);
  for (int u = 0; u < O; ++u) {
    __syncthreads();                 // the previous component's tile is read
#pragma unroll
    for (int k = 0; k < PER; ++k) tile[threadIdx.x + k * blockDim.x] = next[k];
    __syncthreads();
    if (u + 1 < O) fetch(u + 1);
#pragma unroll
    for (int row = 0; row < nc::ROWS; ++row) {
      for (int m = threadIdx.x; m < n; m += blockDim.x)
        nc::glue<ND>(tile + row * n, tt[row], m, n, levels, base_log,
                     dig_s + ((size_t)u * levels * ND * nc::ROWS + row) *
                                 row_bytes,
                     (size_t)ND * nc::ROWS * row_bytes,
                     (size_t)nc::ROWS * row_bytes);
    }
  }
  __syncthreads();                   // the last tile is read: stages free

  int32_t part[nc::MT][NJ][4];
  const nc::Staged op{ext + (size_t)o * R * NJ * 2 * n, nullptr, 0, 0,
                      (unsigned)n,
                      reinterpret_cast<const unsigned char*>(dig_s)};
  nc::contract_mma<ND, JS, false>(part, smem, op, R, rows, n);

  const size_t base = ((size_t)o * B + b0) * n;
  nc::for_each_output<JS>(part, [&](int lane, int m, uint64_t sum) {
    if (lane < rows) {
      const size_t at = base + (size_t)lane * n + m;
      acc_out[at] = acc_in[at] + sum;
    }
  });
}

template <int ND, int JS>
int launch_merged(const int32_t* t, const int8_t* ext, const int64_t* acc_in,
                  int64_t* acc_out, int B, int n, int O, int levels,
                  int base_log, cudaStream_t stream) {
  const size_t smem = front_bytes(8 - JS, n) +
                      (size_t)O * levels * nc::dig_tile_bytes(ND, n);
  auto kern = cmux_step_merged_kernel<ND, JS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + nc::ROWS - 1) / nc::ROWS, O);
  kern<<<grid, nc::mma_threads(n), smem, stream>>>(
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
