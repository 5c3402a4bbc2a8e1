// K6: the CMux update without its glue on batch-major layouts, on Hopper.
//
// K6 (tfhe_extprod_step) replaces the Pallas kernel
// tfhe_aes2_tpu/ops/pallas/extprod.py::extprod_step: the dots and the u64
// recombination of one blind-rotate step on the batch-major layouts that
// glue done outside the kernel produces (digits [n_d, B, R, N], accumulator
// [B, O, N]), the result a new tensor. The TPU kernel wanted the whole BSK
// transposed to [8-js, R, O, 2N] for this path; here the kernel reads the
// prepared entry [O, R, 8-js, 2N] through its own strides, so no key is ever
// re-laid out, and every B is taken (the TPU kernel halves B into tiles of
// at most 256). Per component o:
//
//   acc[o] += Σ_r Σ_{i, j>=js} 2^(8(i+j)) dig_i[r] · NC(BSK plane j)[r][o]
//
// It is K5's function (cmux.cu) on other strides. What bounds it on the
// H100: int8 operations; the contraction is still nc::contract of
// nc_common.cuh, __dp4a from shared-memory S-tables, one block per ROWS
// lanes x all N columns of one component.
#include "nc_common.cuh"

namespace {

// K6. Grid (ceil(B/ROWS), O), block N/2.
// dig     int8  [ND][B][R][N]     digit limb planes, batch-major
// ext     int8  [O][R][8-JS][2N]  this step's BSK limb planes
// acc_in  int64 [B][O][N]         read only
// acc_out int64 [B][O][N]         acc_in + the external product
template <int ND, int JS>
__global__ void extprod_step_kernel(const int8_t* __restrict__ dig,
                                    const int8_t* __restrict__ ext,
                                    const uint64_t* __restrict__ acc_in,
                                    uint64_t* __restrict__ acc_out, int B,
                                    int n, int R) {
  constexpr int NJ = 8 - JS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int o = blockIdx.y;
  const int O = gridDim.y;
  const int b0 = blockIdx.x * nc::ROWS;
  const int rows = min(nc::ROWS, B - b0);

  int32_t part[nc::ROWS][nc::COLS][NJ];
  const nc::Operands op{dig + (size_t)b0 * R * n, (size_t)n,
                        (size_t)B * R * n, (size_t)R * n,
                        ext + (size_t)o * R * NJ * 2 * n,
                        (size_t)NJ * 2 * n, (size_t)2 * n};
  nc::contract<ND, JS>(part, smem, op, R, rows, n);

#pragma unroll
  for (int row = 0; row < nc::ROWS; ++row) {
    if (row < rows) {
#pragma unroll
      for (int c = 0; c < nc::COLS; ++c) {
        const int m = threadIdx.x + c * blockDim.x;
        const size_t at = ((size_t)(b0 + row) * O + o) * n + m;
        acc_out[at] = acc_in[at] + nc::recombine<JS>(part[row][c]);
      }
    }
  }
}

template <int ND, int JS>
int launch_step(const int8_t* dig, const int8_t* ext, const int64_t* acc_in,
                int64_t* acc_out, int B, int n, int O, int R,
                cudaStream_t stream) {
  const size_t smem = nc::contraction_smem(ND, 8 - JS, n);
  auto kern = extprod_step_kernel<ND, JS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + nc::ROWS - 1) / nc::ROWS, O);
  kern<<<grid, n / nc::COLS, smem, stream>>>(
      dig, ext, reinterpret_cast<const uint64_t*>(acc_in),
      reinterpret_cast<uint64_t*>(acc_out), B, n, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tfhe_extprod_step(const int8_t* dig, const int8_t* ext,
                                 const int64_t* acc_in, int64_t* acc_out,
                                 int B, int n, int O, int R, int nd, int js,
                                 void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define STEP_CALL(ND, JS) \
  launch_step<ND, JS>(dig, ext, acc_in, acc_out, B, n, O, R, s)
  NC_DISPATCH(nd, js, STEP_CALL)
#undef STEP_CALL
}
