// K3: the vertical-packing external product on Hopper.
//
// Replaces the Pallas kernel
// tfhe_aes2_tpu/ops/pallas/extprod.py::extprod_grouped_fused. In vertical
// packing every lane b (one byte of one block) has its own selector GGSW,
// shared by its G accumulators (G = 24 for the 8->24-bit SBOX+GalMul lookup
// at PARAMS_SQRD_LVL_64):
//
//   out[b, o, g] = Σ_r Σ_{i, j>=js} 2^(8(i+j)) dig_i[b, r, g] · NC(GGSW plane j)[b, r, o]
//
// What bounds it on the H100: int8 operations, as for K1 (nc_common.cuh);
// per lane the GGSW planes are read once per block and the negacirculant is
// built on chip from the 2N-byte ext rows. The design is K1's contraction
// with the ext rows indexed per lane: one block per (G-tile of ROWS
// accumulators, component o, lane b), the u64 recombination fused in, and
// each output written once.
#include "nc_common.cuh"

namespace {

// Grid (ceil(G/ROWS), O, B), block N/2.
// dig  int8  [B][R][ND·G][N]      lane b's digit limb planes, row r
// ext  int8  [B][O][R][8-JS][2N]  lane b's GGSW row limb planes
// out  int64 [B][O][G][N]
template <int ND, int JS>
__global__ void extprod_grouped_fused_kernel(const int8_t* __restrict__ dig,
                                             const int8_t* __restrict__ ext,
                                             uint64_t* __restrict__ out,
                                             int G, int n, int R) {
  constexpr int NJ = 8 - JS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int o = blockIdx.y;
  const int O = gridDim.y;
  const int b = blockIdx.z;
  const int g0 = blockIdx.x * nc::ROWS;
  const int rows = min(nc::ROWS, G - g0);

  int32_t part[nc::ROWS][nc::COLS][NJ];
  const nc::Operands op{dig + ((size_t)b * R * ND * G + g0) * n,
                        (size_t)ND * G * n, (size_t)G * n, (size_t)n,
                        ext + ((size_t)b * O + o) * R * NJ * 2 * n,
                        (size_t)NJ * 2 * n, (size_t)2 * n};
  nc::contract<ND, JS>(part, smem, op, R, rows, n);

#pragma unroll
  for (int row = 0; row < nc::ROWS; ++row) {
    if (row < rows) {
#pragma unroll
      for (int c = 0; c < nc::COLS; ++c) {
        const int m = threadIdx.x + c * blockDim.x;
        out[(((size_t)b * O + o) * G + g0 + row) * n + m] =
            nc::recombine<JS>(part[row][c]);
      }
    }
  }
}

template <int ND, int JS>
int launch(const int8_t* dig, const int8_t* ext, int64_t* out, int B, int G,
           int n, int O, int R, cudaStream_t stream) {
  const size_t smem = nc::contraction_smem(ND, 8 - JS, n);
  auto kern = extprod_grouped_fused_kernel<ND, JS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((G + nc::ROWS - 1) / nc::ROWS, O, B);
  kern<<<grid, n / nc::COLS, smem, stream>>>(
      dig, ext, reinterpret_cast<uint64_t*>(out), G, n, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tfhe_extprod_grouped_fused(const int8_t* dig, const int8_t* ext,
                                          int64_t* out, int B, int G, int n,
                                          int O, int R, int nd, int js,
                                          void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define VP_CALL(ND, JS) launch<ND, JS>(dig, ext, out, B, G, n, O, R, s)
  NC_DISPATCH(nd, js, VP_CALL)
#undef VP_CALL
}
