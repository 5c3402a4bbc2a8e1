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
// What bounds it on the H100: int8 operations, as for K1 (32 lanes x G=24:
// 32·24·5·5·512²·7 ≈ 3.5e10 multiply-adds, 0.036 ms at the int8 peak). The
// design is K1's tensor-core contraction (nc_mma.cuh) as it is: one block
// per (G-tile of 8 accumulators, component o, lane b); the 8 columns of
// each mma.sync.m16n8k32 are 8 of the lane's G accumulators where in K1
// they are 8 batch lanes, the A fragments are words of the S-tables built
// on chip from the lane's 2N-byte GGSW rows, and the key rows and digit
// tiles of row r+1 arrive by cp.async while row r's mma run. The u64
// recombination is fused into the epilogue and each output written once.
// At js = 4 a thread keeps 64 int32 buckets, so two blocks share an SM.
// A G-tile of fewer than 8 accumulators (G = 1 on the 128-lane stage)
// leaves the instruction's other columns zero.
#include "nc_mma.cuh"

namespace {

// Grid (ceil(G/ROWS), O, B), block N/2 (one warp per 64 columns).
// dig  int8  [B][R][ND·G][N]      lane b's digit limb planes, row r
// ext  int8  [B][O][R][8-JS][2N]  lane b's GGSW row limb planes
// out  int64 [B][O][G][N]
template <int ND, int JS>
__global__ void __launch_bounds__(256, (8 - JS) <= 4 ? 2 : 1)
extprod_grouped_fused_kernel(const int8_t* __restrict__ dig,
                             const int8_t* __restrict__ ext,
                             uint64_t* __restrict__ out, int G, int n,
                             int R) {
  constexpr int NJ = 8 - JS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int o = blockIdx.y;
  const int O = gridDim.y;
  const int b = blockIdx.z;
  const int g0 = blockIdx.x * nc::ROWS;
  const int rows = min(nc::ROWS, G - g0);

  int32_t part[nc::MT][NJ][4];
  // row r's NJ key rows are contiguous; accumulator g0 + row's digit plane
  // i at row r lies at dig + r·ND·G·N + i·G·N + row·N
  const nc::Staged op{ext + ((size_t)b * O + o) * R * NJ * 2 * n,
                      dig + ((size_t)b * R * ND * G + g0) * n,
                      (unsigned)(ND * G * n), (unsigned)(G * n), (unsigned)n,
                      nullptr};
  nc::contract_mma<ND, JS, true>(part, smem, op, R, rows, n);

  uint64_t* out_g = out + (((size_t)b * O + o) * G + g0) * n;
  nc::for_each_output<JS>(part, [&](int row, int m, uint64_t sum) {
    if (row < rows) out_g[(size_t)row * n + m] = sum;
  });
}

template <int ND, int JS>
int launch(const int8_t* dig, const int8_t* ext, int64_t* out, int B, int G,
           int n, int O, int R, cudaStream_t stream) {
  constexpr int NJ = 8 - JS;
  const int smem = 2 * (nc::tab_bytes(NJ, n) + nc::raw_bytes(NJ, n) +
                        nc::dig_tile_bytes(ND, n));
  auto kern = extprod_grouped_fused_kernel<ND, JS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((G + nc::ROWS - 1) / nc::ROWS, O, B);
  kern<<<grid, nc::mma_threads(n), smem, stream>>>(
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
