// K7: the shared-key external product as raw int32 partial sums, on Hopper.
//
// K7 (tfhe_extprod_partials) replaces the Pallas kernel
// tfhe_aes2_tpu/ops/pallas/extprod.py::extprod_partials: the shared-key
// product of the blind-rotate step over all 8 key planes, left as one int32
// sum per weight 2^(8s):
//
//   out[s, b, o] = Σ_r Σ_{i + j = s} dig_i[b, r] · NC(key plane j)[r][o],  s < 8
//
// The caller recombines Σ_s sext(out[s]) << 8s mod 2^64. Pairs with
// i + j >= 8 vanish mod 2^64 and are never formed, as in the TPU kernel.
// (K8, the same for the vertical packing, is K3's tensor-core kernel in
// vp.cu.)
//
// What bounds it on the H100: by the count of operations it stands where
// K1 stands, but it runs nc::contract of nc_common.cuh, __dp4a on the CUDA
// cores, and writes 8 int32 words for every u64 that K1 folds on chip. It
// reads the TPU kernel's operand layouts through nc::Operands strides, so
// nothing is transposed on the way in.
#include "nc_common.cuh"

namespace {

// K7. Grid (ceil(B/ROWS), O), block N/2.
// dig  int8  [ND][B][R][N]   digit limb planes, batch-major
// ext  int8  [8][R][O][2N]   all 8 key limb planes
// out  int32 [8][B][O][N]
template <int ND>
__global__ void extprod_partials_kernel(const int8_t* __restrict__ dig,
                                        const int8_t* __restrict__ ext,
                                        int32_t* __restrict__ out, int B,
                                        int n, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int o = blockIdx.y;
  const int O = gridDim.y;
  const int b0 = blockIdx.x * nc::ROWS;
  const int rows = min(nc::ROWS, B - b0);

  int32_t part[nc::ROWS][nc::COLS][8];
  const nc::Operands op{dig + (size_t)b0 * R * n, (size_t)n,
                        (size_t)B * R * n, (size_t)R * n,
                        ext + (size_t)o * 2 * n, (size_t)O * 2 * n,
                        (size_t)R * O * 2 * n};
  nc::contract<ND, 0>(part, smem, op, R, rows, n);

#pragma unroll
  for (int row = 0; row < nc::ROWS; ++row) {
    if (row < rows) {
#pragma unroll
      for (int c = 0; c < nc::COLS; ++c) {
        const int m = threadIdx.x + c * blockDim.x;
#pragma unroll
        for (int s = 0; s < 8; ++s)
          out[(((size_t)s * B + b0 + row) * O + o) * n + m] = part[row][c][s];
      }
    }
  }
}

template <int ND>
int launch_partials(const int8_t* dig, const int8_t* ext, int32_t* out, int B,
                    int n, int O, int R, cudaStream_t stream) {
  const size_t smem = nc::contraction_smem(ND, 8, n);
  auto kern = extprod_partials_kernel<ND>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + nc::ROWS - 1) / nc::ROWS, O);
  kern<<<grid, n / nc::COLS, smem, stream>>>(dig, ext, out, B, n, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tfhe_extprod_partials(const int8_t* dig, const int8_t* ext,
                                     int32_t* out, int B, int n, int O, int R,
                                     int nd, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (nd) {
    case 1: return launch_partials<1>(dig, ext, out, B, n, O, R, s);
    case 2: return launch_partials<2>(dig, ext, out, B, n, O, R, s);
    case 3: return launch_partials<3>(dig, ext, out, B, n, O, R, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
