// K7 and K8: the external products as raw int32 partial sums, on Hopper.
//
// K7 (tfhe_extprod_partials) replaces the Pallas kernel
// tfhe_aes2_tpu/ops/pallas/extprod.py::extprod_partials: the shared-key
// product of the blind-rotate step over all 8 key planes, left as one int32
// sum per weight 2^(8s):
//
//   out[s, b, o] = Σ_r Σ_{i + j = s} dig_i[b, r] · NC(key plane j)[r][o],  s < 8
//
// K8 (tfhe_extprod_partials_grouped) replaces
// extprod.py::extprod_partials_grouped: the same for the vertical packing,
// where lane b has its own GGSW shared by its G accumulators and the planes
// below js are dropped; rows s < js of the output are written as zeros.
//
// The caller recombines Σ_s sext(out[s]) << 8s mod 2^64. Pairs with
// i + j >= 8 vanish mod 2^64 and are never formed, as in the TPU kernels.
//
// What bounds them on the H100: by the count of operations they stand where
// K1 and K3 stand (the same nc::contract of nc_common.cuh), but they write
// 8 int32 words for every u64 that K1/K3 fold on chip: 4x the output bytes
// (K8 at 32 lanes x 24 accumulators: 63 MB a launch). That traffic is the
// reason the fused kernels exist; these keep the buckets visible, which is
// the form a tensor-core tile will produce and be checked against. Both
// read the TPU kernels' operand layouts through nc::Operands strides, so
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

// K8. Grid (ceil(G/ROWS), O, B), block N/2.
// dig  int8  [ND][B][G][R][N]    lane b's digit limb planes
// ext  int8  [8-JS][B][R][O][2N] lane b's GGSW row limb planes
// out  int32 [8][B][G][O][N]     rows s < JS written as zeros
template <int ND, int JS>
__global__ void
extprod_partials_grouped_kernel(const int8_t* __restrict__ dig,
                                const int8_t* __restrict__ ext,
                                int32_t* __restrict__ out, int G, int n,
                                int R) {
  constexpr int NJ = 8 - JS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int o = blockIdx.y;
  const int O = gridDim.y;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int g0 = blockIdx.x * nc::ROWS;
  const int rows = min(nc::ROWS, G - g0);

  int32_t part[nc::ROWS][nc::COLS][NJ];
  const nc::Operands op{dig + ((size_t)b * G + g0) * R * n, (size_t)n,
                        (size_t)B * G * R * n, (size_t)R * n,
                        ext + ((size_t)b * R * O + o) * 2 * n,
                        (size_t)O * 2 * n, (size_t)B * R * O * 2 * n};
  nc::contract<ND, JS>(part, smem, op, R, rows, n);

#pragma unroll
  for (int row = 0; row < nc::ROWS; ++row) {
    if (row < rows) {
#pragma unroll
      for (int c = 0; c < nc::COLS; ++c) {
        const int m = threadIdx.x + c * blockDim.x;
#pragma unroll
        for (int s = 0; s < 8; ++s)
          out[((((size_t)s * B + b) * G + g0 + row) * O + o) * n + m] =
              s < JS ? 0 : part[row][c][s < JS ? 0 : s - JS];
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

template <int ND, int JS>
int launch_grouped(const int8_t* dig, const int8_t* ext, int32_t* out, int B,
                   int G, int n, int O, int R, cudaStream_t stream) {
  const size_t smem = nc::contraction_smem(ND, 8 - JS, n);
  auto kern = extprod_partials_grouped_kernel<ND, JS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((G + nc::ROWS - 1) / nc::ROWS, O, B);
  kern<<<grid, n / nc::COLS, smem, stream>>>(dig, ext, out, G, n, R);
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

extern "C" int tfhe_extprod_partials_grouped(const int8_t* dig,
                                             const int8_t* ext, int32_t* out,
                                             int B, int G, int n, int O, int R,
                                             int nd, int js, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define GROUPED_CALL(ND, JS) \
  launch_grouped<ND, JS>(dig, ext, out, B, G, n, O, R, s)
  NC_DISPATCH(nd, js, GROUPED_CALL)
#undef GROUPED_CALL
}
