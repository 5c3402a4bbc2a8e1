// K11: the CMux update bucket by bucket, on Hopper.
//
// K11 (tfhe_extprod_step3) replaces the Pallas kernel
// tfhe_aes2_tpu/ops/pallas/extprod.py::extprod_step3. Per component o and
// weight 2^(8s), s in [js, 8):
//
//   bucket_s = Σ_r Σ_{i : js <= s-i} dig_i[r] · NC(BSK plane s-i)[r][o]
//   acc[o]  += Σ_s sign_extend(bucket_s) << 8s                 (mod 2^64)
//
// What defines it: one bucket at a time, each a single chain of products
// over all R rows and every digit limb that reaches it, so a thread holds
// ROWS·COLS = 16 int32 accumulators and nothing else across the chain. The
// TPU kernel walked the buckets as its last, sequential grid axis and
// recombined them at the last one. Here the bucket index is a grid axis,
// grid (ceil(B/ROWS), O, 8-js): each block computes one bucket of ROWS lanes
// of one component and adds sign_extend(bucket) << 8s into the accumulator
// with one 64-bit atomic add per element. Integer addition mod 2^64
// commutes and the atomic wraps exactly, so the result is the same bits
// whatever order the blocks finish in; no block waits for another, and the
// card holds 8-js times the blocks of K5 (1,080 at B = 288), several per SM
// at 16 accumulators a thread.
//
// The S-table of plane s-i is rebuilt per (s, r, i): 11 builds per row r at
// n_d = 2, js = 2 against the 6 of nc::contract, and each digit tile is
// loaded once per bucket that uses it.
//
// What bounds it on the H100: int8 operations, as for K1 (cmux.cu).
#include "nc_common.cuh"

namespace {

// Grid (ceil(B/ROWS), O, 8-js), block N/2.
// dig  int8  [R][ND][B][N]      this step's digit limb planes (K2's output)
// ext  int8  [O][R][8-js][2N]   this step's BSK limb planes
// acc  int64 [O][B][N]          added into with atomics
template <int ND>
__global__ void extprod_step3_kernel(const int8_t* __restrict__ dig,
                                     const int8_t* __restrict__ ext,
                                     unsigned long long* acc, int B, int n,
                                     int R, int js) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int two_n = 2 * n;
  const int mask = two_n - 1;
  const int nw = n >> 2;
  const int nj = 8 - js;
  uint32_t* s_tab = reinterpret_cast<uint32_t*>(smem);          // [ND][2N]
  uint32_t* dig_w = s_tab + ND * two_n;                         // [ND][ROWS][nw]
  const int s = js + blockIdx.z;
  const int o = blockIdx.y;
  const int b0 = blockIdx.x * nc::ROWS;
  const int rows = min(nc::ROWS, B - b0);
  // digit limb i meets key plane j = s - i; the limbs with j >= js
  const int limbs = min(ND, s - js + 1);

  int32_t part[nc::ROWS][nc::COLS];
#pragma unroll
  for (int row = 0; row < nc::ROWS; ++row)
#pragma unroll
    for (int c = 0; c < nc::COLS; ++c) part[row][c] = 0;

#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    __syncthreads();
    nc::load_digit_tile<ND>(dig_w, dig + ((size_t)r * ND * B + b0) * n,
                            (size_t)B * n, (size_t)n, rows, n);
    for (int i = 0; i < limbs; ++i)
      nc::build_s_tables<1>(
          s_tab + i * two_n,
          ext + (((size_t)o * R + r) * nj + (s - i - js)) * two_n, 0, n);
    __syncthreads();
#pragma unroll 1
    for (int w = 0; w < nw; ++w) {
      uint32_t a[ND][nc::ROWS];
#pragma unroll
      for (int i = 0; i < ND; ++i)
#pragma unroll
        for (int row = 0; row < nc::ROWS; ++row)
          a[i][row] = dig_w[(i * nc::ROWS + row) * nw + w];
#pragma unroll
      for (int c = 0; c < nc::COLS; ++c) {
        const int m = threadIdx.x + c * blockDim.x;
        const int x = (4 * w - m) & mask;
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          if (i < limbs) {
            const int b = (int)s_tab[i * two_n + x];
#pragma unroll
            for (int row = 0; row < nc::ROWS; ++row)
              part[row][c] = __dp4a((int)a[i][row], b, part[row][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int row = 0; row < nc::ROWS; ++row) {
    if (row < rows) {
#pragma unroll
      for (int c = 0; c < nc::COLS; ++c) {
        const int m = threadIdx.x + c * blockDim.x;
        atomicAdd(acc + ((size_t)o * B + b0 + row) * n + m,
                  (unsigned long long)((uint64_t)(int64_t)part[row][c]
                                       << (8 * s)));
      }
    }
  }
}

template <int ND>
int launch_bucket(const int8_t* dig, const int8_t* ext, int64_t* acc, int B,
                  int n, int O, int R, int js, cudaStream_t stream) {
  const size_t smem = (size_t)ND * 2 * n * 4 + (size_t)ND * nc::ROWS * n;
  auto kern = extprod_step3_kernel<ND>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + nc::ROWS - 1) / nc::ROWS, O, 8 - js);
  kern<<<grid, n / nc::COLS, smem, stream>>>(
      dig, ext, reinterpret_cast<unsigned long long*>(acc), B, n, R, js);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tfhe_extprod_step3(const int8_t* dig, const int8_t* ext,
                                  int64_t* acc, int B, int n, int O, int R,
                                  int nd, int js, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (js < 0 || js > 7) return (int)cudaErrorInvalidValue;
  switch (nd) {
    case 1: return launch_bucket<1>(dig, ext, acc, B, n, O, R, js, s);
    case 2: return launch_bucket<2>(dig, ext, acc, B, n, O, R, js, s);
    case 3: return launch_bucket<3>(dig, ext, acc, B, n, O, R, js, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
