// K10a and K10b: the CMux step as one long contraction per key plane, on
// Hopper.
//
// K10a (tfhe_rot_diff_digits_flat) replaces the Pallas kernel
// tfhe_aes2_tpu/ops/pallas/extprod.py::rot_diff_digits_flat: K2's glue
// (nc::glue, the digits of X^t·acc - acc split into int8 limbs) written in
// the row-flattened layout [n_d][B][R·N], column (u·L + l)·N + m, so that a
// lane's R digit polynomials lie as one contraction operand of length
// K = R·N. It is bound by bytes, as K2.
//
// K10b (tfhe_extprod_step_longk) replaces extprod.py::extprod_step_longk.
// Per component o:
//
//   acc[o] += Σ_{j>=js} Σ_i 2^(8(i+j)) [ Σ_{r, jj} dig_i[r·N + jj] · NC_j[r][jj, ·] ]
//
// What defines it: key plane j is the OUTER loop and contraction row r the
// inner one, one contraction of length R·N per (o, j, digit limb). While
// plane j runs, only the weights 2^(8(j+i)), i < n_d, receive products, so a
// thread keeps n_d int32 buckets per output (32 registers at n_d = 2 against
// the 96 of nc::contract); when plane j is done, bucket j is complete, is
// folded into the thread's uint64 sum, and the buckets roll down by one. The
// block's whole flat digit tile (n_d·ROWS·R·N bytes: 120 KiB at
// PARAMS_SQRD_LVL_64) is loaded once and stays in shared memory across the
// planes, while the S-table of ONE plane of ONE row (2N words, 4 KiB) is
// rebuilt per (j, r). The TPU schedule transposed the whole prepared BSK to
// [O, 8-js, R, 2N] per call to get plane-major rows; here the kernel reads
// the prepared entry [O, R, 8-js, 2N] through its strides, so no key is
// re-laid out.
//
// What bounds it on the H100: int8 operations, as for K1 (cmux.cu). Against
// nc::contract this loop reads each digit word from shared memory once per
// key plane instead of once, so it issues more shared-memory loads per
// __dp4a; the price of the narrow bucket set.
#include "nc_common.cuh"

namespace {

// K10a. Grid (ceil(B/ROWS), O), block N/2.
// acc     int64 [O][B][N]
// t       int32 [B]
// dig_out int8  [ND][B][R·N]   column (u·L + l)·N + m
template <int ND>
__global__ void
rot_diff_digits_flat_kernel(const uint64_t* __restrict__ acc,
                            const int32_t* __restrict__ t,
                            int8_t* __restrict__ dig_out, int B, int n,
                            int levels, int base_log) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* tile = reinterpret_cast<uint64_t*>(smem);
  const int u = blockIdx.y;
  const int b0 = blockIdx.x * nc::ROWS;
  const int rows = min(nc::ROWS, B - b0);
  const size_t row_len = (size_t)gridDim.y * levels * n;        // R·N
  for (int idx = threadIdx.x; idx < rows * n; idx += blockDim.x)
    tile[idx] = acc[((size_t)u * B + b0) * n + idx];
  __syncthreads();
  for (int row = 0; row < rows; ++row) {
    for (int c = 0; c < nc::COLS; ++c) {
      const int m = threadIdx.x + c * blockDim.x;
      nc::glue<ND>(tile + row * n, t[b0 + row], m, n, levels, base_log,
                   dig_out + (size_t)(b0 + row) * row_len +
                       (size_t)u * levels * n,
                   (size_t)n, (size_t)B * row_len);
    }
  }
}

// K10b. Grid (ceil(B/ROWS), O), block N/2.
// dig  int8  [ND][B][R·N]      K10a's output
// ext  int8  [O][R][8-js][2N]  this step's BSK limb planes (prepared entry)
// acc  int64 [O][B][N]         updated in place
template <int ND>
__global__ void
extprod_step_longk_kernel(const int8_t* __restrict__ dig,
                          const int8_t* __restrict__ ext,
                          uint64_t* __restrict__ acc, int B, int n, int R,
                          int js) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int two_n = 2 * n;
  const int mask = two_n - 1;
  const int nw = n >> 2;
  const int rw = R * nw;                        // words of one flat digit row
  const int nj = 8 - js;
  uint32_t* s_tab = reinterpret_cast<uint32_t*>(smem);          // [2N]
  uint32_t* dig_w = s_tab + two_n;                              // [ND][ROWS][rw]
  const int o = blockIdx.y;
  const int b0 = blockIdx.x * nc::ROWS;
  const int rows = min(nc::ROWS, B - b0);

  // the block's whole flat digit tile, once; lanes past the edge are zero
  for (int idx = threadIdx.x; idx < ND * nc::ROWS * rw; idx += blockDim.x) {
    const int w = idx % rw;
    const int row = (idx / rw) % nc::ROWS;
    const int i = idx / (rw * nc::ROWS);
    uint32_t v = 0;
    if (row < rows) {
      v = *reinterpret_cast<const uint32_t*>(
          dig + ((size_t)i * B + b0 + row) * R * n + 4 * (size_t)w);
    }
    dig_w[idx] = v;
  }

  int32_t live[ND][nc::ROWS][nc::COLS];   // live[i]: the bucket of weight j + i
  uint64_t sum[nc::ROWS][nc::COLS];
#pragma unroll
  for (int row = 0; row < nc::ROWS; ++row)
#pragma unroll
    for (int c = 0; c < nc::COLS; ++c) {
      sum[row][c] = 0;
#pragma unroll
      for (int i = 0; i < ND; ++i) live[i][row][c] = 0;
    }

  const int8_t* ext_o = ext + (size_t)o * R * nj * two_n;
#pragma unroll 1
  for (int j = js; j < 8; ++j) {
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      __syncthreads();     // the digit tile (first pass) or the last products
      nc::build_s_tables<1>(
          s_tab, ext_o + ((size_t)r * nj + (j - js)) * two_n, 0, n);
      __syncthreads();
      const uint32_t* drow = dig_w + r * nw;
#pragma unroll 1
      for (int w = 0; w < nw; ++w) {
        uint32_t a[ND][nc::ROWS];
#pragma unroll
        for (int i = 0; i < ND; ++i)
#pragma unroll
          for (int row = 0; row < nc::ROWS; ++row)
            a[i][row] = drow[(i * nc::ROWS + row) * rw + w];
#pragma unroll
        for (int c = 0; c < nc::COLS; ++c) {
          const int m = threadIdx.x + c * blockDim.x;
          const int b = (int)s_tab[(4 * w - m) & mask];
#pragma unroll
          for (int i = 0; i < ND; ++i) {
            if (i + j < 8) {
#pragma unroll
              for (int row = 0; row < nc::ROWS; ++row)
                live[i][row][c] = __dp4a((int)a[i][row], b, live[i][row][c]);
            }
          }
        }
      }
    }
    // plane j was the last to add to the bucket of weight j: fold it, and
    // roll the others down
#pragma unroll
    for (int row = 0; row < nc::ROWS; ++row)
#pragma unroll
      for (int c = 0; c < nc::COLS; ++c) {
        sum[row][c] += (uint64_t)(int64_t)live[0][row][c] << (8 * j);
#pragma unroll
        for (int i = 0; i + 1 < ND; ++i) live[i][row][c] = live[i + 1][row][c];
        live[ND - 1][row][c] = 0;
      }
  }

#pragma unroll
  for (int row = 0; row < nc::ROWS; ++row) {
    if (row < rows) {
#pragma unroll
      for (int c = 0; c < nc::COLS; ++c) {
        const int m = threadIdx.x + c * blockDim.x;
        acc[((size_t)o * B + b0 + row) * n + m] += sum[row][c];
      }
    }
  }
}

template <int ND>
int launch_glue_flat(const int64_t* acc, const int32_t* t, int8_t* dig_out,
                     int B, int n, int O, int levels, int base_log,
                     cudaStream_t stream) {
  const size_t smem = (size_t)nc::ROWS * n * 8;
  auto kern = rot_diff_digits_flat_kernel<ND>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + nc::ROWS - 1) / nc::ROWS, O);
  kern<<<grid, n / nc::COLS, smem, stream>>>(
      reinterpret_cast<const uint64_t*>(acc), t, dig_out, B, n, levels,
      base_log);
  return (int)cudaGetLastError();
}

template <int ND>
int launch_longk(const int8_t* dig, const int8_t* ext, int64_t* acc, int B,
                 int n, int O, int R, int js, cudaStream_t stream) {
  const size_t smem = (size_t)2 * n * 4 + (size_t)ND * nc::ROWS * R * n;
  auto kern = extprod_step_longk_kernel<ND>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + nc::ROWS - 1) / nc::ROWS, O);
  kern<<<grid, n / nc::COLS, smem, stream>>>(
      dig, ext, reinterpret_cast<uint64_t*>(acc), B, n, R, js);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tfhe_rot_diff_digits_flat(const int64_t* acc, const int32_t* t,
                                         int8_t* dig_out, int B, int n, int O,
                                         int levels, int nd, int base_log,
                                         void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (nd) {
    case 1: return launch_glue_flat<1>(acc, t, dig_out, B, n, O, levels, base_log, s);
    case 2: return launch_glue_flat<2>(acc, t, dig_out, B, n, O, levels, base_log, s);
    case 3: return launch_glue_flat<3>(acc, t, dig_out, B, n, O, levels, base_log, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int tfhe_extprod_step_longk(const int8_t* dig, const int8_t* ext,
                                       int64_t* acc, int B, int n, int O,
                                       int R, int nd, int js, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (js < 0 || js > 7) return (int)cudaErrorInvalidValue;
  switch (nd) {
    case 1: return launch_longk<1>(dig, ext, acc, B, n, O, R, js, s);
    case 2: return launch_longk<2>(dig, ext, acc, B, n, O, R, js, s);
    case 3: return launch_longk<3>(dig, ext, acc, B, n, O, R, js, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
