// K10a and K10b: the CMux step on a lane's digits laid flat as one long
// contraction, on Hopper.
//
// K10a (tfhe_rot_diff_digits_flat) replaces the Pallas kernel
// tfhe_aes2_tpu/ops/pallas/extprod.py::rot_diff_digits_flat: K2's glue (the
// digits of X^t·acc - acc split into int8 limbs) written in the
// row-flattened layout [n_d][B][R·N], column (u·L + l)·N + m, so that a
// lane's R digit polynomials lie as one contraction operand of length
// K = R·N. It is bound by bytes, as K2, and is K2's kernel: nc::glue_wide
// of nc_common.cuh (a thread for every 8 columns of an accumulator row, its
// grid growing with O·B·N), built for the same gadgets through the same
// dispatch (NC_GLUE_DISPATCH), with K10a's output strides in its GlueOut.
//
// K10b (tfhe_extprod_step_longk) replaces extprod.py::extprod_step_longk.
// Per component o:
//
//   acc[o] += Σ_{j>=js} Σ_i 2^(8(i+j)) [ Σ_{r, jj} dig_i[r·N + jj] · NC_j[r][jj, ·] ]
//
// The TPU kernel ran key plane j as the outer loop, one long-K dot per
// (o, plane, limb), so that each VMEM bucket was written at most twice. On
// this card the int32 buckets live in registers and that concern is gone;
// what the long K still gives is a contraction that splits across blocks.
// So K10b is K5's tensor-core contraction (nc::contract_mma of nc_mma.cuh:
// mma.sync.m16n8k32 int8 fed from the S-tables, key rows and digit tiles
// staged by cp.async a row ahead), reading the flat digits as they lie —
// lanes R·N bytes apart, rows N — and the prepared key entry
// [O, R, 8-js, 2N] through its strides, with the R rows split across
// gridDim.z blocks. ceil(B/ROWS)·O blocks alone leave SMs idle (B = 9: 10
// on 132 SMs) or end in a ragged wave, so the wrapper (extprod._longk_splits)
// gives each (lane tile, component) the number of blocks that minimises
// waves x rows a block (B = 9: 8 blocks of 1-2 rows; B = 128: 3 of 5 rows,
// two waves instead of one of 15 rows), each owning a contiguous range of
// rows and adding its recombined partial into acc with a 64-bit atomicAdd:
// addition mod 2^64 is exact in any order and recombination is linear, so
// the result is the same bits. One split adds without atomics. At
// N = 1024 the two column halves of each (tile, component, split) are two
// blocks, as K5's (cmux.cu): gridDim.z is splits x halves, the half the
// low digit of blockIdx.z, and each block adds into its own 512 columns
// from c0, so the halves never meet in an atomic. What bounds
// it: int8 operations, as K1 (cmux.cu), at large B; at B = 9 a block's
// serial latency of its one or two rows.
#include "nc_mma.cuh"

namespace {

// K10a. Grid ceil(O·B·N / (8·GLUE_THREADS)), block GLUE_THREADS: limb i of
// level l of row (u, b) at i·B·R·N + b·R·N + (u·L + l)·N + m.
// acc     int64 [O][B][N]
// t       int32 [B]
// dig_out int8  [ND][B][R·N]   column (u·L + l)·N + m
template <int ND, int L, int BL>
__global__ void __launch_bounds__(nc::GLUE_THREADS)
rot_diff_digits_flat_kernel(const uint64_t* __restrict__ acc,
                            const int32_t* __restrict__ t,
                            int8_t* __restrict__ dig_out, int B, int n,
                            int O) {
  __shared__ __align__(16) uint64_t tile[nc::GLUE_TILE_WORDS];
  const size_t rn = (size_t)O * L * n;
  nc::glue_wide<ND, L, BL>(tile, acc, t, B, n, O * B, dig_out,
                           nc::GlueOut{(size_t)L * n, rn, (size_t)n,
                                       (size_t)B * rn});
}

// K10b. Grid (ceil(B/ROWS), O, splits·halves), block min(N, 512)/2 (one
// warp per 64 columns); halves = nc::column_blocks(N). Block
// z = split·halves + h takes contraction rows [split·R/splits,
// (split+1)·R/splits) and columns [512h, 512h + 512).
// dig  int8  [ND][B][R·N]      K10a's output
// ext  int8  [O][R][8-JS][2N]  this step's BSK limb planes (prepared entry)
// acc  int64 [O][B][N]         updated in place
template <int ND, int JS>
__global__ void __launch_bounds__(256)
extprod_step_longk_kernel(const int8_t* __restrict__ dig,
                          const int8_t* __restrict__ ext,
                          uint64_t* __restrict__ acc, int B, int n, int R) {
  constexpr int NJ = 8 - JS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int o = blockIdx.y;
  const int b0 = blockIdx.x * nc::ROWS;
  const int rows = min(nc::ROWS, B - b0);
  const int halves = nc::column_blocks(n);
  const int splits = gridDim.z / halves;
  const int split = blockIdx.z / halves;
  const int c0 = (blockIdx.z - split * halves) * nc::SPLIT_COLS;
  const int r0 = split * R / splits;
  const int r1 = (split + 1) * R / splits;
  const unsigned rn = (unsigned)R * n;

  int32_t part[nc::MT][NJ][4];
  const nc::Staged op{ext + ((size_t)o * R + r0) * NJ * 2 * n,
                      dig + ((size_t)b0 * R + r0) * n, (unsigned)n,
                      (unsigned)B * rn, rn, nullptr};
  nc::contract_mma<ND, JS, true>(part, smem, op, r1 - r0, rows, n, c0);

  uint64_t* acc_o = acc + ((size_t)o * B + b0) * n;
  nc::for_each_output<JS>(part, [&](int lane, int m, uint64_t sum) {
    if (lane < rows) {
      uint64_t* at = acc_o + (size_t)lane * n + m;
      if (splits == 1)
        *at += sum;
      else
        atomicAdd(reinterpret_cast<unsigned long long*>(at),
                  (unsigned long long)sum);
    }
  }, c0);
}

template <int ND, int L, int BL>
int launch_glue_flat(const int64_t* acc, const int32_t* t, int8_t* dig_out,
                     int B, int n, int O, cudaStream_t stream) {
  const int threads = O * B * (n / nc::GLUE_COLS);
  rot_diff_digits_flat_kernel<ND, L, BL>
      <<<(threads + nc::GLUE_THREADS - 1) / nc::GLUE_THREADS,
         nc::GLUE_THREADS, 0, stream>>>(reinterpret_cast<const uint64_t*>(acc),
                                        t, dig_out, B, n, O);
  return (int)cudaGetLastError();
}

template <int ND, int JS>
int launch_longk(const int8_t* dig, const int8_t* ext, int64_t* acc, int B,
                 int n, int O, int R, int splits, cudaStream_t stream) {
  constexpr int NJ = 8 - JS;
  const int smem = 2 * (nc::tab_bytes(NJ, n) + nc::raw_bytes(NJ, n) +
                        nc::dig_tile_bytes(ND, n));
  auto kern = extprod_step_longk_kernel<ND, JS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int halves = nc::column_blocks(n);
  dim3 grid((B + nc::ROWS - 1) / nc::ROWS, O, splits * halves);
  kern<<<grid, nc::mma_threads(n), smem, stream>>>(
      dig, ext, reinterpret_cast<uint64_t*>(acc), B, n, R);
  return (int)cudaGetLastError();
}

}  // namespace

// K10a is built for the gadgets of NC_GLUE_GADGETS only, as K2; the
// wrapper (extprod.GLUE_GADGETS) refuses any other before it gets here.
extern "C" int tfhe_rot_diff_digits_flat(const int64_t* acc, const int32_t* t,
                                         int8_t* dig_out, int B, int n, int O,
                                         int levels, int nd, int base_log,
                                         void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define GLUE_FLAT_CALL(ND, L, BL)                                           \
  launch_glue_flat<ND, L, BL>(acc, t, dig_out, B, n, O, s)
  NC_GLUE_DISPATCH(nd, levels, base_log, GLUE_FLAT_CALL)
#undef GLUE_FLAT_CALL
}

extern "C" int tfhe_extprod_step_longk(const int8_t* dig, const int8_t* ext,
                                       int64_t* acc, int B, int n, int O,
                                       int R, int nd, int js, int splits,
                                       void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > R) return (int)cudaErrorInvalidValue;
#define LONGK_CALL(ND, JS)                                                  \
  launch_longk<ND, JS>(dig, ext, acc, B, n, O, R, splits, s)
  NC_DISPATCH(nd, js, LONGK_CALL)
#undef LONGK_CALL
}
