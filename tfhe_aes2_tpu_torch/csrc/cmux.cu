// K1, K2 and K5: the blind-rotate CMux step on Hopper.
//
// K1 (tfhe_extprod_step2g) replaces the Pallas kernel
// tfhe_aes2_tpu/ops/pallas/extprod.py::extprod_step2g; K2
// (tfhe_rot_diff_digits) replaces extprod.py::rot_diff_digits; K5
// (tfhe_extprod_step2) replaces extprod.py::extprod_step2. One CMux step
// of the 677-step blind rotation at PARAMS_SQRD_LVL_64 is, per component o:
//
//   acc[o] += Σ_r Σ_{i, j>=js} 2^(8(i+j)) dig_i[r] · NC(BSK plane j)[r][o]
//   next_dig = int8 limb planes of decompose(X^t_next·acc - acc)
//
// and K1 does both in one launch: the block that finishes a row of the new
// accumulator holds the whole polynomial (all N columns of its ROWS batch
// lanes), so the next step's rotation, difference, gadget decomposition and
// limb split (the "glue", K2's body) run from shared memory without another
// pass over device memory. K2 is that glue alone, for step 0, and K5 is K1
// without it: the same kernel built with GLUE = false, whose epilogue only
// adds the recombined sums into the accumulator, so that K2 then K5 (the
// `grid` schedule) is K1 taken apart.
//
// What bounds it on the H100: int8 operations. At B = 256 lanes a step is
// 256·5·15·512²·11 ≈ 5.5e10 multiply-adds against ~15 MB of operands, far
// above the card's operations-per-byte balance. K1's products therefore run
// on the tensor cores: nc::contract_mma (nc_mma.cuh) emits
// mma.sync.m16n8k32 int8 instructions whose A fragments are the words of the
// shared-memory S-tables and whose B fragments are words of the digit tile,
// so the negacirculant is still built on chip from the 2N-byte key row and
// never stored. Key rows and digit tiles arrive by cp.async one contraction
// row ahead. One block an SM: held to the 128 registers that two blocks
// would leave a thread, the kernel spills, gains 5% at 288 lanes and loses
// 12% at 160 and below (PERF.md), because what is left above the int8 bound
// is not latency but the instruction rate of mma.sync itself: alone it reaches
// 2/3 of the card's int8 peak at this N = 8 (probes/mma_rate.cu), and each
// shared load or register move between two of them costs about a fifth of
// one. The glue is about 1 us of a 140 us step.
//
// At N = 1024 a block of K5 owns 8 lanes x 512 columns, as at N = 512:
// 8 warps, 256 threads and the same registers, while a block of all 1024
// columns (512 threads x ~156 registers) could not launch at all. The two
// column halves of one (lane tile, o) are the grid's z (1 below N = 1024,
// so that c0 = 512·z is 0 there: one build serves every N, and the
// run-time offset left K1 and K5 at N = 512 within 1.2% of a build
// without it, probes/mma_regress.py). Each contracts over all N digit
// columns. K1 here takes N <= 512 only, where a block holds the whole new
// row its glue reads: at N = 512 and 1024 the wrapper launches K1 on
// wgmma (cmux_wg.cu), whose cluster shares the row out.
//
// K2 is bound by bytes: at B = 288 it reads 5.9 MB and writes 4.4 MB. It is
// nc::glue_wide (nc_common.cuh): a thread for every 8 columns of a row, so
// its grid grows with O·B·N (92,160 threads at B = 288) and not with
// ceil(B/8)·O blocks; each thread loads its 8 words in 16-byte pieces, reads
// its rotated sources from the block's copy of the row in shared memory, and
// stores each of its L x ND limb planes as one 8-byte word. The gadget
// (levels, base_log) and ND are template values, dispatched by
// NC_GLUE_DISPATCH, which K10a (longk.cu) shares.
#include "nc_mma.cuh"

namespace {

// Shared memory of a block: the two stages of the contraction and, with the
// glue, the [ROWS][N] tile of the new accumulator that takes their place
// afterwards.
inline size_t step_smem(int nd, int nj, int n, bool glue) {
  const size_t stages = 2 * (size_t)(nc::tab_bytes(nj, n) +
                                     nc::raw_bytes(nj, n) +
                                     nc::dig_tile_bytes(nd, n));
  const size_t tile = glue ? (size_t)nc::ROWS * n * 8 : 0;
  return stages > tile ? stages : tile;
}

// Grid (ceil(B/ROWS), O), block N/2 (one warp per 64 columns); K5 at
// N = 1024 grid (ceil(B/ROWS), O, 2), block 256, the block of z = h owning
// columns [512h, 512h + 512).
// dig     int8  [R][ND][B][N]       this step's digit limb planes
// ext     int8  [O][R][8-JS][2N]    this step's BSK limb planes
// acc     int64 [O][B][N]           updated in place
// t_next  int32 [B]                 next step's mod-switched mask element
// dig_out int8  [O][L][ND][B][N]    next step's digits
// Without GLUE (K5) t_next, dig_out, levels and base_log are not read.
template <int ND, int JS, bool GLUE>
__global__ void
__launch_bounds__(256, 1)
extprod_step2g_kernel(const int8_t* __restrict__ dig,
                      const int8_t* __restrict__ ext,
                      uint64_t* __restrict__ acc,
                      const int32_t* __restrict__ t_next,
                      int8_t* __restrict__ dig_out, int B, int n, int R,
                      int levels, int base_log) {
  constexpr int NJ = 8 - JS;
  constexpr int COLS = nc::SPLIT_COLS;    // a split block's columns
  extern __shared__ __align__(16) unsigned char smem[];
  const int o = blockIdx.y;
  const int b0 = blockIdx.x * nc::ROWS;
  const int rows = min(nc::ROWS, B - b0);
  const int c0 = blockIdx.z * COLS;       // 0 below N = 1024

  int32_t part[nc::MT][NJ][4];
  const nc::Staged op{ext + (size_t)o * R * NJ * 2 * n, dig + (size_t)b0 * n,
                      (unsigned)(ND * B * n), (unsigned)(B * n), (unsigned)n,
                      nullptr};
  nc::contract_mma<ND, JS, true>(part, smem, op, R, rows, n, c0);

  uint64_t* acc_o = acc + ((size_t)o * B + b0) * n;
  if constexpr (!GLUE) {
    nc::for_each_output<JS>(part, [&](int lane, int m, uint64_t sum) {
      if (lane < rows) acc_o[(size_t)lane * n + m] += sum;
    }, c0);
    return;
  }
  // the stages are idle past the contraction's last barrier: shared memory
  // now holds the tile of the new accumulator, zero rows past the batch
  // edge (with the glue N <= 512, so c0 is 0)
  uint64_t* tile = reinterpret_cast<uint64_t*>(smem);   // [ROWS][N]
  nc::for_each_output<JS>(part, [&](int lane, int m, uint64_t sum) {
    uint64_t v = 0;
    if (lane < rows) {
      v = acc_o[(size_t)lane * n + m] + sum;
      acc_o[(size_t)lane * n + m] = v;
    }
    tile[lane * n + m] = v;
  });
  __syncthreads();
  for (int row = 0; row < rows; ++row) {
    const int t = t_next[b0 + row];
    for (int m = threadIdx.x; m < n; m += blockDim.x)
      nc::glue<ND>(tile + row * n, t, m, n, levels, base_log,
                   dig_out + (((size_t)o * levels * ND) * B + b0 + row) * n,
                   (size_t)ND * B * n, (size_t)B * n);
  }
}

// K2. Grid ceil(O·B·N / (8·GLUE_THREADS)), block GLUE_THREADS: the glue
// alone, nc::glue_wide over the [O][B] rows of the accumulator.
// acc     int64 [O][B][N]
// t       int32 [B]
// dig_out int8  [O][L][ND][B][N]
template <int ND, int L, int BL>
__global__ void __launch_bounds__(nc::GLUE_THREADS)
rot_diff_digits_kernel(const uint64_t* __restrict__ acc,
                       const int32_t* __restrict__ t,
                       int8_t* __restrict__ dig_out, int B, int n, int O) {
  __shared__ __align__(16) uint64_t tile[nc::GLUE_TILE_WORDS];
  const size_t plane = (size_t)B * n;
  nc::glue_wide<ND, L, BL>(tile, acc, t, B, n, O * B, dig_out,
                           nc::GlueOut{L * ND * plane, (size_t)n, ND * plane,
                                       plane});
}

// An empty kernel: chip_smoke.py times it behind the same device spin as
// the kernels, as the floor one launch costs on the device.
__global__ void empty_kernel() {}

template <int ND, int JS, bool GLUE>
int launch_step(const int8_t* dig, const int8_t* ext, int64_t* acc,
                const int32_t* t_next, int8_t* dig_out, int B, int n, int O,
                int R, int levels, int base_log, cudaStream_t stream) {
  const size_t smem = step_smem(ND, 8 - JS, n, GLUE);
  auto kern = extprod_step2g_kernel<ND, JS, GLUE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + nc::ROWS - 1) / nc::ROWS, O, nc::column_blocks(n));
  kern<<<grid, nc::mma_threads(n), smem, stream>>>(
      dig, ext, reinterpret_cast<uint64_t*>(acc), t_next, dig_out, B, n, R,
      levels, base_log);
  return (int)cudaGetLastError();
}

template <int ND, int L, int BL>
int launch_glue(const int64_t* acc, const int32_t* t, int8_t* dig_out, int B,
                int n, int O, cudaStream_t stream) {
  const int threads = O * B * (n / nc::GLUE_COLS);
  rot_diff_digits_kernel<ND, L, BL>
      <<<(threads + nc::GLUE_THREADS - 1) / nc::GLUE_THREADS,
         nc::GLUE_THREADS, 0, stream>>>(reinterpret_cast<const uint64_t*>(acc),
                                        t, dig_out, B, n, O);
  return (int)cudaGetLastError();
}

}  // namespace

// K1 on mma.sync is built for N <= 512 (its glue reads the whole row from
// one block's tile); extprod.k1_path sends N = 512 and 1024 to cmux_wg.cu.
extern "C" int tfhe_extprod_step2g(const int8_t* dig, const int8_t* ext,
                                   int64_t* acc, const int32_t* t_next,
                                   int8_t* dig_out, int B, int n, int O, int R,
                                   int levels, int nd, int js, int base_log,
                                   void* stream) {
  if (n > nc::SPLIT_COLS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define STEP_CALL(ND, JS)                                                   \
  launch_step<ND, JS, true>(dig, ext, acc, t_next, dig_out, B, n, O, R,    \
                            levels, base_log, s)
  NC_DISPATCH(nd, js, STEP_CALL)
#undef STEP_CALL
}

extern "C" int tfhe_extprod_step2(const int8_t* dig, const int8_t* ext,
                                  int64_t* acc, int B, int n, int O, int R,
                                  int nd, int js, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define STEP2_CALL(ND, JS)                                                  \
  launch_step<ND, JS, false>(dig, ext, acc, nullptr, nullptr, B, n, O, R,  \
                             0, 0, s)
  NC_DISPATCH(nd, js, STEP2_CALL)
#undef STEP2_CALL
}

// K2 is built for the gadgets of NC_GLUE_GADGETS (nc_common.cuh) only; the
// wrapper (extprod.GLUE_GADGETS) refuses any other before it gets here.
extern "C" int tfhe_rot_diff_digits(const int64_t* acc, const int32_t* t,
                                    int8_t* dig_out, int B, int n, int O,
                                    int levels, int nd, int base_log,
                                    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define GLUE_CALL(ND, L, BL)                                                \
  launch_glue<ND, L, BL>(acc, t, dig_out, B, n, O, s)
  NC_GLUE_DISPATCH(nd, levels, base_log, GLUE_CALL)
#undef GLUE_CALL
}

extern "C" int tfhe_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
