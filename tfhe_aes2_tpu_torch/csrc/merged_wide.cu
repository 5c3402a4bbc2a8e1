// K9 at N = 1024: the whole blind-rotate CMux step in one launch, on Hopper.
//
// The N = 1024 build of K9 (tfhe_cmux_step_merged_wide), which replaces the
// Pallas kernel tfhe_aes2_tpu/ops/pallas/extprod.py::cmux_step_merged as
// merged.cu's does below N = 1024 (what it computes, and why the result is
// a second buffer: merged.cu). A source of its own so that nvcc builds it
// beside merged.cu, not after it.
//
// merged.cu's layout does not fit at N = 1024: all R resident tiles take
// R·16,640 bytes at ND = 2 (199,680 at lvl256's R = 12, over the 232,448 a
// block may have with the stages beside them), and a block of all 1024
// columns cannot launch (cmux.cu). So the 2·O blocks of a lane tile — O
// components x two column halves of 512, 256 threads each as in K1 — are one
// cluster (cudaLaunchKernelEx, cluster dimension {1, O, 2}), and the glue is
// shared out: block (o, h) glues only component o's L rows at its own
// columns [512h, 512h + 512), reading the rotated sources straight from the
// old accumulator in device memory, into L·ND·ROWS·512 bytes of its shared
// memory (32 KiB at lvl256). After a cluster barrier each block contracts
// over all R rows and all N digit columns as K1 does (nc::contract_mma with
// staged digit tiles), except that row r = u·L + l's tile is copied into
// the stage not from device memory but from the shared memory of blocks
// (u, 0) and (u, 1) (distributed shared memory, cooperative_groups'
// map_shared_rank: 16-byte loads, all in flight before the stores, one row
// ahead of the products). A second cluster barrier keeps each block's
// digits alive until every partner has copied them. A block takes the two
// stages of K1 plus its own digits, 188,928 bytes at lvl256 (229,888 at
// js = 0), and each digit is glued once a lane tile instead of O times.
// The cluster of 2·O blocks (6 at k = 2) must fit in one GPC at one block
// an SM; above 8 it needs the non-portable cluster size (up to 16, O <= 8).
//
// What bounds it on the H100: int8 operations, as for K1: the products are
// nc::contract_mma's mma.sync.m16n8k32 int8 (nc_mma.cuh).
#include <cooperative_groups.h>

#include "nc_mma.cuh"

namespace {

constexpr int WIDE_N = 2 * nc::SPLIT_COLS;     // the polynomial size
constexpr int HALF = nc::SPLIT_COLS;           // a block's output columns
constexpr int WIDE_THREADS = HALF / 2;         // one warp per 64 of them

// Bytes of the two stages (S-tables, raw key rows, digit tiles: K1's), then
// of a block's own digits [L][ND][ROWS][512] after them.
__host__ __device__ inline size_t wide_stage_bytes(int nd, int nj) {
  return 2 * (size_t)(nc::tab_bytes(nj, WIDE_N) + nc::raw_bytes(nj, WIDE_N) +
                      nc::dig_tile_bytes(nd, WIDE_N));
}
__host__ __device__ inline size_t own_bytes(int nd, int levels) {
  return (size_t)levels * nd * nc::ROWS * HALF;
}

// Grid (ceil(B/ROWS), O, 2), block 256, clusters {1, O, 2}: block (o, h)
// owns lanes b0..b0+7 of component o at columns [512h, 512h + 512) and is
// cluster rank o + O·h. Operands as merged.cu's kernel's, N = 1024.
template <int ND, int JS>
__global__ void __launch_bounds__(WIDE_THREADS)
cmux_step_merged_wide_kernel(const int32_t* __restrict__ t,
                             const int8_t* __restrict__ ext,
                             const uint64_t* __restrict__ acc_in,
                             uint64_t* __restrict__ acc_out, int B, int O,
                             int levels, int base_log) {
  namespace cg = cooperative_groups;
  constexpr int NJ = 8 - JS;
  constexpr int n = WIDE_N;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int o = blockIdx.y;
  const int c0 = blockIdx.z * HALF;
  const int b0 = blockIdx.x * nc::ROWS;
  const int rows = min(nc::ROWS, B - b0);
  const int R = O * levels;
  int8_t* own = reinterpret_cast<int8_t*>(smem + wide_stage_bytes(ND, NJ));

  // the glue of component o at this block's columns, all L levels; lanes
  // past the batch edge get all-zero digits
  const size_t level_stride = (size_t)ND * nc::ROWS * HALF;
  const size_t limb_stride = (size_t)nc::ROWS * HALF;
  for (int row = 0; row < nc::ROWS; ++row) {
    int8_t* out = own + row * HALF - c0;       // column m at out[m]
    if (row < rows) {
      const uint64_t* src = acc_in + ((size_t)o * B + b0 + row) * n;
      const int tr = t[b0 + row];
      for (int m = c0 + threadIdx.x; m < c0 + HALF; m += WIDE_THREADS)
        nc::glue<ND>(src, tr, m, n, levels, base_log, out, level_stride,
                     limb_stride);
    } else {
      for (int m = c0 + threadIdx.x; m < c0 + HALF; m += WIDE_THREADS)
        for (int k = 0; k < levels * ND; ++k) out[k * limb_stride + m] = 0;
    }
  }
  cluster.sync();                  // every block's digits are written

  // Row r = u·L + l: digit plane i of lane `row` at column m lies in block
  // (u, m / 512), cluster rank u + O·(m / 512), at byte
  // ((l·ND + i)·ROWS + row)·512 + m mod 512 of its own digits. A thread
  // moves 2·ND 16-byte pieces of the [ND][ROWS][N + DIG_PAD] tile.
  auto copy_dig = [&](unsigned char* tile, int r) {
    constexpr int CHUNKS = n / 16;             // 16-byte pieces a digit row
    constexpr int PER = ND * nc::ROWS * CHUNKS / WIDE_THREADS;
    const int u = r / levels;
    const int l = r - u * levels;
    uint4 v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = threadIdx.x + k * WIDE_THREADS;
      const int chunk = idx % CHUNKS;
      const int row = (idx / CHUNKS) % nc::ROWS;
      const int i = idx / (CHUNKS * nc::ROWS);
      const int h = chunk / (CHUNKS / 2);
      const int8_t* src = cluster.map_shared_rank(own, u + O * h);
      v[k] = *reinterpret_cast<const uint4*>(
          src + ((l * ND + i) * nc::ROWS + row) * HALF +
          16 * (chunk - h * (CHUNKS / 2)));
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = threadIdx.x + k * WIDE_THREADS;
      const int chunk = idx % CHUNKS;
      const int row = (idx / CHUNKS) % nc::ROWS;
      const int i = idx / (CHUNKS * nc::ROWS);
      *reinterpret_cast<uint4*>(tile + (i * nc::ROWS + row) *
                                           (n + nc::DIG_PAD) +
                                16 * chunk) = v[k];
    }
  };

  int32_t part[nc::MT][NJ][4];
  const nc::Staged op{ext + (size_t)o * R * NJ * 2 * n, nullptr, 0, 0, 0,
                      nullptr};
  nc::contract_mma<ND, JS, true, false>(part, smem, op, R, rows, n, c0,
                                        copy_dig);

  const size_t base = ((size_t)o * B + b0) * n;
  nc::for_each_output<JS>(part, [&](int lane, int m, uint64_t sum) {
    if (lane < rows) {
      const size_t at = base + (size_t)lane * n + m;
      acc_out[at] = acc_in[at] + sum;
    }
  }, c0);
  cluster.sync();          // the partners may still be copying our digits
}

// The launch of a B-lane step, its kernel's attributes set: grid
// (ceil(B/8), O, 2), clusters {1, O, 2} (above 8 blocks the non-portable
// size). `attr` holds the cluster dimension cfg points to.
template <int ND, int JS>
cudaError_t wide_config(int B, int O, int levels, cudaStream_t stream,
                        cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  const size_t smem = wide_stage_bytes(ND, 8 - JS) + own_bytes(ND, levels);
  auto kern = cmux_step_merged_wide_kernel<ND, JS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && 2 * O > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = O;
  attr.val.clusterDim.z = 2;
  cfg = {};
  cfg.gridDim = dim3((B + nc::ROWS - 1) / nc::ROWS, O, 2);
  cfg.blockDim = dim3(WIDE_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return err;
}

template <int ND, int JS>
int launch_merged_wide(const int32_t* t, const int8_t* ext,
                       const int64_t* acc_in, int64_t* acc_out, int B, int O,
                       int levels, int base_log, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = wide_config<ND, JS>(B, O, levels, stream, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, cmux_step_merged_wide_kernel<ND, JS>, t,
                           ext, reinterpret_cast<const uint64_t*>(acc_in),
                           reinterpret_cast<uint64_t*>(acc_out), B, O, levels,
                           base_log);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many of the launch's clusters the card holds at once.
template <int ND, int JS>
int wide_clusters(int O, int levels, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = wide_config<ND, JS>(1, O, levels, nullptr, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, cmux_step_merged_wide_kernel<ND, JS>, &cfg);
}

}  // namespace

extern "C" int tfhe_cmux_step_merged_wide(const int32_t* t, const int8_t* ext,
                                          const int64_t* acc_in,
                                          int64_t* acc_out, int B, int O,
                                          int levels, int nd, int js,
                                          int base_log, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define MERGED_WIDE_CALL(ND, JS)                                          \
  launch_merged_wide<ND, JS>(t, ext, acc_in, acc_out, B, O, levels,       \
                             base_log, s)
  NC_DISPATCH(nd, js, MERGED_WIDE_CALL)
#undef MERGED_WIDE_CALL
}

// The clusters of K9 at N = 1024 that the card holds at once
// (cudaOccupancyMaxActiveClusters), for O components of L levels: a
// launch of more than that runs in waves. chip_smoke.py reads it.
extern "C" int tfhe_cmux_step_merged_wide_clusters(int O, int levels, int nd,
                                                   int js, int* clusters) {
#define CLUSTERS_CALL(ND, JS) wide_clusters<ND, JS>(O, levels, clusters)
  NC_DISPATCH(nd, js, CLUSTERS_CALL)
#undef CLUSTERS_CALL
}
