// K1 on wgmma at N = 512 and 1024: the blind-rotate CMux step of
// tfhe_aes2_tpu/ops/pallas/extprod.py::extprod_step2g, as cmux.cu's K1
// computes it (the same kept limb-plane dots, int32 buckets, wrapping
// uint64 recombination and fused glue of the next step, bit for bit), with
// its contraction on wgmma.mma_async.m64n32k32 over 32-lane tiles
// (nc_wgmma.cuh) in place of mma.sync.m16n8k32 over 8-lane blocks.
//
// What bounds it on the H100: int8 operations (a step at B = 2,048 lanes is
// 2,048 x 4.325e8 operations at lvl64, 0.448 ms at the 1,979 TOPS peak,
// and 2,048 x 8.305e8 at lvl256, 0.859 ms), and beside them shared-memory
// bandwidth: each wgmma reads its 1 KB digit tile from shared memory,
// about half of the 128 bytes a clock an SM has at the tensor cores' rate.
// mma.sync at N = 8 stopped at a third of the bound (PERF.md).
//
// A block owns 32 batch lanes x COLS = 128 output columns of one component
// o: two warpgroups of one 64-column tile each, 8-JS buckets of 16 int32
// registers a thread (32 lanes x all 512 columns x 6 buckets would need
// more registers than an SM has). It contracts over all N digit columns,
// unit by unit (a unit: one contraction row's KC = 512 digit columns, so
// one a row at N = 512 and two at N = 1024), as nc::contract_mma does row
// by row: the raw key bytes and the digit tile of the next unit arrive by
// cp.async into a second stage, and the next unit's table windows are
// built from the raw bytes, in small steps between this unit's first
// instruction groups. Grid (ceil(B/32), O, N/COLS). N is a template value:
// the stage and the unit's body are the same at both sizes, and N sets the
// cluster, the units a row and the raw bytes a unit stages.
//
// The glue. The next step's rotation reads column (m - t) mod N of the
// whole new row, so the N/COLS blocks of one (lane tile, o) launch as one
// cluster (cudaLaunchKernelEx, cluster {1, 1, N/COLS}: 4 blocks at N = 512,
// 8 at N = 1024; rank = blockIdx.z).
// Each block adds its recombined sums into the accumulator through a
// [32][COLS] int64 tile in its shared memory (coalesced read-modify-write
// of device memory), the cluster synchronises, and each block glues its own
// columns, reading the rotated source x from the tile of rank x / COLS
// through distributed shared memory (cmux.cu's rank ^ 1 at N = 1024, for
// any cluster size); a second cluster barrier keeps each tile alive until
// the cluster has read it. Lanes past the batch edge read zero digits and
// store nothing.
#include <cooperative_groups.h>

#include "nc_wgmma.cuh"

namespace {

namespace wg = nc::wg;

// dig     int8  [R][ND][B][N]         this step's digit limb planes
// ext     int8  [O][R][8-JS][2N]      this step's BSK limb planes
// acc     int64 [O][B][N]             updated in place
// t_next  int32 [B]                   next step's mod-switched mask element
// dig_out int8  [O][L][ND][B][N]      next step's digits
template <int N, int ND, int JS>
__global__ void __launch_bounds__(wg::THREADS, 1)
extprod_step2g_wg_kernel(const int8_t* __restrict__ dig,
                         const int8_t* __restrict__ ext,
                         uint64_t* __restrict__ acc,
                         const int32_t* __restrict__ t_next,
                         int8_t* __restrict__ dig_out, int B, int R,
                         int levels, int base_log) {
  constexpr int NJ = 8 - JS;
  constexpr int KC = wg::KC, COLS = wg::COLS, THREADS = wg::THREADS;
  constexpr int UNITS = wg::units<N>();
  constexpr int TAB_B = NJ * wg::TAB_WORDS * 4, RAW_B = NJ * 2 * KC,
                DIG_B = ND * wg::DIG_PLANE, ROW_B = NJ * 2 * N;
  extern __shared__ __align__(128) unsigned char smem[];
  const int o = blockIdx.y;
  const int b0 = blockIdx.x * wg::LANES;
  const int rows = min(wg::LANES, B - b0);
  const int c0 = blockIdx.z * COLS;     // blockIdx.z is the cluster rank
  const int U = R * UNITS;              // unit v: row v / UNITS, k-chunk
                                        // v % UNITS
  unsigned char* tab = smem;                // [2][TAB_B]
  unsigned char* raw = smem + 2 * TAB_B;    // [2][RAW_B]
  unsigned char* dig_s = raw + 2 * RAW_B;   // [2][DIG_B]
  const int8_t* ext_o = ext + (size_t)o * R * ROW_B;
  const int8_t* dig_b = dig + (size_t)b0 * N;
  const unsigned dig_r = (unsigned)(ND * B * N);
  const unsigned dig_plane = (unsigned)(B * N);
  // unit v's digit rows at its k0, and piece p of its raw key bytes
  auto unit_dig = [&](int v) {
    return dig_b + (size_t)(v / UNITS) * dig_r + (v % UNITS) * KC;
  };
  auto copy_raw = [&](unsigned char* dst, int v, int p) {
    wg::copy_raw_piece<N, NJ>(dst, ext_o + (size_t)(v / UNITS) * ROW_B, c0,
                              (v % UNITS) * KC, p);
  };

  int32_t part[NJ][wg::ACC];
#pragma unroll
  for (int s = 0; s < NJ; ++s)
#pragma unroll
    for (int c = 0; c < wg::ACC; ++c) part[s][c] = 0;

  // unit 0's stage (and unit 1's raw bytes); then each unit stages the
  // next in the shadow of its own first instruction groups (mma_unit's
  // prep)
  if constexpr (UNITS == 1) {
    nc::copy_async(raw, ext_o, (R > 1 ? 2 : 1) * RAW_B);
  } else {
    for (int p = threadIdx.x; p < 2 * RAW_B / 16; p += THREADS)
      copy_raw(raw + (p / (RAW_B / 16)) * RAW_B, p / (RAW_B / 16),
               p % (RAW_B / 16));
  }
  for (int t = 0; t < wg::prep_steps<ND, NJ>(); ++t)
    wg::copy_digit_piece<ND>(dig_s, dig_b, dig_plane, N, rows,
                             threadIdx.x + t * THREADS);
  nc::cp_async_commit();
  nc::cp_async_wait_all();
  __syncthreads();
  for (int t = 0; t < wg::prep_steps<ND, NJ>(); ++t)
    wg::build_window_group<N, NJ>(reinterpret_cast<uint32_t*>(tab), raw, c0,
                                  threadIdx.x + t * THREADS);
  wg::fence_proxy_async();
  __syncthreads();
  for (int u = 0; u < U; ++u) {
    const int s = u & 1;
    // stage s holds unit u's tables and digits, raw stage s^1 unit u+1's
    // key bytes; everything else was last read before the barrier just
    // passed. Step t of the staging: digit piece and table group t of
    // unit u+1, 16 raw bytes of unit u+2
    auto prep = [&](int t) {
      const int p = threadIdx.x + t * THREADS;
      if (u + 1 < U) {
        wg::copy_digit_piece<ND>(dig_s + (s ^ 1) * DIG_B, unit_dig(u + 1),
                                 dig_plane, N, rows, p);
        wg::build_window_group<N, NJ>(
            reinterpret_cast<uint32_t*>(tab + (s ^ 1) * TAB_B),
            raw + (s ^ 1) * RAW_B, c0, p);
      }
      if (u + 2 < U && p < RAW_B / 16) copy_raw(raw + s * RAW_B, u + 2, p);
    };
    wg::mma_unit<ND, JS>(part,
                         reinterpret_cast<const uint32_t*>(tab + s * TAB_B),
                         wg::digit_desc(dig_s + s * DIG_B), prep);
    nc::cp_async_commit();
    // the next unit's digits land in the stage these instructions read
    wg::wait<0>();
    nc::cp_async_wait_all();
    wg::fence_proxy_async();
    __syncthreads();
  }

  // the stages are idle past the last barrier: shared memory now holds the
  // [LANES][COLS] tile of the block's new accumulator, zero past the batch
  // edge
  uint64_t* tile = reinterpret_cast<uint64_t*>(smem);
  wg::for_each_output<JS>(part, [&](int lane, int m, uint64_t sum) {
    tile[lane * COLS + m] = sum;
  });
  __syncthreads();
  uint64_t* acc_o = acc + ((size_t)o * B + b0) * N + c0;
  for (int idx = threadIdx.x; idx < wg::LANES * COLS; idx += THREADS) {
    const int lane = idx / COLS, m = idx % COLS;
    uint64_t v = 0;
    if (lane < rows) {
      v = acc_o[(size_t)lane * N + m] + tile[idx];
      acc_o[(size_t)lane * N + m] = v;
    }
    tile[idx] = v;
  }
  // (X^t·acc)[m] = ±acc[x], x = (m - t) mod N, lies in the tile of rank
  // x / COLS
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int idx = threadIdx.x; idx < rows * COLS; idx += THREADS) {
    const int row = idx / COLS;
    const int m = c0 + idx % COLS;
    const int t = t_next[b0 + row];
    const int src = (m - t) & (2 * N - 1);
    const int x = src & (N - 1);
    const uint64_t* owner = cluster.map_shared_rank(tile, x / COLS);
    const uint64_t v = owner[row * COLS + x % COLS];
    const uint64_t rot = src < N ? v : (uint64_t)0 - v;
    int8_t* out = dig_out + (((size_t)o * levels * ND) * B + b0 + row) * N;
    nc::glue_digits<ND>(rot - tile[idx], m, levels, base_log, out,
                        (size_t)ND * B * N, (size_t)B * N);
  }
  cluster.sync();   // the cluster may still be reading this block's tile
}

// The launch of a B-lane step, its kernel's attributes set: grid
// (ceil(B/32), O, N/COLS), clusters {1, 1, N/COLS}. `attr` holds the
// cluster dimension cfg points to.
template <int N, int ND, int JS>
cudaError_t wg_config(int B, int O, cudaStream_t stream,
                      cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  const int smem = wg::smem_bytes(8 - JS, ND);
  cudaError_t err = cudaFuncSetAttribute(
      extprod_step2g_wg_kernel<N, ND, JS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = wg::cluster<N>();
  cfg = {};
  cfg.gridDim = dim3((B + wg::LANES - 1) / wg::LANES, O, wg::cluster<N>());
  cfg.blockDim = dim3(wg::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return err;
}

template <int N, int ND, int JS>
int launch_wg(const int8_t* dig, const int8_t* ext, int64_t* acc,
              const int32_t* t_next, int8_t* dig_out, int B, int O, int R,
              int levels, int base_log, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = wg_config<N, ND, JS>(B, O, stream, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, extprod_step2g_wg_kernel<N, ND, JS>, dig,
                           ext, reinterpret_cast<uint64_t*>(acc), t_next,
                           dig_out, B, R, levels, base_log);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many of the launch's clusters the card holds at once.
template <int N, int ND, int JS>
int wg_clusters(int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = wg_config<N, ND, JS>(wg::LANES, 1, nullptr, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, extprod_step2g_wg_kernel<N, ND, JS>, &cfg);
}

}  // namespace

// K1 on wgmma: tfhe_extprod_step2g's arguments and layouts, at n = 512 and
// 1024 only (cudaErrorInvalidValue at any other n).
extern "C" int tfhe_extprod_step2g_wg(const int8_t* dig, const int8_t* ext,
                                      int64_t* acc, const int32_t* t_next,
                                      int8_t* dig_out, int B, int n, int O,
                                      int R, int levels, int nd, int js,
                                      int base_log, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define WG_CALL_512(ND, JS)                                                 \
  launch_wg<512, ND, JS>(dig, ext, acc, t_next, dig_out, B, O, R, levels,  \
                         base_log, s)
#define WG_CALL_1024(ND, JS)                                                \
  launch_wg<1024, ND, JS>(dig, ext, acc, t_next, dig_out, B, O, R, levels, \
                          base_log, s)
  if (n == 512) {
    NC_DISPATCH(nd, js, WG_CALL_512)
  }
  if (n == 1024) {
    NC_DISPATCH(nd, js, WG_CALL_1024)
  }
#undef WG_CALL_512
#undef WG_CALL_1024
  return (int)cudaErrorInvalidValue;
}

// The clusters of K1 on wgmma that the card holds at once
// (cudaOccupancyMaxActiveClusters) at n = 512 or 1024: a launch of more
// than that runs in waves. chip_smoke.py and PERF.md read it.
extern "C" int tfhe_extprod_step2g_wg_clusters(int n, int nd, int js,
                                               int* clusters) {
#define WG_OCC_512(ND, JS) wg_clusters<512, ND, JS>(clusters)
#define WG_OCC_1024(ND, JS) wg_clusters<1024, ND, JS>(clusters)
  if (n == 512) {
    NC_DISPATCH(nd, js, WG_OCC_512)
  }
  if (n == 1024) {
    NC_DISPATCH(nd, js, WG_OCC_1024)
  }
#undef WG_OCC_512
#undef WG_OCC_1024
  return (int)cudaErrorInvalidValue;
}
