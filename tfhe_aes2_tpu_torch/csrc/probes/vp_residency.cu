// How many blocks of K3 and K8 (vp.cu) does one SM hold at once? At js = 4
// (lvl1, lvl4, lvl64) the kernel asks for two blocks an SM
// (__launch_bounds__(256, 2)); at N = 1024 two blocks of 115,200 bytes of
// dynamic shared memory each fit the SM's 233,472 bytes only just, with the
// 1,024 bytes the runtime reserves a block. A standalone probe:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//     -o vp_residency vp_residency.cu && ./vp_residency
//
// It includes vp.cu and prints, for N in {512, 1024}, n_d = 2 and
// js in {3, 4}, cudaOccupancyMaxActiveBlocksPerMultiprocessor of each
// kernel at the shared memory and block size its launch uses.
#include <cstdio>

#include "../vp.cu"

namespace {

template <int ND, int JS, bool PARTIALS>
int residency(int n) {
  constexpr int NJ = 8 - JS;
  const int smem = 2 * (nc::tab_bytes(NJ, n) + nc::raw_bytes(NJ, n) +
                        nc::dig_tile_bytes(ND, n));
  auto kern = n > nc::SPLIT_COLS
                  ? extprod_grouped_fused_kernel<ND, JS, PARTIALS, true>
                  : extprod_grouped_fused_kernel<ND, JS, PARTIALS, false>;
  int blocks = -1;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kern, nc::mma_threads(n), smem) != cudaSuccess)
    return -1;
  return blocks;
}

template <int JS>
void report(int n) {
  constexpr int NJ = 8 - JS;
  const int smem = 2 * (nc::tab_bytes(NJ, n) + nc::raw_bytes(NJ, n) +
                        nc::dig_tile_bytes(2, n));
  printf("N=%4d n_d=2 js=%d: %6d B shared, %3d threads: K3 %d, K8 %d "
         "blocks an SM\n", n, JS, smem, nc::mma_threads(n),
         residency<2, JS, false>(n), residency<2, JS, true>(n));
}

}  // namespace

int main() {
  for (int n : {512, 1024}) {
    report<3>(n);
    report<4>(n);
  }
  return 0;
}
