// K3 and K8: the vertical-packing external product on Hopper.
//
// K3 (tfhe_extprod_grouped_fused) replaces the Pallas kernel
// tfhe_aes2_tpu/ops/pallas/extprod.py::extprod_grouped_fused. In vertical
// packing every lane b (one byte of one block) has its own selector GGSW,
// shared by its G accumulators (G = 24 for the 8->24-bit SBOX+GalMul lookup
// at PARAMS_SQRD_LVL_64):
//
//   out[b, o, g] = Σ_r Σ_{i, j>=js} 2^(8(i+j)) dig_i[b, r, g] · NC(GGSW plane j)[b, r, o]
//
// K8 (tfhe_extprod_partials_grouped) replaces
// extprod.py::extprod_partials_grouped: the same product left as one int32
// sum per weight 2^(8s), on the TPU kernel's operand layouts, rows s < js
// written as zeros; the caller recombines Σ_s sext(out[s]) << 8s mod 2^64.
//
// What bounds them on the H100: int8 operations, as for K1 (32 lanes x
// G=24: 32·24·5·5·512²·7 ≈ 3.5e10 multiply-adds, 0.036 ms at the int8 peak);
// K8 also writes 8 int32 words for every u64 of K3 (63 MB at 32 x 24, 0.019
// ms at 3.35 TB/s). The design is K1's tensor-core contraction
// (nc_mma.cuh) as it is: one block per (G-tile of 8 accumulators,
// component o, lane b); the 8 columns of each mma.sync.m16n8k32 are 8 of
// the lane's G accumulators where in K1 they are 8 batch lanes, the A
// fragments are words of the S-tables built on chip from the lane's 2N-byte
// GGSW rows, and the key rows and digit tiles of row r+1 arrive by cp.async
// while row r's mma run. K3 and K8 are one kernel built two ways, as K1 and
// K5 are: K3 (PARTIALS = false) folds the buckets into u64 in the epilogue
// and writes each output once; K8 (PARTIALS = true) reads its own layouts
// through the Staged strides — the digits batch-major as K6's, the key
// planes B·R·O·2N bytes apart (KEY_STRIDED) — and stores the buckets as
// they are. At js = 4 a thread keeps 64 int32 buckets, so two blocks share
// an SM. At N = 1024 (SPLIT) the columns are split as in K5 (cmux.cu): a
// block owns 512 of them, 8 warps, and the grid's x runs over (G-tile,
// column half); no glue, so no cluster. SPLIT is a template value here,
// not read at run time as in cmux.cu: at js = 4 K3 sits at its 128-register
// cap, and a run-time column offset cost it 2.3-2.7% at N = 512
// (probes/mma_regress.py), where K8 and K1 lost nothing. The split
// instantiations are built for ND = 1 and 2 only, the circuit bootstrap's
// digit limbs in PARAMS_WOPPBS_8BIT (1) and in lvl1, lvl4 and lvl256 (2);
// the wrappers refuse any other ND there (extprod.WIDE_ND). A G-tile of
// fewer than 8 accumulators (G = 1 on the 128-lane stage, and in the
// tree-PBS model's selection product) leaves the instruction's other
// columns zero.
#include <type_traits>

#include "nc_mma.cuh"

namespace {

// Grid (ceil(G/ROWS), O, B), block N/2 (one warp per 64 columns); SPLIT
// (N = 1024): grid (2·ceil(G/ROWS), O, B), block 256, x = 2·(G-tile) + h
// owning columns [512h, 512h + 512).
// K3:
//   dig  int8  [B][R][ND·G][N]      lane b's digit limb planes, row r
//   ext  int8  [B][O][R][8-JS][2N]  lane b's GGSW row limb planes
//   out  int64 [B][O][G][N]
// K8 (PARTIALS):
//   dig  int8  [ND][B][G][R][N]     lane b's digit limb planes
//   ext  int8  [8-JS][B][R][O][2N]  lane b's GGSW row limb planes
//   out  int32 [8][B][G][O][N]      rows s < JS written as zeros
template <int ND, int JS, bool PARTIALS, bool SPLIT>
__global__ void __launch_bounds__(256, (8 - JS) <= 4 ? 2 : 1)
extprod_grouped_fused_kernel(
    const int8_t* __restrict__ dig, const int8_t* __restrict__ ext,
    std::conditional_t<PARTIALS, int32_t, uint64_t>* __restrict__ out, int G,
    int n, int R) {
  constexpr int NJ = 8 - JS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int o = blockIdx.y;
  const int O = gridDim.y;
  const int b = blockIdx.z;
  const int g0 = (SPLIT ? blockIdx.x >> 1 : blockIdx.x) * nc::ROWS;
  const int c0 = SPLIT ? (blockIdx.x & 1) * nc::SPLIT_COLS : 0;
  const int rows = min(nc::ROWS, G - g0);

  int32_t part[nc::MT][NJ][4];
  if constexpr (!PARTIALS) {
    // row r's NJ key rows are contiguous; accumulator g0 + row's digit
    // plane i at row r lies at dig + r·ND·G·N + i·G·N + row·N
    const nc::Staged op{ext + ((size_t)b * O + o) * R * NJ * 2 * n,
                        dig + ((size_t)b * R * ND * G + g0) * n,
                        (unsigned)(ND * G * n), (unsigned)(G * n),
                        (unsigned)n, nullptr};
    nc::contract_mma<ND, JS, true>(part, smem, op, R, rows, n, c0);

    uint64_t* out_g = out + (((size_t)b * O + o) * G + g0) * n;
    nc::for_each_output<JS>(part, [&](int row, int m, uint64_t sum) {
      if (row < rows) out_g[(size_t)row * n + m] = sum;
    }, c0);
  } else {
    // key plane j of row r at ext + j·B·R·O·2N + ((b·R + r)·O + o)·2N;
    // accumulator g0 + row's digit plane i at row r at
    // dig + i·B·G·R·N + (b·G + g0 + row)·R·N + r·N
    const int B = gridDim.z;
    const nc::Staged op{ext + ((size_t)b * R * O + o) * 2 * n,
                        dig + ((size_t)b * G + g0) * R * n,
                        (unsigned)n,
                        (unsigned)B * G * R * n,
                        (unsigned)R * n,
                        nullptr,
                        (unsigned)O * 2 * n,
                        (unsigned)B * R * O * 2 * n};
    nc::contract_mma<ND, JS, true, true>(part, smem, op, R, rows, n, c0);

    const size_t plane = (size_t)B * G * O * n;      // out[s] to out[s+1]
    int32_t* out_g = out + (((size_t)b * G + g0) * O + o) * n;
    nc::for_each_fragment([&](int q, int c, int row, int m) {
      if (row < rows) {
        int32_t* at = out_g + (size_t)row * O * n + m;
#pragma unroll
        for (int s = 0; s < JS; ++s) at[s * plane] = 0;
#pragma unroll
        for (int s = 0; s < NJ; ++s) at[(s + JS) * plane] = part[q][s][c];
      }
    }, c0);
  }
}

template <int ND, int JS, bool PARTIALS, bool SPLIT, typename Out>
int launch(const int8_t* dig, const int8_t* ext, Out* out, int B, int G,
           int n, int O, int R, cudaStream_t stream) {
  constexpr int NJ = 8 - JS;
  const int smem = 2 * (nc::tab_bytes(NJ, n) + nc::raw_bytes(NJ, n) +
                        nc::dig_tile_bytes(ND, n));
  auto kern = extprod_grouped_fused_kernel<ND, JS, PARTIALS, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((G + nc::ROWS - 1) / nc::ROWS * (SPLIT ? 2 : 1), O, B);
  using Word = std::conditional_t<PARTIALS, int32_t, uint64_t>;
  kern<<<grid, nc::mma_threads(n), smem, stream>>>(
      dig, ext, reinterpret_cast<Word*>(out), G, n, R);
  return (int)cudaGetLastError();
}

}  // namespace

// At N = 1024 the split kernels, ND = 1 and 2 only (see above): CALL(ND, JS)
// for JS in 0..7, cudaErrorInvalidValue for any other (nd, js).
#define VP_SPLIT_DISPATCH(ND_, JS_, CALL)                                  \
  switch ((ND_) * 8 + (JS_)) {                                             \
    case 8: return CALL(1, 0); case 9: return CALL(1, 1);                  \
    case 10: return CALL(1, 2); case 11: return CALL(1, 3);                \
    case 12: return CALL(1, 4); case 13: return CALL(1, 5);                \
    case 14: return CALL(1, 6); case 15: return CALL(1, 7);                \
    case 16: return CALL(2, 0); case 17: return CALL(2, 1);                \
    case 18: return CALL(2, 2); case 19: return CALL(2, 3);                \
    case 20: return CALL(2, 4); case 21: return CALL(2, 5);                \
    case 22: return CALL(2, 6); case 23: return CALL(2, 7);                \
    default: return (int)cudaErrorInvalidValue;                            \
  }

extern "C" int tfhe_extprod_grouped_fused(const int8_t* dig, const int8_t* ext,
                                          int64_t* out, int B, int G, int n,
                                          int O, int R, int nd, int js,
                                          void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define VP_CALL(ND, JS) \
  launch<ND, JS, false, false>(dig, ext, out, B, G, n, O, R, s)
#define VP_SPLIT_CALL(ND, JS) \
  launch<ND, JS, false, true>(dig, ext, out, B, G, n, O, R, s)
  if (n > nc::SPLIT_COLS) {
    VP_SPLIT_DISPATCH(nd, js, VP_SPLIT_CALL)
  }
  NC_DISPATCH(nd, js, VP_CALL)
#undef VP_CALL
#undef VP_SPLIT_CALL
}

extern "C" int tfhe_extprod_partials_grouped(const int8_t* dig,
                                             const int8_t* ext, int32_t* out,
                                             int B, int G, int n, int O, int R,
                                             int nd, int js, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define PARTIALS_CALL(ND, JS) \
  launch<ND, JS, true, false>(dig, ext, out, B, G, n, O, R, s)
#define PARTIALS_SPLIT_CALL(ND, JS) \
  launch<ND, JS, true, true>(dig, ext, out, B, G, n, O, R, s)
  if (n > nc::SPLIT_COLS) {
    VP_SPLIT_DISPATCH(nd, js, PARTIALS_SPLIT_CALL)
  }
  NC_DISPATCH(nd, js, PARTIALS_CALL)
#undef PARTIALS_CALL
#undef PARTIALS_SPLIT_CALL
}
