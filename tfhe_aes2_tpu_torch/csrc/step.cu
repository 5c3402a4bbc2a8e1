// K6 and K7: the CMux update without its glue on batch-major layouts, and
// the shared-key product as raw int32 partial sums, on Hopper.
//
// K6 (tfhe_extprod_step) replaces the Pallas kernel
// tfhe_aes2_tpu/ops/pallas/extprod.py::extprod_step: the dots and the u64
// recombination of one blind-rotate step on the batch-major layouts that
// glue done outside the kernel produces (digits [n_d, B, R, N], accumulator
// [B, O, N]), the result a new tensor. The TPU kernel wanted the whole BSK
// transposed to [8-js, R, O, 2N] for this path; here the kernel reads the
// prepared entry [O, R, 8-js, 2N] through its own strides, so no key is ever
// re-laid out, and every B is taken (the TPU kernel halves B into tiles of
// at most 256). Per component o:
//
//   acc[o] += Σ_r Σ_{i, j>=js} 2^(8(i+j)) dig_i[r] · NC(BSK plane j)[r][o]
//
// It is K5's function (cmux.cu) on other strides, and K5's kernel body:
// what bounds it on the H100 is int8 operations, so the products run on the
// tensor cores through nc::contract_mma (nc_mma.cuh: mma.sync.m16n8k32 int8
// fed from the shared-memory S-tables, key rows and digit tiles staged by
// cp.async one contraction row ahead). Only the Staged record differs: the
// batch-major digits lie as K10b's flat ones (longk.cu) — a lane's R rows
// side by side, rows N bytes apart, lanes R·N — so the tiles are read as
// they lie. One block owns 8 lanes x min(N, 512) columns of one component
// and all R rows: the output is a new tensor, so a split of the rows would
// first need acc_in copied into acc_out. At N = 1024 the two column halves
// of a row tile are two blocks, as K5's (cmux.cu): each stages the whole
// key row and digit tile, builds the whole S-tables, contracts over all N
// digit columns and writes its own 512 columns from c0 = 512·blockIdx.z,
// reading acc_in at the same columns. The offset is read at run time, so
// every N takes one build.
//
// K7 (tfhe_extprod_partials) replaces extprod.py::extprod_partials: the
// same product over all 8 key planes of ext = [p, -p] (JS = 0), left as one
// int32 sum per weight 2^(8s),
//
//   out[s, b, o] = Σ_r Σ_{i + j = s} dig_i[b, r] · NC(key plane j)[r][o],  s < 8
//
// which the caller recombines, Σ_s sext(out[s]) << 8s mod 2^64. Its digits
// lie as K6's, so it is K6's kernel built with PARTIALS, as K8 is K3's
// (vp.cu): the key planes of [8, R, O, 2N] lie R·O·2N bytes apart and are
// staged plane by plane (KEY_STRIDED), and the epilogue stores the 8
// buckets of each D register where they are, out[s][b][o][m]. At JS = 0 a
// thread keeps 128 int32 buckets, so one block an SM. It splits its
// columns at N = 1024 as K6; its two stages then take 213,760 bytes at
// n_d = 3, under the 232,448 a block may have, with no room for a third.
#include <type_traits>

#include "nc_mma.cuh"

namespace {

// Grid (ceil(B/ROWS), O, halves), block min(N, 512)/2 (one warp per 64
// columns); halves = nc::column_blocks(N), the block of z = h owning
// columns [512h, 512h + 512).
// K6:
//   dig     int8  [ND][B][R][N]     digit limb planes, batch-major
//   ext     int8  [O][R][8-JS][2N]  this step's BSK limb planes
//   acc_in  int64 [B][O][N]         read only
//   out     int64 [B][O][N]         acc_in + the external product
// K7 (PARTIALS, JS = 0; acc_in is not read):
//   dig     int8  [ND][B][R][N]     digit limb planes, batch-major
//   ext     int8  [8][R][O][2N]     all 8 key limb planes
//   out     int32 [8][B][O][N]
template <int ND, int JS, bool PARTIALS>
__global__ void __launch_bounds__(256)
extprod_step_kernel(
    const int8_t* __restrict__ dig, const int8_t* __restrict__ ext,
    const uint64_t* __restrict__ acc_in,
    std::conditional_t<PARTIALS, int32_t, uint64_t>* __restrict__ out, int B,
    int n, int R) {
  constexpr int NJ = 8 - JS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int o = blockIdx.y;
  const int O = gridDim.y;
  const int b0 = blockIdx.x * nc::ROWS;
  const int rows = min(nc::ROWS, B - b0);
  const unsigned rn = (unsigned)R * n;
  const int c0 = blockIdx.z * nc::SPLIT_COLS;   // 0 below N = 1024

  int32_t part[nc::MT][NJ][4];
  if constexpr (!PARTIALS) {
    const nc::Staged op{ext + (size_t)o * R * NJ * 2 * n,
                        dig + (size_t)b0 * rn, (unsigned)n, (unsigned)B * rn,
                        rn, nullptr};
    nc::contract_mma<ND, JS, true>(part, smem, op, R, rows, n, c0);

    nc::for_each_output<JS>(part, [&](int lane, int m, uint64_t sum) {
      if (lane < rows) {
        const size_t at = ((size_t)(b0 + lane) * O + o) * n + m;
        out[at] = acc_in[at] + sum;
      }
    }, c0);
  } else {
    // key plane j of row r at ext + j·R·O·2N + r·O·2N + o·2N
    static_assert(JS == 0, "K7 takes all 8 key planes");
    const nc::Staged op{ext + (size_t)o * 2 * n,
                        dig + (size_t)b0 * rn,
                        (unsigned)n,
                        (unsigned)B * rn,
                        rn,
                        nullptr,
                        (unsigned)O * 2 * n,
                        (unsigned)R * O * 2 * n};
    nc::contract_mma<ND, 0, true, true>(part, smem, op, R, rows, n, c0);

    const size_t plane = (size_t)B * O * n;           // out[s] to out[s+1]
    int32_t* out_o = out + ((size_t)b0 * O + o) * n;
    nc::for_each_fragment([&](int q, int c, int lane, int m) {
      if (lane < rows) {
        int32_t* at = out_o + (size_t)lane * O * n + m;
#pragma unroll
        for (int s = 0; s < 8; ++s) at[s * plane] = part[q][s][c];
      }
    }, c0);
  }
}

template <int ND, int JS, bool PARTIALS, typename Out>
int launch_step(const int8_t* dig, const int8_t* ext, const int64_t* acc_in,
                Out* out, int B, int n, int O, int R, cudaStream_t stream) {
  constexpr int NJ = 8 - JS;
  const int smem = 2 * (nc::tab_bytes(NJ, n) + nc::raw_bytes(NJ, n) +
                        nc::dig_tile_bytes(ND, n));
  auto kern = extprod_step_kernel<ND, JS, PARTIALS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + nc::ROWS - 1) / nc::ROWS, O, nc::column_blocks(n));
  using Word = std::conditional_t<PARTIALS, int32_t, uint64_t>;
  kern<<<grid, nc::mma_threads(n), smem, stream>>>(
      dig, ext, reinterpret_cast<const uint64_t*>(acc_in),
      reinterpret_cast<Word*>(out), B, n, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tfhe_extprod_step(const int8_t* dig, const int8_t* ext,
                                 const int64_t* acc_in, int64_t* acc_out,
                                 int B, int n, int O, int R, int nd, int js,
                                 void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define STEP_CALL(ND, JS) \
  launch_step<ND, JS, false>(dig, ext, acc_in, acc_out, B, n, O, R, s)
  NC_DISPATCH(nd, js, STEP_CALL)
#undef STEP_CALL
}

extern "C" int tfhe_extprod_partials(const int8_t* dig, const int8_t* ext,
                                     int32_t* out, int B, int n, int O, int R,
                                     int nd, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define PARTIALS_CALL(ND) \
  launch_step<ND, 0, true>(dig, ext, nullptr, out, B, n, O, R, s)
  switch (nd) {
    case 1: return PARTIALS_CALL(1);
    case 2: return PARTIALS_CALL(2);
    case 3: return PARTIALS_CALL(3);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PARTIALS_CALL
}
