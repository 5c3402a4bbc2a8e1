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
// over the rows and every digit limb that reaches it. The TPU kernel walked
// the buckets as its last, sequential grid axis and recombined them at the
// last one. Here the bucket index is a grid axis, grid (ceil(B/ROWS), O,
// (8-js)·splits): each block computes one bucket of ROWS lanes of one
// component over its share of the R rows and adds sign_extend(bucket) << 8s
// into the accumulator with one 64-bit atomic add per element. Integer
// addition mod 2^64 commutes and the atomic wraps exactly, so the result is
// the same bits whatever order the blocks finish in.
//
// What bounds it on the H100: int8 operations, as for K1 (cmux.cu); so the
// products run on the tensor cores, as mma.sync.m16n8k32 fed from the
// shared-memory S-tables (nc_mma.cuh), key rows and digit tiles staged by
// cp.async one row ahead. A block keeps ONE bucket, acc[MT][4]: 16 int32
// accumulators a thread where K5 keeps 96, and ~37 KB of shared memory at
// n_d = 2 (two stages of two S-tables, two raw key rows and a 2 x 8-lane
// digit tile), so several blocks share an SM. Per row a block stages only
// the `limbs` = min(n_d, s-js+1) key planes j = s-i that its bucket meets —
// contiguous in the prepared entry, from plane s-limbs+1 — and the digit
// limbs i < limbs, and runs one plane against one limb at a time
// (nc::mma_row<1, 7>: one plane, one limb, one bucket). The price of the
// decomposition: the S-table of plane j is built by bucket j and bucket
// j+1 (11 builds a row at n_d = 2, js = 2 against K5's 6), and each digit
// tile is staged once per bucket that reads it.
//
// The rows split across gridDim.z as well (extprod._bucket_splits): at
// B = 9 the 60 unsplit blocks leave most of 132 SMs idle. The split is free
// in exactness: each block's bucket is a sub-sum of the same terms, so
// |partial| <= limbs·R·N·2^14 < 2^31 (the wrappers' bound) and the sum of
// the sign-extended partials is the sign-extended sum, mod 2^64.
//
// At N = 1024 the two column halves of each (tile, component, bucket,
// split) are two blocks, as K5's (cmux.cu): gridDim.z is (8-js) x splits x
// halves, and a block contracts over all N digit columns into its own 512
// columns from c0 (nc::mma_row's column offset), so the halves' atomics
// touch disjoint words. Its shared memory, n_d·37,120 bytes there, keeps
// several blocks an SM (extprod._bucket_residency reads how many).
#include "nc_mma.cuh"

namespace {

// One block's bucket over R rows. ext: the first row's `LIMBS` key planes
// (plane t meets digit limb LIMBS-1-t), rows ext_r bytes apart. dig: limb 0
// of lane 0 at the first row; limb i of lane `row` at row r is at
// dig + r*dig_r + i*dig_plane + row*N.
template <int LIMBS>
__device__ __forceinline__ void bucket_contract(
    int32_t (&acc)[nc::MT][1][4], unsigned char* smem,
    const int8_t* __restrict__ ext, size_t ext_r,
    const int8_t* __restrict__ dig, size_t dig_r, unsigned dig_plane, int R,
    int rows_valid, int n, int c0) {
  const int tab_b = nc::tab_bytes(LIMBS, n), raw_b = nc::raw_bytes(LIMBS, n),
            dig_b = nc::dig_tile_bytes(LIMBS, n);
  const int stride = (n + nc::DIG_PAD) >> 2;        // words a digit-tile row
  unsigned char* tab = smem;
  unsigned char* raw = smem + 2 * tab_b;
  unsigned char* tile = raw + 2 * raw_b;
#pragma unroll
  for (int q = 0; q < nc::MT; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[q][0][c] = 0;

  nc::copy_async(raw, ext, raw_b);
  nc::copy_digits_async<LIMBS>(tile, dig, dig_plane, n, rows_valid, n);
  if (R > 1) nc::copy_async(raw + raw_b, ext + ext_r, raw_b);
  nc::cp_async_commit();
  nc::cp_async_wait_all();
  __syncthreads();
  nc::build_tables<LIMBS>(reinterpret_cast<uint32_t*>(tab), raw, n);
  __syncthreads();
  for (int r = 0; r < R; ++r) {
    const int st = r & 1;
    // as nc::contract_mma: stage st holds row r's tables and digits, raw
    // stage st^1 row r+1's key rows
    if (r + 1 < R)
      nc::copy_digits_async<LIMBS>(tile + (st ^ 1) * dig_b,
                                   dig + (r + 1) * dig_r, dig_plane, n,
                                   rows_valid, n);
    if (r + 2 < R)
      nc::copy_async(raw + st * raw_b, ext + (r + 2) * ext_r, raw_b);
    nc::cp_async_commit();
    if (r + 1 < R)
      nc::build_tables<LIMBS>(
          reinterpret_cast<uint32_t*>(tab + (st ^ 1) * tab_b),
          raw + (st ^ 1) * raw_b, n);
    const uint32_t* tw = reinterpret_cast<const uint32_t*>(tab + st * tab_b);
    const uint32_t* dw = reinterpret_cast<const uint32_t*>(tile + st * dig_b);
#pragma unroll
    for (int t = 0; t < LIMBS; ++t)
      nc::mma_row<1, 7>(acc, tw + t * 2 * n,
                        dw + (LIMBS - 1 - t) * nc::ROWS * stride, n, c0);
    nc::cp_async_wait_all();
    __syncthreads();
  }
}

// bucket_contract<limbs> for a block-uniform limbs in [1, L].
template <int L>
__device__ __forceinline__ void bucket_limbs(
    int limbs, int32_t (&acc)[nc::MT][1][4], unsigned char* smem,
    const int8_t* __restrict__ ext, size_t ext_r,
    const int8_t* __restrict__ dig, size_t dig_r, unsigned dig_plane, int R,
    int rows_valid, int n, int c0) {
  if constexpr (L > 1) {
    if (limbs < L) {
      bucket_limbs<L - 1>(limbs, acc, smem, ext, ext_r, dig, dig_r,
                          dig_plane, R, rows_valid, n, c0);
      return;
    }
  }
  bucket_contract<L>(acc, smem, ext, ext_r, dig, dig_r, dig_plane, R,
                     rows_valid, n, c0);
}

// Grid (ceil(B/ROWS), O, (8-js)·splits·halves), block min(N, 512)/2 (one
// warp per 64 columns); halves = nc::column_blocks(N). Block
// z = (split·halves + h)·(8-js) + (s-js) takes bucket s over rows
// [split·R/splits, (split+1)·R/splits) and columns [512h, 512h + 512).
// dig  int8  [R][ND][B][N]      this step's digit limb planes (K2's output)
// ext  int8  [O][R][8-js][2N]   this step's BSK limb planes
// acc  int64 [O][B][N]          added into with atomics
template <int ND>
__global__ void __launch_bounds__(256)
extprod_step3_kernel(const int8_t* __restrict__ dig,
                     const int8_t* __restrict__ ext, unsigned long long* acc,
                     int B, int n, int R, int js) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nj = 8 - js;
  const int halves = nc::column_blocks(n);
  const int splits = gridDim.z / (nj * halves);
  const int s = js + blockIdx.z % nj;
  const int column_block = blockIdx.z / nj;       // split·halves + h
  const int split = column_block / halves;
  const int c0 = (column_block - split * halves) * nc::SPLIT_COLS;
  const int r0 = split * R / splits, r1 = (split + 1) * R / splits;
  const int o = blockIdx.y;
  const int b0 = blockIdx.x * nc::ROWS;
  const int rows = min(nc::ROWS, B - b0);
  // digit limb i meets key plane j = s - i; the limbs with j >= js
  const int limbs = min(ND, s - js + 1);

  int32_t bucket[nc::MT][1][4];
  bucket_limbs<ND>(
      limbs, bucket, smem,
      ext + (((size_t)o * R + r0) * nj + (s - limbs + 1 - js)) * 2 * n,
      (size_t)nj * 2 * n, dig + ((size_t)r0 * ND * B + b0) * n,
      (size_t)ND * B * n, (unsigned)B * n, r1 - r0, rows, n, c0);

  unsigned long long* acc_o = acc + ((size_t)o * B + b0) * n;
  nc::for_each_fragment([&](int q, int c, int lane, int m) {
    if (lane < rows)
      atomicAdd(acc_o + (size_t)lane * n + m,
                (unsigned long long)((uint64_t)(int64_t)bucket[q][0][c]
                                     << (8 * s)));
  }, c0);
}

template <int ND>
int bucket_smem(int n) {
  return 2 * (nc::tab_bytes(ND, n) + nc::raw_bytes(ND, n) +
              nc::dig_tile_bytes(ND, n));
}

template <int ND>
int launch_bucket(const int8_t* dig, const int8_t* ext, int64_t* acc, int B,
                  int n, int O, int R, int js, int splits,
                  cudaStream_t stream) {
  const int smem = bucket_smem<ND>(n);
  auto kern = extprod_step3_kernel<ND>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int halves = nc::column_blocks(n);
  dim3 grid((B + nc::ROWS - 1) / nc::ROWS, O, (8 - js) * splits * halves);
  kern<<<grid, nc::mma_threads(n), smem, stream>>>(
      dig, ext, reinterpret_cast<unsigned long long*>(acc), B, n, R, js);
  return (int)cudaGetLastError();
}

template <int ND>
int bucket_residency(int n, int* blocks) {
  const int smem = bucket_smem<ND>(n);
  auto kern = extprod_step3_kernel<ND>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kern, nc::mma_threads(n), smem);
}

}  // namespace

extern "C" int tfhe_extprod_step3(const int8_t* dig, const int8_t* ext,
                                  int64_t* acc, int B, int n, int O, int R,
                                  int nd, int js, int splits, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (js < 0 || js > 7 || splits < 1 || splits > R)
    return (int)cudaErrorInvalidValue;
  switch (nd) {
    case 1: return launch_bucket<1>(dig, ext, acc, B, n, O, R, js, splits, s);
    case 2: return launch_bucket<2>(dig, ext, acc, B, n, O, R, js, splits, s);
    case 3: return launch_bucket<3>(dig, ext, acc, B, n, O, R, js, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of K11 that one SM holds at once, for polynomial size n and nd
// digit limbs (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int tfhe_extprod_step3_residency(int n, int nd, int* blocks) {
  switch (nd) {
    case 1: return bucket_residency<1>(n, blocks);
    case 2: return bucket_residency<2>(n, blocks);
    case 3: return bucket_residency<3>(n, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}
