// Shared device code of the negacirculant limb-plane kernels (K1, K3, K5-K11)
// and of the glue that K1, K2, K9 and K10a run. The __dp4a contraction below
// (nc::contract) is K7's alone; the others contract on the tensor cores
// (nc_mma.cuh) from the same S-tables. The glue comes in two forms: nc::glue,
// one column at a time from a tile a block already holds (K1, K9, K10a), and
// nc::glue_wide, K2's pass over the accumulator in device memory.
//
// The contraction these kernels evaluate, for one output component o:
//
//   out[row, m] = Σ_r Σ_{i, j>=JS} 2^(8(i+j)) Σ_jj dig_i[r, row, jj] · NC_j[r][jj, m]
//
// with NC_j[r][jj, m] = ext_j[r][(m - jj) mod 2N] the negacirculant of one
// int8 limb plane of ext = [p, -p]. NC is never materialised (the expanded
// negacirculant BSK alone would be ~146 GB): each block keeps, per plane, a
// 2N-word "S-table" in shared memory whose word x packs the four bytes
// rext[x..x+3], rext[q] = ext[(-q) mod 2N]. The four negacirculant entries
// NC[jj+q, m], q = 0..3, are then exactly the bytes of word (jj - m) mod 2N,
// in the order __dp4a pairs them with the four digit bytes dig[jj..jj+3].
// Neighbouring threads own neighbouring columns m, so their S-table words
// are neighbours too: conflict-free shared loads.
//
// One block owns ROWS output rows x all N columns of one component; thread
// t owns columns t and t + N/2, so blockDim.x = N/2. Each (row, column)
// keeps one int32 bucket per weight 2^(8s), s = i + j in [JS, 8); products
// with s >= 8 vanish mod 2^64 and are skipped. Bucket bound: at most ND
// (i, j) pairs land in one bucket, each summing R·N products of at most
// 2^7 · 2^7, so |bucket| <= ND·R·N·2^14 — 2.5e8 for the blind rotation at
// PARAMS_SQRD_LVL_64 (ND=2, R=15, N=512), below 2^31. The Python wrappers
// refuse shapes past this bound. The buckets are folded into a wrapping
// uint64 (sign-extended, shifted by 8s) once the contraction is complete;
// any exact order of int32 partial sums gives the same bits mod 2^64.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nc {

constexpr int ROWS = 8;   // output rows per block
constexpr int COLS = 2;   // output columns per thread

// Shared-memory bytes of the contraction stage: NJ S-tables of 2N words and
// the ND x ROWS x N digit tile.
__host__ __device__ inline size_t contraction_smem(int nd, int nj, int n) {
  return (size_t)nj * 2 * n * 4 + (size_t)nd * ROWS * n;
}

// Fill the NJ S-tables from NJ int8 ext rows of 2N bytes; plane j's row
// starts at ext + j*plane_stride.
template <int NJ>
__device__ __forceinline__ void build_s_tables(uint32_t* s_tab,
                                               const int8_t* __restrict__ ext,
                                               size_t plane_stride, int n) {
  const int two_n = 2 * n;
  const int mask = two_n - 1;
  for (int idx = threadIdx.x; idx < NJ * two_n; idx += blockDim.x) {
    const int j = idx / two_n;
    const int x = idx - j * two_n;
    const int8_t* e = ext + (size_t)j * plane_stride;
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = (two_n - x - q) & mask;
      word |= (uint32_t)(uint8_t)e[p] << (8 * q);
    }
    s_tab[idx] = word;
  }
}

// Load the ND x ROWS digit tile as 32-bit words: plane i of row `row` starts
// at base + i*plane_stride + row*row_stride (all multiples of 4 bytes). Rows
// at or past `rows_valid` load as zero.
template <int ND>
__device__ __forceinline__ void load_digit_tile(uint32_t* dig_w,
                                                const int8_t* __restrict__ base,
                                                size_t plane_stride,
                                                size_t row_stride,
                                                int rows_valid, int n) {
  const int nw = n >> 2;
  for (int idx = threadIdx.x; idx < ND * ROWS * nw; idx += blockDim.x) {
    const int w = idx % nw;
    const int row = (idx / nw) % ROWS;
    const int i = idx / (nw * ROWS);
    uint32_t v = 0;
    if (row < rows_valid) {
      v = *reinterpret_cast<const uint32_t*>(
          base + i * plane_stride + row * row_stride + 4 * (size_t)w);
    }
    dig_w[idx] = v;
  }
}

// Accumulate one row r of the contraction into the buckets.
template <int ND, int JS>
__device__ __forceinline__ void accumulate(int32_t (&part)[ROWS][COLS][8 - JS],
                                           const uint32_t* s_tab,
                                           const uint32_t* dig_w, int n) {
  const int two_n = 2 * n;
  const int mask = two_n - 1;
  const int nw = n >> 2;
#pragma unroll 1
  for (int w = 0; w < nw; ++w) {
    uint32_t a[ND][ROWS];
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int row = 0; row < ROWS; ++row)
        a[i][row] = dig_w[(i * ROWS + row) * nw + w];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int m = threadIdx.x + c * blockDim.x;
      const int x = (4 * w - m) & mask;
#pragma unroll
      for (int j = JS; j < 8; ++j) {
        const int b = (int)s_tab[(j - JS) * two_n + x];
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          if (i + j < 8) {
#pragma unroll
            for (int row = 0; row < ROWS; ++row)
              part[row][c][i + j - JS] =
                  __dp4a((int)a[i][row], b, part[row][c][i + j - JS]);
          }
        }
      }
    }
  }
}

// Where one block's operands lie, so that every kernel reads its own layout:
// digit plane i of output row `row` at contraction row r starts at
// dig + r*dig_r + i*dig_plane + row*dig_row; key plane j of contraction row
// r starts at ext + r*ext_r + j*ext_plane (strides in bytes, the digit
// strides multiples of 4).
struct Operands {
  const int8_t* dig;
  size_t dig_r, dig_plane, dig_row;
  const int8_t* ext;
  size_t ext_r, ext_plane;
};

// The whole contraction of one block: zero the buckets, then for each of
// the R rows stage the digit tile and the S-tables in shared memory (`smem`
// holds contraction_smem bytes) and accumulate.
template <int ND, int JS>
__device__ __forceinline__ void contract(int32_t (&part)[ROWS][COLS][8 - JS],
                                         unsigned char* smem,
                                         const Operands& op, int R,
                                         int rows_valid, int n) {
  constexpr int NJ = 8 - JS;
  uint32_t* s_tab = reinterpret_cast<uint32_t*>(smem);
  uint32_t* dig_w = s_tab + NJ * 2 * n;
#pragma unroll
  for (int row = 0; row < ROWS; ++row)
#pragma unroll
    for (int c = 0; c < COLS; ++c)
#pragma unroll
      for (int s = 0; s < NJ; ++s) part[row][c][s] = 0;
  for (int r = 0; r < R; ++r) {
    __syncthreads();
    load_digit_tile<ND>(dig_w, op.dig + r * op.dig_r, op.dig_plane,
                        op.dig_row, rows_valid, n);
    build_s_tables<NJ>(s_tab, op.ext + r * op.ext_r, op.ext_plane, n);
    __syncthreads();
    accumulate<ND, JS>(part, s_tab, dig_w, n);
  }
}

// Σ_s sign_extend(bucket_s) << 8s, wrapping mod 2^64.
template <int JS>
__device__ __forceinline__ uint64_t recombine(const int32_t (&bucket)[8 - JS]) {
  uint64_t sum = 0;
#pragma unroll
  for (int s = 0; s < 8 - JS; ++s)
    sum += (uint64_t)(int64_t)bucket[s] << (8 * (s + JS));
  return sum;
}

// The glue of the blind rotation for one accumulator row held in shared
// memory: the gadget digits of (X^t·acc - acc)[m], each split into ND balanced
// int8 limbs; limb i of level l goes to out[l*level_stride + i*limb_stride + m]
// (strides in bytes; `out` may be device or shared memory).
template <int ND>
__device__ __forceinline__ void glue(const uint64_t* row, int t, int m, int n,
                                     int levels, int base_log, int8_t* out,
                                     size_t level_stride, size_t limb_stride) {
  const int two_n = 2 * n;
  const int src = (m - t) & (two_n - 1);   // (X^t·acc)[m] = ext[(m - t) mod 2N]
  const uint64_t rot = src < n ? row[src] : (uint64_t)0 - row[src - n];
  const uint64_t diff = rot - row[m];
  const int b = base_log;
  const int shift = 64 - b * levels;
  const uint64_t r = shift > 0 ? (diff + (1ull << (shift - 1))) >> shift : diff;
  uint64_t h = 0;
  for (int l = 0; l < levels; ++l) h += 1ull << (b - 1 + b * l);
  const uint64_t y = r + h;
  const uint64_t mask = (1ull << b) - 1;
  int32_t off = 0;
#pragma unroll
  for (int i = 0; i < ND - 1; ++i) off += 128 << (8 * i);
  for (int l = 0; l < levels; ++l) {
    const int pos = b * (levels - 1 - l);
    const int32_t digit = (int32_t)((y >> pos) & mask) - (1 << (b - 1));
    const int32_t yy = digit + off;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int32_t p = i < ND - 1 ? ((yy >> (8 * i)) & 0xFF) - 128
                                   : (yy >> (8 * i));
      out[(size_t)l * level_stride + (size_t)i * limb_stride + m] = (int8_t)p;
    }
  }
}

// K2's glue as one wide pass, bound by bytes. nc::glue above serves a block
// that already holds a tile of the accumulator (K1, K9); this one reads the
// accumulator itself. A thread owns GLUE_COLS = 8 consecutive columns
// m0..m0+7 of one accumulator row (o, b); a block of GLUE_THREADS threads
// owns 1024 / N whole rows (2 at N = 512), so the grid covers O·B·N/8
// threads whatever the batch. Each thread reads its own 8 words with four
// 16-byte loads and puts them into the block's row copy in shared memory;
// after one barrier it reads its 8 rotated sources (m - t) mod 2N from
// there (ext = [acc, -acc]: one run that wraps at 2N at most once and
// changes sign at N), computes all L x ND digit limbs of its columns in
// registers, and writes each (level, limb) plane as one 8-byte store: a
// warp writes 256 contiguous bytes a plane at N = 512. The shared row copy
// is padded by one word every 8 (word x at x + x/8), so that the 8-word runs
// of neighbouring threads fall on different banks. L, BL (base_log) and ND
// are compile-time values: the level and limb loops unroll. Limb i < ND-1
// of a digit is byte i of (digit + OFF) minus 128 and the last limb the
// bits above, so with OFF = Σ_{i<ND-1} 128·2^(8i) the bytes of
// (digit + OFF) ^ OFF are the ND limbs as int8: one add and one xor a digit.
constexpr int GLUE_COLS = 8;        // consecutive columns a thread owns
constexpr int GLUE_THREADS = 128;   // threads a block: 1024 columns
constexpr int GLUE_TILE_WORDS = GLUE_THREADS * GLUE_COLS * 9 / 8;

// Where glue_wide writes: limb i of level l of row (o, b) at column m lands
// at out + o*o + b*b + l*level + i*limb + m (bytes, multiples of 8).
struct GlueOut {
  size_t o, b, level, limb;
};

template <int ND, int L, int BL>
__device__ __forceinline__ void glue_wide(uint64_t* tile,
                                          const uint64_t* __restrict__ acc,
                                          const int32_t* __restrict__ t,
                                          int B, int n, int rows,
                                          int8_t* __restrict__ out,
                                          const GlueOut& st) {
  static_assert(L * BL < 64 && BL <= 16 && ND >= 1 && ND <= 3,
                "gadget outside the glue's range");
  constexpr int SHIFT = 64 - L * BL;
  constexpr uint64_t MASK = (1ull << BL) - 1;
  constexpr uint32_t OFF = ND == 1 ? 0u : ND == 2 ? 0x80u : 0x8080u;
  uint64_t h = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) h += 1ull << (BL - 1 + BL * l);

  const int per_row = n / GLUE_COLS;                 // threads a row
  const int lr = threadIdx.x / per_row;              // row of the block
  const int m0 = (threadIdx.x - lr * per_row) * GLUE_COLS;
  const int row = blockIdx.x * (GLUE_THREADS / per_row) + lr;   // o·B + b
  const bool live = row < rows;
  uint64_t* srow = tile + lr * (n + n / 8);
  uint64_t own[GLUE_COLS];
  if (live) {
    const ulonglong2* src =
        reinterpret_cast<const ulonglong2*>(acc + (size_t)row * n + m0);
#pragma unroll
    for (int k = 0; k < GLUE_COLS / 2; ++k) {
      const ulonglong2 v = src[k];
      own[2 * k] = v.x;
      own[2 * k + 1] = v.y;
    }
#pragma unroll
    for (int k = 0; k < GLUE_COLS; ++k) srow[m0 + m0 / 8 + k] = own[k];
  }
  __syncthreads();
  if (!live) return;
  const int o = row / B;
  const int b = row - o * B;
  const int tb = t[b];
  uint32_t z[L][GLUE_COLS];   // (digit + OFF) ^ OFF: byte i is limb i
#pragma unroll
  for (int k = 0; k < GLUE_COLS; ++k) {
    const int src = (m0 + k - tb) & (2 * n - 1);
    const int x = src & (n - 1);
    const uint64_t v = srow[x + (x >> 3)];
    const uint64_t diff = (src < n ? v : (uint64_t)0 - v) - own[k];
    const uint64_t y = ((diff + (1ull << (SHIFT - 1))) >> SHIFT) + h;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int32_t digit =
          (int32_t)((y >> (BL * (L - 1 - l))) & MASK) - (1 << (BL - 1));
      z[l][k] = ((uint32_t)digit + OFF) ^ OFF;
    }
  }
  int8_t* base = out + o * st.o + b * st.b + m0;
#pragma unroll
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      // byte i of z[l][k] for k = 0..7, as the 8 bytes of one store
      const unsigned sel = i | (i + 4) << 4;
      const uint32_t lo = __byte_perm(__byte_perm(z[l][0], z[l][1], sel),
                                      __byte_perm(z[l][2], z[l][3], sel),
                                      0x5410);
      const uint32_t hi = __byte_perm(__byte_perm(z[l][4], z[l][5], sel),
                                      __byte_perm(z[l][6], z[l][7], sel),
                                      0x5410);
      *reinterpret_cast<uint2*>(base + l * st.level + i * st.limb) =
          make_uint2(lo, hi);
    }
  }
}

}  // namespace nc

// Instantiate `launch<ND, JS>(args...)` for ND in 1..3, JS in 0..7; returns
// cudaErrorInvalidValue for anything else.
#define NC_DISPATCH(ND_, JS_, CALL)                                        \
  switch ((ND_) * 8 + (JS_)) {                                             \
    case 8: return CALL(1, 0); case 9: return CALL(1, 1);                  \
    case 10: return CALL(1, 2); case 11: return CALL(1, 3);                \
    case 12: return CALL(1, 4); case 13: return CALL(1, 5);                \
    case 14: return CALL(1, 6); case 15: return CALL(1, 7);                \
    case 16: return CALL(2, 0); case 17: return CALL(2, 1);                \
    case 18: return CALL(2, 2); case 19: return CALL(2, 3);                \
    case 20: return CALL(2, 4); case 21: return CALL(2, 5);                \
    case 22: return CALL(2, 6); case 23: return CALL(2, 7);                \
    case 24: return CALL(3, 0); case 25: return CALL(3, 1);                \
    case 26: return CALL(3, 2); case 27: return CALL(3, 3);                \
    case 28: return CALL(3, 4); case 29: return CALL(3, 5);                \
    case 30: return CALL(3, 6); case 31: return CALL(3, 7);                \
    default: return (int)cudaErrorInvalidValue;                            \
  }
