// Shared device code of the negacirculant limb-plane kernels (K1, K3, K5-K11)
// and of the glue that K1, K2, K9 and K10a run. Every contraction runs on
// the tensor cores (nc_mma.cuh) from the S-tables defined here. The glue
// comes in two forms: nc::glue, one column at a time from a tile a block
// already holds (K1, K9), and nc::glue_wide, one wide pass over the
// accumulator in device memory (K2, K10a: the same kernel body with each
// one's output strides, built for the gadgets of NC_GLUE_GADGETS).
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
// NC[jj+q, m], q = 0..3, are then exactly the bytes of word (jj - m) mod 2N:
// one 32-bit word is four consecutive k of one column, which is what an
// int8 mma fragment register holds (nc_mma.cuh).
//
// One block owns ROWS output rows x all N columns of one component (N <=
// 512; at N = 1024 two blocks share them, nc_mma.cuh). Each
// (row, column) keeps one int32 bucket per weight 2^(8s), s = i + j in
// [JS, 8); products with s >= 8 vanish mod 2^64 and are skipped. Bucket
// bound: at most ND (i, j) pairs land in one bucket, each summing R·N
// products of at most 2^7 · 2^7, so |bucket| <= ND·R·N·2^14 — 2.5e8 for the
// blind rotation at PARAMS_SQRD_LVL_64 (ND=2, R=15, N=512), below 2^31. The
// Python wrappers refuse shapes past this bound. The buckets are folded into
// a wrapping uint64 (sign-extended, shifted by 8s) once the contraction is
// complete, or stored as they are (K7, K8); any exact order of int32
// partial sums gives the same bits mod 2^64.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nc {

constexpr int ROWS = 8;   // output rows per block
constexpr int COLS = 2;   // columns a thread of K9's glue owns (merged.cu)

// Σ_s sign_extend(bucket_s) << 8s, wrapping mod 2^64.
template <int JS>
__device__ __forceinline__ uint64_t recombine(const int32_t (&bucket)[8 - JS]) {
  uint64_t sum = 0;
#pragma unroll
  for (int s = 0; s < 8 - JS; ++s)
    sum += (uint64_t)(int64_t)bucket[s] << (8 * (s + JS));
  return sum;
}

// The gadget digits of one difference diff = (X^t·acc - acc)[m], each split
// into ND balanced int8 limbs; limb i of level l goes to
// out[l*level_stride + i*limb_stride + m] (strides in bytes; `out` may be
// device or shared memory). The second half of nc::glue below; K1 at
// N = 1024 forms the difference from two blocks' halves of the row itself
// (cmux.cu).
template <int ND>
__device__ __forceinline__ void glue_digits(uint64_t diff, int m, int levels,
                                            int base_log, int8_t* out,
                                            size_t level_stride,
                                            size_t limb_stride) {
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

// The glue of the blind rotation for one accumulator row held in shared
// memory: glue_digits of (X^t·acc - acc)[m].
template <int ND>
__device__ __forceinline__ void glue(const uint64_t* row, int t, int m, int n,
                                     int levels, int base_log, int8_t* out,
                                     size_t level_stride, size_t limb_stride) {
  const int two_n = 2 * n;
  const int src = (m - t) & (two_n - 1);   // (X^t·acc)[m] = ext[(m - t) mod 2N]
  const uint64_t rot = src < n ? row[src] : (uint64_t)0 - row[src - n];
  glue_digits<ND>(rot - row[m], m, levels, base_log, out, level_stride,
                  limb_stride);
}

// The glue as one wide pass, bound by bytes: K2's and K10a's kernel body,
// each with its own output strides (GlueOut). nc::glue above serves a block
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

// The (levels, base_log) gadgets the glue kernels K2 (cmux.cu) and K10a
// (longk.cu) are built for: the blind rotation's of every parameter set in
// ops/params.py and models/shortint_1bit.py ((7, 6): the tree-PBS model's),
// and (2, 12) of the card's tests. The wrappers refuse any other before the
// launch (extprod.GLUE_GADGETS, held equal to this list by a CPU test).
// G(L, BL, CALL) is applied to each.
#define NC_GLUE_GADGETS(G, CALL)                                           \
  G(2, 12, CALL) G(2, 15, CALL) G(3, 12, CALL) G(4, 9, CALL) G(6, 7, CALL) \
  G(7, 6, CALL)

#define NC_GLUE_CASE(L, BL, CALL)                                          \
  case ((L) * 64 + (BL)) * 4 + 1: return CALL(1, L, BL);                   \
  case ((L) * 64 + (BL)) * 4 + 2: return CALL(2, L, BL);                   \
  case ((L) * 64 + (BL)) * 4 + 3: return CALL(3, L, BL);

// Instantiate `launch<ND, L, BL>(args...)` for ND in 1..3 and every gadget
// (L, BL) of NC_GLUE_GADGETS; returns cudaErrorInvalidValue for anything
// else.
#define NC_GLUE_DISPATCH(ND_, LEVELS_, BASE_LOG_, CALL)                    \
  if ((ND_) < 1 || (ND_) > 3 || (BASE_LOG_) < 1 || (BASE_LOG_) > 63)       \
    return (int)cudaErrorInvalidValue;                                     \
  switch (((LEVELS_) * 64 + (BASE_LOG_)) * 4 + (ND_)) {                    \
    NC_GLUE_GADGETS(NC_GLUE_CASE, CALL)                                    \
    default: return (int)cudaErrorInvalidValue;                            \
  }
