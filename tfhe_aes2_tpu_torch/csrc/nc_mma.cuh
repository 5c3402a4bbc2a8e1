// The negacirculant contraction of every kernel with int8 products — K1 and
// K5 (cmux.cu), K3 and K8 (vp.cu), K6 and K7 (step.cu), K9 (merged.cu), K10b
// (longk.cu) and K11 (bucket.cu) — on the tensor cores: mma.sync.m16n8k32
// (int8 x int8 -> int32) fed straight from the shared-memory S-tables, with
// the key rows and digit tiles staged by cp.async one contraction row ahead.
// K11 runs its own row loop over the pieces below (one weight bucket a
// block).
//
// The function is nc_common.cuh's:
//
//   out[lane, m] = Σ_r Σ_{i, j>=JS} 2^(8(i+j)) Σ_jj dig_i[r, lane, jj] · NC_j[r][jj, m]
//
// The S-table word IS a fragment register. The instruction computes
// D[16 x 8] += A[16 x 32] · B[32 x 8]. Here A is a slab of the negacirculant
// turned on its side, A[row, k] = NC_j[k0 + k, m0 + row], and B the digits
// of the block's ROWS = 8 batch lanes, B[k, lane] = dig_i[lane, k0 + k]; so
// the 8 lanes are exactly N = 8 of the instruction. With gid = lane_id / 4
// and tig = lane_id % 4, A's register holds four consecutive k of one
// column: A[gid (+8)][4·tig .. 4·tig+3 (+16)] = NC_j[k0 + 4·tig + q (+16),
// m0 + gid (+8)], q = 0..3 — the four bytes of S-table word
// (k0 + 4·tig (+16) - m0 - gid (-8)) mod 2N (nc_common.cuh: word x packs
// rext[x..x+3]). One 32-bit shared load a register, no shuffle; the 32
// lanes of a warp read words 4·tig - gid, distinct or equal within a span
// of 20: no bank conflict. B's register is one word of the digit tile,
// whose rows are padded by DIG_PAD bytes so that the eight gid fall into
// eight different bank groups.
//
// Ten words feed four tiles. A warp owns MT = 4 neighbouring 16-column
// tiles (64 columns). A block owns COLS = min(N, 512) output columns from
// c0 (c0 = 0 up to N = 512; 0 or 512 at N = 1024, where two blocks share a
// row tile) and has COLS/64 warps; it still contracts over all N digit
// columns. Write W(e) = word (e + 4·tig - gid) and
// E = 32·kt - 64·warp - c0: tile q's fragment is (W(E-16q),
// W(E-16q-8), W(E-16q+16), W(E-16q+8)), so the four tiles together read
// the window v[p] = W(E + 16 - 8p), p = 0..9, and tile q takes (v[2q+2],
// v[2q+3], v[2q], v[2q+1]). One k-step later E grows by 32 and v[p]
// becomes v[p+4]: four new words a k-step and key plane, six
// carried in registers (the k-loop is unrolled by four, which turns most of
// the carrying into renaming). The k-loop runs inside the loop over key
// planes, so only one plane's window is live beside the 96 accumulators of
// JS = 2. A k-step of one plane is 4 + 2·ND shared loads for 4·ND mma.
//
// No index is ever masked: the table is stored ROTATED by N words (word x
// at (x + N) mod 2N) and every index a warp forms lies in [1-N, N-4] before
// the rotation (its columns c0 + 64·warp .. +63 lie in [0, N) whatever c0),
// so each load is base + immediate, the base stepping by 32 words a k-step.
// That range needs N >= 64. Every block stages the whole 2N-byte key row and
// builds the whole 2N-word S-table of each plane, split or not.
//
// Staging: per contraction row a block needs the 8-JS raw key rows (2N
// bytes each; contiguous in every layout but K7's and K8's, whose planes lie
// R·O·2N and B·R·O·2N bytes apart and are copied plane by plane,
// KEY_STRIDED) and, in K1, its
// ND x 8 digit rows (K9 at N = 1024 copies these from its cluster's shared
// memory itself: copy_dig below). Both come by cp.async
// (16 bytes a thread) into a second stage while the current row's mma run;
// the S-table words of the next row are built from the shared-memory copy
// (three aligned word loads and four __byte_perm per four words, one
// 16-byte store) by the same warps that then run the current row's mma, so
// builds and products of different warps overlap. One __syncthreads a row.
//
// Accumulation is the instruction's int32, which wraps (no .satfinite); the
// bucket bound of nc_common.cuh keeps every sum below 2^31 all the same.
#pragma once

#include <type_traits>

#include "nc_common.cuh"

namespace nc {

constexpr int MT = 4;         // 16-column tiles a warp owns
constexpr int DIG_PAD = 16;   // bytes added to each digit-tile row

constexpr int SPLIT_COLS = 512;   // the most output columns a block owns

// Threads of a block for polynomial size n >= 64: one warp per 64 of the
// block's min(n, SPLIT_COLS) columns.
__host__ __device__ inline int mma_threads(int n) {
  return (n < SPLIT_COLS ? n : SPLIT_COLS) / 2;
}

// Blocks that share a row tile's n output columns, SPLIT_COLS each: 2 at
// N = 1024, else 1 (K6, K7, K10b and K11 read theirs from blockIdx.z).
__host__ __device__ inline int column_blocks(int n) {
  return n > SPLIT_COLS ? n / SPLIT_COLS : 1;
}

// Bytes of one stage's S-tables, raw key rows and (K1) digit tile.
__host__ __device__ inline int tab_bytes(int nj, int n) {
  return nj * 2 * n * 4;
}
__host__ __device__ inline int raw_bytes(int nj, int n) { return nj * 2 * n; }
__host__ __device__ inline int dig_tile_bytes(int nd, int n) {
  return nd * ROWS * (n + DIG_PAD);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Start the copy of `bytes` contiguous bytes (a multiple of 16, both ends
// 16-byte aligned) into shared memory.
__device__ __forceinline__ void copy_async(unsigned char* dst,
                                           const int8_t* __restrict__ src,
                                           int bytes) {
  for (int at = threadIdx.x * 16; at < bytes; at += blockDim.x * 16)
    cp_async16(dst + at, src + at, 16);
}

// Start the copy of NJ key planes of 2N bytes, plane j from
// src + j*plane_stride (16-byte aligned), into dst one after the other.
template <int NJ>
__device__ __forceinline__ void copy_planes_async(
    unsigned char* dst, const int8_t* __restrict__ src, unsigned plane_stride,
    int n) {
  const int per_plane = n >> 3;             // 16-byte pieces a plane
  for (int idx = threadIdx.x; idx < NJ * per_plane; idx += blockDim.x) {
    const int j = idx / per_plane;
    cp_async16(dst + 16 * idx,
               src + (size_t)j * plane_stride + 16 * (idx - j * per_plane),
               16);
  }
}

// Start the copy of one contraction row's ND x ROWS digit rows of n bytes
// into a padded tile; rows at or past rows_valid fill with zeros. Plane i
// of lane `row` starts at src + i*plane_stride + row*lane_stride.
template <int ND>
__device__ __forceinline__ void copy_digits_async(
    unsigned char* tile, const int8_t* __restrict__ src,
    unsigned plane_stride, unsigned lane_stride, int rows_valid, int n) {
  const int per_row = n >> 4;
  for (int idx = threadIdx.x; idx < ND * ROWS * per_row; idx += blockDim.x) {
    const int chunk = idx % per_row;
    const int row = (idx / per_row) % ROWS;
    const int i = idx / (per_row * ROWS);
    const bool valid = row < rows_valid;
    cp_async16(tile + (i * ROWS + row) * (n + DIG_PAD) + 16 * chunk,
               src + (size_t)i * plane_stride +
                   (unsigned)(valid ? row : 0) * lane_stride + 16 * chunk,
               valid ? 16 : 0);
  }
}

// Build NJ rotated S-tables (2N words each) from NJ raw key rows of 2N
// bytes in shared memory. Table word x packs raw bytes (-x), (-x-1), (-x-2),
// (-x-3) mod 2N from its low byte up; the four words x = 4y..4y+3 come from
// the three aligned raw words at bytes -4y-8, -4y-4, -4y.
template <int NJ>
__device__ __forceinline__ void build_tables(uint32_t* tab,
                                             const unsigned char* raw, int n) {
  const int hw = n >> 1;             // raw words, and word groups, a plane
  const uint32_t* raw_w = reinterpret_cast<const uint32_t*>(raw);
  for (int g = threadIdx.x; g < NJ * hw; g += blockDim.x) {
    const int j = g / hw;
    const int y = g - j * hw;
    const uint32_t* p = raw_w + j * hw;
    const uint32_t w0 = p[(hw - y) & (hw - 1)];
    const uint32_t wm1 = p[(hw - y - 1) & (hw - 1)];
    const uint32_t wm2 = p[(hw - y - 2) & (hw - 1)];
    uint4 out;
    out.x = __byte_perm(wm1, w0, 0x1234);
    out.y = __byte_perm(wm1, wm1, 0x0123);
    out.z = __byte_perm(wm2, wm1, 0x3456);
    out.w = __byte_perm(wm2, wm1, 0x2345);
    *reinterpret_cast<uint4*>(tab + j * 2 * n + ((4 * y + n) & (2 * n - 1))) =
        out;
  }
}

// One contraction row into the buckets: acc[q][s] is the D fragment of the
// warp's tile q for weight 2^(8(s+JS)). `tab` holds the row's NJ rotated
// S-tables, `dig_w` its padded digit tile as words; the block's columns
// start at c0.
template <int ND, int JS>
__device__ __forceinline__ void mma_row(int32_t (&acc)[MT][8 - JS][4],
                                        const uint32_t* tab,
                                        const uint32_t* dig_w, int n,
                                        int c0 = 0) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int stride = (n + DIG_PAD) >> 2;          // words a digit-tile row
  const int ksteps = n >> 5;
  // v[p] of k-step kt is tab_j[at + 32·kt - 8p]
  const uint32_t* at0 = tab + n + 16 + 4 * tig - gid - 64 * warp - c0;
  const uint32_t* dig0 = dig_w + gid * stride + tig;
#pragma unroll
  for (int j = JS; j < 8; ++j) {
    const uint32_t* at = at0 + (j - JS) * 2 * n;
    const uint32_t* dg = dig0;
    uint32_t v[10];
#pragma unroll
    for (int p = 4; p < 10; ++p) v[p] = at[-8 * p];
#pragma unroll 4
    for (int kt = 0; kt < ksteps; ++kt) {
#pragma unroll
      for (int p = 0; p < 4; ++p) v[p] = at[-8 * p];
      uint32_t b[ND][2];
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        if (i + j < 8) {
          b[i][0] = dg[i * ROWS * stride];
          b[i][1] = dg[i * ROWS * stride + 4];
        }
      }
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        if (i + j < 8) {
#pragma unroll
          for (int q = 0; q < MT; ++q)
            mma_s8(acc[q][i + j - JS], v[2 * q + 2], v[2 * q + 3], v[2 * q],
                   v[2 * q + 1], b[i][0], b[i][1]);
        }
      }
#pragma unroll
      for (int p = 9; p >= 4; --p) v[p] = v[p - 4];
      at += 32;
      dg += 8;
    }
  }
}

// Shared memory of the contraction: two stages of S-tables, two of raw key
// rows and, when STAGE_DIG, two of digit tiles, in this order from `smem`.
// Without STAGE_DIG the digits of all R rows are resident at `dig_res`
// (R padded tiles of dig_tile_bytes each).
struct Staged {
  const int8_t* ext;   // row r's NJ key rows are contiguous at ext + r*raw_bytes
                       // or, with KEY_STRIDED (K7, K8), plane j of row r is
                       // at ext + r*ext_r + j*ext_plane
  const int8_t* dig;   // K1, K3, K5-K8, K10b: digit plane i of lane `row` at
                       // row r is at dig + r*dig_r + i*dig_plane +
                       // row*dig_lane
  unsigned dig_r, dig_plane;
  unsigned dig_lane;   // N where a lane's rows lie apart (K1, K3, K5), R·N in
                       // K6's, K7's and K8's batch-major and K10b's flat
                       // layouts
  const unsigned char* dig_res;   // K9 at N <= 512: the resident digit tiles
  unsigned ext_r = 0, ext_plane = 0;   // read with KEY_STRIDED only
};

// The block's output columns start at c0 (nonzero only where a row tile is
// split between blocks, N = 1024). With STAGE_DIG and a copy_dig (K9 at
// N = 1024, merged_wide.cu), copy_dig(tile, r) stages row r's digit tile
// in place of the cp.async from op.dig: a copy that is complete when it
// returns (the row's barrier then publishes it, as cp_async_wait_all does
// the others).
template <int ND, int JS, bool STAGE_DIG, bool KEY_STRIDED = false,
          typename CopyDig = std::nullptr_t>
__device__ __forceinline__ void contract_mma(int32_t (&acc)[MT][8 - JS][4],
                                             unsigned char* smem,
                                             const Staged& op, int R,
                                             int rows_valid, int n,
                                             int c0 = 0,
                                             CopyDig copy_dig = nullptr) {
  constexpr int NJ = 8 - JS;
  constexpr bool OWN_COPY = !std::is_same_v<CopyDig, std::nullptr_t>;
  const int tab_b = tab_bytes(NJ, n), raw_b = raw_bytes(NJ, n),
            dig_b = dig_tile_bytes(ND, n);
  unsigned char* tab = smem;
  unsigned char* raw = smem + 2 * tab_b;
  unsigned char* dig = raw + 2 * raw_b;
#pragma unroll
  for (int q = 0; q < MT; ++q)
#pragma unroll
    for (int s = 0; s < NJ; ++s)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[q][s][c] = 0;
  // start the copy of row r's NJ key rows into `dst`
  auto copy_keys = [&](unsigned char* dst, int r) {
    if constexpr (KEY_STRIDED)
      copy_planes_async<NJ>(dst, op.ext + (size_t)r * op.ext_r, op.ext_plane,
                            n);
    else
      copy_async(dst, op.ext + r * raw_b, raw_b);
  };

  copy_keys(raw, 0);
  if constexpr (STAGE_DIG && OWN_COPY)
    copy_dig(dig, 0);
  else if constexpr (STAGE_DIG)
    copy_digits_async<ND>(dig, op.dig, op.dig_plane, op.dig_lane,
                          rows_valid, n);
  if (R > 1) copy_keys(raw + raw_b, 1);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  build_tables<NJ>(reinterpret_cast<uint32_t*>(tab), raw, n);
  __syncthreads();
  for (int r = 0; r < R; ++r) {
    const int s = r & 1;
    // stage s holds row r's tables and digits, raw stage s^1 row r+1's key
    // rows; everything else was last read before the barrier just passed
    if constexpr (STAGE_DIG && OWN_COPY) {
      if (r + 1 < R) copy_dig(dig + (s ^ 1) * dig_b, r + 1);
    } else if constexpr (STAGE_DIG) {
      if (r + 1 < R)
        copy_digits_async<ND>(dig + (s ^ 1) * dig_b,
                              op.dig + (size_t)(r + 1) * op.dig_r,
                              op.dig_plane, op.dig_lane, rows_valid, n);
    }
    if (r + 2 < R) copy_keys(raw + s * raw_b, r + 2);
    cp_async_commit();
    if (r + 1 < R)
      build_tables<NJ>(reinterpret_cast<uint32_t*>(tab + (s ^ 1) * tab_b),
                       raw + (s ^ 1) * raw_b, n);
    const unsigned char* d =
        STAGE_DIG ? dig + s * dig_b : op.dig_res + r * dig_b;
    mma_row<ND, JS>(acc, reinterpret_cast<const uint32_t*>(tab + s * tab_b),
                    reinterpret_cast<const uint32_t*>(d), n, c0);
    cp_async_wait_all();
    __syncthreads();
  }
}

// The D fragment's map: register c of tile q of this thread is output
// column c0 + 64·warp + 16·q + gid + 8·(c / 2) of batch lane 2·tig + c % 2.
// Calls f(q, c, lane, column) for each of the thread's MT·4 registers.
template <typename F>
__device__ __forceinline__ void for_each_fragment(F f, int c0 = 0) {
  const int lane_id = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane_id >> 2, tig = lane_id & 3;
#pragma unroll
  for (int q = 0; q < MT; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      f(q, c, 2 * tig + (c & 1),
        c0 + 64 * warp + 16 * q + gid + 8 * (c >> 1));
}

// The epilogue: f(lane, column, sum) with the buckets recombined.
template <int JS, typename F>
__device__ __forceinline__ void for_each_output(
    const int32_t (&acc)[MT][8 - JS][4], F f, int c0 = 0) {
  for_each_fragment([&](int q, int c, int lane, int m) {
    int32_t bucket[8 - JS];
#pragma unroll
    for (int s = 0; s < 8 - JS; ++s) bucket[s] = acc[q][s][c];
    f(lane, m, recombine<JS>(bucket));
  }, c0);
}

}  // namespace nc
