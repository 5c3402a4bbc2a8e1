// K1's contraction on the warpgroup instruction (cmux_wg.cu), at N = 512
// and 1024: wgmma.mma_async.m64n32k32.s32.s8.s8 over 32-lane tiles, where
// nc_mma.cuh's mma.sync.m16n8k32 has 8-lane blocks. The function is
// nc_common.cuh's:
//
//   out[lane, m] = Σ_r Σ_{i, j>=JS} 2^(8(i+j)) Σ_jj dig_i[r, lane, jj] · NC_j[r][jj, m]
//
// Why: at N = 8 (8 batch lanes a block) mma.sync alone reaches 2/3 of the
// card's int8 peak, and each shared load or register move between two of
// them costs about a fifth of one (probes/mma_rate.cu). wgmma at N >= 32
// reaches the peak, reads its B operand from shared memory through a
// descriptor (no load instructions), and runs asynchronously beside the
// loads of the next A fragment.
//
// The instruction computes D[64 x 32] += A[64 x 32] · B[32 x 32] for one
// warpgroup (4 warps, 128 threads). A is a slab of the negacirculant, 64
// output columns by 32 k, from registers; B the digits of the block's 32
// batch lanes, the instruction's N, from shared memory.
//
// The shape. A warpgroup owns one 64-column tile with 8-JS buckets of 16
// int32 registers a thread (96 at JS = 2), and a block WGS = 2
// warpgroups: COLS = 128 columns, and the N/COLS blocks of one (lane
// tile, o) are one cluster: 4 at N = 512 (the card holds 30 such clusters
// at once, 120 of its 132 SMs), 8 at N = 1024, the largest portable
// cluster (15 at once, the same 120 SMs). Measured against it (PERF.md
// §6): a second tile a warpgroup (255 registers and spills), four
// warpgroups a block (128 registers and spills; all 132 SMs, in clusters
// of two).
//
// The unit of the pipeline is one (contraction row r, k-chunk) pair: the
// KC = 512 digit columns k0 .. k0 + KC - 1 of row r, one unit a row at
// N = 512, two at N = 1024 (k0 = 0, 512). A unit's stage and its unrolled
// KSTEPS = 16 k-steps are the same at both sizes, so every block that fits
// shared memory at N = 512 fits at 1024 (a whole row's stage at N = 1024
// would not: 237,568 bytes at ND = 2, JS = 0).
//
// A from the S-table words. Warp w of the warpgroup supplies A's rows
// 16w .. 16w+15 in mma.sync's fragment layout: thread (gid, tig) holds
// a0 = A[gid][4tig..+3], a1 = A[gid+8][4tig..], a2 = A[gid][16+4tig..],
// a3 = A[gid+8][16+4tig..]. Which output column a row stands for is ours
// to choose: in warpgroup g, row gid of warp w is column cA + gid and row
// gid+8 is column cA + gid - 16, with cA = c0 + 64·g + 16 + 8·(w & 1) +
// 32·(w >> 1) (so warps 0..3 cover columns 16..23 and 0..7, 24..31 and
// 8..15, 48..55 and 32..39, 56..63 and 40..47 of the warpgroup's 64).
// With NC[k, m] = byte 0 of S-table word (k - m) mod 2N and
// e = k0 + 32·kt + 4·tig - gid - cA at k-step kt of a unit, the four
// registers are the words W(e), W(e+16), W(e+16), W(e+32): word m =
// W(e0 + 16·m) of a thread's sequence (e0 at k-step 0), k-step kt takes
// words 2kt, 2kt+1, 2kt+1, 2kt+2. So a k-step of one key plane loads two
// new words a thread (k-step 0 three) and feeds them to ND instructions,
// one per digit limb i, each into bucket i + j - JS: two shared loads for
// ND·16·32·32 multiply-adds a warp, where nc::mma_row loads 4 + 2·ND words
// for ND·4·16·8·32.
//
// The S-table window. A block owns COLS output columns from c0 and a unit
// contracts over KC digit columns from k0, so it reads table words x in
// [1 + k0 - c0 - COLS, k0 + KC - 4 - c0] only: each plane's table is the
// window T[y] = W(y + k0 - c0 - COLS), y in [0, KC + COLS), built from the
// raw key bytes as nc::build_tables builds the whole table (four words from
// three raw words), never wrapped, c0 + COLS a multiple of 4. The raw bytes
// a unit stages are 2·KC a plane: at N = 512 the whole row, at N = 1024
// the slice of raw words w0 .. w0 + KC/2 - 1 (mod N/2) that starts
// TAB_WORDS/4 + 4 words before word -(k0 - c0 - COLS)/4, so that window
// group yw reads slice words TAB_WORDS/4 + 4 - yw - d, d = 0, 1, 2, all in
// [3, TAB_WORDS/4 + 4]; w0 is a multiple of 4, so each 16-byte piece of the
// slice is a piece of the row.
//
// B in wgmma's canonical K-major layout without swizzle: core matrices of
// 8 lanes x 16 bytes (k), 128 contiguous bytes, lane l of the core matrix
// at byte 16·l. Byte (lane, k) of digit limb i lies at
// i·DIG_PLANE + (k / 16)·K_CHUNK + lane·16 + k % 16 (k counted from the
// unit's k0): the leading byte offset (between core matrices along k) is
// K_CHUNK = 512, the stride byte offset (between the four 8-lane core
// matrices) 128, and a k-step's descriptor starts 2·K_CHUNK further on.
// Each 16-byte cp.async piece (lane, chunk) lands at chunk·512 + lane·16,
// so the copy that stages the digits also re-tiles them; a pair of threads
// takes the two 16-byte chunks of one 32-byte sector of a lane's row, so a
// warp reads 16 whole sectors and writes 2 x 256 contiguous bytes of shared
// memory.
//
// The pipeline. A k-step of every key plane is one commit group: its
// words loaded, wgmma.fence (the A registers were just written), its
// instructions (one a kept limb-plane pair (i, j), 11 at lvl64), commit,
// then wait_group DEPTH = 1, so that one group runs while the next one's
// words load. An instruction that accumulates into the registers of one
// still in the pipe waits for its result, so a k-step orders its planes
// with each bucket's two products (limb 1 of plane j, limb 0 of plane
// j + 1) apart, and both limbs of a plane, which share their A fragment,
// in turn. Measured at B = 2,048 (PERF.md, PR 20): a plane at a time,
// its k-steps into the same two buckets, held the step at 1.03-1.21
// ms whatever the group's size and depth; every plane a k-step, 0.97-0.99
// ms; the next group's words loaded before the wait, or two groups in
// flight, cost ptxas its registers (the instructions serialised, 1.50 ms).
// The k-loop and the plane loop are unrolled: every word is a value of its
// own, live until the wait that retires the last group reading it, and the
// accumulators are touched by nothing but wgmma between the zeroing and the
// final wait. The next unit's staging (its cp.async copies and table
// windows) runs in small steps after the unit's first commits, while those
// groups compute. Each unit ends with wait_group 0, before the barrier
// after which the next unit's digits land in the stage this unit's
// instructions read (and a group left in flight across the unit loop's
// back edge is one ptxas does not keep apart from the next unit's words:
// wrong results, measured); the cp.async data reaches the async proxy
// through fence.proxy.async before that barrier.
#pragma once

#include "nc_mma.cuh"

namespace nc {
namespace wg {

constexpr int KC = 512;           // digit columns of one unit
constexpr int LANES = 32;         // batch lanes of a block = N of the instruction
constexpr int KSTEPS = KC / 32;
constexpr int DIG_PLANE = LANES * KC;       // bytes of one limb's digit tile
constexpr int K_CHUNK = LANES * 16;         // leading byte offset
constexpr int LANE_GROUP = 128;             // stride byte offset
constexpr int ACC = LANES / 2;              // D registers a thread, a bucket

constexpr int WGS = 2;                      // warpgroups a block
constexpr int DEPTH = 1;         // commit groups left in flight at each wait
constexpr int THREADS = 128 * WGS;
constexpr int COLS = 64 * WGS;              // output columns a block owns
constexpr int TAB_WORDS = KC + COLS;        // one plane's table window

// The polynomial sizes the kernel is built for, and what N sets: the blocks
// of one (lane tile, o), which are one cluster, and the units of a row.
template <int N>
__host__ __device__ constexpr int cluster() {
  static_assert((N == 512 || N == 1024) && N % COLS == 0 && N / COLS <= 8,
                "a portable cluster of N/COLS blocks");
  return N / COLS;
}
template <int N>
__host__ __device__ constexpr int units() {
  return N / KC;
}

// Bytes of one stage (tables, raw key bytes, digit tiles; the same at
// every N) and of a block:
// two stages, or the [LANES][COLS] int64 tile of the new accumulator that
// takes their place for the glue, whichever is larger.
__host__ __device__ constexpr int stage_bytes(int nj, int nd) {
  return nj * TAB_WORDS * 4 + nj * 2 * KC + nd * DIG_PLANE;
}
__host__ __device__ constexpr int smem_bytes(int nj, int nd) {
  return 2 * stage_bytes(nj, nd) > LANES * COLS * 8 ? 2 * stage_bytes(nj, nd)
                                                    : LANES * COLS * 8;
}

__device__ __forceinline__ uint64_t digit_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)(K_CHUNK >> 4) << 16) |
         ((uint64_t)(LANE_GROUP >> 4) << 32);
}

__device__ __forceinline__ void mma_n32(int32_t (&d)[ACC], uint32_t a0,
                                        uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1));
}
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int G>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(G) : "memory");
}
// cp.async's writes made visible to the async proxy that wgmma reads by
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Start the copy of piece p of one unit's ND x LANES digit rows of KC
// bytes into the canonical tile (nothing past the last piece); lanes at or
// past rows_valid fill with zeros. Piece p: bit 0 and bits 6.. the 16-byte
// chunk, bits 1-5 the lane, above the chunks the limb. Limb i of lane
// `lane` starts at src + i*plane_stride + lane*lane_stride (src at the
// unit's k0).
template <int ND>
__device__ __forceinline__ void copy_digit_piece(
    unsigned char* tile, const int8_t* __restrict__ src,
    unsigned plane_stride, unsigned lane_stride, int rows_valid, int p) {
  constexpr int CHUNKS = KC / 16;
  if (p >= ND * LANES * CHUNKS) return;
  const int lane = (p >> 1) & (LANES - 1);
  const int c = ((p >> 6) & (CHUNKS / 2 - 1)) * 2 + (p & 1);
  const int i = p / (LANES * CHUNKS);
  const bool valid = lane < rows_valid;
  cp_async16(tile + i * DIG_PLANE + c * K_CHUNK + lane * 16,
             src + (size_t)i * plane_stride +
                 (unsigned)(valid ? lane : 0) * lane_stride + 16 * c,
             valid ? 16 : 0);
}

// The raw word (mod N/2) that a unit's staged slice starts at, N = 1024:
// TAB_WORDS/4 + 4 words before word -(k0 - c0 - COLS)/4, a multiple of 4.
__device__ __forceinline__ int raw_word0(int c0, int k0) {
  return ((c0 + COLS - k0) >> 2) - TAB_WORDS / 4 - 4;
}

// Start the copy of 16-byte piece p of one unit's raw key bytes, 2·KC a
// plane, from the NJ key rows of 2N bytes at `row` into `raw` (the caller
// stops at NJ·2·KC/16 pieces): at N = KC the whole rows, at N = 1024 the
// slice of KC/2 words from raw_word0 of each plane, wrapping mod N/2.
template <int N, int NJ>
__device__ __forceinline__ void copy_raw_piece(unsigned char* raw,
                                               const int8_t* __restrict__ row,
                                               int c0, int k0, int p) {
  if constexpr (N == KC) {
    cp_async16(raw + 16 * p, row + 16 * p, 16);
  } else {
    constexpr int PER_PLANE = KC / 8;      // 16-byte pieces of a slice
    const int j = p / PER_PLANE;
    const int w = (raw_word0(c0, k0) + 4 * (p - j * PER_PLANE)) & (N / 2 - 1);
    cp_async16(raw + 16 * p, row + (size_t)j * 2 * N + 4 * w, 16);
  }
}

// Build group g of NJ table windows (TAB_WORDS words each, four words a
// group; nothing past the last group) from a unit's raw key bytes, 2·KC a
// plane: window word y is S-table word x = y + k0 - c0 - COLS (mod 2N),
// and the four words of group yw of plane j are nc::build_tables' group
// yw + (k0 - c0 - COLS)/4 (mod N/2), read from the raw words -that, -that
// - 1 and -that - 2. y below is that group counted from the slice's first
// word: at N = 512 (the whole row, k0 = 0) yw - (c0 + COLS)/4 mod N/2; at
// N = 1024 yw - TAB_WORDS/4 - 4 (raw_word0), so no read wraps.
template <int N, int NJ>
__device__ __forceinline__ void build_window_group(uint32_t* tab,
                                                   const unsigned char* raw,
                                                   int c0, int g) {
  constexpr int SW = KC / 2, GROUPS = TAB_WORDS / 4;
  if (g >= NJ * GROUPS) return;
  const uint32_t* raw_w = reinterpret_cast<const uint32_t*>(raw);
  const int j = g / GROUPS;
  const int yw = g - j * GROUPS;
  const int y = N == KC ? (yw - ((c0 + COLS) >> 2)) & (SW - 1)
                        : yw - GROUPS - 4;
  const uint32_t* p = raw_w + j * SW;
  const uint32_t w0 = p[(SW - y) & (SW - 1)];
  const uint32_t wm1 = p[(SW - y - 1) & (SW - 1)];
  const uint32_t wm2 = p[(SW - y - 2) & (SW - 1)];
  uint4 out;
  out.x = __byte_perm(wm1, w0, 0x1234);
  out.y = __byte_perm(wm1, wm1, 0x0123);
  out.z = __byte_perm(wm2, wm1, 0x3456);
  out.w = __byte_perm(wm2, wm1, 0x2345);
  *reinterpret_cast<uint4*>(tab + j * TAB_WORDS + 4 * yw) = out;
}

// The next unit's staging, a thread's part in PREP_STEPS steps: step t
// starts the thread's t-th digit piece and 16 raw key bytes and builds its
// t-th table group.
template <int ND, int NJ>
__host__ __device__ constexpr int prep_steps() {
  constexpr int a = (ND * LANES * KC / 16 + THREADS - 1) / THREADS;
  constexpr int b = (NJ * 2 * KC / 16 + THREADS - 1) / THREADS;
  constexpr int c = (NJ * TAB_WORDS / 4 + THREADS - 1) / THREADS;
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// One unit into the buckets: acc[s] is the warpgroup's D fragment for
// weight 2^(8(s+JS)). `tab` holds the unit's NJ table windows, `desc`
// describes its digit tile (limb 0, k-step 0). prep(t) is called for
// t < prep_steps<ND, 8 - JS>(): after the commit of the unit's k-step t,
// so that the next unit's staging runs while the k-steps before it
// compute, and past the unit's last k-step after it.
template <int ND, int JS, typename Prep>
__device__ __forceinline__ void mma_unit(int32_t (&acc)[8 - JS][ACC],
                                         const uint32_t* tab, uint64_t desc,
                                         Prep prep) {
  constexpr int STEPS = prep_steps<ND, 8 - JS>();
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = threadIdx.x >> 7;
  const int gid = lane >> 2, tig = lane & 3;
  // word m of plane j is at0[(j - JS)·TAB_WORDS + 16·m] (e0 + 16·m - k0 +
  // c0 + COLS, the window's index)
  const uint32_t* at0 = tab + COLS - 64 * g - 16 - 8 * (warp & 1) -
                        32 * (warp >> 1) + 4 * tig - gid;
  uint32_t word[8 - JS][2 * KSTEPS + 1];
#pragma unroll
  for (int kt = 0; kt < KSTEPS; ++kt) {
    // k-step kt's words of every plane
#pragma unroll
    for (int j = JS; j < 8; ++j) {
      const uint32_t* at = at0 + (j - JS) * TAB_WORDS;
      if (kt == 0) word[j - JS][0] = at[0];
      word[j - JS][2 * kt + 1] = at[16 * (2 * kt + 1)];
      word[j - JS][2 * kt + 2] = at[16 * (2 * kt + 2)];
    }
    fence();
    // plane by plane, both limbs of a plane in turn (one A fragment, two
    // instructions), the planes with j - JS even first, then the odd ones:
    // the two products a bucket takes in a k-step, limb 1 of plane j and
    // limb 0 of plane j + 1, lie (8 - JS + 1) / 2 planes apart
#pragma unroll
    for (int p = 0; p < 8 - JS; ++p) {
      constexpr int HALF = (8 - JS + 1) / 2;
      const int j = JS + (p < HALF ? 2 * p : 2 * (p - HALF) + 1);
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        if (i + j < 8)
          mma_n32(acc[i + j - JS], word[j - JS][2 * kt],
                  word[j - JS][2 * kt + 1], word[j - JS][2 * kt + 1],
                  word[j - JS][2 * kt + 2],
                  desc + ((i * DIG_PLANE + kt * 2 * K_CHUNK) >> 4));
      }
    }
    commit();
    if (kt < STEPS) prep(kt);
    wait<DEPTH>();
  }
#pragma unroll
  for (int t = KSTEPS; t < STEPS; ++t) prep(t);
}

// The D fragment's map: register r of a thread is batch lane
// 8·(r / 4) + 2·tig + r % 2 and output column cA + gid - 16·((r / 2) % 2)
// (block-local: cA - c0). Calls f(lane, column, sum) with the buckets
// recombined, for each of the thread's ACC registers.
template <int JS, typename F>
__device__ __forceinline__ void for_each_output(
    const int32_t (&acc)[8 - JS][ACC], F f) {
  const int lane_id = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = threadIdx.x >> 7;
  const int gid = lane_id >> 2, tig = lane_id & 3;
  const int col = 64 * g + 16 + 8 * (warp & 1) + 32 * (warp >> 1) + gid;
#pragma unroll
  for (int r = 0; r < ACC; ++r) {
    int32_t bucket[8 - JS];
#pragma unroll
    for (int s = 0; s < 8 - JS; ++s) bucket[s] = acc[s][r];
    f(8 * (r >> 2) + 2 * tig + (r & 1), col - 16 * ((r >> 1) & 1),
      recombine<JS>(bucket));
  }
}

}  // namespace wg
}  // namespace nc
