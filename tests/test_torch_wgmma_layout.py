"""The index arithmetic of K1 on wgmma (csrc/cmux_wg.cu, csrc/nc_wgmma.cuh),
emulated in numpy and held against `extprod_step2g_plain`.

The kernel feeds `wgmma.mma_async.m64n32k32.s32.s8.s8`: operand A (64 rows,
from registers) is a slab of the negacirculant read from each plane's
S-table window of N + COLS words, operand B (32 columns, from shared memory
through a descriptor) the digits of the block's 32 batch lanes in the
canonical K-major layout. The emulation follows the device code: the window
build from the raw key row, the cp.async piece map that places the digits
in core matrices, the descriptor's leading and stride byte offsets, the A
fragment of each warp (rows 16·warp + gid and + 8, standing for columns
cA + gid and cA + gid - 16) from the thread's sequence of words 16 apart,
the D fragment map thread -> (column, lane), the accumulator tile and the
cluster's glue reads across the N / COLS blocks of a lane tile, and the
ragged last tile. The per-k-step products are summed over a row's k in one
float32 product (exact: every partial sum is an integer below 2^24), so the
file stays at a few seconds. Change an index in nc_wgmma.cuh or cmux_wg.cu
-> change it here first. Needs nothing of the JAX package.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_mma_layout import byte_perm, table_by_definition
from tfhe_aes2_tpu_torch.ops import decomposition, torus
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx

N, LANES = kx.WG_N, kx.WG_LANES
KSTEPS = N // 32
CHUNKS = N // 16                    # 16-byte chunks of a lane's digit row
DIG_PLANE = LANES * N               # bytes of one limb's digit tile
K_CHUNK, LANE_GROUP = LANES * 16, 128   # the descriptor's LBO and SBO
ACC = LANES // 2                    # D registers a thread, a bucket
LANE = np.arange(32)
GID, TIG = LANE >> 2, LANE & 3
CSRC = Path(kx.__file__).resolve().parents[2] / "csrc"
COLS = kx.WG_COLS                   # output columns of a block
WGS = COLS // 64                    # warpgroups of a block
CLUSTER = N // COLS                 # blocks of one (lane tile, o)
TAB = N + COLS                      # words of one plane's table window


def window_table(raw, c0):
    """The table windows as build_window stores them: raw int8 [..., 2N]
    (one plane's key row each), c0 int [...] or a scalar -> uint32
    [..., N + COLS]; group yw (words 4yw..4yw+3) from the three raw words
    of nc::build_tables' group (yw - (c0 + COLS)/4) mod N/2."""
    hw = N // 2
    raw_w = np.ascontiguousarray(raw).view(np.uint32)     # [..., N/2]
    lead = np.broadcast_shapes(raw_w.shape[:-1], np.shape(c0))
    raw_w = np.broadcast_to(raw_w, lead + (hw,))
    yw = np.arange(TAB // 4)
    y = (yw - (np.asarray(c0)[..., None] + COLS) // 4) % hw
    w0, wm1, wm2 = (np.take_along_axis(
        raw_w, np.broadcast_to((hw - y - d) % hw, lead + (TAB // 4,)), -1)
        for d in (0, 1, 2))
    tab = np.empty(lead + (TAB // 4, 4), dtype=np.uint32)
    tab[..., 0] = byte_perm(wm1, w0, 0x1234)
    tab[..., 1] = byte_perm(wm1, wm1, 0x0123)
    tab[..., 2] = byte_perm(wm2, wm1, 0x3456)
    tab[..., 3] = byte_perm(wm2, wm1, 0x2345)
    return tab.reshape(lead + (TAB,))


def word_index():
    """at0 of mma_row per (warpgroup, warp, lane): the window index of the
    thread's word 0, W(e0) with e0 = 4·tig - gid - cA at k-step 0, int
    [WGS, 4, 32]; word m lies 16·m further on."""
    g = np.arange(WGS)[:, None, None]
    w = np.arange(4)[None, :, None]
    return (COLS - 64 * g - 16 - 8 * (w & 1) - 32 * (w >> 1)
            + 4 * TIG - GID)


def _a_slots():
    """Where each byte of a warp's four A registers sits in the 64 x 32 A
    of the warpgroup: rows 16·warp + gid (+8 for a1, a3), k 4·tig + q
    (+16 for a2, a3), as mma.sync's A fragment; flat [4, 32, 4, 4]."""
    w, lane, reg, q = np.meshgrid(np.arange(4), LANE, np.arange(4),
                                  np.arange(4), indexing="ij")
    return ((16 * w + GID[lane] + 8 * (reg & 1)) * 32
            + 4 * TIG[lane] + q + 16 * (reg >> 1))


def _d_slots():
    """Where D register r of a thread sits in the 64 x 32 D: row 16·warp +
    gid + 8·((r / 2) % 2), column 8·(r / 4) + 2·tig + r % 2; flat
    [4, 32, ACC]."""
    w, lane, r = np.meshgrid(np.arange(4), LANE, np.arange(ACC),
                             indexing="ij")
    return ((16 * w + GID[lane] + 8 * ((r >> 1) & 1)) * 32
            + 8 * (r >> 2) + 2 * TIG[lane] + (r & 1))


A_AT, D_AT = _a_slots(), _d_slots()
A_FROM = np.argsort(A_AT.reshape(-1))     # the register byte of each A slot
assert np.array_equal(np.sort(A_AT.reshape(-1)), np.arange(64 * 32))


def a_operand(tabs):
    """A of every k-step of one plane, as the warps load it: tabs uint32
    [..., TAB] (one window per block) -> int8 [..., WGS, 64, N] (row,
    k = 32·kt + k of the k-step). K-step kt takes the thread's words 2kt,
    2kt+1, 2kt+1, 2kt+2 (a0 .. a3): word 0 loaded before k-step 0, words
    2kt+1 and 2kt+2 at k-step kt."""
    at0 = word_index()
    m = 2 * np.arange(KSTEPS)                               # [KT]
    idx = at0[None] + 16 * m[:, None, None, None]           # [KT, WGS, 4, 32]
    assert idx.min() >= 0 and idx.max() + 32 < TAB, \
        "the A words leave the window"
    regs = np.stack([idx, idx + 16, idx + 16, idx + 32], -1)
    words = tabs[..., regs]                  # [..., KT, WGS, 4, 32, 4]
    by = np.ascontiguousarray(words).view(np.int8)   # byte q at bits 8q
    lead = words.shape[:-3]                  # [..., KT, WGS]
    a = by.reshape(lead + (-1,))[..., A_FROM]
    a = a.reshape(lead + (64, 32))           # [..., KT, WGS, 64, 32]
    a = np.moveaxis(a, -4, -3)               # [..., WGS, KT, 64, 32]
    a = np.swapaxes(a, -3, -2)               # [..., WGS, 64, KT, 32]
    return a.reshape(a.shape[:-2] + (N,))    # [..., WGS, 64, N]


def digit_tile(dig_rows, rows_valid):
    """One contraction row's digit tile as copy_digits stages it: dig_rows
    int8 [n_d, LANES, N] (lanes past the batch anything) -> the shared
    bytes, uint8 [n_d·DIG_PLANE]: piece p (bit 0 and bits 6.. the chunk,
    bits 1-5 the lane, above them the limb) lands at i·DIG_PLANE +
    chunk·K_CHUNK + lane·16, zero past rows_valid."""
    n_d = dig_rows.shape[0]
    p = np.arange(n_d * LANES * CHUNKS)
    lane = (p >> 1) & (LANES - 1)
    c = ((p >> 6) & (CHUNKS // 2 - 1)) * 2 + (p & 1)
    i = p // (LANES * CHUNKS)
    dst = i * DIG_PLANE + c * K_CHUNK + lane * 16
    assert np.array_equal(np.sort(dst), 16 * np.arange(p.size))
    tile = np.full(n_d * DIG_PLANE, 0xAA, dtype=np.uint8)
    pieces = dig_rows.view(np.uint8).reshape(n_d, LANES, CHUNKS, 16)[
        i, lane, c]
    pieces[lane >= rows_valid] = 0
    tile[dst[:, None] + np.arange(16)] = pieces
    return tile


def b_operand(tile, i, kt):
    """B of limb i at k-step kt as wgmma reads it through the descriptor
    (start i·DIG_PLANE + kt·2·K_CHUNK, LBO = K_CHUNK, SBO = LANE_GROUP):
    byte (k, n) at start + (k/16)·LBO + (n/8)·SBO + (n%8)·16 + k%16,
    int8 [32 k, 32 n]."""
    k = np.arange(32)[:, None]
    n = np.arange(32)[None, :]
    at = (i * DIG_PLANE + kt * 2 * K_CHUNK + (k // 16) * K_CHUNK
          + (n // 8) * LANE_GROUP + (n % 8) * 16 + k % 16)
    return tile[at].view(np.int8)


def output_map():
    """The D fragment's map (for_each_output): register r of a thread is
    lane 8·(r/4) + 2·tig + r%2 and block column 64·g + 16 + 8·(w&1) +
    32·(w>>1) + gid - 16·((r/2)%2); (lane, column) int [WGS, 4, 32, ACC]
    each, every (lane, column) of the block once."""
    g, w, lane, r = np.meshgrid(np.arange(WGS), np.arange(4), LANE,
                                np.arange(ACC), indexing="ij")
    out_lane = 8 * (r >> 2) + 2 * TIG[lane] + (r & 1)
    out_col = (64 * g + 16 + 8 * (w & 1) + 32 * (w >> 1) + GID[lane]
               - 16 * ((r >> 1) & 1))
    hits = np.zeros((LANES, COLS), dtype=int)
    np.add.at(hits, (out_lane, out_col), 1)
    assert (hits == 1).all()
    return out_lane, out_col


def emulate(dig, ext, acc, t, base_log, levels, js):
    """K1 on wgmma, block by block as the kernel computes it: dig int8
    [O, L, n_d, B, N], ext int8 [O, R, 8-js, 2N], acc int64 [O, B, N],
    t int [B] -> (new acc, the glue's rotated differences int64 [O, B, N],
    each read from the tile of the cluster rank that owns its source, and
    how often each rank was read)."""
    k1, lv, n_d, b, _ = dig.shape
    r_cnt, nj = ext.shape[1], 8 - js
    tiles = -(-b // LANES)
    c0s = COLS * np.arange(CLUSTER)
    dig_rows = dig.reshape(r_cnt, n_d, b, N)
    # buckets as D fragments: [nj, O, lane tiles, CLUSTER, WGS, 4, 32, ACC]
    buckets = np.zeros((nj, k1, tiles, CLUSTER, WGS, 4, 32, ACC),
                       dtype=np.int64)
    for r in range(r_cnt):
        b_full = np.empty((n_d, tiles, N, 32), dtype=np.float32)  # [i,T,k,n]
        for tl in range(tiles):
            rows = min(LANES, b - LANES * tl)
            pad = np.full((n_d, LANES, N), 77, dtype=np.int8)   # never read
            pad[:, :rows] = dig_rows[r, :, LANES * tl:LANES * tl + rows]
            tile = digit_tile(pad, rows)
            for i in range(n_d):
                b_full[i, tl] = np.concatenate(
                    [b_operand(tile, i, kt) for kt in range(KSTEPS)])
        windows = window_table(ext[:, r, :, None], c0s)   # [O, NJ, CL, TAB]
        for j in range(js, 8):
            # [O, 1, CL, WGS, 64, N]
            a_full = a_operand(windows[:, j - js]).astype(np.float32)[
                :, None]
            for i in range(n_d):
                if i + j >= 8:
                    continue
                d = a_full @ b_full[i][None, :, None, None]
                frag = d.reshape(d.shape[:-2] + (-1,))[..., D_AT]
                buckets[i + j - js] += frag.astype(np.int64)
    assert np.abs(buckets).max() < 2 ** 31      # the int32 buckets hold it
    total = np.zeros(buckets.shape[1:], dtype=np.uint64)
    with np.errstate(over="ignore"):
        for s in range(nj):
            total += buckets[s].view(np.uint64) << np.uint64(8 * (s + js))
    out_lane, out_col = output_map()
    sums = np.zeros((k1, tiles, CLUSTER, LANES, COLS), dtype=np.uint64)
    sums[..., out_lane, out_col] = total
    # the accumulator's read-modify-write through the tile, zero past the
    # batch edge
    new = acc.copy().view(np.uint64)
    tile_acc = np.zeros_like(sums)
    with np.errstate(over="ignore"):
        for tl in range(tiles):
            rows = min(LANES, b - LANES * tl)
            for h, c0 in enumerate(c0s):
                seg = new[:, LANES * tl:LANES * tl + rows, c0:c0 + COLS]
                seg += sums[:, tl, h, :rows]
                tile_acc[:, tl, h, :rows] = seg
    # the glue: block h of the cluster reads source x from the tile of rank
    # x // COLS at row·COLS + x % COLS
    rot_diff = np.zeros((k1, b, N), dtype=np.uint64)
    reads = np.zeros(CLUSTER, dtype=int)
    with np.errstate(over="ignore"):
        for tl in range(tiles):
            rows = min(LANES, b - LANES * tl)
            for h, c0 in enumerate(c0s):
                row = np.arange(rows)[:, None]
                m = c0 + np.arange(COLS)[None, :]
                src = (m - t[LANES * tl + row]) & (2 * N - 1)
                x = src & (N - 1)
                owner = x // COLS
                np.add.at(reads, owner.reshape(-1), k1)
                v = tile_acc[:, tl][:, owner, row, x % COLS]
                rot = np.where(src < N, v, np.uint64(0) - v)
                rot_diff[:, LANES * tl:LANES * tl + rows, c0:c0 + COLS] = (
                    rot - tile_acc[:, tl, h, :rows])
    return new.view(np.int64), rot_diff.view(np.int64), reads


def step_operands(b, seed, k1=5, lv=3, n_d=2, js=2, base_log=12, fill=None):
    """A step at N = 512, by default PARAMS_SQRD_LVL_64's (k+1 = 5, L = 3,
    n_d = 2, js = 2, base_log 12); random, or every byte `fill`."""
    rng = np.random.default_rng(seed)
    if fill is None:
        dig = rng.integers(-128, 128, (k1, lv, n_d, b, N), dtype=np.int8)
        ext = rng.integers(-128, 128, (k1, k1 * lv, 8 - js, 2 * N),
                           dtype=np.int8)
    else:
        dig = np.full((k1, lv, n_d, b, N), fill, dtype=np.int8)
        ext = np.full((k1, k1 * lv, 8 - js, 2 * N), fill, dtype=np.int8)
    acc = rng.integers(-2 ** 63, 2 ** 63, (k1, b, N), dtype=np.int64)
    t = rng.integers(0, 2 * N, b)
    t[:4] = [0, 1, N, 2 * N - 1][:b]
    return dig, ext, acc, t, base_log, lv, js


def check_against_plain(dig, ext, acc, t, base_log, levels, js):
    n_d = dig.shape[2]
    want_acc, want_dig = kx.extprod_step2g_plain(
        torch.from_numpy(dig), torch.from_numpy(ext),
        torch.from_numpy(acc.copy()), torch.from_numpy(t).to(torch.int32),
        base_log, levels, js)
    got_acc, rot_diff, reads = emulate(dig, ext, acc, t, base_log, levels,
                                       js)
    assert np.array_equal(got_acc, want_acc.numpy())
    digits = decomposition.decompose(torch.from_numpy(rot_diff), base_log,
                                     levels)
    got_dig = torus.split_int32_signed(digits, n_d).permute(1, 4, 0, 2, 3)
    assert torch.equal(got_dig, want_dig)
    return reads


def test_wgmma_k1_matches_plain_at_lvl64():
    """A whole step at lvl64's shapes, emulated block by block (B = 40: a
    full lane tile and a ragged one of 8 lanes), equals
    extprod_step2g_plain bit for bit: the new accumulator and the next
    step's digits; the glue reads every rank of the cluster."""
    reads = check_against_plain(*step_operands(40, 60))
    assert (reads > 0).all()


def test_wgmma_k1_matches_plain_at_the_tree_models_step():
    """js = 1 and one limb a digit (the tree model's; 7 buckets), at
    B = 37: bit-equal to plain."""
    check_against_plain(*step_operands(37, 61, k1=2, lv=2, n_d=1, js=1,
                                       base_log=6))


def test_wgmma_k1_extreme_values():
    """Every digit and key byte -128 at R = 15 (one component, 15 levels
    of base 2^4): each int32 bucket at n_d·R·N·2^14, the bound the wrapper
    admits, reproduced exactly, with a ragged tile of 13 lanes."""
    check_against_plain(*step_operands(13, 7, k1=1, lv=15, base_log=4,
                                       fill=-128))


def test_table_window_is_the_s_table():
    """Every block's window (c0 its first column) holds S-table words
    x = y - c0 - COLS for y in [0, N + COLS), unwrapped; the A words of
    every warp and k-step lie inside it."""
    rng = np.random.default_rng(2)
    raw = rng.integers(-128, 128, 2 * N, dtype=np.int8)
    full = table_by_definition(raw, N)                  # word x at x + N
    y = np.arange(TAB)
    for c0 in range(0, N, COLS):
        assert np.array_equal(window_table(raw, c0),
                              full[(y - c0 - COLS + N) % (2 * N)])
    at0 = word_index()
    assert at0.min() >= 1 and (at0 + 16 * 2 * KSTEPS).max() <= TAB - 4


def test_a_fragment_is_the_negacirculant_slab():
    """A[row, k] of warpgroup g is NC[k, column(row)] =
    ext[(column - k) mod 2N], column(16w + gid) = cA + gid and
    column(16w + gid + 8) = cA + gid - 16, block-local cA = 64·g + 16 +
    8·(w&1) + 32·(w>>1); the rows of a warpgroup are its 64 columns once
    each."""
    rng = np.random.default_rng(3)
    raw = rng.integers(-128, 128, 2 * N, dtype=np.int8)
    for c0 in (0, N - COLS):
        a = a_operand(window_table(raw, c0))            # [WGS, 64, N]
        for g in range(WGS):
            w = np.arange(4)[:, None]
            ca = 64 * g + 16 + 8 * (w & 1) + 32 * (w >> 1)
            col = np.concatenate([ca + np.arange(8), ca - 16 + np.arange(8)],
                                 axis=1).reshape(-1)     # by row
            assert np.array_equal(np.sort(col), 64 * g + np.arange(64))
            k = np.arange(N)
            want = raw[(c0 + col[:, None] - k[None, :]) % (2 * N)]
            assert np.array_equal(a[g], want)


def test_digit_tile_core_matrices():
    """The staged digit tile read through the descriptor is the digits:
    B[k, n] of limb i at k-step kt is dig_i[lane n, 32·kt + k], lanes past
    the batch zero; each 8-lane core matrix is 128 contiguous bytes."""
    rng = np.random.default_rng(4)
    dig = rng.integers(-128, 128, (2, LANES, N), dtype=np.int8)
    tile = digit_tile(dig, 27)
    for i in range(2):
        for kt in (0, 7, KSTEPS - 1):
            got = b_operand(tile, i, kt)
            want = dig[i, :, 32 * kt:32 * kt + 32].T.copy()
            want[:, 27:] = 0
            assert np.array_equal(got, want)
    core = tile[:128].view(np.int8).reshape(8, 16)      # lanes 0-7, k 0-15
    assert np.array_equal(core, dig[0, :8, :16])


def test_dispatch_chooses_the_path_from_n_and_b():
    """k1_path: wgmma at N = 512 from WG_MIN_LANES lanes up, mma.sync below
    it and at every other N; the shape constants are the CUDA source's and
    every block fits the card's shared memory and a portable cluster."""
    for b in (kx.WG_MIN_LANES, 9, 32, 40, 288, 2048):
        assert kx.k1_path(512, b) == "wgmma"
    for b in range(1, kx.WG_MIN_LANES):
        assert kx.k1_path(512, b) == "mma.sync"
    for n in (64, 256, 1024):
        for b in (1, 288, 2048):
            assert kx.k1_path(n, b) == "mma.sync"
    src = (CSRC / "nc_wgmma.cuh").read_text()
    assert int(re.search(r"constexpr int N = (\d+);", src).group(1)) == N
    assert int(re.search(r"constexpr int LANES = (\d+);", src).group(1)) \
        == LANES
    assert 64 * int(re.search(r"constexpr int WGS = (\d+);", src).group(1)) \
        == COLS
    assert N % COLS == 0 and CLUSTER <= 8
    for js in range(8):
        for n_d in (1, 2, 3):
            assert kx._k1_wg_smem(8 - js, n_d) <= kx.SMEM_LIMIT


def test_wrapper_counts_the_wgmma_launches_apart():
    """On the CPU the wrapper runs the plain version and counts no launch
    of either kernel."""
    dig, ext, acc, t, bl, lv, js = step_operands(33, 5)
    before = (kx.extprod_step2g.launches, kx.extprod_step2g.launches_wg)
    kx.extprod_step2g(torch.from_numpy(dig[:, :, :, :1]),
                      torch.from_numpy(ext), torch.from_numpy(acc[:, :1]),
                      torch.from_numpy(t[:1]).to(torch.int32), bl, lv, js)
    assert (kx.extprod_step2g.launches, kx.extprod_step2g.launches_wg) \
        == before
