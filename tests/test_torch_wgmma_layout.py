"""The index arithmetic of K1 on wgmma (csrc/cmux_wg.cu, csrc/nc_wgmma.cuh),
emulated in numpy and held against `extprod_step2g_plain`, at each
polynomial size the kernel is built for (N = 512 and 1024).

The kernel feeds `wgmma.mma_async.m64n32k32.s32.s8.s8`: operand A (64 rows,
from registers) is a slab of the negacirculant read from each plane's
S-table window of KC + COLS words, operand B (32 columns, from shared
memory through a descriptor) the digits of the block's 32 batch lanes in
the canonical K-major layout. A block contracts unit by unit, a unit the
KC = 512 digit columns from k0 of one row (one a row at N = 512, two at
1024). The emulation follows the device code: the raw key bytes a unit
stages (the whole row at N = 512, a slice of it at 1024) and the window
built from them, the cp.async piece map that places the digits in core
matrices, the descriptor's leading and stride byte offsets, the A fragment
of each warp (rows 16·warp + gid and + 8, standing for columns cA + gid and
cA + gid - 16) from the thread's sequence of words 16 apart, the D
fragment map thread -> (column, lane), the accumulator tile and the
cluster's glue reads across the N / COLS blocks of a lane tile, and the
ragged last tile. The per-k-step products are summed over a unit's k in
one float32 product (exact: every partial sum is an integer below 2^24),
so the file stays at seconds. Change an index in nc_wgmma.cuh or
cmux_wg.cu -> change it here first. Needs nothing of the JAX package.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_mma_layout import byte_perm, table_by_definition
from tfhe_aes2_tpu_torch.ops import decomposition, polynomial, torus
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx

LANES, KC = kx.WG_LANES, kx.WG_KC
KSTEPS = KC // 32                   # k-steps of a unit
CHUNKS = KC // 16                   # 16-byte chunks of a lane's unit row
DIG_PLANE = LANES * KC              # bytes of one limb's digit tile
K_CHUNK, LANE_GROUP = LANES * 16, 128   # the descriptor's LBO and SBO
ACC = LANES // 2                    # D registers a thread, a bucket
LANE = np.arange(32)
GID, TIG = LANE >> 2, LANE & 3
CSRC = Path(kx.__file__).resolve().parents[2] / "csrc"
COLS = kx.WG_COLS                   # output columns of a block
WGS = COLS // 64                    # warpgroups of a block
TAB = KC + COLS                     # words of one plane's table window
SIZES = sorted(kx.WG_N)             # 512, 1024


def raw_word0(c0, k0):
    """nc_wgmma.cuh's raw_word0: at N = 1024 the raw word (mod N/2) that a
    unit's staged slice starts at."""
    return (c0 + COLS - k0) // 4 - TAB // 4 - 4


def unit_raw(raw_w, n, c0, k0):
    """The raw key words a unit stages (copy_raw_piece): raw_w uint32
    [..., N/2] (one plane's row each), c0 int [...] -> uint32 [..., KC/2]:
    the whole row at N = KC, else by 16-byte pieces the slice of KC/2 words
    from raw_word0 (mod N/2), no piece across the wrap."""
    if n == KC:
        return raw_w
    w = (raw_word0(c0, k0)[..., None] + 4 * np.arange(KC // 8)) % (n // 2)
    assert (w % 4 == 0).all()
    idx = (w[..., None] + np.arange(4)).reshape(w.shape[:-1] + (KC // 2,))
    return np.take_along_axis(raw_w, idx, -1)


def window_table(raw, c0, n, k0=0):
    """The table windows as build_window_group stores them for the unit at
    k0: raw int8 [..., 2N] (one plane's key row each), c0 int [...] or a
    scalar -> uint32 [..., KC + COLS]; group yw (words 4yw..4yw+3) from
    three staged words, slice word (SW - y - d) mod SW, d = 0, 1, 2, with
    y = (yw - (c0 + COLS)/4) mod SW at N = 512 and yw - TAB/4 - 4 at 1024
    (SW = KC/2 staged words a plane)."""
    sw = KC // 2
    raw_w = np.ascontiguousarray(raw).view(np.uint32)     # [..., N/2]
    lead = np.broadcast_shapes(raw_w.shape[:-1], np.shape(c0))
    raw_w = np.broadcast_to(raw_w, lead + (n // 2,))
    c0 = np.broadcast_to(np.asarray(c0), lead)
    staged = unit_raw(raw_w, n, c0, k0)                   # [..., SW]
    yw = np.arange(TAB // 4)
    y = ((yw - (c0[..., None] + COLS) // 4) % sw if n == KC
         else np.broadcast_to(yw - TAB // 4 - 4, lead + (TAB // 4,)))
    w0, wm1, wm2 = (np.take_along_axis(staged, (sw - y - d) % sw, -1)
                    for d in (0, 1, 2))
    tab = np.empty(lead + (TAB // 4, 4), dtype=np.uint32)
    tab[..., 0] = byte_perm(wm1, w0, 0x1234)
    tab[..., 1] = byte_perm(wm1, wm1, 0x0123)
    tab[..., 2] = byte_perm(wm2, wm1, 0x3456)
    tab[..., 3] = byte_perm(wm2, wm1, 0x2345)
    return tab.reshape(lead + (TAB,))


def word_index():
    """at0 of mma_unit per (warpgroup, warp, lane): the window index of the
    thread's word 0, W(e0) with e0 = k0 + 4·tig - gid - cA at k-step 0, int
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
    [..., TAB] (one window per block) -> int8 [..., WGS, 64, KC] (row,
    k = 32·kt + k of the k-step, counted from the unit's k0). K-step kt
    takes the thread's words 2kt, 2kt+1, 2kt+1, 2kt+2 (a0 .. a3): word 0
    loaded before k-step 0, words 2kt+1 and 2kt+2 at k-step kt."""
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
    return a.reshape(a.shape[:-2] + (KC,))   # [..., WGS, 64, KC]


def digit_tile(dig_rows, rows_valid):
    """One unit's digit tile as copy_digit_piece stages it: dig_rows int8
    [n_d, LANES, KC] (the unit's columns; lanes past the batch anything)
    -> the shared
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
    """K1 on wgmma, block by block and unit by unit as the kernel computes
    it: dig int8 [O, L, n_d, B, N], ext int8 [O, R, 8-js, 2N], acc int64
    [O, B, N], t int [B] -> (new acc, the glue's rotated differences int64
    [O, B, N], each read from the tile of the cluster rank that owns its
    source, how often each rank was read, and how many reads were negated,
    src >= N)."""
    k1, lv, n_d, b, n = dig.shape
    r_cnt, nj = ext.shape[1], 8 - js
    cluster = n // COLS
    tiles = -(-b // LANES)
    c0s = COLS * np.arange(cluster)
    dig_rows = dig.reshape(r_cnt, n_d, b, n)
    # buckets as D fragments: [nj, O, lane tiles, cluster, WGS, 4, 32, ACC]
    buckets = np.zeros((nj, k1, tiles, cluster, WGS, 4, 32, ACC),
                       dtype=np.int64)
    for r in range(r_cnt):
        for k0 in range(0, n, KC):
            b_full = np.empty((n_d, tiles, KC, 32), dtype=np.float32)
            for tl in range(tiles):
                rows = min(LANES, b - LANES * tl)
                pad = np.full((n_d, LANES, KC), 77, dtype=np.int8)  # unread
                pad[:, :rows] = dig_rows[r, :, LANES * tl:LANES * tl + rows,
                                         k0:k0 + KC]
                tile = digit_tile(pad, rows)
                for i in range(n_d):
                    b_full[i, tl] = np.concatenate(
                        [b_operand(tile, i, kt) for kt in range(KSTEPS)])
            # [O, NJ, cluster, TAB]
            windows = window_table(ext[:, r, :, None], c0s, n, k0)
            for j in range(js, 8):
                # [O, 1, cluster, WGS, 64, KC]
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
    sums = np.zeros((k1, tiles, cluster, LANES, COLS), dtype=np.uint64)
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
    # the glue, lane tile by lane tile
    rot_diff = np.zeros((k1, b, n), dtype=np.uint64)
    reads = np.zeros(cluster, dtype=int)
    negated = 0
    with np.errstate(over="ignore"):
        for tl in range(tiles):
            rows = min(LANES, b - LANES * tl)
            lanes = slice(LANES * tl, LANES * tl + rows)
            own = tile_acc[:, tl, :, :rows]
            rot, by_rank, neg = cluster_glue(own, t[lanes])
            reads += by_rank.sum(axis=0)
            negated += neg
            rot_diff[:, lanes] = rot - own.transpose(0, 2, 1, 3).reshape(
                k1, rows, n)
    return new.view(np.int64), rot_diff.view(np.int64), reads, negated


def cluster_glue(tiles, t):
    """The rotated sources of K1 on wgmma's glue for one lane tile: tiles
    uint64 [O, cluster, rows, COLS], rank h's tile of the new accumulator
    (its COLS columns from COLS·h); t [rows] -> (X^t·acc uint64 [O, rows,
    N], block h's column m read as source x = src mod N, src = (m - t) mod
    2N, from the tile of rank x // COLS at row·COLS + x % COLS, negated
    where src >= N; reads int [cluster, cluster], how often block h read
    rank g's tile at [h, g]; how many reads were negated)."""
    k1, cluster, rows, _ = tiles.shape
    n = cluster * COLS
    row = np.arange(rows)[:, None]
    rot = np.zeros((k1, rows, n), dtype=np.uint64)
    reads = np.zeros((cluster, cluster), dtype=int)
    negated = 0
    with np.errstate(over="ignore"):
        for h in range(cluster):
            m = COLS * h + np.arange(COLS)[None, :]
            src = (m - t[:, None]) & (2 * n - 1)
            x = src & (n - 1)
            owner = x // COLS
            np.add.at(reads[h], owner.reshape(-1), k1)
            negated += k1 * int((src >= n).sum())
            v = tiles[:, owner, row, x % COLS]
            rot[:, :, COLS * h:COLS * (h + 1)] = np.where(src < n, v,
                                                         np.uint64(0) - v)
    return rot, reads, negated


def step_operands(b, seed, n=512, k1=5, lv=3, n_d=2, js=2, base_log=12,
                  fill=None):
    """A step at polynomial size n, by default PARAMS_SQRD_LVL_64's
    (N = 512, k+1 = 5, L = 3, n_d = 2, js = 2, base_log 12); random, or
    every byte `fill`."""
    rng = np.random.default_rng(seed)
    if fill is None:
        dig = rng.integers(-128, 128, (k1, lv, n_d, b, n), dtype=np.int8)
        ext = rng.integers(-128, 128, (k1, k1 * lv, 8 - js, 2 * n),
                           dtype=np.int8)
    else:
        dig = np.full((k1, lv, n_d, b, n), fill, dtype=np.int8)
        ext = np.full((k1, k1 * lv, 8 - js, 2 * n), fill, dtype=np.int8)
    acc = rng.integers(-2 ** 63, 2 ** 63, (k1, b, n), dtype=np.int64)
    t = rng.integers(0, 2 * n, b)
    t[:4] = [0, 1, n, 2 * n - 1][:b]
    return dig, ext, acc, t, base_log, lv, js


def check_against_plain(dig, ext, acc, t, base_log, levels, js):
    n_d = dig.shape[2]
    want_acc, want_dig = kx.extprod_step2g_plain(
        torch.from_numpy(dig), torch.from_numpy(ext),
        torch.from_numpy(acc.copy()), torch.from_numpy(t).to(torch.int32),
        base_log, levels, js)
    got_acc, rot_diff, reads, negated = emulate(dig, ext, acc, t, base_log,
                                                levels, js)
    assert np.array_equal(got_acc, want_acc.numpy())
    digits = decomposition.decompose(torch.from_numpy(rot_diff), base_log,
                                     levels)
    got_dig = torus.split_int32_signed(digits, n_d).permute(1, 4, 0, 2, 3)
    assert torch.equal(got_dig, want_dig)
    return reads, negated


def test_wgmma_k1_matches_plain_at_lvl64():
    """A whole step at lvl64's shapes, emulated block by block (B = 40: a
    full lane tile and a ragged one of 8 lanes), equals
    extprod_step2g_plain bit for bit: the new accumulator and the next
    step's digits; the glue reads every rank of the cluster."""
    reads, _ = check_against_plain(*step_operands(40, 60))
    assert (reads > 0).all()


def test_wgmma_k1_matches_plain_at_the_tree_models_step():
    """js = 1 and one limb a digit (the tree model's; 7 buckets), at
    B = 37: bit-equal to plain."""
    check_against_plain(*step_operands(37, 61, k1=2, lv=2, n_d=1, js=1,
                                       base_log=6))


@pytest.mark.parametrize("b", [33, 40])
def test_wgmma_k1_matches_plain_at_lvl256(b):
    """PARAMS_SQRD_LVL_256's step at N = 1024 (k+1 = 3, L = 4, n_d = 2,
    js = 2, base_log 9: R = 12 rows of two units each), across the 32-lane
    tile edge: bit-equal to plain; the glue reads all 8 ranks of the
    cluster, some of them negated (src >= N)."""
    reads, negated = check_against_plain(*step_operands(
        b, 70 + b, n=1024, k1=3, lv=4, n_d=2, js=2, base_log=9))
    assert reads.shape == (8,) and (reads > 0).all() and negated > 0


def test_wgmma_k1_matches_plain_at_the_8bit_step():
    """PARAMS_WOPPBS_8BIT's step at N = 1024 (k+1 = 3, L = 6, one limb a
    digit, js = 1, base_log 7: R = 18, 7 buckets), B = 33: bit-equal to
    plain."""
    check_against_plain(*step_operands(33, 71, n=1024, k1=3, lv=6, n_d=1,
                                       js=1, base_log=7))


@pytest.mark.parametrize("n", SIZES)
def test_wgmma_k1_extreme_values(n):
    """Every digit and key byte -128 at R = 15 (one component, 15 levels
    of base 2^4): each int32 bucket at n_d·R·N·2^14, reproduced exactly,
    with a ragged tile of 13 lanes."""
    check_against_plain(*step_operands(13, 7, n=n, k1=1, lv=15, base_log=4,
                                       fill=-128))


@pytest.mark.parametrize("t_case", ["none", "at N", "at 2N", "mixed"])
def test_cluster_glue_reads_across_the_ranks(t_case):
    """At N = 1024 the rotated sources the glue reads across the cluster's
    8 ranks equal X^t·acc (polynomial.monomial_mul), each column read once,
    for every rotation class: t below N, t in [N, 2N) (a source past N
    reads the negated half of [acc, -acc]), t near the wrap at 2N, and
    random t; each class but the first has every block read a rank other
    than its own, and the class at N negates."""
    n, rows = 1024, 8
    cluster = n // COLS
    rng = np.random.default_rng(["none", "at N", "at 2N",
                                 "mixed"].index(t_case))
    acc = rng.integers(-2 ** 63, 2 ** 63, (rows, n), dtype=np.int64)
    t = {"none": np.array([0, 1, 100, 511, 512, 513, 700, 1000]),
         "at N": np.array([1024, 1025, 1100, 1535, 1536, 1700, 2000, 2047]),
         "at 2N": np.array([1, 7, 300, 511, 512, 900, 1023, 1024]),
         "mixed": rng.integers(0, 2 * n, rows)}[t_case].astype(np.int64)
    want = polynomial.monomial_mul(torch.from_numpy(acc),
                                   torch.from_numpy(t)).numpy()
    tiles = acc.view(np.uint64).reshape(rows, cluster, COLS).transpose(
        1, 0, 2)[None]
    rot, reads, negated = cluster_glue(tiles, t)
    assert np.array_equal(rot[0].view(np.int64), want)
    assert (reads.sum(axis=1) == rows * COLS).all()
    if t_case != "none":
        assert (reads.sum(axis=1) > reads.diagonal()).all()
    if t_case == "at N":
        assert negated > 0


@pytest.mark.parametrize("n", SIZES)
def test_table_window_is_the_s_table(n):
    """Every unit's window (c0 the block's first column, k0 the unit's
    first digit column) holds S-table words x = y + k0 - c0 - COLS for y
    in [0, KC + COLS), unwrapped; the A words of every warp and k-step lie
    inside it, and over all blocks and units they read x in [1 - N, N - 4]
    only, every such word once at least."""
    rng = np.random.default_rng(2)
    raw = rng.integers(-128, 128, 2 * n, dtype=np.int8)
    full = table_by_definition(raw, n)                  # word x at x + N
    y = np.arange(TAB)
    at0 = word_index()
    assert at0.min() >= 1 and (at0 + 16 * 2 * KSTEPS).max() <= TAB - 4
    read = set()
    for c0 in range(0, n, COLS):
        for k0 in range(0, n, KC):
            assert np.array_equal(window_table(raw, c0, n, k0),
                                  full[(y + k0 - c0 - COLS + n) % (2 * n)])
            read.update(range(1 + k0 - c0 - COLS, k0 + KC - 3 - c0))
    assert read == set(range(1 - n, n - 3))


@pytest.mark.parametrize("n", SIZES)
def test_raw_slice_covers_the_window(n):
    """At N = 1024 a unit stages KC/2 raw words a plane from raw_word0, a
    multiple of 4 (whole 16-byte pieces), and its window groups read slice
    words TAB/4 + 4 - yw - d in [3, TAB/4 + 4] (no wrap in the slice); at
    N = 512 it stages the whole row."""
    for c0 in range(0, n, COLS):
        for k0 in range(0, n, KC):
            w0 = raw_word0(c0, k0)
            assert w0 % 4 == 0
            raw_w = np.arange(n // 2, dtype=np.uint32)
            staged = unit_raw(raw_w, n, np.asarray(c0), k0)
            if n == KC:
                assert np.array_equal(staged, raw_w)
                continue
            assert np.array_equal(staged, (w0 + np.arange(KC // 2)) % (n // 2))
            yw = np.arange(TAB // 4)
            # raw word -(yw + (k0 - c0 - COLS)/4) - d, d = 0..2, at slice
            # word TAB/4 + 4 - yw - d
            for d in range(3):
                word = (-(yw + (k0 - c0 - COLS) // 4) - d) % (n // 2)
                at = TAB // 4 + 4 - yw - d
                assert at.min() >= 3 and at.max() <= TAB // 4 + 4
                assert np.array_equal(staged[at], word)


@pytest.mark.parametrize("n", SIZES)
def test_a_fragment_is_the_negacirculant_slab(n):
    """A[row, k] of warpgroup g at the unit from k0 is NC[k0 + k,
    column(row)] = ext[(column - k0 - k) mod 2N], column(16w + gid) = cA +
    gid and column(16w + gid + 8) = cA + gid - 16, block-local cA = 64·g +
    16 + 8·(w&1) + 32·(w>>1); the rows of a warpgroup are its 64 columns
    once each."""
    rng = np.random.default_rng(3)
    raw = rng.integers(-128, 128, 2 * n, dtype=np.int8)
    for c0 in (0, n - COLS):
        for k0 in range(0, n, KC):
            a = a_operand(window_table(raw, c0, n, k0))     # [WGS, 64, KC]
            for g in range(WGS):
                w = np.arange(4)[:, None]
                ca = 64 * g + 16 + 8 * (w & 1) + 32 * (w >> 1)
                col = np.concatenate([ca + np.arange(8),
                                      ca - 16 + np.arange(8)],
                                     axis=1).reshape(-1)     # by row
                assert np.array_equal(np.sort(col), 64 * g + np.arange(64))
                k = k0 + np.arange(KC)
                want = raw[(c0 + col[:, None] - k[None, :]) % (2 * n)]
                assert np.array_equal(a[g], want)


@pytest.mark.parametrize("n", SIZES)
def test_digit_tile_core_matrices(n):
    """Each unit's staged digit tile read through the descriptor is its
    digits: B[k, lane] of limb i at k-step kt of the unit from k0 is
    dig_i[lane, k0 + 32·kt + k], lanes past the batch zero; each 8-lane
    core matrix is 128 contiguous bytes."""
    rng = np.random.default_rng(4)
    dig = rng.integers(-128, 128, (2, LANES, n), dtype=np.int8)
    for k0 in range(0, n, KC):
        tile = digit_tile(dig[:, :, k0:k0 + KC], 27)
        for i in range(2):
            for kt in (0, 7, KSTEPS - 1):
                got = b_operand(tile, i, kt)
                want = dig[i, :, k0 + 32 * kt:k0 + 32 * kt + 32].T.copy()
                want[:, 27:] = 0
                assert np.array_equal(got, want)
        core = tile[:128].view(np.int8).reshape(8, 16)  # lanes 0-7, k 0-15
        assert np.array_equal(core, dig[0, :8, k0:k0 + 16])


def test_dispatch_chooses_the_path_from_n_and_b():
    """k1_path: wgmma at each N the CUDA source is built for (512 and 1024)
    whatever the batch (it wins from one lane at both, PERF.md), mma.sync
    at every other N; the shape constants are the CUDA source's, and at
    both N every block (js 0..7, n_d 1..3) fits the card's shared memory
    and a portable cluster, and the wrapper's shared-memory size refuses
    every other N."""
    src = (CSRC / "nc_wgmma.cuh").read_text()
    kern = (CSRC / "cmux_wg.cu").read_text()
    built = {int(v) for v in re.findall(r"launch_wg<(\d+), ND, JS>", kern)}
    assert built == set(kx.WG_N) == {512, 1024}
    for n in SIZES:
        assert kx.k1_path(n) == "wgmma"
        assert n % COLS == 0 and n // COLS <= 8 and n % KC == 0
        for js in range(8):
            for n_d in (1, 2, 3):
                assert kx._k1_wg_smem(n, 8 - js, n_d) <= kx.SMEM_LIMIT
    for n in (64, 128, 256, 2048):
        assert kx.k1_path(n) == "mma.sync"
        with pytest.raises(ValueError):
            kx._k1_wg_smem(n, 6, 2)
    assert int(re.search(r"constexpr int KC = (\d+);", src).group(1)) == KC
    assert int(re.search(r"constexpr int LANES = (\d+);", src).group(1)) \
        == LANES
    assert 64 * int(re.search(r"constexpr int WGS = (\d+);", src).group(1)) \
        == COLS


@pytest.mark.parametrize("n", SIZES)
def test_wrapper_counts_the_wgmma_launches_apart(n):
    """On the CPU the wrapper runs the plain version and counts no launch
    of either kernel."""
    dig, ext, acc, t, bl, lv, js = step_operands(33, 5, n=n)
    before = (kx.extprod_step2g.launches, kx.extprod_step2g.launches_wg)
    kx.extprod_step2g(torch.from_numpy(dig[:, :, :, :1]),
                      torch.from_numpy(ext), torch.from_numpy(acc[:, :1]),
                      torch.from_numpy(t[:1]).to(torch.int32), bl, lv, js)
    assert (kx.extprod_step2g.launches, kx.extprod_step2g.launches_wg) \
        == before
