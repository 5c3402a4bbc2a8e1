"""The index arithmetic of the tensor-core contraction (csrc/nc_mma.cuh),
emulated in numpy and held against `extprod_step2_plain`.

K1 and K9 feed `mma.sync.m16n8k32` (int8 x int8 -> int32) straight from the
shared-memory S-tables: operand A (16 rows) is a slab of the negacirculant,
operand B (8 columns) the digits of the block's 8 batch lanes. The emulation
below follows the device code register by register — the S-table build from
the raw key row with byte permutes, the table's rotation by N words, the
padded digit tile, the sliding ten-word window of a warp's four column
tiles, the fragment maps of the instruction, the thread -> (column, lane)
map of the epilogue — so that every index formula is checked here, where
there is no card. It needs nothing of the JAX package.
"""

import numpy as np
import pytest
import torch

from tfhe_aes2_tpu_torch.ops import polynomial
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx

ROWS = 8          # batch lanes of a block = N of the instruction
MT = 4            # 16-column tiles of a warp
PAD = 16          # bytes added to each digit-tile row
LANE = np.arange(32)
GID, TIG = LANE >> 2, LANE & 3


def byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: result byte b is byte
    (sel >> 4b) & 7 of the eight bytes (x: 0-3, y: 4-7)."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint32)
    for b in range(4):
        idx = np.uint64(8 * ((sel >> (4 * b)) & 7))
        out |= (((both >> idx) & np.uint64(0xFF)).astype(np.uint32)
                << np.uint32(8 * b))
    return out


def build_table(raw_plane, n):
    """One plane's S-table as the kernel builds it: from the 2N raw key
    bytes (n/2 aligned words), four table words per group of three raw
    words, stored rotated by N words."""
    hw = n // 2
    raw_w = raw_plane.view(np.uint32)                         # [n/2]
    y = np.arange(hw)
    w0 = raw_w[(hw - y) % hw]
    wm1 = raw_w[(hw - y - 1) % hw]
    wm2 = raw_w[(hw - y - 2) % hw]
    tab = np.empty(2 * n, dtype=np.uint32)
    at = (4 * y + n) % (2 * n)
    tab[at] = byte_perm(wm1, w0, 0x1234)
    tab[at + 1] = byte_perm(wm1, wm1, 0x0123)
    tab[at + 2] = byte_perm(wm2, wm1, 0x3456)
    tab[at + 3] = byte_perm(wm2, wm1, 0x2345)
    return tab


def table_by_definition(ext_plane, n):
    """Word x packs rext[x..x+3], rext[q] = ext[(-q) mod 2N], byte q at
    bits 8q (csrc/nc_common.cuh); stored at (x + N) mod 2N."""
    x = np.arange(2 * n)
    by = ext_plane[(-(x[:, None] + np.arange(4))) % (2 * n)].view(np.uint8)
    words = (by.astype(np.uint32) << (8 * np.arange(4, dtype=np.uint32))).sum(
        axis=1, dtype=np.uint32)
    tab = np.empty(2 * n, dtype=np.uint32)
    tab[(x + n) % (2 * n)] = words
    return tab


def unpack_s8(words):
    """uint32 [...] -> int8 [..., 4], byte q at bits 8q."""
    sh = 8 * np.arange(4, dtype=np.uint32)
    return ((words[..., None] >> sh) & np.uint32(0xFF)).astype(
        np.uint8).view(np.int8)


def _fragment_slots():
    """Where each fragment byte (or D register) sits in the instruction's
    matrices (PTX ISA layouts), as flat positions: A [16 x 32] by (lane,
    register, byte), B [32 x 8] likewise, D [16 x 8] by (lane, register)."""
    lane, reg, q = np.meshgrid(LANE, np.arange(4), np.arange(4),
                               indexing="ij")
    a_at = ((GID[lane] + 8 * (reg & 1)) * 32
            + 4 * TIG[lane] + q + 16 * (reg >> 1))
    lane, reg, q = np.meshgrid(LANE, np.arange(2), np.arange(4),
                               indexing="ij")
    b_at = (4 * TIG[lane] + q + 16 * reg) * 8 + GID[lane]
    lane, reg = np.meshgrid(LANE, np.arange(4), indexing="ij")
    d_at = (GID[lane] + 8 * (reg >> 1)) * 8 + 2 * TIG[lane] + (reg & 1)
    return a_at.reshape(-1), b_at.reshape(-1), d_at.reshape(-1)


A_AT, B_AT, D_AT = _fragment_slots()


def mma_m16n8k32(a_regs, b_regs):
    """One warp's mma.sync.m16n8k32.s8.s8.s32, batched over leading axes:
    a_regs uint32 [..., 32, 4], b_regs uint32 [..., 32, 2] -> the D
    fragment int64 [..., 32, 4] of A·B (PTX ISA fragment layouts). The
    products are exact in float64 (|A·B| <= 32·2^14)."""
    lead = np.broadcast_shapes(a_regs.shape[:-2], b_regs.shape[:-2])
    a = np.empty(lead + (16 * 32,))
    b = np.empty(lead + (32 * 8,))
    a[..., A_AT] = unpack_s8(a_regs).reshape(a_regs.shape[:-2] + (-1,))
    b[..., B_AT] = unpack_s8(b_regs).reshape(b_regs.shape[:-2] + (-1,))
    d = a.reshape(lead + (16, 32)) @ b.reshape(lead + (32, 8))
    return d.reshape(lead + (-1,))[..., D_AT].reshape(
        lead + (32, 4)).astype(np.int64)


def window_word(tab, n, warp, kt, p, c0=0):
    """Window entry p of k-step kt, per (warp, lane): table word
    N + 32·kt + 16 - 8p + 4·tig - gid - 64·warp - c0, never wrapped (c0:
    the block's first column, 0 or 512 at N = 1024)."""
    idx = (n + 32 * kt + 16 - 8 * p
           + (4 * TIG - GID)[None, :] - 64 * warp[:, None] - c0)
    assert idx.min() >= 0 and idx.max() < 2 * n, "window leaves the table"
    return tab[idx]


def tile_words(dig_r):
    """One contraction row's digit limbs int8 [n_d, ROWS, N] as the padded
    shared-memory tile, in 32-bit words."""
    n_d, _, n = dig_r.shape
    tile = np.zeros((n_d, ROWS, n + PAD), dtype=np.int8)
    tile[:, :, :n] = dig_r
    return tile.reshape(-1).view(np.uint32)


def block_warps(n):
    """Warps of a block: one per 64 of its min(N, 512) columns."""
    return max(1, min(n, 512) // 64)


def plane_fragments(tab, tile_w, limbs, n, c0=0):
    """mma_row's k-loop over one key plane (its rotated S-table `tab`)
    against each digit limb i in `limbs` of a padded tile: int64 [len(limbs),
    warps, MT, 32, 4], the D fragments of every warp's MT column tiles, the
    block's columns from c0."""
    warps = np.arange(block_warps(n))
    stride = (n + PAD) // 4                                   # words a row
    out = np.zeros((len(limbs), len(warps), MT, 32, 4), dtype=np.int64)
    v = [None] * 10
    for p in range(4, 10):
        v[p] = window_word(tab, n, warps, 0, p, c0)
    for kt in range(n // 32):
        for p in range(4):
            v[p] = window_word(tab, n, warps, kt, p, c0)
        for p in range(4, 10):              # carried from the last k-step
            assert np.array_equal(v[p], window_word(tab, n, warps, kt, p, c0))
        a_regs = np.stack([np.stack([v[2 * q + 2], v[2 * q + 3], v[2 * q],
                                     v[2 * q + 1]], -1) for q in range(MT)],
                          1)                             # [warps, MT, 32, 4]
        for x, i in enumerate(limbs):
            word = (i * ROWS + GID) * stride + 8 * kt + TIG
            b_regs = np.stack([tile_w[word], tile_w[word + 4]], -1)
            out[x] += mma_m16n8k32(a_regs, b_regs)
        for p in range(9, 3, -1):
            v[p] = v[p - 4]
    return out


def block_output(frags, n, c0=0):
    """The epilogue's map: frags int64 [warps, MT, 32, 4], one value per D
    register -> [ROWS, N]: register c of tile q of a thread is column
    c0 + 64·warp + 16·q + gid + 8·(c / 2) of batch lane 2·tig + c % 2. The
    block's columns are written once each, the others left zero."""
    out = np.zeros((ROWS, n), dtype=np.int64)
    written = np.zeros((ROWS, n), dtype=np.int64)
    for w in range(frags.shape[0]):
        for q in range(MT):
            for reg in range(4):
                m = c0 + 64 * w + 16 * q + GID + 8 * (reg >> 1)
                lane = 2 * TIG + (reg & 1)
                keep = m < n
                out[lane[keep], m[keep]] = frags[w, q, :, reg][keep]
                np.add.at(written, (lane[keep], m[keep]), 1)
    assert (written[:, c0:c0 + min(n, 512)] == 1).all()
    return out


def checked_table(raw_plane, n):
    tab = build_table(raw_plane, n)
    assert np.array_equal(tab, table_by_definition(raw_plane, n))
    return tab


def contract_buckets(dig, ext, js, c0=0):
    """dig int8 [R, n_d, ROWS, N], ext int8 [R, 8-js, 2N] -> the block's
    int32 buckets as D fragments, int64 [8-js, warps, MT, 32, 4] (bucket s
    of weight 2^(8(s+js))), computed as the kernel computes them for the
    block whose columns start at c0."""
    r_cnt, n_d, _, n = dig.shape
    nj = 8 - js
    acc = np.zeros((nj, block_warps(n), MT, 32, 4), dtype=np.int64)
    for r in range(r_cnt):
        tile_w = tile_words(dig[r])
        for j in range(js, 8):
            limbs = [i for i in range(n_d) if i + j < 8]
            frags = plane_fragments(checked_table(ext[r, j - js], n), tile_w,
                                    limbs, n, c0)
            for x, i in enumerate(limbs):
                acc[i + j - js] += frags[x]
    assert np.abs(acc).max() < 2 ** 31       # the int32 buckets hold it
    return acc


def contract_emulated(dig, ext, js, c0=0):
    """dig int8 [R, n_d, ROWS, N], ext int8 [R, 8-js, 2N] -> the block's
    int64 [ROWS, N] sum, computed as the kernel computes it: all N columns
    up to N = 512, the 512 from c0 at N = 1024 (the others zero)."""
    n = dig.shape[3]
    nj = 8 - js
    acc = contract_buckets(dig, ext, js, c0)
    total = np.zeros(acc.shape[1:], dtype=np.uint64)
    for s in range(nj):
        total += acc[s].view(np.uint64) << np.uint64(8 * (s + js))
    return block_output(total.view(np.int64), n, c0)


def bucket_emulated(dig, key):
    """K11's block: dig int8 [R, limbs, ROWS, N] (digit limbs 0..limbs-1),
    key int8 [R, limbs, 2N] (the key planes s-limbs+1 .. s of the block's
    bucket s) -> the int32 bucket int64 [ROWS, N], plane t against limb
    limbs-1-t (mma_row<1, 7> once a plane)."""
    r_cnt, limbs, _, n = dig.shape
    acc = np.zeros((block_warps(n), MT, 32, 4), dtype=np.int64)
    for r in range(r_cnt):
        tile_w = tile_words(dig[r])
        for t in range(limbs):
            acc += plane_fragments(checked_table(key[r, t], n), tile_w,
                                   [limbs - 1 - t], n)[0]
    assert np.abs(acc).max() < 2 ** 31       # the int32 bucket holds it
    return block_output(acc, n)


@pytest.mark.parametrize("n", [64, 512])
@pytest.mark.parametrize("js", [0, 2])
@pytest.mark.parametrize("n_d", [1, 2])
def test_mma_fragment_map_matches_plain(n, js, n_d):
    """The emulated warp-level contraction equals extprod_step2_plain,
    bit for bit, on random int8 operands."""
    rng = np.random.default_rng(100 * n + 10 * js + n_d)
    k1, levels = 2, 1
    r_cnt = k1 * levels
    dig = rng.integers(-128, 128, (k1, levels, n_d, ROWS, n), dtype=np.int8)
    ext = rng.integers(-128, 128, (k1, r_cnt, 8 - js, 2 * n), dtype=np.int8)
    want = kx.extprod_step2_plain(
        torch.from_numpy(dig), torch.from_numpy(ext),
        torch.zeros((k1, ROWS, n), dtype=torch.int64), js).numpy()
    for o in range(k1):
        got = contract_emulated(dig.reshape(r_cnt, n_d, ROWS, n), ext[o], js)
        assert np.array_equal(got, want[o])


@pytest.mark.parametrize("n", [64, 512])
def test_mma_extreme_values_stay_in_int32(n):
    """Every digit and key byte -128: the largest bucket the wrappers admit
    per contraction row, reproduced exactly."""
    dig = np.full((1, 1, 2, ROWS, n), -128, dtype=np.int8)
    ext = np.full((1, 1, 6, 2 * n), -128, dtype=np.int8)
    want = kx.extprod_step2_plain(
        torch.from_numpy(dig), torch.from_numpy(ext),
        torch.zeros((1, ROWS, n), dtype=torch.int64), 2).numpy()
    got = contract_emulated(dig.reshape(1, 2, ROWS, n), ext[0], 2)
    assert np.array_equal(got, want[0])


@pytest.mark.parametrize("n", [64, 512])
def test_toeplitz_identities(n):
    """The A fragment of (k-tile kt, column tile mt) depends on
    32·kt - 16·mt only, so (kt, mt) and (kt+1, mt+2) share it; and the
    registers a2, a3 of tile mt are a0, a1 of tile mt-1, which is what lets
    four neighbouring tiles read a ten-word window."""
    rng = np.random.default_rng(n)
    tab = table_by_definition(
        rng.integers(-128, 128, 2 * n, dtype=np.int8), n)

    def frag(kt, mt):
        base = n + 32 * kt - 16 * mt + 4 * TIG - GID
        return np.stack([tab[(base + d) % (2 * n)] for d in (0, -8, 16, 8)])

    tiles, ksteps = n // 16, n // 32
    for kt in range(ksteps - 1):
        for mt in range(tiles - 2):
            assert np.array_equal(frag(kt, mt), frag(kt + 1, mt + 2))
    for kt in range(ksteps):
        for mt in range(1, tiles):
            assert np.array_equal(frag(kt, mt)[2:], frag(kt, mt - 1)[:2])
    # and the fragment really is the negacirculant slab: A[row, k] =
    # NC[32·kt + k, 16·mt + row] = ext[(16·mt + row - 32·kt - k) mod 2N]
    ext = rng.integers(-128, 128, 2 * n, dtype=np.int8)
    tab = table_by_definition(ext, n)
    kt, mt = ksteps - 1, tiles - 1
    by = unpack_s8(frag(kt, mt))                             # [4, 32, 4]
    for reg in range(4):
        for q in range(4):
            row = GID + 8 * (reg & 1)
            k = 4 * TIG + q + 16 * (reg >> 1)
            assert np.array_equal(
                by[reg, :, q], ext[(16 * mt + row - 32 * kt - k) % (2 * n)])


@pytest.mark.parametrize("js", [0, 2])
def test_mma_column_split_at_n1024(js):
    """N = 1024: the two blocks of a row tile, c0 = 0 and c0 = 512, each
    contracting over all 1024 digit columns with 8 warps, write each of
    their own 512 columns once and nothing else; stitched together they
    equal extprod_step2_plain, bit for bit. Every window index stays in the
    rotated table unmasked (window_word asserts it)."""
    rng = np.random.default_rng(1024 + js)
    n, n_d, k1, levels = 1024, 2, 2, 1
    r_cnt = k1 * levels
    dig = rng.integers(-128, 128, (k1, levels, n_d, ROWS, n), dtype=np.int8)
    ext = rng.integers(-128, 128, (k1, r_cnt, 8 - js, 2 * n), dtype=np.int8)
    want = kx.extprod_step2_plain(
        torch.from_numpy(dig), torch.from_numpy(ext),
        torch.zeros((k1, ROWS, n), dtype=torch.int64), js).numpy()
    o = 1
    halves = [contract_emulated(dig.reshape(r_cnt, n_d, ROWS, n), ext[o], js,
                                c0) for c0 in (0, 512)]
    assert not halves[0][:, 512:].any() and not halves[1][:, :512].any()
    assert np.array_equal(halves[0] + halves[1], want[o])


def cluster_glue_sources(acc_rows, t, c0):
    """K1's glue at N = 1024 for the block of columns [c0, c0 + 512): each
    block's tile holds its [ROWS][512] half of the new accumulator; for
    column m the source src = (m - t) mod 2N, x = src mod N, is read from
    this block's tile when x lies in its half ((x ^ c0) < 512), else from
    the partner's, at row·512 + x mod 512, negated when src >= N
    (csrc/cmux.cu, N > 512). acc_rows uint64 [ROWS, N] -> the rotated values
    (X^t·acc)[m] uint64 [ROWS, 512] and how often each half was read."""
    n, cols = acc_rows.shape[1], 512
    tiles = {h: acc_rows[:, h * cols:(h + 1) * cols].reshape(-1)
             for h in (0, 1)}
    own, other = tiles[c0 // cols], tiles[1 - c0 // cols]
    rot = np.zeros((ROWS, cols), dtype=np.uint64)
    reads = {"own": 0, "other": 0}
    for row in range(ROWS):
        m = c0 + np.arange(cols)
        src = (m - t[row]) & (2 * n - 1)
        x = src & (n - 1)
        mine = (x ^ c0) < cols
        v = np.where(mine, own[row * cols + (x & (cols - 1))],
                     other[row * cols + (x & (cols - 1))])
        with np.errstate(over="ignore"):
            rot[row] = np.where(src < n, v, np.uint64(0) - v)
        reads["own"] += int(mine.sum())
        reads["other"] += int((~mine).sum())
    return rot, reads


@pytest.mark.parametrize("t_case", ["none", "at N", "at 2N", "mixed"])
def test_cluster_glue_reads_across_the_halves(t_case):
    """The rotated sources K1's cluster glue reads, for both blocks, equal
    X^t·acc (polynomial.monomial_mul) for every rotation class: no wrap
    (src = m - t in [0, N)), a wrap at N (src in [N, 2N): the sign of
    ext = [acc, -acc]) and a wrap at 2N (m < t); each class reads both
    halves where its rotation crosses one."""
    n = 1024
    rng = np.random.default_rng(["none", "at N", "at 2N",
                                 "mixed"].index(t_case))
    acc = rng.integers(-2 ** 63, 2 ** 63, (ROWS, n), dtype=np.int64)
    t = {"none": np.array([0, 1, 100, 511, 512, 513, 700, 1000]),
         "at N": np.array([1024, 1025, 1100, 1535, 1536, 1700, 2000, 2047]),
         "at 2N": np.array([1, 7, 300, 511, 512, 900, 1023, 1024]),
         "mixed": rng.integers(0, 2 * n, ROWS)}[t_case].astype(np.int64)
    want = polynomial.monomial_mul(torch.from_numpy(acc),
                                   torch.from_numpy(t)).numpy()
    for c0 in (0, 512):
        rot, reads = cluster_glue_sources(acc.view(np.uint64), t, c0)
        assert np.array_equal(rot.view(np.int64), want[:, c0:c0 + 512])
        if t_case != "none":
            assert reads["other"] > 0
