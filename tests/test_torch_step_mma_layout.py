"""The per-block addressing of the tensor-core CMux steps that run
`nc::contract_mma` through nc_mma.cuh's `Staged` record — K5 (csrc/cmux.cu,
K1's kernel without its glue), K6 (csrc/step.cu) and K10b (csrc/longk.cu) —
and of K11 (csrc/bucket.cu), which runs its own row loop one weight bucket
a block, emulated in numpy and held against the plain versions.

The contraction's fragment map is `contract_emulated`'s
(tests/test_torch_mma_layout.py), followed register by register; K11's
single bucket is its `bucket_emulated`. What is new here is where each
block's operands lie: the `Staged` record's base pointers and its three
digit strides (row, plane, lane), the zero fill of the lanes past the batch
edge, K6's batch-major layouts, K11's key planes s-limbs+1..s of each row
and its digit limbs below `limbs`, and for K10b and K11 the split of the R
contraction rows across blocks, whose partials the kernels add into the
accumulator with 64-bit atomics (wrapping u64 here). Change an index in
cmux.cu, step.cu, longk.cu, bucket.cu or nc_mma.cuh -> change it here
first. At N = 1024 K6, K10b and K11 split each row tile's columns between
two blocks as K5 does: `grid_z_blocks` decodes their blockIdx.z as the
kernels do, and the coverage tests hold every (lane, column, row, bucket)
to exactly one block. Needs nothing of the JAX package.
"""

import numpy as np
import pytest
import torch

from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx
from tests.test_torch_mma_layout import (GID, MT, ROWS, TIG, block_warps,
                                         bucket_emulated, contract_emulated)

N = 64


def staged_block(dig_f, ext_f, rec, r_cnt, rows_valid, n_d, nj, n,
                 key_strides=None):
    """The operands one block's contract_mma stages, read from the flat
    operands through its Staged record: the R key rows (NJ planes of 2N
    bytes, contiguous from ext_at; with key_strides = (ext_r, ext_plane),
    K8's KEY_STRIDED staging, plane j of row r from ext_at + r·ext_r +
    j·ext_plane) and the padded digit tiles, digit plane i of lane `row` at
    row r from dig_at + r·dig_r + i·dig_plane + row·dig_lane; lanes at or
    past rows_valid are zero (copy_digits_async's zero-byte copies)."""
    ext_at, dig_at, dig_r, dig_plane, dig_lane = rec
    ext_r, ext_plane = key_strides or (nj * 2 * n, 2 * n)
    tile = np.zeros((r_cnt, n_d, ROWS, n), dtype=np.int8)
    key = np.zeros((r_cnt, nj, 2 * n), dtype=np.int8)
    for r in range(r_cnt):
        for j in range(nj):
            at = ext_at + r * ext_r + j * ext_plane
            assert at % 16 == 0 and at + 2 * n <= ext_f.size
            key[r, j] = ext_f[at:at + 2 * n]
        for i in range(n_d):
            for row in range(rows_valid):
                at = dig_at + r * dig_r + i * dig_plane + row * dig_lane
                assert 0 <= at and at + n <= dig_f.size
                tile[r, i, row] = dig_f[at:at + n]
    return tile, key


def wrap_add(acc, part):
    with np.errstate(over="ignore"):
        return (acc.view(np.uint64) + part.view(np.uint64)).view(np.int64)


def operands(b, n_d, js, seed, k1=2, levels=2):
    rng = np.random.default_rng(seed)
    r_cnt = k1 * levels
    dig = rng.integers(-128, 128, (k1, levels, n_d, b, N), dtype=np.int8)
    ext = rng.integers(-128, 128, (k1, r_cnt, 8 - js, 2 * N), dtype=np.int8)
    acc = rng.integers(-2 ** 62, 2 ** 62, (k1, b, N), dtype=np.int64)
    return dig, ext, acc


def k5_emulated(dig, ext, acc, js):
    """K5: grid (ceil(B/8), O); block (tile, o)'s Staged record as
    extprod_step2g_kernel builds it, the epilogue acc += sum."""
    k1, levels, n_d, b, n = dig.shape
    o_cnt, r_cnt, nj, _ = ext.shape
    dig_f, ext_f = dig.reshape(-1), ext.reshape(-1)
    out = acc.copy()
    for o in range(o_cnt):
        for b0 in range(0, b, ROWS):
            rows = min(ROWS, b - b0)
            rec = (o * r_cnt * nj * 2 * n, b0 * n, n_d * b * n, b * n, n)
            tile, key = staged_block(dig_f, ext_f, rec, r_cnt, rows, n_d, nj,
                                     n)
            block = contract_emulated(tile, key, js)
            out[o, b0:b0 + rows] = wrap_add(out[o, b0:b0 + rows],
                                            block[:rows])
    return out


def longk_rows(z, splits, r_cnt):
    """Block z's contraction rows [r0, r1), as extprod_step_longk_kernel
    computes them."""
    return z * r_cnt // splits, (z + 1) * r_cnt // splits


def k10b_emulated(flat, ext, acc, js, splits):
    """K10b: grid (ceil(B/8), O, splits); block (tile, o, z)'s Staged record
    over its rows [r0, r1) of the flat digits, its partial added into acc
    as wrapping u64 (the kernel's atomicAdd)."""
    n_d, b, rn = flat.shape
    o_cnt, r_cnt, nj, two_n = ext.shape
    n = two_n // 2
    dig_f, ext_f = flat.reshape(-1), ext.reshape(-1)
    out = acc.copy()
    for o in range(o_cnt):
        for b0 in range(0, b, ROWS):
            rows = min(ROWS, b - b0)
            for z in range(splits):
                r0, r1 = longk_rows(z, splits, r_cnt)
                rec = ((o * r_cnt + r0) * nj * 2 * n, (b0 * r_cnt + r0) * n,
                       n, b * r_cnt * n, r_cnt * n)
                tile, key = staged_block(dig_f, ext_f, rec, r1 - r0, rows,
                                         n_d, nj, n)
                block = contract_emulated(tile, key, js)
                out[o, b0:b0 + rows] = wrap_add(out[o, b0:b0 + rows],
                                                block[:rows])
    return out


def k6_emulated(dig_bm, ext, acc_bm, js):
    """K6: grid (ceil(B/8), O) over the batch-major digits [n_d, B, R, N]
    (lanes R·N bytes apart, rows N); block (tile, o)'s Staged record as
    extprod_step_kernel builds it, the epilogue acc_out = acc_in + sum
    into [B, O, N], a new array."""
    n_d, b, r_cnt, n = dig_bm.shape
    o_cnt, _, nj, _ = ext.shape
    dig_f, ext_f = dig_bm.reshape(-1), ext.reshape(-1)
    out = np.zeros_like(acc_bm)
    for o in range(o_cnt):
        for b0 in range(0, b, ROWS):
            rows = min(ROWS, b - b0)
            rec = (o * r_cnt * nj * 2 * n, b0 * r_cnt * n, n,
                   b * r_cnt * n, r_cnt * n)
            tile, key = staged_block(dig_f, ext_f, rec, r_cnt, rows, n_d, nj,
                                     n)
            block = contract_emulated(tile, key, js)
            out[b0:b0 + rows, o] = wrap_add(acc_bm[b0:b0 + rows, o],
                                            block[:rows])
    return out


def k11_emulated(dig, ext, acc, js, splits):
    """K11: grid (ceil(B/8), O, (8-js)·splits); block (tile, o, z) takes
    bucket s = js + z % (8-js) over its rows [r0, r1) of split z // (8-js):
    per row the `limbs` = min(n_d, s-js+1) key planes from plane
    s-limbs+1 (key rows (8-js)·2N bytes apart) and digit limbs 0..limbs-1
    of K2's [R][n_d][B][N] digits; sign_extend(bucket) << 8s added into acc
    as wrapping u64 (the kernel's atomicAdd)."""
    k1, levels, n_d, b, n = dig.shape
    o_cnt, r_cnt, nj, two_n = ext.shape
    dig_f, ext_f = dig.reshape(-1), ext.reshape(-1)
    out = acc.copy()
    for o in range(o_cnt):
        for b0 in range(0, b, ROWS):
            rows = min(ROWS, b - b0)
            for z in range(nj * splits):
                s, split = js + z % nj, z // nj
                r0, r1 = longk_rows(split, splits, r_cnt)
                limbs = min(n_d, s - js + 1)
                key = np.zeros((r1 - r0, limbs, two_n), dtype=np.int8)
                tile = np.zeros((r1 - r0, limbs, ROWS, n), dtype=np.int8)
                for r in range(r0, r1):
                    at = ((o * r_cnt + r) * nj + s - limbs + 1 - js) * two_n
                    assert at >= 0 and at + limbs * two_n <= ext_f.size
                    key[r - r0] = ext_f[at:at + limbs * two_n].reshape(
                        limbs, two_n)
                    for i in range(limbs):
                        for row in range(rows):
                            at = ((r * n_d + i) * b + b0 + row) * n
                            tile[r - r0, i, row] = dig_f[at:at + n]
                bucket = bucket_emulated(tile, key)[:rows]
                part = bucket.view(np.uint64) << np.uint64(8 * s)
                out[o, b0:b0 + rows] = wrap_add(out[o, b0:b0 + rows],
                                                part.view(np.int64))
    return out


@pytest.mark.parametrize("b", [1, 9, 13])
@pytest.mark.parametrize("js", [0, 2])
@pytest.mark.parametrize("n_d", [1, 2, 3])
def test_k5_staged_addressing_matches_plain(b, js, n_d):
    """K5's Staged record, read from the flat [R][ND][B][N] digits with
    lanes N bytes apart, emulated by the K1/K9 fragment map, equals
    extprod_step2_plain bit for bit, ragged last lane tile included."""
    dig, ext, acc = operands(b, n_d, js, seed=100 * b + 10 * js + n_d)
    want = kx.extprod_step2_plain(torch.from_numpy(dig), torch.from_numpy(ext),
                                  torch.from_numpy(acc.copy()), js).numpy()
    assert np.array_equal(k5_emulated(dig, ext, acc, js), want)


@pytest.mark.parametrize("b", [1, 9, 13])
@pytest.mark.parametrize("js", [0, 2])
@pytest.mark.parametrize("n_d", [1, 2, 3])
def test_k10b_split_staged_addressing_matches_plain(b, js, n_d):
    """K10b's Staged record on the flat [n_d][B][R·N] digits (lanes R·N
    bytes apart, rows N), each split's row range from its own base, the
    splits' recombined partials added as wrapping u64: equal to
    extprod_step_longk_plain bit for bit with the wrapper's split and with
    one block and with three blocks a tile (rows 1, 1, 2)."""
    dig, ext, acc = operands(b, n_d, js, seed=200 * b + 10 * js + n_d)
    k1, levels, _, _, n = dig.shape
    r_cnt = k1 * levels
    # K10a's layout (rot_diff_digits_flat_plain): column (u·L + l)·N + m
    flat = dig.transpose(2, 3, 0, 1, 4).reshape(n_d, b, r_cnt * n)
    want = kx.extprod_step_longk_plain(
        torch.from_numpy(flat), torch.from_numpy(ext),
        torch.from_numpy(acc.copy()), js).numpy()
    assert np.array_equal(
        want, kx.extprod_step2_plain(torch.from_numpy(dig),
                                     torch.from_numpy(ext),
                                     torch.from_numpy(acc.copy()),
                                     js).numpy())
    split = kx._longk_splits(b, k1, r_cnt, n)
    assert split == r_cnt             # one or two lane tiles: a row a block
    for splits in sorted({1, 3, split}):
        assert np.array_equal(k10b_emulated(flat, ext, acc, js, splits),
                              want), splits


@pytest.mark.parametrize("b,split", [(9, 8), (160, 5), (288, 5), (1, 15),
                                     (13, 8), (64, 3), (128, 3), (200, 1),
                                     (256, 3)])
def test_longk_split_choice(b, split):
    """At the blind rotation's O=5, R=15: B=9 is 10 blocks on 132 SMs, so
    13 splits would fit in one wave, but 8 give the same two rows at most a
    block; B=128 (80 blocks) takes two waves of 5-row blocks over one wave
    of 15 rows; B=200 (125 blocks) one unsplit wave. The measured best at
    B in {1, 9, 13, 64, 128, 160} (csrc/probes/longk_splits.py)."""
    assert kx._longk_splits(b, 5, 15, 512) == split


def test_longk_splits_cover_every_row_once():
    """Over a range of batches, components and rows: each split's rows are
    contiguous and non-empty and every row is taken exactly once; where all
    blocks of one row each fit in one wave every row is its own block; where
    the tiles fill whole waves the rows stay unsplit; a split never models
    slower than none."""
    def waves_rows(tiles, s, r):
        return -(-tiles * s // 132) * (-(-r // s) + kx.LONGK_BLOCK_ROWS)
    for o in (1, 2, 3, 5):
        for r in (1, 2, 4, 6, 15, 16):
            for b in (1, 8, 9, 13, 40, 64, 160, 288, 1056):
                s = kx._longk_splits(b, o, r, 512)
                assert 1 <= s <= r
                taken = []
                for z in range(s):
                    r0, r1 = longk_rows(z, s, r)
                    assert r1 > r0
                    taken += range(r0, r1)
                assert taken == list(range(r))
                tiles = -(-b // 8) * o
                if tiles * r <= 132:
                    assert s == r
                if tiles % 132 == 0:
                    assert s == 1
                assert waves_rows(tiles, s, r) <= waves_rows(tiles, 1, r)


@pytest.mark.parametrize("b", [1, 9, 13])
@pytest.mark.parametrize("js", [0, 2])
@pytest.mark.parametrize("n_d", [1, 2, 3])
def test_k6_staged_addressing_matches_plain(b, js, n_d):
    """K6's Staged record on the batch-major digits [n_d, B, R, N] (lanes
    R·N bytes apart, rows N) and its epilogue into a new [B, O, N] array,
    emulated by the fragment map, equal to extprod_step_plain bit for bit
    (and to K5's update), ragged last lane tile included."""
    dig, ext, acc = operands(b, n_d, js, seed=300 * b + 10 * js + n_d)
    k1, levels, _, _, n = dig.shape
    dig_bm = np.ascontiguousarray(
        dig.reshape(k1 * levels, n_d, b, n).transpose(1, 2, 0, 3))
    acc_bm = np.ascontiguousarray(acc.transpose(1, 0, 2))
    want = kx.extprod_step_plain(torch.from_numpy(dig_bm),
                                 torch.from_numpy(ext),
                                 torch.from_numpy(acc_bm), js).numpy()
    assert np.array_equal(
        want.transpose(1, 0, 2),
        kx.extprod_step2_plain(torch.from_numpy(dig), torch.from_numpy(ext),
                               torch.from_numpy(acc.copy()), js).numpy())
    got = k6_emulated(dig_bm, ext, acc_bm, js)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("b", [1, 9, 13])
@pytest.mark.parametrize("js", [0, 2])
@pytest.mark.parametrize("n_d", [1, 2, 3])
def test_k11_bucket_blocks_match_plain(b, js, n_d):
    """K11's bucket blocks — per bucket s only the key planes s-limbs+1..s
    of each row and the digit limbs below limbs — each block's bucket
    sign-extended, shifted by 8s and added as wrapping u64: equal to
    extprod_step3_plain bit for bit unsplit, with three blocks a bucket
    (rows 1, 1, 2) and with a row a block."""
    dig, ext, acc = operands(b, n_d, js, seed=400 * b + 10 * js + n_d)
    want = kx.extprod_step3_plain(torch.from_numpy(dig), torch.from_numpy(ext),
                                  torch.from_numpy(acc.copy()), js).numpy()
    r_cnt = ext.shape[1]
    for splits in (1, 3, r_cnt):
        assert np.array_equal(k11_emulated(dig, ext, acc, js, splits),
                              want), splits


@pytest.mark.parametrize("b,split", [(1, 8), (9, 5), (13, 5), (64, 3),
                                     (128, 3), (160, 3), (200, 1), (256, 2),
                                     (288, 1)])
def test_bucket_split_choice(b, split):
    """At the blind rotation's O=5, R=15, js=2 (6 buckets) with the 3 K11
    blocks an SM that the H100 holds at N=512, n_d=2: B=9 is 60 blocks on
    396 slots, so 5 splits of 3 rows fill one wave; B=200 (750 blocks)
    stays unsplit; the picks csrc/probes/bucket_splits.py measured best or
    within 3% of it at 8 of these 9 batches (B=9: 8% off the best, 4)."""
    assert kx._bucket_splits(b, 5, 15, 6, 3, 512) == split


def test_bucket_splits_cover_every_row_once():
    """Over a range of batches, components, rows, buckets and residencies:
    each split's rows are contiguous and non-empty and every row is taken
    exactly once; where all blocks of one row each fit in one wave of the
    SMs' slots every row is its own block; a split never models slower
    than none."""
    def waves_rows(blocks, s, r, resident):
        return (-(-blocks * s // (132 * resident))
                * (-(-r // s) + kx.BUCKET_BLOCK_ROWS))
    for resident in (1, 3, 8):
        for o, nj in ((1, 8), (2, 6), (5, 6), (5, 4)):
            for r in (1, 2, 4, 6, 15, 16):
                for b in (1, 8, 9, 13, 40, 64, 160, 288, 1056):
                    s = kx._bucket_splits(b, o, r, nj, resident, 512)
                    assert 1 <= s <= r
                    taken = []
                    for z in range(s):
                        r0, r1 = longk_rows(z, s, r)
                        assert r1 > r0
                        taken += range(r0, r1)
                    assert taken == list(range(r))
                    blocks = -(-b // 8) * o * nj
                    if blocks * r <= 132 * resident:
                        assert s == r
                    assert (waves_rows(blocks, s, r, resident)
                            <= waves_rows(blocks, 1, r, resident))


# ------------------------------- N = 1024: the column split of K6, K10b, K11

def fragment_cover(n, c0):
    """int [ROWS, N]: how often a block whose columns start at c0 writes
    each (lane, column) through nc::for_each_fragment — register c of tile
    q of a thread is column c0 + 64·warp + 16·q + gid + 8·(c / 2) of lane
    2·tig + c % 2, over the block's min(N, 512)/64 warps."""
    cover = np.zeros((ROWS, n), dtype=np.int64)
    for w in range(block_warps(n)):
        for q in range(MT):
            for c in range(4):
                m = c0 + 64 * w + 16 * q + GID + 8 * (c >> 1)
                assert (m < n).all()
                np.add.at(cover, (2 * TIG + (c & 1), m), 1)
    return cover


def grid_z_blocks(kernel, gz, n, r_cnt, js):
    """Each blockIdx.z of the kernel's launch decoded as the kernel decodes
    it: [(c0, (r0, r1), buckets)] — the block's first column, its
    contraction rows and the weight buckets s it adds. K6 (step.cu): z is
    the column half; K10b (longk.cu): z = split·halves + h; K11
    (bucket.cu): z = (split·halves + h)·(8-js) + (s-js)."""
    halves = n // 512 if n > 512 else 1
    nj = 8 - js
    out = []
    for z in range(gz):
        if kernel == "K6":
            out.append((z * 512, (0, r_cnt), range(js, 8)))
        elif kernel == "K10b":
            splits, split = gz // halves, z // halves
            out.append(((z - split * halves) * 512,
                        longk_rows(split, splits, r_cnt), range(js, 8)))
        else:
            splits = gz // (nj * halves)
            s, column_block = js + z % nj, z // nj
            split = column_block // halves
            out.append(((column_block - split * halves) * 512,
                        longk_rows(split, splits, r_cnt), [s]))
    return out


def grid_z(kernel, splits, n, js):
    """gridDim.z of the kernel's launch (launch_step, launch_longk,
    launch_bucket)."""
    halves = n // 512 if n > 512 else 1
    return {"K6": halves, "K10b": splits * halves,
            "K11": (8 - js) * splits * halves}[kernel]


# (R, js) of the N = 1024 blind rotations: lvl1/lvl4 (2, 15), lvl256 (4, 9),
# the 8-bit model's (6, 7), each with its set's truncation of the BSK
WIDE_STEPS = {6: 2, 12: 2, 18: 1}


@pytest.mark.parametrize("b", [1, 9, 13, 288])
@pytest.mark.parametrize("r_cnt", sorted(WIDE_STEPS))
@pytest.mark.parametrize("kernel", ["K6", "K10b", "K11"])
def test_column_split_covers_every_output_once_at_n1024(kernel, r_cnt, b):
    """At N = 1024, k = 2: over the launch's grid (ceil(B/8), O, z), with
    the wrapper's row split (K10b, K11 at 3 blocks an SM), one split and a
    row a block, every (lane, component, column, contraction row, weight
    bucket) is added by exactly one block, and no block writes a lane past
    the batch or a column outside its half."""
    n, o_cnt, js = 1024, 3, WIDE_STEPS[r_cnt]
    nj = 8 - js
    cover = {c0: fragment_cover(n, c0) for c0 in (0, 512)}
    for c0, c in cover.items():
        assert (c[:, c0:c0 + 512] == 1).all() and c.sum() == ROWS * 512
    wrapper = {"K6": 1, "K10b": kx._longk_splits(b, o_cnt, r_cnt, n),
               "K11": kx._bucket_splits(b, o_cnt, r_cnt, nj, 3, n)}[kernel]
    lanes = np.zeros(b, dtype=np.int64)
    for b0 in range(0, -(-b // ROWS) * ROWS, ROWS):      # blockIdx.x
        lanes[b0:b0 + ROWS] += 1
    assert (lanes == 1).all()
    # blockIdx.y is the component; the tiles differ only in rows_valid
    for splits in sorted({1, r_cnt, wrapper} if kernel != "K6" else {1}):
        for rows in sorted({min(ROWS, b), b - ROWS * (-(-b // ROWS) - 1)}):
            got = np.zeros((ROWS, n, r_cnt, 8), dtype=np.int64)
            for c0, (r0, r1), buckets in grid_z_blocks(
                    kernel, grid_z(kernel, splits, n, js), n, r_cnt, js):
                assert r1 > r0
                mine = cover[c0] * (np.arange(ROWS) < rows)[:, None]
                for s in buckets:
                    got[:, :, r0:r1, s] += mine[:, :, None]
            assert (got[:rows, :, :, js:] == 1).all(), (splits, rows)
            assert not got[rows:].any() and not got[:, :, :, :js].any()


@pytest.mark.parametrize("r_cnt", sorted(WIDE_STEPS))
def test_splits_count_both_column_halves_at_n1024(r_cnt):
    """At N = 1024 a lane tile is two blocks of columns: K10b's and K11's
    split models count both, so each picks what it would for twice the
    tiles (or buckets) at N = 512 — K11 with at most BUCKET_WIDE_SLOTS
    blocks an SM — and below N = 1024 nothing changes."""
    js = WIDE_STEPS[r_cnt]
    for b in (1, 9, 13, 32, 64, 128, 160, 288):
        for o in (1, 3, 5):
            assert (kx._longk_splits(b, o, r_cnt, 1024)
                    == kx._longk_splits(b, 2 * o, r_cnt, 512))
            assert (kx._longk_splits(b, o, r_cnt, 256)
                    == kx._longk_splits(b, o, r_cnt, 512))
            for resident in (1, 3, 6):
                slots = min(resident, kx.BUCKET_WIDE_SLOTS)
                assert (kx._bucket_splits(b, o, r_cnt, 8 - js, resident, 1024)
                        == kx._bucket_splits(b, o, r_cnt, 2 * (8 - js),
                                             slots, 512))
                assert (kx._bucket_splits(b, o, r_cnt, 8 - js, resident, 256)
                        == kx._bucket_splits(b, o, r_cnt, 8 - js, resident,
                                             512))
    # one 8-lane tile, three components: 6 column blocks, so every row of
    # K10b is a block (108 of 132 SMs at R = 18)
    assert kx._longk_splits(1, 3, r_cnt, 1024) == r_cnt


# (B, K10b's split, K11's split) at lvl256's step (O = 3, R = 12, js = 2)
# and the 8-bit model's (O = 3, R = 18, js = 1), K11 at the 3 blocks an SM
# the H100 holds there
WIDE_SPLITS = {"lvl256": [(1, 12, 6), (9, 6, 3), (13, 6, 3), (32, 4, 3),
                          (64, 2, 4), (128, 4, 3), (160, 1, 1), (200, 4, 2),
                          (256, 2, 2), (288, 3, 1)],
               "8-bit": [(1, 18, 6), (9, 9, 3), (13, 9, 3), (32, 5, 3),
                         (64, 5, 3), (128, 4, 3), (160, 1, 3), (200, 6, 1),
                         (256, 2, 2), (288, 3, 1)]}


@pytest.mark.parametrize("step", sorted(WIDE_SPLITS))
def test_wide_split_choice(step):
    """At N = 1024 the splits K10b and K11 take at the two steps' measured
    batches (csrc/probes/longk_splits.py and bucket_splits.py, NVIDIA H100
    80GB HBM3 at 700 W): K10b's are the measured best or within 3% of it
    at 16 of 20 (the others 3.3-12.5% off, the most at lvl256's B = 64);
    K11's within 3% at 14 of 20 (the others 3.4-11% off, the most at
    lvl256's B = 32)."""
    r_cnt, js = (12, 2) if step == "lvl256" else (18, 1)
    for b, longk, bucket in WIDE_SPLITS[step]:
        assert kx._longk_splits(b, 3, r_cnt, 1024) == longk, b
        assert kx._bucket_splits(b, 3, r_cnt, 8 - js, 3, 1024) == bucket, b


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("js", [0, 2])
def test_step_kernels_fit_shared_memory_at_n1024(nd, js):
    """Every build of K6, K7, K10b and K11 fits its two stages in a block's
    232,448 bytes at N = 1024: the wrappers' _check_smem passes, K7 (all 8
    key planes, js = 0) at n_d = 3 with 213,760 bytes."""
    n, nj = 1024, 8 - js
    staged = kx._mma_stage_bytes(n, nj) + 2 * kx._mma_dig_tile_bytes(n, nd)
    kx._check_smem("extprod_step", staged)
    kx._check_smem("extprod_step_longk", staged)
    kx._check_smem("extprod_partials", kx._mma_stage_bytes(n, 8)
                   + 2 * kx._mma_dig_tile_bytes(n, nd))
    kx._check_smem("extprod_step3", kx._mma_stage_bytes(n, nd)
                   + 2 * kx._mma_dig_tile_bytes(n, nd))
    assert (kx._mma_stage_bytes(n, 8) + 2 * kx._mma_dig_tile_bytes(n, 3)
            == 213760)
    assert (kx._mma_stage_bytes(n, nd) + 2 * kx._mma_dig_tile_bytes(n, nd)
            == nd * 37120)
