"""The per-block addressing of K5 (csrc/cmux.cu, K1's kernel without its
glue) and K10b (csrc/longk.cu) through nc_mma.cuh's `Staged` record,
emulated in numpy and held against the plain versions.

Both run `nc::contract_mma`, whose fragment map `contract_emulated`
(tests/test_torch_mma_layout.py) follows register by register. What is new
here is where each block's operands lie: the `Staged` record's base
pointers and its three digit strides (row, plane, lane), the zero fill of
the lanes past the batch edge, and for K10b the split of the R contraction
rows across blocks, whose recombined partials the kernel adds into the
accumulator with 64-bit atomics (wrapping u64 here). Change an index in
cmux.cu, longk.cu or nc_mma.cuh -> change it here first. Needs nothing of
the JAX package.
"""

import numpy as np
import pytest
import torch

from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx
from tests.test_torch_mma_layout import ROWS, contract_emulated

N = 64


def staged_block(dig_f, ext_f, rec, r_cnt, rows_valid, n_d, nj, n):
    """The operands one block's contract_mma stages, read from the flat
    operands through its Staged record: the R key rows (NJ planes of 2N
    bytes, contiguous from ext_at) and the padded digit tiles, digit plane i
    of lane `row` at row r from dig_at + r·dig_r + i·dig_plane +
    row·dig_lane; lanes at or past rows_valid are zero (copy_digits_async's
    zero-byte copies)."""
    ext_at, dig_at, dig_r, dig_plane, dig_lane = rec
    tile = np.zeros((r_cnt, n_d, ROWS, n), dtype=np.int8)
    key = np.zeros((r_cnt, nj, 2 * n), dtype=np.int8)
    for r in range(r_cnt):
        at = ext_at + r * nj * 2 * n
        assert at + nj * 2 * n <= ext_f.size
        key[r] = ext_f[at:at + nj * 2 * n].reshape(nj, 2 * n)
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
    split = kx._longk_splits(b, k1, r_cnt)
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
    assert kx._longk_splits(b, 5, 15) == split


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
                s = kx._longk_splits(b, o, r)
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
