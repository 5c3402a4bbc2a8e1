"""The index arithmetic of K4's tensor-core contraction (csrc/matmul.cu) and
of K3's per-lane addressing of nc_mma.cuh (csrc/vp.cu), emulated in numpy
and held against the plain versions.

K4 feeds `mma.sync.m16n8k32` (int8 x int8 -> int32) from two K-major tiles
in shared memory, copied by cp.async 16 bytes at a time: the digits as they
lie (K padded to 16 by the wrapper) and the key planes from the K-major
storage of `kmajor_key_planes`. Both tiles are rows of 64 bytes with
XOR-swizzled 16-byte chunks, read by `ldmatrix.x4`. The emulation below
follows the device code step by step — the wrapper's K padding, key layout
and split choice, the cp.async chunk maps with their zero fill, the
swizzle, the ldmatrix lane addresses, the instruction's fragment layouts,
the warps that skip past the edge, the epilogue's register -> (row, column)
map, the split-K partition with its wrapping sum and the stage ring — so
that every index formula is checked here, where there is no card. Change an
index in matmul.cu -> change it here first. Needs nothing of the JAX
package.
"""

import numpy as np
import pytest
import torch

from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx
from tfhe_aes2_tpu_torch.ops.kernels import matmul as kmm
from tests.test_torch_mma_layout import (GID, LANE, ROWS, TIG, byte_perm,
                                         contract_emulated, unpack_s8)

MW, NW = 3, 4                  # warps along rows, columns
BM, BN, KT = 32 * MW, 16 * NW, 64
STAGES = 4


def swz(row, c):
    """Byte offset of 16-byte chunk c of row `row` in a K-major tile."""
    return row * KT + 16 * (c ^ (((row >> 1) ^ (row >> 3)) & 3))


def ldmatrix_x4(smem, addr):
    """smem uint8 [..., S]; addr int [W, 32], lane l's address of row l % 8
    of matrix l // 8 -> registers uint32 [..., W, 32, 4]: register q of
    thread t is 32-bit word t % 4 of row t // 4 of matrix q."""
    assert (addr % 16 == 0).all(), "ldmatrix rows are 16-byte aligned"
    words = smem.view(np.uint32)
    regs = [words[..., (addr[:, 8 * q + GID] + 4 * TIG) // 4]
            for q in range(4)]
    return np.stack(regs, axis=-1)


def frag_a(regs):
    """A fragment registers [..., 32, 4] -> int8 A [..., 16, 32]."""
    a = np.zeros(regs.shape[:-2] + (16, 32), dtype=np.int8)
    by = unpack_s8(regs)
    for reg in range(4):
        for q in range(4):
            a[..., GID + 8 * (reg & 1), 4 * TIG + q + 16 * (reg >> 1)] = \
                by[..., LANE, reg, q]
    return a


def frag_b(regs):
    """B fragment registers [..., 32, 2] -> int8 B [..., 32, 8]."""
    b = np.zeros(regs.shape[:-2] + (32, 8), dtype=np.int8)
    by = unpack_s8(regs)
    for reg in range(2):
        for q in range(4):
            b[..., 4 * TIG + q + 16 * reg, GID] = by[..., LANE, reg, q]
    return b


def stage_digits(d_flat, shape, b_tiles, t):
    """copy_slice's digit tile of slice t, uint8 [b_tiles, ND, BM·KT], from
    the wrapper's padded digits [ND, B, ldd] (flat, 16 zero bytes after)."""
    n_d, b, k, ldd = shape
    i, row, c, q = np.meshgrid(np.arange(n_d), np.arange(BM), np.arange(4),
                               np.arange(16), indexing="ij")
    brow = BM * np.arange(b_tiles)[:, None, None, None, None] + row
    kk = KT * t + 16 * c
    ok = (brow < b) & (kk < k)
    src = np.where(ok, (i * b + brow) * ldd + kk + q, d_flat.size - 1)
    tile = np.zeros((b_tiles, n_d, BM * KT), dtype=np.int8)
    dest = (swz(row, c) + q)
    for bt_i in range(b_tiles):
        tile[bt_i, i.reshape(-1), dest.reshape(-1)] = np.where(
            ok[bt_i], d_flat[src[bt_i]], 0).reshape(-1)
    return tile.view(np.uint8)


def stage_key(m_flat, shape, n_tiles, t):
    """copy_slice's key tile of slice t, uint8 [n_tiles, NJ, BN·KT], from
    the K-major key storage [NJ, N, ldm] (flat, 16 zero bytes after)."""
    nj, k, n, ldm = shape
    j, col, c, q = np.meshgrid(np.arange(nj), np.arange(BN), np.arange(4),
                               np.arange(16), indexing="ij")
    ncol = BN * np.arange(n_tiles)[:, None, None, None, None] + col
    kk = KT * t + 16 * c
    ok = (ncol < n) & (kk < k)
    src = np.where(ok, (j * n + ncol) * ldm + kk + q, m_flat.size - 1)
    tile = np.zeros((n_tiles, nj, BN * KT), dtype=np.int8)
    dest = (swz(col, c) + q)
    for nt_i in range(n_tiles):
        tile[nt_i, j.reshape(-1), dest.reshape(-1)] = np.where(
            ok[nt_i], m_flat[src[nt_i]], 0).reshape(-1)
    return tile.view(np.uint8)


def kmajor_storage(m):
    """The wrapper's key operand: kmajor_key_planes' view, recognised by
    _kmajor_ld, and the flat storage the kernel addresses."""
    view = kmm.kmajor_key_planes(torch.from_numpy(m))
    ldm = kmm._kmajor_ld(view)
    nj, k, n = m.shape
    assert ldm is not None and ldm % 16 == 0 and ldm >= k
    assert torch.equal(view, torch.from_numpy(m))
    flat = torch.as_strided(view, (nj * n * ldm,), (1,),
                            view.storage_offset()).numpy()
    return np.concatenate([flat, np.zeros(16, np.int8)]), ldm


# mma_slice's ldmatrix lane addresses, per (warp row or column, tile, k-step)
_LO8 = LANE & 7
A_ADDR = np.array([[[swz(32 * wm + _LO8 + 8 * ((LANE >> 3) & 1) + 16 * mt,
                         2 * kt + (LANE >> 4))
                     for kt in range(2)] for mt in range(2)]
                   for wm in range(MW)])                   # [MW, 2, 2, 32]
B_ADDR = np.array([[swz(16 * wn + _LO8 + 8 * (LANE >> 4),
                        2 * kt + ((LANE >> 3) & 1))
                    for kt in range(2)] for wn in range(NW)])   # [NW, 2, 32]


def limb_matmul_emulated(d, m, js, splits=None):
    """d int8 [n_d, B, K], m int8 [8-js, K, N] -> (int64 [B, N], splits),
    computed as the wrapper and the kernel compute it."""
    n_d, b, k = d.shape
    nj, _, n = m.shape
    ldd = -(-k // 16) * 16
    d_pad = np.zeros((n_d, b, ldd), dtype=np.int8)
    d_pad[..., :k] = d
    d_flat = np.concatenate([d_pad.reshape(-1), np.zeros(16, np.int8)])
    m_flat, ldm = kmajor_storage(m)
    if splits is None:
        splits = kmm._splits(b, k, n)
    b_tiles, n_tiles, slices = -(-b // BM), -(-n // BN), -(-k // KT)
    assert 1 <= splits <= slices
    # a warp skips its mma when all its rows or all its columns lie past
    # the edge; its registers stay zero and are never stored
    busy_m = (BM * np.arange(b_tiles)[:, None] + 32 * np.arange(MW)) < b
    busy_n = (BN * np.arange(n_tiles)[:, None] + 16 * np.arange(NW)) < n
    out = np.zeros((b, n), dtype=np.uint64)
    for z in range(splits):
        t0, t1 = z * slices // splits, (z + 1) * slices // splits
        bucket = np.zeros((nj, b_tiles * BM, n_tiles * BN))
        for t in range(t0, t1):
            a_tile = stage_digits(d_flat, (n_d, b, k, ldd), b_tiles, t)
            bt = stage_key(m_flat, (nj, k, n, ldm), n_tiles, t)
            # A[b_tile, i, wm, mt, kt] 16 x 32; B[n_tile, j, wn, kt, nt] 32 x 8
            a = frag_a(ldmatrix_x4(a_tile, A_ADDR.reshape(-1, 32)).reshape(
                b_tiles, n_d, MW, 2, 2, 32, 4))
            breg = ldmatrix_x4(bt, B_ADDR.reshape(-1, 32)).reshape(
                n_tiles, nj, NW, 2, 32, 4)
            bm = np.stack([frag_b(breg[..., 2 * nt:2 * nt + 2])
                           for nt in range(2)], axis=4)
            a_full = a.transpose(1, 0, 2, 3, 5, 4, 6).reshape(
                n_d, b_tiles * BM, KT).astype(np.float64)
            b_full = bm.transpose(1, 3, 5, 0, 2, 4, 6).reshape(
                nj, KT, n_tiles * BN).astype(np.float64)
            for i in range(n_d):
                for j in range(nj):
                    if i + j + js < 8:
                        bucket[i + j] += a_full[i] @ b_full[j]
        assert np.abs(bucket).max() < 2 ** 31     # the int32 buckets hold it
        bucket = bucket.astype(np.int64).reshape(
            nj, b_tiles, MW, 2, 16, n_tiles, NW, 2, 8)
        bucket *= (busy_m[None, :, :, None, None, None, None, None, None]
                   & busy_n[None, None, None, None, None, :, :, None, None])
        # D fragment (PTX layout), then the epilogue's map back to (b, n)
        bucket = bucket.transpose(0, 1, 2, 3, 5, 6, 7, 4, 8)
        for c in range(4):
            reg = bucket[..., GID + 8 * (c >> 1), 2 * TIG + (c & 1)]
            total = np.zeros(reg.shape[1:], dtype=np.uint64)
            for s in range(nj):
                with np.errstate(over="ignore"):
                    total += (reg[s].astype(np.uint64)
                              << np.uint64(8 * (s + js)))
            # total: [b_tiles, MW, 2(mt), n_tiles, NW, 2(nt), 32 lanes]
            bt_i, wm, mt, nt_i, wn, nt, ln = np.meshgrid(
                *[np.arange(x) for x in total.shape], indexing="ij")
            rows = (BM * bt_i + 32 * wm + 16 * mt + (ln >> 2) + 8 * (c >> 1))
            cols = (BN * nt_i + 16 * wn + 8 * nt + 2 * (ln & 3) + (c & 1))
            keep = (rows < b) & (cols < n)
            with np.errstate(over="ignore"):
                np.add.at(out, (rows[keep], cols[keep]), total[keep])
    return out.view(np.int64), splits


def _plain(d, m, js):
    return kmm.fused_limb_matmul_plain(torch.from_numpy(d),
                                       torch.from_numpy(m), js).numpy()


@pytest.mark.parametrize("b,k,n,n_d,js", [
    (13, 130, 40, 3, 1),       # pfKS-like planes, every edge ragged
    (70, 130, 678, 1, 5),      # the keyswitch's N and planes, split K
    (1, 4098, 40, 3, 1),       # the pfKS's K: unaligned rows, 65 slices
    (13, 4098, 678, 1, 5),     # the keyswitch's N at the pfKS's K
    (70, 4098, 40, 1, 1),      # two row tiles of warps, one past the edge
    (1, 130, 678, 3, 5),
    (13, 2049, 40, 4, 1),      # lvl1's pfKS: four limbs, K = (kN+1)·L
    (70, 130, 40, 4, 0),       # four limbs against all eight key planes
])
def test_k4_fragment_map_matches_plain(b, k, n, n_d, js):
    """The emulated K4 equals fused_limb_matmul_plain bit for bit on random
    int8 operands, with the wrapper's split of K and with none."""
    rng = np.random.default_rng(b * 7 + k + n + n_d + js)
    d = rng.integers(-128, 128, (n_d, b, k), dtype=np.int8)
    m = rng.integers(-128, 128, (8 - js, k, n), dtype=np.int8)
    want = _plain(d, m, js)
    got, splits = limb_matmul_emulated(d, m, js)
    assert np.array_equal(got, want)
    if splits > 1:
        assert np.array_equal(limb_matmul_emulated(d, m, js, splits=1)[0],
                              want)


def test_k4_extreme_values_at_longest_k():
    """Every digit and key byte -128 at the longest K the wrapper admits for
    three digit limbs (3·K·2^14 < 2^31): the largest int32 bucket, exact in
    one block (the wrapper would split this K; the split is checked
    above)."""
    n_d, js = 3, 1
    k = ((1 << 31) - 1) // (n_d << 14)
    d = np.full((n_d, 1, k), -128, dtype=np.int8)
    m = np.full((8 - js, k, 8), -128, dtype=np.int8)
    want = _plain(d, m, js)
    assert np.array_equal(limb_matmul_emulated(d, m, js, splits=1)[0], want)


@pytest.mark.parametrize("b,k,n,split", [
    (288, 8192, 678, 4), (9, 8192, 678, 12), (160, 8192, 678, 6),
    (288, 4098, 12800, 1), (9, 4098, 12800, 1), (1, 130, 40, 1),
])
def test_k4_split_choice(b, k, n, split):
    """The wrapper's split fills the card's 132 SMs with one block each
    where the output has few tiles, and keeps 8 slices a block."""
    assert kmm._splits(b, k, n) == split


@pytest.mark.parametrize("cnt", range(1, 9))
def test_k4_stage_ring(cnt):
    """The kernel's cp.async ring of STAGES slices: one commit group a slice
    (empty past the last), wait_group(STAGES - 2) then a barrier at slice r.
    Then slice r's group is complete, and the stage the next copy overwrites
    is the one slice r-1's mma read, which every warp has left (the
    barrier); no stage is written while it is being read."""
    groups = []                      # per committed group: its slice or None
    written_at = {}                  # stage -> slice it holds
    for s in range(STAGES - 1):
        groups.append(s if s < cnt else None)
        if s < cnt:
            written_at[s % STAGES] = s
    for r in range(cnt):
        pending = STAGES - 2                      # wait_group(STAGES - 2)
        complete = groups[:len(groups) - pending]
        assert r in complete
        assert written_at[r % STAGES] == r
        nxt = r + STAGES - 1
        if nxt < cnt:
            assert nxt % STAGES == (r - 1) % STAGES
            written_at[nxt % STAGES] = nxt
        groups.append(nxt if nxt < cnt else None)
        # the mma of slice r reads stage r % STAGES, not the one in flight
        assert nxt % STAGES != r % STAGES


def test_k4_swizzle_is_conflict_free():
    """Each 8-row matrix of an ldmatrix puts one chunk index into eight
    different groups of four banks, for both tiles and every lane address."""
    for addr in list(A_ADDR.reshape(-1, 32)) + list(B_ADDR.reshape(-1, 32)):
        for q in range(4):
            groups = (addr[8 * q:8 * q + 8] // 16) % 8
            assert len(set(groups)) == 8


@pytest.mark.parametrize("g,n_d,js", [(11, 2, 4), (1, 2, 4), (8, 1, 6)])
def test_k3_staged_addressing_matches_plain(g, n_d, js):
    """K3 through nc::contract_mma: each block's Staged record (its lane's
    GGSW rows, its 8-accumulator tile of the lane's digits, rows_valid =
    min(8, G - g0)) read from the flat operands, emulated by the K1/K9
    fragment map, equals extprod_grouped_fused_plain bit for bit."""
    rng = np.random.default_rng(10 * g + n_d + js)
    b, o_cnt, r_cnt, n = 2, 2, 3, 64
    nj = 8 - js
    dig = rng.integers(-128, 128, (b, r_cnt, n_d * g, n), dtype=np.int8)
    ext = rng.integers(-128, 128, (b, o_cnt, r_cnt, nj, 2 * n), dtype=np.int8)
    want = kx.extprod_grouped_fused_plain(torch.from_numpy(dig),
                                          torch.from_numpy(ext), n_d,
                                          js).numpy()
    dig_f, ext_f = dig.reshape(-1), ext.reshape(-1)
    got = np.zeros_like(want)
    for lane in range(b):
        for o in range(o_cnt):
            for g0 in range(0, g, ROWS):
                rows_valid = min(ROWS, g - g0)
                ext_at = (lane * o_cnt + o) * r_cnt * nj * 2 * n
                dig_at = (lane * r_cnt * n_d * g + g0) * n
                dig_r, dig_plane = n_d * g * n, g * n
                tile = np.zeros((r_cnt, n_d, ROWS, n), dtype=np.int8)
                key = np.zeros((r_cnt, nj, 2 * n), dtype=np.int8)
                for r in range(r_cnt):
                    at = ext_at + r * nj * 2 * n   # row r's key rows
                    key[r] = ext_f[at:at + nj * 2 * n].reshape(nj, 2 * n)
                    for i in range(n_d):
                        for row in range(rows_valid):
                            at = dig_at + r * dig_r + i * dig_plane + row * n
                            tile[r, i, row] = dig_f[at:at + n]
                block = contract_emulated(tile, key, js)
                got[lane, o, g0:g0 + rows_valid] = block[:rows_valid]
    assert np.array_equal(got, want)


def _slice_products(nd, js, by_rows):
    """The (mt, nt, i, j, bucket) of every mma one warp issues in one k-step
    of mma_slice (by_rows False: all A fragments live, j then i then mt, nt)
    or of mma_slice_by_rows (ND = 4: mt outermost, one row tile's A
    fragments live), as csrc/matmul.cu orders them."""
    issued = []
    if not by_rows:
        for j in range(js, 8):
            for i in range(nd):
                if i + j < 8:
                    issued += [(mt, nt, i, j, i + j - js)
                               for mt in range(2) for nt in range(2)]
    else:
        for mt in range(2):
            for j in range(js, 8):
                for i in range(nd):
                    if i + j < 8:
                        issued += [(mt, nt, i, j, i + j - js)
                                   for nt in range(2)]
    return issued


@pytest.mark.parametrize("js", range(8))
def test_k4_four_limb_bucket_map(js):
    """ND = 4's k-step (mma_slice_by_rows) issues the same products into the
    same weight buckets as mma_slice's order would: each (row tile, column
    tile, limb i, key plane j) with i + j < 8 once, into bucket i + j - js;
    the products of weight 2^64 and above are never issued. A fragments
    live at once: 4 registers a limb, 16 instead of 32."""
    by_rows = _slice_products(4, js, True)
    assert sorted(by_rows) == sorted(_slice_products(4, js, False))
    assert len(set(by_rows)) == len(by_rows)
    want = {(mt, nt, i, j) for mt in range(2) for nt in range(2)
            for i in range(4) for j in range(js, 8) if i + j < 8}
    assert {x[:4] for x in by_rows} == want
    assert all(0 <= x[4] < 8 - js for x in by_rows)
