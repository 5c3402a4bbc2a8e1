"""K9 at N = 1024 (csrc/merged_wide.cu): the index map of its cluster, emulated
in numpy and held against the plain versions.

At N = 1024 the 2·O blocks of a lane tile — component o x column half h,
cluster rank o + O·h — are one cluster. Block (o, h) glues component o's L
rows at its own columns [512h, 512h + 512) into its shared memory,
[L][n_d][ROWS][512] after the two stages of the contraction; then every
block copies each contraction row r = u·L + l's digit tile [n_d][ROWS][N +
16] from blocks (u, 0) and (u, 1) into its stage (copy_dig), 2·n_d pieces
of 16 bytes a thread, and contracts it as K1 does (the contraction's
fragment map is tests/test_torch_mma_layout.py's, its column split
tests/test_torch_step_mma_layout.py's). Checked here: which block glues
which (component, level, column); that every byte of every staged tile
comes from exactly one owner and equals the plain glue's digit (zero past
the batch edge); that every output column is written by one block; that
every offset stays inside the block's reckoned bytes and those under the
232,448 a block may have, for each set of ops/params.py. Change an index in
merged_wide.cu -> change it here first. Needs nothing of the JAX package.
"""

import numpy as np
import pytest
import torch

from tfhe_aes2_tpu_torch.ops import decomposition, torus, truncation
from tfhe_aes2_tpu_torch.ops import params as params_mod
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx
from tests.test_torch_mma_layout import PAD, ROWS
from tests.test_torch_step_mma_layout import fragment_cover

N = 1024
HALF = 512                      # a block's output columns
THREADS = 256                   # a block's threads: one warp per 64 columns
SMEM_LIMIT = 232448             # bytes of shared memory a block may take

# every set of ops/params.py by name, and those with N = 1024
SETS = {name: p for name, p in vars(params_mod).items()
        if isinstance(p, params_mod.WopbsParams)}
WIDE_SETS = sorted(name for name, p in SETS.items()
                   if p.polynomial_size == N)


def geometry(p):
    """(O, L, base_log, n_d, js) of the set's blind rotation."""
    n_d = torus.limbs_for_bound(decomposition.digit_bound(p.pbs_base_log))
    return (p.glwe_dimension + 1, p.pbs_level, p.pbs_base_log, n_d,
            truncation.bsk_j_start(p))


def wide_stage_bytes(n_d, nj):
    """Two stages of S-tables, raw key rows and padded digit tiles (K1's)."""
    return 2 * (nj * 2 * N * 4 + nj * 2 * N + n_d * ROWS * (N + PAD))


def own_bytes(n_d, levels):
    """A block's own digits, [L][n_d][ROWS][512]."""
    return levels * n_d * ROWS * HALF


def cluster_rank(o, h, k1):
    """The rank of block (x, o, h) in a cluster of dimension {1, O, 2}
    whose grid is (ceil(B/8), O, 2): x + 1·(o + O·h)."""
    return o + k1 * h


def glue_offsets(levels, n_d, row, c0):
    """Where nc::glue writes digit limb i of level l of lane `row` at
    column m in [c0, c0 + 512): out = own + row·512 - c0, byte
    l·level_stride + i·limb_stride + m of it -> int [L, n_d, 512]."""
    level_stride, limb_stride = n_d * ROWS * HALF, ROWS * HALF
    l = np.arange(levels)[:, None, None]
    i = np.arange(n_d)[None, :, None]
    m = c0 + np.arange(HALF)[None, None, :]
    return l * level_stride + i * limb_stride + row * HALF - c0 + m


def own_regions(dig, b0, rows, k1, levels, n_d):
    """The cluster's own digits for the lane tile from b0: dig int8
    [O, L, n_d, B, N] (the plain glue) -> int8 [2·O, own bytes] by cluster
    rank; lanes at or past `rows` all zero. Every byte written once."""
    size = own_bytes(n_d, levels)
    regions = np.full((2 * k1, size), 77, dtype=np.int8)
    for o in range(k1):
        for h in range(2):
            c0 = h * HALF
            own = regions[cluster_rank(o, h, k1)]
            count = np.zeros(size, dtype=np.int64)
            for row in range(ROWS):
                at = glue_offsets(levels, n_d, row, c0)
                assert at.min() >= 0 and at.max() < size
                own[at] = (dig[o, :, :, b0 + row, c0:c0 + HALF]
                           if row < rows else 0)
                np.add.at(count, at, 1)
            assert (count == 1).all()
    return regions


def copy_map(r, levels, n_d, k1):
    """copy_dig's pieces for contraction row r, per (thread, k): the source
    rank, the byte offset in its own digits and the byte offset in the
    staged tile [n_d][ROWS][N + 16], each a 16-byte piece."""
    chunks = N // 16
    per = n_d * ROWS * chunks // THREADS
    assert per * THREADS == n_d * ROWS * chunks and per == 2 * n_d
    idx = np.arange(THREADS)[:, None] + THREADS * np.arange(per)[None, :]
    chunk = idx % chunks
    row = (idx // chunks) % ROWS
    i = idx // (chunks * ROWS)
    h = chunk // (chunks // 2)
    u, l = divmod(r, levels)
    src = (((l * n_d + i) * ROWS + row) * HALF
           + 16 * (chunk - h * (chunks // 2)))
    dst = (i * ROWS + row) * (N + PAD) + 16 * chunk
    return u + k1 * h, src, dst


def staged_tile(regions, r, levels, n_d, k1):
    """Row r's digit tile as copy_dig stages it from the cluster's own
    digits -> int8 [n_d, ROWS, N]; every byte of the tile's rows written
    once, the padding never."""
    rank, src, dst = copy_map(r, levels, n_d, k1)
    size = own_bytes(n_d, levels)
    assert src.min() >= 0 and src.max() + 16 <= size
    assert src.min() % 16 == 0 and dst.min() % 16 == 0
    tile = np.zeros(n_d * ROWS * (N + PAD), dtype=np.int8)
    count = np.zeros_like(tile, dtype=np.int64)
    span = np.arange(16)
    tile[dst[..., None] + span] = regions[rank[..., None],
                                          src[..., None] + span]
    np.add.at(count, dst[..., None] + span, 1)
    count = count.reshape(n_d, ROWS, N + PAD)
    assert (count[:, :, :N] == 1).all() and not count[:, :, N:].any()
    return tile.reshape(n_d, ROWS, N + PAD)[:, :, :N]


@pytest.mark.parametrize("name", WIDE_SETS)
def test_k9_cluster_glues_each_row_and_column_once(name):
    """Over the cluster's 2·O blocks, each (contraction row, digit column)
    of the lane tile is glued by exactly one block: block (o, h), rank
    o + O·h, the rows o·L .. o·L + L - 1 at columns [512h, 512h + 512); the
    ranks are 0 .. 2·O - 1 once each, at most 16 (K9_CLUSTER_MAX)."""
    k1, levels, _, n_d, _ = geometry(SETS[name])
    r_cnt = k1 * levels
    ranks = sorted(cluster_rank(o, h, k1) for o in range(k1) for h in (0, 1))
    assert ranks == list(range(2 * k1)) and 2 * k1 <= kx.K9_CLUSTER_MAX
    glued = np.zeros((r_cnt, N), dtype=np.int64)
    for o in range(k1):
        for h in (0, 1):
            glued[o * levels:(o + 1) * levels, h * HALF:(h + 1) * HALF] += 1
    assert (glued == 1).all()
    # and every row's tile reads its two halves from those two blocks
    for r in range(r_cnt):
        rank, _, dst = copy_map(r, levels, n_d, k1)
        column = (dst % (N + PAD))
        u = r // levels
        assert np.array_equal(rank, u + k1 * (column // HALF))


@pytest.mark.parametrize("name", WIDE_SETS)
def test_k9_cluster_stages_the_glue_of_every_row(name):
    """At the set's gadget, on a ragged batch of 13 (two lane tiles, the
    second with 5 lanes) whose rotations include 0, N-1, N and 2N-1: the
    own digits the cluster's blocks glue, staged row by row through
    copy_dig, are the plain glue's digits of the lane tile (zero past the
    batch edge), each (row, limb, lane, column) read from one owner, local
    or partner; contracted, they give cmux_step_merged_plain."""
    p = SETS[name]
    k1, levels, base_log, n_d, js = geometry(p)
    rng = np.random.default_rng(len(name) + 1024)
    b = 13
    acc = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63, (k1, b, N),
                                        dtype=np.int64))
    t = torch.from_numpy(rng.integers(0, 2 * N, b).astype(np.int32))
    t[:4] = torch.tensor([0, N - 1, N, 2 * N - 1], dtype=torch.int32)
    dig = kx.rot_diff_digits_plain(acc, t, base_log, levels, n_d).numpy()
    staged = np.zeros_like(dig)                      # [O, L, n_d, B, N]
    for b0 in range(0, b, ROWS):
        rows = min(ROWS, b - b0)
        regions = own_regions(dig, b0, rows, k1, levels, n_d)
        for r in range(k1 * levels):
            u, l = divmod(r, levels)
            tile = staged_tile(regions, r, levels, n_d, k1)
            assert not tile[:, rows:].any()
            staged[u, l, :, b0:b0 + rows] = tile[:, :rows]
            # the block (o, h) that stages it reads 1 of its 2·O owners'
            # pieces from itself, the others from partners
            rank, _, _ = copy_map(r, levels, n_d, k1)
            for o in range(k1):
                for h in (0, 1):
                    local = rank == cluster_rank(o, h, k1)
                    assert local.sum() == (rank.size // 2 if o == u else 0)
    assert np.array_equal(staged, dig)
    ext = torch.from_numpy(rng.integers(-128, 128, (k1, k1 * levels, 8 - js,
                                                    2 * N), dtype=np.int8))
    got = kx.extprod_step2_plain(torch.from_numpy(staged), ext, acc.clone(),
                                 js)
    assert torch.equal(got, kx.cmux_step_merged_plain(t, ext, acc, base_log,
                                                      levels, js))


def test_k9_cluster_writes_every_output_once():
    """The two column halves of component o (blockIdx.y) write each (lane,
    column) of its 8 x 1024 output tile once between them, through
    nc::for_each_output with c0 = 512h."""
    cover = fragment_cover(N, 0) + fragment_cover(N, HALF)
    assert (cover == 1).all()


@pytest.mark.parametrize("js", ["set", 0])
@pytest.mark.parametrize("name", WIDE_SETS + ["PARAMS_SQRD_LVL_64",
                                              "PARAMS_SQRD_LVL_64_MXU"])
def test_k9_fits_shared_memory(name, js):
    """K9's block for each set at its BSK truncation js and at js = 0: at
    N = 1024 the two stages then the block's own digits, every offset
    copy_dig and the glue reach inside them; at N <= 512 the front (stages
    or the glue's accumulator tile) then all R resident digit tiles. Each
    equals the wrapper's _k9_smem and is under 232,448."""
    p = SETS[name]
    k1, levels, _, n_d, js_set = geometry(p)
    js = js_set if js == "set" else js
    n, nj, r_cnt = p.polynomial_size, 8 - js, k1 * levels
    if n == N:
        stages, own = wide_stage_bytes(n_d, nj), own_bytes(n_d, levels)
        total = stages + own
        top = max(glue_offsets(levels, n_d, ROWS - 1, c0).max()
                  for c0 in (0, HALF))
        assert top == own - 1
        for r in range(r_cnt):
            _, src, dst = copy_map(r, levels, n_d, k1)
            assert src.max() + 16 <= own
            assert dst.max() + 16 <= n_d * ROWS * (N + PAD)
        assert stages % 16 == 0            # the own digits 16-byte aligned
    else:
        front = max(2 * (nj * 2 * n * 4 + nj * 2 * n), ROWS * n * 8)
        total = front + r_cnt * n_d * ROWS * (n + PAD)
    assert total == kx._k9_smem(n, nj, n_d, levels, r_cnt)
    assert total <= SMEM_LIMIT, (name, js, total)
    kx._check_smem("cmux_step_merged", total)
