"""The thread map of nc::glue_wide (csrc/nc_common.cuh), the kernel body of
K2 (csrc/cmux.cu) and K10a (csrc/longk.cu), emulated in numpy and held
against `rot_diff_digits_plain` and `rot_diff_digits_flat_plain`.

A thread owns 8 consecutive columns m0..m0+7 of one accumulator row
(o, b); a block of 128 threads owns 1024/N whole rows. The emulation follows
the kernel thread by thread: the row copy in shared memory padded by one
word every 8, each thread's own words from its 16-byte loads, the rotated
sources (m - t) mod 2N read back from that copy with the sign flip past N,
the rounding shift and the digits of the compile-time gadget, the limbs as
the bytes of (digit + OFF) ^ OFF, and one packed 8-byte store per (level,
limb) plane gathered by __byte_perm, at the address its GlueOut strides
give: K2's [O, L, n_d, B, N] or K10a's flat [n_d, B, R·N]. Every output byte
must be written exactly once. Change an index in glue_wide -> change it here
first. Needs nothing of the JAX package.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tfhe_aes2_tpu_torch.models import shortint_1bit
from tfhe_aes2_tpu_torch.ops import decomposition, params, torus
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx
from tests.test_torch_mma_layout import byte_perm

COLS, THREADS = 8, 128            # nc::GLUE_COLS, nc::GLUE_THREADS
TILE_WORDS = THREADS * COLS * 9 // 8
U64 = np.uint64


def k2_out(o_cnt, levels, n_d, b, n):
    """K2's GlueOut strides (o, b, level, limb) in bytes and its output
    shape [O, L, n_d, B, N]."""
    plane = b * n
    return ((levels * n_d * plane, n, n_d * plane, plane),
            (o_cnt, levels, n_d, b, n))


def k10a_out(o_cnt, levels, n_d, b, n):
    """K10a's GlueOut strides and its output shape [n_d, B, R·N]: limb i of
    level l of row (u, b) at i·B·R·N + b·R·N + (u·L + l)·N + m."""
    rn = o_cnt * levels * n
    return (levels * n, rn, n, b * rn), (n_d, b, rn)


def glue_emulated(acc, t, base_log, levels, n_d, out_layout=k2_out):
    """acc int64 [O, B, N], t int32 [B] -> the int8 digit limb planes in
    out_layout's strides and shape (K2's by default), computed as
    glue_wide computes them, all threads of the grid at once (thread g of
    the grid is thread g % 128 of block g // 128)."""
    o_cnt, b, n = acc.shape
    (st_o, st_b, st_level, st_limb), shape = out_layout(o_cnt, levels, n_d,
                                                        b, n)
    per_row = n // COLS                       # threads a row
    rows = o_cnt * b
    blocks = -(-rows * per_row // THREADS)    # the launch's grid
    g = np.arange(blocks * THREADS)
    blk, tid = g // THREADS, g % THREADS
    lr = tid // per_row
    m0 = (tid - lr * per_row) * COLS
    row = blk * (THREADS // per_row) + lr
    live = row < rows
    blk, lr, m0, row = blk[live], lr[live], m0[live], row[live]
    srow = blk * TILE_WORDS + lr * (n + n // 8)

    acc_u = acc.reshape(-1).view(U64)
    own = np.stack([acc_u[row * n + m0 + k] for k in range(COLS)], -1)
    assert ((row * n + m0) * 8 % 16 == 0).all()        # ulonglong2 loads
    tile = np.zeros(blocks * TILE_WORDS, dtype=U64)
    for k in range(COLS):
        tile[srow + m0 + m0 // 8 + k] = own[:, k]
    # __syncthreads(); then each thread's rotated run
    o, bb = row // b, row % b
    tb = t[bb].astype(np.int64)
    shift = 64 - levels * base_log
    h = sum(1 << (base_log - 1 + base_log * lv) for lv in range(levels))
    off = {1: 0, 2: 0x80, 3: 0x8080}[n_d]
    z = np.zeros((levels, len(row), COLS), dtype=np.uint32)
    with np.errstate(over="ignore"):
        for k in range(COLS):
            src = (m0 + k - tb) & (2 * n - 1)
            x = src & (n - 1)
            # within the block's padded copy of its rows (one at N = 1024)
            assert (lr * (n + n // 8) + x + (x >> 3) < TILE_WORDS).all()
            v = tile[srow + x + (x >> 3)]
            rot = np.where(src < n, v, U64(0) - v)
            y = (((rot - own[:, k] + U64(1 << (shift - 1))) >> U64(shift))
                 + U64(h))
            for lv in range(levels):
                digit = ((y >> U64(base_log * (levels - 1 - lv)))
                         & U64((1 << base_log) - 1)).astype(np.int64)
                digit -= 1 << (base_log - 1)
                z[lv, :, k] = ((digit + off) & 0xFFFFFFFF).astype(
                    np.uint32) ^ np.uint32(off)
    out = np.zeros(o_cnt * levels * n_d * b * n // 8, dtype=U64)
    written = np.zeros(out.size, dtype=np.int64)
    for lv in range(levels):
        for i in range(n_d):
            sel = i | (i + 4) << 4
            half = [byte_perm(byte_perm(z[lv, :, q], z[lv, :, q + 1], sel),
                              byte_perm(z[lv, :, q + 2], z[lv, :, q + 3],
                                        sel), 0x5410) for q in (0, 4)]
            at = o * st_o + bb * st_b + m0 + lv * st_level + i * st_limb
            assert (at % 8 == 0).all()                 # 8-byte stores
            out[at // 8] = half[0].astype(U64) | half[1].astype(U64) << U64(32)
            np.add.at(written, at // 8, 1)
    assert (written == 1).all()                # every byte, exactly once
    return out.view(np.int8).reshape(shape)


def n_d_of(base_log):
    return torus.limbs_for_bound(decomposition.digit_bound(base_log))


T_CASES = ["0", "1", "N-1", "N", "N+1", "2N-1", "random"]


def lane_shifts(case, n, b, rng):
    if case == "random":
        return rng.integers(0, 2 * n, b, dtype=np.int32)
    value = {"0": 0, "1": 1, "N-1": n - 1, "N": n, "N+1": n + 1,
             "2N-1": 2 * n - 1}[case]
    return np.full(b, value, dtype=np.int32)


@pytest.mark.parametrize("n", [64, 256, 512, 1024])
@pytest.mark.parametrize("t_case", T_CASES)
def test_k2_thread_map_matches_plain(n, t_case):
    """At B=13 (O·B = 65 rows: the last block holds fewer rows than it has
    room for at every N below 1024, where a block holds one row), with the rotation 0, 1, N-1, N, N+1, 2N-1 and a
    random one a lane: the emulated kernel equals rot_diff_digits_plain
    bit for bit for every gadget it is built for."""
    rng = np.random.default_rng(1000 * n + T_CASES.index(t_case))
    o_cnt, b = 5, 13
    acc = rng.integers(-2 ** 63, 2 ** 63, (o_cnt, b, n), dtype=np.int64)
    t = lane_shifts(t_case, n, b, rng)
    for levels, base_log in sorted(kx.GLUE_GADGETS):
        n_d = n_d_of(base_log)
        want = kx.rot_diff_digits_plain(torch.from_numpy(acc),
                                        torch.from_numpy(t), base_log,
                                        levels, n_d).numpy()
        got = glue_emulated(acc, t, base_log, levels, n_d)
        assert np.array_equal(got, want), (levels, base_log)


@pytest.mark.parametrize("b", [1, 2, 9, 288])
def test_k2_thread_map_at_every_limb_count(b):
    """The lvl64 gadget (3, 12) with one, two and three limbs a digit (the
    wrapper takes n_d apart from the gadget), at N=512 where a block holds
    two rows: B=1 leaves a block half empty, B=288 is the main path's
    widest batch."""
    rng = np.random.default_rng(77 + b)
    n = 512
    acc = rng.integers(-2 ** 63, 2 ** 63, (5, b, n), dtype=np.int64)
    t = rng.integers(0, 2 * n, b, dtype=np.int32)
    for n_d in (1, 2, 3):
        want = kx.rot_diff_digits_plain(torch.from_numpy(acc),
                                        torch.from_numpy(t), 12, 3,
                                        n_d).numpy()
        assert np.array_equal(glue_emulated(acc, t, 12, 3, n_d), want), n_d


def test_glue_gadgets_match_the_kernel_and_the_parameter_sets():
    """The wrapper's GLUE_GADGETS are the gadgets of NC_GLUE_GADGETS, the
    one list (csrc/nc_common.cuh) whose cases tfhe_rot_diff_digits (K2) and
    tfhe_rot_diff_digits_flat (K10a) both dispatch, and they hold the blind
    rotation's (pbs_level, pbs_base_log) of every parameter set."""
    csrc = Path(kx.__file__).resolve().parents[2] / "csrc"
    src = (csrc / "nc_common.cuh").read_text()
    listed = re.search(r"#define NC_GLUE_GADGETS\(G, CALL\)(.*?)\n\n", src,
                       re.S).group(1)
    cases = {(int(a), int(b))
             for a, b in re.findall(r"G\((\d+), (\d+), CALL\)", listed)}
    assert cases == kx.GLUE_GADGETS
    for name in ("cmux.cu", "longk.cu"):
        assert "NC_GLUE_DISPATCH(nd, levels, base_log," in (
            csrc / name).read_text(), name
    sets = [v for module in (params, shortint_1bit)
            for v in vars(module).values()
            if isinstance(v, params.WopbsParams)]
    assert len(sets) >= 10
    assert shortint_1bit.PARAMS_SHORTINT_1BIT in sets
    assert params.PARAMS_WOPPBS_8BIT in sets
    for p in sets:
        assert (p.pbs_level, p.pbs_base_log) in kx.GLUE_GADGETS


def test_wide_nd_matches_the_split_builds_and_the_parameter_sets():
    """extprod.WIDE_ND names the n_d values whose N = 1024 builds
    VP_SPLIT_DISPATCH (csrc/vp.cu) instantiates — its cases (ND, JS) cover
    exactly WIDE_ND x 0..7, for K3 and K8 both — and those are the circuit
    bootstrap's digit limbs of every set with N = 1024."""
    src = (Path(kx.__file__).resolve().parents[2] / "csrc"
           / "vp.cu").read_text()
    macro = re.search(r"#define VP_SPLIT_DISPATCH\(ND_, JS_, CALL\)(.*?)\n\n",
                      src, re.S).group(1)
    cases = {(int(nd), int(js))
             for nd, js in re.findall(r"CALL\((\d+), (\d+)\)", macro)}
    assert cases == {(nd, js) for nd in kx.WIDE_ND for js in range(8)}
    assert src.count("VP_SPLIT_DISPATCH(nd, js,") == 2
    assert set(kx.WIDE_ND_KERNELS) == {"extprod_grouped_fused",
                                       "extprod_partials_grouped"}
    wide = {torus.limbs_for_bound(decomposition.digit_bound(p.cbs_base_log))
            for p in vars(params).values()
            if isinstance(p, params.WopbsParams) and p.polynomial_size > 512}
    assert wide == set(kx.WIDE_ND) == {1, 2}


def test_k2_refuses_an_unbuilt_gadget_off_the_cpu():
    """Off the CPU a gadget the kernel is not built for raises before any
    launch; on the CPU the plain version takes it."""
    for dev in ("meta", "cpu"):
        acc = torch.zeros((2, 3, 64), dtype=torch.int64, device=dev)
        t = torch.zeros(3, dtype=torch.int32, device=dev)
        if dev == "cpu":
            assert kx.rot_diff_digits(acc, t, 11, 3, 2).shape == (2, 3, 2,
                                                                  3, 64)
        else:
            with pytest.raises(ValueError, match="not built"):
                kx.rot_diff_digits(acc, t, 11, 3, 2)


@pytest.mark.parametrize("n", [64, 256, 512])
@pytest.mark.parametrize("t_case", T_CASES)
def test_k10a_thread_map_matches_plain(n, t_case):
    """K10a is glue_wide with its own output strides: at B=13 with the
    rotation 0, 1, N-1, N, N+1, 2N-1 and a random one a lane, the emulated
    kernel writes every byte of [n_d, B, R·N] once and equals
    rot_diff_digits_flat_plain bit for bit for every gadget it is built
    for."""
    rng = np.random.default_rng(5000 + 1000 * n + T_CASES.index(t_case))
    o_cnt, b = 5, 13
    acc = rng.integers(-2 ** 63, 2 ** 63, (o_cnt, b, n), dtype=np.int64)
    t = lane_shifts(t_case, n, b, rng)
    for levels, base_log in sorted(kx.GLUE_GADGETS):
        n_d = n_d_of(base_log)
        want = kx.rot_diff_digits_flat_plain(
            torch.from_numpy(acc), torch.from_numpy(t), base_log, levels,
            n_d).numpy()
        got = glue_emulated(acc, t, base_log, levels, n_d, k10a_out)
        assert np.array_equal(got, want), (levels, base_log)


@pytest.mark.parametrize("b", [1, 9, 288])
@pytest.mark.parametrize("n_d", [1, 2, 3])
def test_k10a_thread_map_at_every_limb_count(b, n_d):
    """The lvl64 gadget (3, 12) in K10a's flat layout with one, two and three
    limbs a digit at N=512: B=1 leaves a block half empty, B=9 is the
    `longk` counter derivation's batch, B=288 the widest; the flat digits
    are also K2's emulated output permuted."""
    rng = np.random.default_rng(900 + 10 * b + n_d)
    n = 512
    acc = rng.integers(-2 ** 63, 2 ** 63, (5, b, n), dtype=np.int64)
    t = rng.integers(0, 2 * n, b, dtype=np.int32)
    got = glue_emulated(acc, t, 12, 3, n_d, k10a_out)
    want = kx.rot_diff_digits_flat_plain(torch.from_numpy(acc),
                                         torch.from_numpy(t), 12, 3,
                                         n_d).numpy()
    assert np.array_equal(got, want)
    k2 = glue_emulated(acc, t, 12, 3, n_d)               # [O, L, n_d, B, N]
    assert np.array_equal(
        got, k2.transpose(2, 3, 0, 1, 4).reshape(n_d, b, 5 * 3 * n))


def test_k10a_refuses_an_unbuilt_gadget_off_the_cpu():
    """K10a is built for the gadgets of K2 only: off the CPU any other
    raises before a launch; on the CPU the plain version takes it."""
    for dev in ("meta", "cpu"):
        acc = torch.zeros((2, 3, 64), dtype=torch.int64, device=dev)
        t = torch.zeros(3, dtype=torch.int32, device=dev)
        if dev == "cpu":
            assert kx.rot_diff_digits_flat(acc, t, 11, 3, 2).shape == (
                2, 3, 2 * 3 * 64)
        else:
            with pytest.raises(ValueError, match="not built"):
                kx.rot_diff_digits_flat(acc, t, 11, 3, 2)
