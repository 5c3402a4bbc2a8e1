"""The port's CUDA kernels on the card, held bit-for-bit against their plain
versions at small shapes with ragged batch, group and contraction edges.

Needs an NVIDIA GPU and nvcc; skips without a GPU. Imports no JAX, so on a
machine without it run: python -m pytest tests/test_torch_cuda.py -m cuda
--noconftest"""

import pytest
import torch

from tfhe_aes2_tpu_torch.ops import decomposition, params, polynomial, torus
from tfhe_aes2_tpu_torch.ops import truncation
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx
from tfhe_aes2_tpu_torch.ops.kernels import matmul as kmm
from tests.torch_port_common import require_cuda


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """On the card: every kernel bit-equal to its plain version at small
    shapes, including ragged batch and group edges."""
    require_cuda()
    gen = torch.Generator().manual_seed(5)
    dev = "cuda"

    def r8(*shape):
        return torch.randint(-128, 128, shape, generator=gen,
                             dtype=torch.int8).to(dev)

    n, k1, levels, b, base_log, n_d, js = 64, 3, 2, 13, 12, 2, 2
    acc = torch.randint(-2 ** 62, 2 ** 62, (k1, b, n), generator=gen,
                        dtype=torch.int64).to(dev)
    t = torch.randint(0, 2 * n, (b,), generator=gen,
                      dtype=torch.int32).to(dev)
    assert torch.equal(kx.rot_diff_digits(acc, t, base_log, levels, n_d),
                       kx.rot_diff_digits_plain(acc, t, base_log, levels,
                                                n_d))
    dig, ext = r8(k1, levels, n_d, b, n), r8(k1, k1 * levels, 8 - js, 2 * n)
    a1, d1 = kx.extprod_step2g(dig, ext, acc.clone(), t, base_log, levels, js)
    a2, d2 = kx.extprod_step2g_plain(dig, ext, acc.clone(), t, base_log,
                                     levels, js)
    assert torch.equal(a1, a2) and torch.equal(d1, d2)
    # K5 / K6: the same update without the glue, in place / batch-major
    a5 = kx.extprod_step2(dig, ext, acc.clone(), js)
    assert torch.equal(a5, kx.extprod_step2_plain(dig, ext, acc.clone(), js))
    assert torch.equal(a5, a1)
    dig_bm = dig.reshape(k1 * levels, n_d, b, n).permute(1, 2, 0, 3).contiguous()
    acc_bm = acc.permute(1, 0, 2).contiguous()
    a6 = kx.extprod_step(dig_bm, ext, acc_bm, js)
    assert torch.equal(a6, kx.extprod_step_plain(dig_bm, ext, acc_bm, js))
    assert torch.equal(a6.permute(1, 0, 2), a1)
    # K9 / K10a + K10b / K2 + K11: the same step, one launch / flat digits,
    # rows split across blocks / one bucket per block with atomics; ragged
    # last tile
    a9 = kx.cmux_step_merged(t, ext, acc, base_log, levels, js)
    assert torch.equal(a9, kx.cmux_step_merged_plain(t, ext, acc, base_log,
                                                     levels, js))
    d2 = kx.rot_diff_digits(acc, t, base_log, levels, n_d)
    want = kx.extprod_step2(d2, ext, acc.clone(), js)
    assert torch.equal(a9, want)
    flat = kx.rot_diff_digits_flat(acc, t, base_log, levels, n_d)
    assert torch.equal(flat, kx.rot_diff_digits_flat_plain(acc, t, base_log,
                                                           levels, n_d))
    a10 = kx.extprod_step_longk(flat, ext, acc.clone(), js)
    assert torch.equal(a10, kx.extprod_step_longk_plain(flat, ext,
                                                        acc.clone(), js))
    assert torch.equal(a10, want)
    a11 = kx.extprod_step3(d2, ext, acc.clone(), js)
    assert torch.equal(a11, kx.extprod_step3_plain(d2, ext, acc.clone(), js))
    assert torch.equal(a11, want)
    # K7: all 8 key planes; recombined over zeroed low planes it is K6
    ext8 = r8(8, k1 * levels, k1, 2 * n)
    parts = kx.extprod_partials(dig_bm, ext8)
    assert torch.equal(parts, kx.extprod_partials_plain(dig_bm, ext8))
    ext8[:js] = 0
    assert torch.equal(
        acc_bm + polynomial.recombine_partials(
            kx.extprod_partials(dig_bm, ext8)),
        kx.extprod_step(dig_bm, ext8[js:].permute(2, 1, 0, 3).contiguous(),
                        acc_bm, js))
    # K8: ragged group edge, rows below js zero
    dig8, ext_8 = r8(n_d, 3, 11, 4, n), r8(4, 3, 4, 2, 2 * n)
    parts = kx.extprod_partials_grouped(dig8, ext_8, 4)
    assert torch.equal(parts,
                       kx.extprod_partials_grouped_plain(dig8, ext_8, 4))
    assert not parts[:4].any()
    dig, ext = r8(3, 4, n_d * 11, n), r8(3, 2, 4, 4, 2 * n)
    assert torch.equal(kx.extprod_grouped_fused(dig, ext, n_d, 4),
                       kx.extprod_grouped_fused_plain(dig, ext, n_d, 4))
    d, m = r8(3, 37, 101), r8(7, 101, 75)
    assert torch.equal(kmm.fused_limb_matmul(d, m, 1),
                       kmm.fused_limb_matmul_plain(d, m, 1))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 256, 512])
@pytest.mark.parametrize("b", [1, 9, 13, 288])
def test_cuda_tensor_core_steps_match_plain(n, b):
    """On the card: K1, K5, K6, K9, K10b and K11 (mma.sync int8; K10b split
    across blocks at B <= 13, K11 at its split, unsplit and a row a block)
    bit-equal to their plain versions with a ragged last lane tile, for js
    in {0, 2} and one, two and three limbs a digit."""
    require_cuda()
    gen = torch.Generator().manual_seed(1000 * n + b)
    k1, levels = 2, 2
    for js in (0, 2):
        for n_d, base_log in ((1, 6), (2, 12), (3, 20)):
            acc = torch.randint(-2 ** 62, 2 ** 62, (k1, b, n), generator=gen,
                                dtype=torch.int64).cuda()
            t = torch.randint(0, 2 * n, (b,), generator=gen,
                              dtype=torch.int32).cuda()
            dig = torch.randint(-128, 128, (k1, levels, n_d, b, n),
                                generator=gen, dtype=torch.int8).cuda()
            ext = torch.randint(-128, 128, (k1, k1 * levels, 8 - js, 2 * n),
                                generator=gen, dtype=torch.int8).cuda()
            a1, d1 = kx.extprod_step2g(dig, ext, acc.clone(), t, base_log,
                                       levels, js)
            a2, d2 = kx.extprod_step2g_plain(dig, ext, acc.clone(), t,
                                             base_log, levels, js)
            assert torch.equal(a1, a2) and torch.equal(d1, d2)
            assert torch.equal(
                kx.cmux_step_merged(t, ext, acc, base_log, levels, js),
                kx.cmux_step_merged_plain(t, ext, acc, base_log, levels, js))
            _assert_undivided_steps_match_plain(dig, ext, acc, js)
    torch.cuda.synchronize()


def _assert_undivided_steps_match_plain(dig, ext, acc, js):
    """The step's update without its glue, each bit-equal to its plain
    version: K5 and K11 on K2's layout (K11 at the wrapper's split, unsplit
    and a row a block), K10b on the same digits laid flat (K10a's layout),
    K6 on them batch-major."""
    k1, levels, n_d, b, n = dig.shape
    assert torch.equal(kx.extprod_step2(dig, ext, acc.clone(), js),
                       kx.extprod_step2_plain(dig, ext, acc.clone(), js))
    flat = dig.permute(2, 3, 0, 1, 4).reshape(n_d, b, k1 * levels * n)
    assert torch.equal(kx.extprod_step_longk(flat, ext, acc.clone(), js),
                       kx.extprod_step_longk_plain(flat, ext, acc.clone(),
                                                   js))
    dig_bm = dig.reshape(k1 * levels, n_d, b, n).permute(1, 2, 0,
                                                         3).contiguous()
    acc_bm = acc.permute(1, 0, 2).contiguous()
    assert torch.equal(kx.extprod_step(dig_bm, ext, acc_bm, js),
                       kx.extprod_step_plain(dig_bm, ext, acc_bm, js))
    want = kx.extprod_step3_plain(dig, ext, acc.clone(), js)
    assert torch.equal(kx.extprod_step3(dig, ext, acc.clone(), js), want)
    for splits in (1, k1 * levels):
        got = kx._launch_step3(dig, ext, acc.clone(), js, splits)
        assert torch.equal(got, want), splits


@pytest.mark.cuda
def test_cuda_tensor_core_steps_extreme_values():
    """On the card: every digit and key byte -128 at the blind rotation's
    R=15, N=512, n_d=2, js=2 — each int32 bucket at the bound the wrappers
    admit — still bit-equal to plain (K9's digits come from its own glue, so
    only its key is extreme); K5, K6, K10b and K11 too, K10b split in 8 at
    B=13 and unsplit at B=201, K11 at its split, unsplit and a row a
    block."""
    require_cuda()
    gen = torch.Generator().manual_seed(9)
    k1, levels, n, n_d, js, base_log = 5, 3, 512, 2, 2, 12
    assert [kx._longk_splits(b, k1, k1 * levels, n)
            for b in (13, 201)] == [8, 1]
    for b in (13, 201):
        dig = torch.full((k1, levels, n_d, b, n), -128, dtype=torch.int8,
                         device="cuda")
        ext = torch.full((k1, k1 * levels, 8 - js, 2 * n), -128,
                         dtype=torch.int8, device="cuda")
        acc = torch.randint(-2 ** 62, 2 ** 62, (k1, b, n), generator=gen,
                            dtype=torch.int64).cuda()
        t = torch.randint(0, 2 * n, (b,), generator=gen,
                          dtype=torch.int32).cuda()
        a1, d1 = kx.extprod_step2g(dig, ext, acc.clone(), t, base_log, levels,
                                   js)
        a2, d2 = kx.extprod_step2g_plain(dig, ext, acc.clone(), t, base_log,
                                         levels, js)
        assert torch.equal(a1, a2) and torch.equal(d1, d2)
        assert torch.equal(
            kx.cmux_step_merged(t, ext, acc, base_log, levels, js),
            kx.cmux_step_merged_plain(t, ext, acc, base_log, levels, js))
        _assert_undivided_steps_match_plain(dig, ext, acc, js)
    torch.cuda.synchronize()


def _k1_mma_sync(dig, ext, acc, t, base_log, levels, js):
    """K1 on mma.sync (csrc/cmux.cu, N <= 512) through its C entry, whatever
    extprod.k1_path would take: (acc updated in place, next digits)."""
    k1, _, n_d, b, n = dig.shape
    out = torch.empty_like(dig)
    f = kx._fn("cmux", "tfhe_extprod_step2g", [kx._P] * 5 + [kx._I] * 8
               + [kx._P])
    kx.build.check(f(dig.data_ptr(), ext.data_ptr(), acc.data_ptr(),
                     t.data_ptr(), out.data_ptr(), b, n, k1, ext.shape[1],
                     levels, n_d, js, base_log,
                     kx.build.stream_ptr(acc.device)), "extprod_step2g")
    return acc, out


@pytest.mark.cuda
@pytest.mark.parametrize("b", [9, 32, 40, 128, 288, 2048])
def test_cuda_k1_wgmma_matches_plain_and_mma_sync(b):
    """On the card at PARAMS_SQRD_LVL_64's step (N=512, R=15, n_d=2, js=2):
    K1 as the wrapper launches it at every batch (cmux_wg.cu, wgmma over
    32-lane tiles; B=9 and 40 a ragged tile) bit-equal to the
    plain version and to K1 on mma.sync (cmux.cu); launches_wg counts
    exactly the launches that took the wgmma path."""
    require_cuda()
    gen = torch.Generator().manual_seed(2000 + b)
    k1, levels, n, n_d, js, base_log = 5, 3, 512, 2, 2, 12
    assert kx.k1_path(n) == "wgmma"
    dig = torch.randint(-128, 128, (k1, levels, n_d, b, n), generator=gen,
                        dtype=torch.int8).cuda()
    ext = torch.randint(-128, 128, (k1, k1 * levels, 8 - js, 2 * n),
                        generator=gen, dtype=torch.int8).cuda()
    acc = torch.randint(-2 ** 63, 2 ** 63 - 1, (k1, b, n), generator=gen,
                        dtype=torch.int64).cuda()
    t = torch.randint(0, 2 * n, (b,), generator=gen, dtype=torch.int32).cuda()
    before = (kx.extprod_step2g.launches, kx.extprod_step2g.launches_wg)
    a1, d1 = kx.extprod_step2g(dig, ext, acc.clone(), t, base_log, levels, js)
    assert (kx.extprod_step2g.launches, kx.extprod_step2g.launches_wg) == (
        before[0] + 1, before[1] + 1)
    a0, d0 = _k1_mma_sync(dig, ext, acc.clone(), t, base_log, levels, js)
    assert (kx.extprod_step2g.launches, kx.extprod_step2g.launches_wg) == (
        before[0] + 1, before[1] + 1)
    a2, d2 = kx.extprod_step2g_plain(dig, ext, acc.clone(), t, base_log,
                                     levels, js)
    assert torch.equal(a1, a2) and torch.equal(d1, d2)
    assert torch.equal(a1, a0) and torch.equal(d1, d0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 1024])
@pytest.mark.parametrize("n_d", [1, 2, 3])
def test_cuda_k1_wgmma_every_bucket_layout(n_d, n):
    """On the card: K1 on wgmma at N=512 and 1024 for js in 0..7 with one
    to three limbs a digit (R=10, B=40 and B=70, each with a ragged tile)
    and with every digit and key byte -128 at R=15, n_d=2, js=2, B=64 (each
    int32 bucket at n_d·R·N·2^14), bit-equal to plain."""
    require_cuda()
    gen = torch.Generator().manual_seed(30 + n_d + n)
    k1, levels = 5, 2
    base_log = {1: 6, 2: 12, 3: 20}[n_d]
    for js in range(8):
        for b in (40, 70):
            dig = torch.randint(-128, 128, (k1, levels, n_d, b, n),
                                generator=gen, dtype=torch.int8).cuda()
            ext = torch.randint(-128, 128, (k1, k1 * levels, 8 - js, 2 * n),
                                generator=gen, dtype=torch.int8).cuda()
            acc = torch.randint(-2 ** 62, 2 ** 62, (k1, b, n), generator=gen,
                                dtype=torch.int64).cuda()
            t = torch.randint(0, 2 * n, (b,), generator=gen,
                              dtype=torch.int32).cuda()
            a1, d1 = kx.extprod_step2g(dig, ext, acc.clone(), t, base_log,
                                       levels, js)
            a2, d2 = kx.extprod_step2g_plain(dig, ext, acc.clone(), t,
                                             base_log, levels, js)
            assert torch.equal(a1, a2) and torch.equal(d1, d2), (js, b)
    if n_d == 2:
        b = 64
        dig = torch.full((k1, 3, 2, b, n), -128, dtype=torch.int8,
                         device="cuda")
        ext = torch.full((k1, k1 * 3, 6, 2 * n), -128, dtype=torch.int8,
                         device="cuda")
        acc = torch.randint(-2 ** 62, 2 ** 62, (k1, b, n), generator=gen,
                            dtype=torch.int64).cuda()
        t = torch.randint(0, 2 * n, (b,), generator=gen,
                          dtype=torch.int32).cuda()
        a1, d1 = kx.extprod_step2g(dig, ext, acc.clone(), t, 12, 3, 2)
        a2, d2 = kx.extprod_step2g_plain(dig, ext, acc.clone(), t, 12, 3, 2)
        assert torch.equal(a1, a2) and torch.equal(d1, d2)
    torch.cuda.synchronize()


# The N = 1024 sets of ops/params.py (lvl4's step is lvl1's)
N1024_SETS = {"lvl256": params.PARAMS_SQRD_LVL_256,
              "8-bit": params.PARAMS_WOPPBS_8BIT,
              "lvl1": params.PARAMS_SQRD_LVL_1}


def _step_at(p, b, gen, fill=None):
    """Operands of the set p's CMux step for b lanes, the rotations 0, 1,
    N and 2N-1 among them; fill: every digit and key byte. Returns
    (dig, ext, acc, t, base_log, levels, js)."""
    k1, levels, n = p.glwe_dimension + 1, p.pbs_level, p.polynomial_size
    n_d = torus.limbs_for_bound(decomposition.digit_bound(p.pbs_base_log))
    js = truncation.bsk_j_start(p)
    if fill is None:
        dig = torch.randint(-128, 128, (k1, levels, n_d, b, n), generator=gen,
                            dtype=torch.int8).cuda()
        ext = torch.randint(-128, 128, (k1, k1 * levels, 8 - js, 2 * n),
                            generator=gen, dtype=torch.int8).cuda()
    else:
        dig = torch.full((k1, levels, n_d, b, n), fill, dtype=torch.int8,
                         device="cuda")
        ext = torch.full((k1, k1 * levels, 8 - js, 2 * n), fill,
                         dtype=torch.int8, device="cuda")
    acc = torch.randint(-2 ** 63, 2 ** 63 - 1, (k1, b, n), generator=gen,
                        dtype=torch.int64).cuda()
    t = torch.randint(0, 2 * n, (b,), generator=gen, dtype=torch.int32)
    t[:min(b, 4)] = torch.tensor([0, 1, n, 2 * n - 1])[:min(b, 4)]
    return dig, ext, acc, t.cuda(), p.pbs_base_log, levels, js


def _k1_three_ways(dig, ext, acc, t, base_log, levels, js):
    """K1 as the wrapper launches it, counted: launches and launches_wg
    each one more; K5 then K2 (extprod_step2, then rot_diff_digits on
    t_next), counted by neither; both bit-equal to the plain version."""
    before = (kx.extprod_step2g.launches, kx.extprod_step2g.launches_wg)
    a1, d1 = kx.extprod_step2g(dig, ext, acc.clone(), t, base_log, levels, js)
    assert (kx.extprod_step2g.launches, kx.extprod_step2g.launches_wg) == (
        before[0] + 1, before[1] + 1)
    a5 = kx.extprod_step2(dig, ext, acc.clone(), js)
    d5 = kx.rot_diff_digits(a5, t, base_log, levels, dig.shape[2])
    assert (kx.extprod_step2g.launches, kx.extprod_step2g.launches_wg) == (
        before[0] + 1, before[1] + 1)
    a2, d2 = kx.extprod_step2g_plain(dig, ext, acc.clone(), t, base_log,
                                     levels, js)
    assert torch.equal(a1, a2) and torch.equal(d1, d2)
    assert torch.equal(a1, a5) and torch.equal(d1, d5)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 31, 32, 33, 128, 288])
@pytest.mark.parametrize("name", sorted(N1024_SETS))
def test_cuda_k1_wgmma_n1024_matches_plain_and_k5_k2(name, b):
    """On the card at each N = 1024 set's step (lvl256: R = 12, n_d 2, js 2;
    the 8-bit model's: R = 18, n_d 1, js 1; lvl1's: R = 6): K1 as the
    wrapper launches it (cmux_wg.cu, clusters of 8 blocks), across the
    32-lane tile edge, bit-equal to the plain version and to K5 then K2
    (cmux.cu); launches and launches_wg each count one a call."""
    require_cuda()
    gen = torch.Generator().manual_seed(4000 + b)
    p = N1024_SETS[name]
    assert p.polynomial_size == 1024
    assert kx.k1_path(1024) == "wgmma"
    _k1_three_ways(*_step_at(p, b, gen))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_k1_wgmma_n1024_extreme_values():
    """On the card at lvl256's step, B = 33: every digit and key byte -128,
    so every int32 bucket at n_d·R·N·2^14, K1 on wgmma bit-equal to plain
    and to K5 then K2."""
    require_cuda()
    gen = torch.Generator().manual_seed(4100)
    _k1_three_ways(*_step_at(N1024_SETS["lvl256"], 33, gen, fill=-128))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_k1_mma_sync_refuses_n1024():
    """K1 on mma.sync is built for N <= 512 (its glue reads the whole new
    row from one block's tile): its C entry returns cudaErrorInvalidValue
    at lvl256's step and launches nothing, the accumulator left as it
    was."""
    require_cuda()
    gen = torch.Generator().manual_seed(4200)
    dig, ext, acc, t, base_log, levels, js = _step_at(
        N1024_SETS["lvl256"], 9, gen)
    before = acc.clone()
    with pytest.raises(RuntimeError, match="cudaError_t 1\\)"):
        _k1_mma_sync(dig, ext, acc, t, base_log, levels, js)
    torch.cuda.synchronize()
    assert torch.equal(acc, before)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 9, 13, 70, 288])
def test_cuda_limb_matmul_tensor_cores_match_plain(b):
    """On the card: K4 (mma.sync int8, K split across blocks where the
    output has few tiles) bit-equal to its plain version at ragged K, N and
    B, with one, two and three digit limbs, at the keyswitch's and the
    pfKS's K and N, on N-major key planes (laid out K-major by the wrapper)
    and on the K-major view the prepared keys hold."""
    require_cuda()
    gen = torch.Generator().manual_seed(50 + b)
    for k, n, n_d, js in ((130, 40, 3, 1), (4098, 678, 1, 5),
                          (8192, 678, 1, 5), (4098, 1000, 3, 1),
                          (77, 33, 2, 0), (4098, 12800, 3, 1)):
        d = torch.randint(-128, 128, (n_d, b, k), generator=gen,
                          dtype=torch.int8).cuda()
        m = torch.randint(-128, 128, (8 - js, k, n), generator=gen,
                          dtype=torch.int8).cuda()
        ref = kmm.fused_limb_matmul_plain(d, m, js)
        assert torch.equal(kmm.fused_limb_matmul(d, m, js), ref), (k, n)
        assert torch.equal(kmm.fused_limb_matmul(
            d, kmm.kmajor_key_planes(m), js), ref), (k, n)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_limb_matmul_extreme_values():
    """On the card: every byte -128 at the longest K the wrapper admits for
    three digit limbs, split across blocks and not."""
    require_cuda()
    k = ((1 << 31) - 1) // (3 << 14)
    for b, n in ((13, 40), (96, 64 * 132)):
        d = torch.full((3, b, k), -128, dtype=torch.int8, device="cuda")
        m = torch.full((7, k, n), -128, dtype=torch.int8, device="cuda")
        assert torch.equal(kmm.fused_limb_matmul(d, m, 1),
                           kmm.fused_limb_matmul_plain(d, m, 1)), (b, n)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 512])
@pytest.mark.parametrize("lanes,g", [(4, 8), (3, 11), (5, 1), (2, 24)])
def test_cuda_grouped_tensor_cores_match_plain(n, lanes, g):
    """On the card: K3 (nc::contract_mma, a lane's accumulators as the
    instruction's columns) bit-equal to its plain version with ragged and
    single-accumulator groups, for js in {0, 4} and one to three limbs."""
    require_cuda()
    gen = torch.Generator().manual_seed(100 * n + 10 * lanes + g)
    for js in (0, 4):
        for n_d in (1, 2, 3):
            dig = torch.randint(-128, 128, (lanes, 5, n_d * g, n),
                                generator=gen, dtype=torch.int8).cuda()
            ext = torch.randint(-128, 128, (lanes, 2, 5, 8 - js, 2 * n),
                                generator=gen, dtype=torch.int8).cuda()
            assert torch.equal(
                kx.extprod_grouped_fused(dig, ext, n_d, js),
                kx.extprod_grouped_fused_plain(dig, ext, n_d, js)), (js, n_d)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [9, 288])
def test_cuda_bucket_every_split_matches_plain(b):
    """On the card: K11 at the blind rotation's O=5, R=15, N=512, n_d=2,
    js=2 with every split count 1..15 of its rows, bit-equal to its plain
    version; the wrapper's split is one of them."""
    require_cuda()
    gen = torch.Generator().manual_seed(b)
    k1, levels, n, n_d, js = 5, 3, 512, 2, 2
    r = k1 * levels
    dig = torch.randint(-128, 128, (k1, levels, n_d, b, n), generator=gen,
                        dtype=torch.int8).cuda()
    ext = torch.randint(-128, 128, (k1, r, 8 - js, 2 * n), generator=gen,
                        dtype=torch.int8).cuda()
    acc = torch.randint(-2 ** 62, 2 ** 62, (k1, b, n), generator=gen,
                        dtype=torch.int64).cuda()
    want = kx.extprod_step3_plain(dig, ext, acc.clone(), js)
    for splits in range(1, r + 1):
        got = kx._launch_step3(dig, ext, acc.clone(), js, splits)
        assert torch.equal(got, want), splits
    assert 1 <= kx._bucket_splits(
        b, k1, r, 8 - js, kx._bucket_residency(n, n_d), n) <= r
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 9, 13, 288])
def test_cuda_glue_matches_plain(b):
    """On the card: K2 (nc::glue_wide, a thread for every 8 columns of a
    row) bit-equal to its plain version at N in {64, 256, 512}, with the
    rotation 0, 1, N-1, N, N+1, 2N-1 and a random one a lane, for every
    gadget it is built for and, at lvl64's (3, 12), one to three limbs a
    digit; then K2 then K5 equal to K1 at lvl64's shapes."""
    require_cuda()
    gen = torch.Generator().manual_seed(300 + b)
    for n in (64, 256, 512):
        acc = torch.randint(-2 ** 63, 2 ** 63 - 1, (5, b, n), generator=gen,
                            dtype=torch.int64).cuda()
        for value in (0, 1, n - 1, n, n + 1, 2 * n - 1, None):
            t = (torch.randint(0, 2 * n, (b,), generator=gen,
                               dtype=torch.int32) if value is None
                 else torch.full((b,), value, dtype=torch.int32)).cuda()
            gadgets = [(lv, bl, nd) for lv, bl in sorted(kx.GLUE_GADGETS)
                       for nd in ((1, 2, 3) if (lv, bl) == (3, 12)
                                  else (1 if bl <= 7 else 2,))]
            for levels, base_log, n_d in gadgets:
                assert torch.equal(
                    kx.rot_diff_digits(acc, t, base_log, levels, n_d),
                    kx.rot_diff_digits_plain(acc, t, base_log, levels, n_d)
                ), (n, value, levels, base_log, n_d)
    k1, levels, n, n_d, js, base_log = 5, 3, 512, 2, 2, 12
    dig = torch.randint(-128, 128, (k1, levels, n_d, b, n), generator=gen,
                        dtype=torch.int8).cuda()
    ext = torch.randint(-128, 128, (k1, k1 * levels, 8 - js, 2 * n),
                        generator=gen, dtype=torch.int8).cuda()
    acc = torch.randint(-2 ** 62, 2 ** 62, (k1, b, n), generator=gen,
                        dtype=torch.int64).cuda()
    t = torch.randint(0, 2 * n, (b,), generator=gen, dtype=torch.int32).cuda()
    a1, d1 = kx.extprod_step2g(dig, ext, acc.clone(), t, base_log, levels,
                               js)
    a5 = kx.extprod_step2(dig, ext, acc.clone(), js)
    assert torch.equal(a5, a1)
    assert torch.equal(kx.rot_diff_digits(a5, t, base_log, levels, n_d), d1)
    torch.cuda.synchronize()


def _assert_k8_matches_plain_and_k3(dig, ext, n_d, js):
    """K8 on K3's operands laid out as its own (dig [n_d, B, G, R, N], ext
    [8-js, B, R, O, 2N]): bit-equal to its plain version, rows s < js zero,
    and recombined equal to K3."""
    lanes, r, ndg, n = dig.shape
    g = ndg // n_d
    dig8 = dig.reshape(lanes, r, n_d, g, n).permute(2, 0, 3, 1,
                                                    4).contiguous()
    ext8 = ext.permute(3, 0, 2, 1, 4).contiguous()
    parts = kx.extprod_partials_grouped(dig8, ext8, js)
    assert torch.equal(parts,
                       kx.extprod_partials_grouped_plain(dig8, ext8, js))
    assert not parts[:js].any()
    assert torch.equal(polynomial.recombine_partials(parts, js),
                       kx.extprod_grouped_fused(dig, ext, n_d,
                                                js).permute(0, 2, 1, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 512])
@pytest.mark.parametrize("lanes,g", [(4, 8), (3, 11), (5, 1), (2, 24)])
def test_cuda_partials_grouped_matches_plain(n, lanes, g):
    """On the card: K8 (K3's tensor-core kernel storing its int32 buckets,
    key planes staged plane by plane) bit-equal to its plain version with
    ragged and single-accumulator groups, for js in {0, 4} and one to three
    limbs, and recombined equal to K3."""
    require_cuda()
    gen = torch.Generator().manual_seed(700 + 100 * n + 10 * lanes + g)
    for js in (0, 4):
        for n_d in (1, 2, 3):
            dig = torch.randint(-128, 128, (lanes, 5, n_d * g, n),
                                generator=gen, dtype=torch.int8).cuda()
            ext = torch.randint(-128, 128, (lanes, 2, 5, 8 - js, 2 * n),
                                generator=gen, dtype=torch.int8).cuda()
            _assert_k8_matches_plain_and_k3(dig, ext, n_d, js)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_partials_grouped_extreme_values():
    """On the card: every digit and key byte -128 at the vertical packing's
    R=5, O=5, N=512, n_d=2, js=4 — each int32 bucket at its largest — K8
    bit-equal to plain and recombined equal to K3."""
    require_cuda()
    dig = torch.full((4, 5, 2 * 24, 512), -128, dtype=torch.int8,
                     device="cuda")
    ext = torch.full((4, 5, 5, 4, 1024), -128, dtype=torch.int8,
                     device="cuda")
    _assert_k8_matches_plain_and_k3(dig, ext, 2, 4)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 9, 13, 288])
def test_cuda_glue_flat_matches_plain(b):
    """On the card: K10a (K2's nc::glue_wide with the flat output strides)
    bit-equal to its plain version at N in {64, 256, 512}, with the
    rotation 0, 1, N-1, N, N+1, 2N-1 and a random one a lane, for every
    gadget it is built for and, at lvl64's (3, 12), one to three limbs a
    digit; and equal to K2's output permuted to the flat layout."""
    require_cuda()
    gen = torch.Generator().manual_seed(400 + b)
    for n in (64, 256, 512):
        acc = torch.randint(-2 ** 63, 2 ** 63 - 1, (5, b, n), generator=gen,
                            dtype=torch.int64).cuda()
        for value in (0, 1, n - 1, n, n + 1, 2 * n - 1, None):
            t = (torch.randint(0, 2 * n, (b,), generator=gen,
                               dtype=torch.int32) if value is None
                 else torch.full((b,), value, dtype=torch.int32)).cuda()
            gadgets = [(lv, bl, nd) for lv, bl in sorted(kx.GLUE_GADGETS)
                       for nd in ((1, 2, 3) if (lv, bl) == (3, 12)
                                  else (1 if bl <= 7 else 2,))]
            for levels, base_log, n_d in gadgets:
                flat = kx.rot_diff_digits_flat(acc, t, base_log, levels, n_d)
                assert torch.equal(flat, kx.rot_diff_digits_flat_plain(
                    acc, t, base_log, levels, n_d)), (n, value, levels,
                                                      base_log, n_d)
                k2 = kx.rot_diff_digits(acc, t, base_log, levels, n_d)
                assert torch.equal(flat, k2.permute(2, 3, 0, 1, 4).reshape(
                    n_d, b, 5 * levels * n)), (n, value, levels, base_log,
                                               n_d)
    torch.cuda.synchronize()


def _assert_k7_matches_plain_and_k6(dig_bm, ext8, js=2):
    """K7 bit-equal to its plain version; then, with its key planes below
    js zeroed, recombined over a random accumulator equal to K6's update on
    the planes from js up (laid out as the prepared entry [O, R, 8-js,
    2N])."""
    parts = kx.extprod_partials(dig_bm, ext8)
    assert torch.equal(parts, kx.extprod_partials_plain(dig_bm, ext8))
    n_d, b, r, n = dig_bm.shape
    o = ext8.shape[2]
    gen = torch.Generator().manual_seed(b * n + n_d)
    acc_bm = torch.randint(-2 ** 62, 2 ** 62, (b, o, n), generator=gen,
                           dtype=torch.int64).cuda()
    low = ext8.clone()
    low[:js] = 0
    assert torch.equal(
        acc_bm + polynomial.recombine_partials(kx.extprod_partials(dig_bm,
                                                                   low)),
        kx.extprod_step(dig_bm, low[js:].permute(2, 1, 0, 3).contiguous(),
                        acc_bm, js))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 512])
@pytest.mark.parametrize("b", [1, 13, 288])
def test_cuda_partials_matches_plain(n, b):
    """On the card: K7 (K6's tensor-core kernel over all 8 key planes,
    storing its int32 buckets) bit-equal to its plain version with a
    ragged last lane tile, for one to three limbs, and recombined over
    zeroed low planes equal to K6's update."""
    require_cuda()
    gen = torch.Generator().manual_seed(800 + 10 * n + b)
    for n_d in (1, 2, 3):
        dig_bm = torch.randint(-128, 128, (n_d, b, 15, n), generator=gen,
                               dtype=torch.int8).cuda()
        ext8 = torch.randint(-128, 128, (8, 15, 5, 2 * n), generator=gen,
                             dtype=torch.int8).cuda()
        _assert_k7_matches_plain_and_k6(dig_bm, ext8)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_partials_extreme_values():
    """On the card: every digit and key byte -128 at the blind rotation's
    R=15, O=5, N=512, n_d=2 — each int32 bucket at the bound the wrapper
    admits — K7 bit-equal to plain at B=13 and B=288, and recombined equal
    to K6."""
    require_cuda()
    for b in (13, 288):
        dig_bm = torch.full((2, b, 15, 512), -128, dtype=torch.int8,
                            device="cuda")
        ext8 = torch.full((8, 15, 5, 1024), -128, dtype=torch.int8,
                          device="cuda")
        _assert_k7_matches_plain_and_k6(dig_bm, ext8)
    torch.cuda.synchronize()


# ------------------------------------------------ N = 1024 (lvl1/4/256)

# The N = 1024 blind rotations' gadgets (levels, base_log) and R = (k+1)·L
# at k = 2: lvl1 and lvl4 (2, 15), lvl256 (4, 9); both give two limbs a digit
WIDE_GADGETS = ((2, 15), (4, 9))


def _step_operands(gen, k1, n, levels, n_d, b, js, fill=None):
    """A CMux step's operands at (k+1, N, L, n_d, B, js), the rotations 0,
    N-1, N and 2N-1 among the lanes; fill: every digit and key byte."""
    acc = torch.randint(-2 ** 62, 2 ** 62, (k1, b, n), generator=gen,
                        dtype=torch.int64).cuda()
    t = torch.randint(0, 2 * n, (b,), generator=gen, dtype=torch.int32)
    t[: min(b, 4)] = torch.tensor([0, n - 1, n, 2 * n - 1])[: min(b, 4)]
    lo, hi = (-128, 128) if fill is None else (fill, fill + 1)
    dig = torch.randint(lo, hi, (k1, levels, n_d, b, n), generator=gen,
                        dtype=torch.int8).cuda()
    ext = torch.randint(lo, hi, (k1, k1 * levels, 8 - js, 2 * n),
                        generator=gen, dtype=torch.int8).cuda()
    return dig, ext, acc, t.cuda()


def _wide_step_operands(gen, b, levels, js, fill=None):
    """A step's operands at N = 1024, k = 2, two limbs."""
    return _step_operands(gen, 3, 1024, levels, 2, b, js, fill)


def _assert_wide_step(dig, ext, acc, t, base_log, levels, js):
    """K1 (on wgmma: 8 blocks of 128 columns one cluster, its glue reading
    the rotated sources from any of them) and K5 (two blocks of 512
    columns) at N = 1024 bit-equal to their plain versions; K2 then K5
    equal to K1."""
    n_d = dig.shape[2]
    a1, d1 = kx.extprod_step2g(dig, ext, acc.clone(), t, base_log, levels, js)
    a2, d2 = kx.extprod_step2g_plain(dig, ext, acc.clone(), t, base_log,
                                     levels, js)
    assert torch.equal(a1, a2) and torch.equal(d1, d2)
    a5 = kx.extprod_step2(dig, ext, acc.clone(), js)
    assert torch.equal(a5, kx.extprod_step2_plain(dig, ext, acc.clone(), js))
    assert torch.equal(a5, a1)
    assert torch.equal(kx.rot_diff_digits(a5, t, base_log, levels, n_d), d1)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 9, 13, 288])
def test_cuda_wide_steps_match_plain(b):
    """On the card at N = 1024, k = 2: K1 (a block of K1 on wgmma owns 32
    lanes x 128 columns, 8 blocks one cluster) and K5 (8 lanes x 512
    columns) bit-equal to their plain versions, for both
    N = 1024 gadgets and js in {0, 2}, with a ragged last lane tile (rows
    past the batch edge in both halves) and the rotations 0, N-1, N and
    2N-1 among the lanes."""
    require_cuda()
    gen = torch.Generator().manual_seed(7000 + b)
    for levels, base_log in WIDE_GADGETS:
        for js in (0, 2):
            _assert_wide_step(*_wide_step_operands(gen, b, levels, js),
                              base_log, levels, js)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [13, 288])
def test_cuda_wide_steps_extreme_values(b):
    """On the card at N = 1024, R = 12 (lvl256's gadget (4, 9)), js = 2:
    every digit and key byte -128, each int32 bucket at n_d·R·N·2^14."""
    require_cuda()
    gen = torch.Generator().manual_seed(7100 + b)
    _assert_wide_step(*_wide_step_operands(gen, b, 4, 2, fill=-128), 9, 4, 2)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 9, 13, 288])
def test_cuda_wide_glue_matches_plain(b):
    """On the card: K2 at N = 1024 (a block of 128 threads holds one row)
    for every gadget it is built for, each with its own limb count, bit-equal
    to its plain version, the rotations 0, N-1, N and 2N-1 among the lanes."""
    require_cuda()
    gen = torch.Generator().manual_seed(7200 + b)
    k1, n = 3, 1024
    acc = torch.randint(-2 ** 63, 2 ** 63 - 1, (k1, b, n), generator=gen,
                        dtype=torch.int64).cuda()
    t = torch.randint(0, 2 * n, (b,), generator=gen, dtype=torch.int32)
    t[: min(b, 4)] = torch.tensor([0, n - 1, n, 2 * n - 1])[: min(b, 4)]
    t = t.cuda()
    for levels, base_log in sorted(kx.GLUE_GADGETS):
        n_d = torus.limbs_for_bound(decomposition.digit_bound(base_log))
        assert torch.equal(
            kx.rot_diff_digits(acc, t, base_log, levels, n_d),
            kx.rot_diff_digits_plain(acc, t, base_log, levels, n_d))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("js", [3, 4])
@pytest.mark.parametrize("lanes,g", [(4, 8), (3, 11), (5, 1), (2, 24)])
def test_cuda_wide_grouped_match_plain(js, lanes, g):
    """On the card at N = 1024, k = 2, one cbs level (R = 3), two limbs: K3
    and K8 (the columns split between two blocks, no cluster) bit-equal to
    their plain versions at the vertical packing's js of lvl256 (3) and of
    lvl1/lvl4 (4), ragged G-tiles included; K8 recombined equal to K3."""
    require_cuda()
    gen = torch.Generator().manual_seed(7300 + 100 * js + 10 * lanes + g)
    n, k1, r, n_d = 1024, 3, 3, 2
    dig = torch.randint(-128, 128, (lanes, r, n_d * g, n), generator=gen,
                        dtype=torch.int8).cuda()
    ext = torch.randint(-128, 128, (lanes, k1, r, 8 - js, 2 * n),
                        generator=gen, dtype=torch.int8).cuda()
    fused = kx.extprod_grouped_fused(dig, ext, n_d, js)
    assert torch.equal(fused,
                       kx.extprod_grouped_fused_plain(dig, ext, n_d, js))
    dig_8 = dig.reshape(lanes, r, n_d, g, n).permute(2, 0, 3, 1,
                                                    4).contiguous()
    ext_8 = ext.permute(3, 0, 2, 1, 4).contiguous()
    parts = kx.extprod_partials_grouped(dig_8, ext_8, js)
    assert torch.equal(parts,
                       kx.extprod_partials_grouped_plain(dig_8, ext_8, js))
    assert torch.equal(polynomial.recombine_partials(parts, js),
                       fused.permute(0, 2, 1, 3))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_wide_grouped_extreme_values():
    """On the card at N = 1024, js = 3: every digit and key byte -128 in K3
    and in K8, K8 recombined equal to K3."""
    require_cuda()
    n, k1, r, n_d, js, lanes, g = 1024, 3, 3, 2, 3, 4, 24
    dig = torch.full((lanes, r, n_d * g, n), -128, dtype=torch.int8,
                     device="cuda")
    ext = torch.full((lanes, k1, r, 8 - js, 2 * n), -128, dtype=torch.int8,
                     device="cuda")
    fused = kx.extprod_grouped_fused(dig, ext, n_d, js)
    assert torch.equal(fused,
                       kx.extprod_grouped_fused_plain(dig, ext, n_d, js))
    dig_8 = torch.full((n_d, lanes, g, r, n), -128, dtype=torch.int8,
                       device="cuda")
    ext_8 = torch.full((8 - js, lanes, r, k1, 2 * n), -128, dtype=torch.int8,
                       device="cuda")
    parts = kx.extprod_partials_grouped(dig_8, ext_8, js)
    assert torch.equal(parts,
                       kx.extprod_partials_grouped_plain(dig_8, ext_8, js))
    assert torch.equal(polynomial.recombine_partials(parts, js),
                       fused.permute(0, 2, 1, 3))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 9, 13, 288])
def test_cuda_limb_matmul_four_limbs_match_plain(b):
    """On the card: K4 with four digit limbs (lvl1's pfKS, gadget (1, 24))
    bit-equal to its plain version, at lvl1's pfKS shape (K = 2049,
    N = 9216, js = 1), at js = 0 (eight key planes) and at ragged shapes."""
    require_cuda()
    gen = torch.Generator().manual_seed(7400 + b)
    for k, n, js in ((2049, 9216, 1), (130, 40, 0), (4098, 678, 1),
                     (77, 33, 5)):
        d = torch.randint(-128, 128, (4, b, k), generator=gen,
                          dtype=torch.int8).cuda()
        m = torch.randint(-128, 128, (8 - js, k, n), generator=gen,
                          dtype=torch.int8).cuda()
        assert torch.equal(kmm.fused_limb_matmul(d, m, js),
                           kmm.fused_limb_matmul_plain(d, m, js))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_limb_matmul_four_limbs_extreme_values():
    """On the card: K4 with four limbs and every byte -128 at K = 16383, the
    longest the plain version computes exactly in float64, one block a tile
    (132 tiles of 96 x 64: no split)."""
    require_cuda()
    kk = 16383
    d = torch.full((4, 96, kk), -128, dtype=torch.int8, device="cuda")
    m = torch.full((7, kk, 64 * 132), -128, dtype=torch.int8, device="cuda")
    assert kmm._splits(96, kk, 64 * 132) == 1
    assert torch.equal(kmm.fused_limb_matmul(d, m, 1),
                       kmm.fused_limb_matmul_plain(d, m, 1))
    torch.cuda.synchronize()


# ------------- N = 1024 under longk, bucket and glue_out: K6, K7, K10a,
# K10b and K11 split by columns

# (k+1, levels, base_log, n_d, js) of the N = 1024 blind rotations, js the
# set's BSK truncation: lvl1/lvl4, lvl256 and the 8-bit model
WIDE_SCHEDULE_STEPS = {"lvl1": (3, 2, 15, 2, 2), "lvl256": (3, 4, 9, 2, 2),
                       "woppbs_8bit": (3, 6, 7, 1, 1)}


def _assert_wide_schedules(dig, ext, acc, t, base_log, levels, js):
    """At N = 1024: K6 (batch-major, a new tensor), K10a then K10b (flat
    digits; the wrapper's row split and unsplit) and K11 on K2's digits
    (the wrapper's split, unsplit and a row a block), each bit-equal to its
    plain version and to K5's update; K10a equal to K2 permuted."""
    k1, _, n_d, b, n = dig.shape
    r = k1 * levels
    want = kx.extprod_step2(dig, ext, acc.clone(), js)
    assert torch.equal(want, kx.extprod_step2_plain(dig, ext, acc.clone(),
                                                    js))
    dig_bm = dig.reshape(r, n_d, b, n).permute(1, 2, 0, 3).contiguous()
    acc_bm = acc.permute(1, 0, 2).contiguous()
    k6 = kx.extprod_step(dig_bm, ext, acc_bm, js)
    assert torch.equal(k6, kx.extprod_step_plain(dig_bm, ext, acc_bm, js))
    assert torch.equal(k6.permute(1, 0, 2), want)
    d2 = kx.rot_diff_digits(acc, t, base_log, levels, n_d)
    flat = kx.rot_diff_digits_flat(acc, t, base_log, levels, n_d)
    assert torch.equal(flat, kx.rot_diff_digits_flat_plain(
        acc, t, base_log, levels, n_d))
    assert torch.equal(flat, d2.permute(2, 3, 0, 1, 4).reshape(n_d, b,
                                                               r * n))
    flat = dig.permute(2, 3, 0, 1, 4).reshape(n_d, b, r * n)
    ref10 = kx.extprod_step_longk_plain(flat, ext, acc.clone(), js)
    assert torch.equal(ref10, want)
    assert torch.equal(kx.extprod_step_longk(flat, ext, acc.clone(), js),
                       want)
    assert torch.equal(kx._launch_longk(flat, ext, acc.clone(), js, 1), want)
    assert torch.equal(kx.extprod_step3_plain(dig, ext, acc.clone(), js),
                       want)
    assert torch.equal(kx.extprod_step3(dig, ext, acc.clone(), js), want)
    for splits in (1, r):
        assert torch.equal(kx._launch_step3(dig, ext, acc.clone(), js,
                                            splits), want), splits


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 9, 13, 288])
@pytest.mark.parametrize("step", sorted(WIDE_SCHEDULE_STEPS))
def test_cuda_wide_schedules_match_plain(step, b):
    """On the card at N = 1024 (each row tile's columns two blocks of 512):
    the longk, bucket and glue_out steps' kernels at the step of lvl1,
    lvl256 or the 8-bit model, with the set's js and js in {0, 2}, a ragged
    last lane tile and the rotations 0, N-1, N and 2N-1 among the lanes."""
    require_cuda()
    gen = torch.Generator().manual_seed(7600 + b + len(step))
    k1, levels, base_log, n_d, js_set = WIDE_SCHEDULE_STEPS[step]
    for js in sorted({js_set, 0, 2}):
        dig, ext, acc, t = _step_operands(gen, k1, 1024, levels, n_d, b, js)
        _assert_wide_schedules(dig, ext, acc, t, base_log, levels, js)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [13, 288])
def test_cuda_wide_schedules_extreme_values(b):
    """On the card at N = 1024, R = 12 (lvl256's gadget (4, 9)), js = 2:
    every digit and key byte -128, each int32 bucket at n_d·R·N·2^14."""
    require_cuda()
    gen = torch.Generator().manual_seed(7700 + b)
    dig, ext, acc, t = _step_operands(gen, 3, 1024, 4, 2, b, 2, fill=-128)
    _assert_wide_schedules(dig, ext, acc, t, 9, 4, 2)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 13, 288])
def test_cuda_wide_partials_match_plain(b):
    """On the card at N = 1024: K7 (all 8 key planes, js = 0, one block an
    SM, 213,760 bytes of shared memory at n_d = 3) bit-equal to its plain
    version for one to three limbs at R = 12 and R = 18, recombined over
    zeroed low planes equal to K6's update; and with every byte -128 at
    R = 12, n_d = 2."""
    require_cuda()
    gen = torch.Generator().manual_seed(7800 + b)
    for n_d, r in ((1, 18), (2, 12), (3, 12)):
        dig_bm = torch.randint(-128, 128, (n_d, b, r, 1024), generator=gen,
                               dtype=torch.int8).cuda()
        ext8 = torch.randint(-128, 128, (8, r, 3, 2048), generator=gen,
                             dtype=torch.int8).cuda()
        _assert_k7_matches_plain_and_k6(dig_bm, ext8)
    _assert_k7_matches_plain_and_k6(
        torch.full((2, b, 12, 1024), -128, dtype=torch.int8, device="cuda"),
        torch.full((8, 12, 3, 2048), -128, dtype=torch.int8, device="cuda"))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [9, 288])
def test_cuda_wide_longk_and_bucket_every_split_match_plain(b):
    """On the card at lvl256's step (N = 1024, R = 12, n_d = 2, js = 2):
    K10b and K11 at every split count 1..12 of their rows, both column
    halves of each split its own block, bit-equal to K5's update."""
    require_cuda()
    gen = torch.Generator().manual_seed(7900 + b)
    dig, ext, acc, _ = _step_operands(gen, 3, 1024, 4, 2, b, 2)
    want = kx.extprod_step2_plain(dig, ext, acc.clone(), 2)
    flat = dig.permute(2, 3, 0, 1, 4).reshape(2, b, 12 * 1024)
    for splits in range(1, 13):
        assert torch.equal(kx._launch_longk(flat, ext, acc.clone(), 2,
                                            splits), want), splits
        assert torch.equal(kx._launch_step3(dig, ext, acc.clone(), 2,
                                            splits), want), splits
    torch.cuda.synchronize()


# ------------- N = 1024 under merged: K9, a lane tile's 2·O blocks a cluster

def _assert_wide_merged(acc, t, ext, base_log, levels, js):
    """K9 at N = 1024 bit-equal to its plain version and to K2 then K5 on
    the same accumulator, which it leaves untouched."""
    n_d = torus.limbs_for_bound(decomposition.digit_bound(base_log))
    before = acc.clone()
    k9 = kx.cmux_step_merged(t, ext, acc, base_log, levels, js)
    assert torch.equal(acc, before)
    assert torch.equal(k9, kx.cmux_step_merged_plain(t, ext, acc, base_log,
                                                     levels, js))
    d2 = kx.rot_diff_digits(acc, t, base_log, levels, n_d)
    assert torch.equal(k9, kx.extprod_step2(d2, ext, acc.clone(), js))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 9, 13, 16, 128, 160, 288])
@pytest.mark.parametrize("step", sorted(WIDE_SCHEDULE_STEPS))
def test_cuda_wide_merged_matches_plain(step, b):
    """On the card at N = 1024: K9 (the 2·O blocks of a lane tile one
    cluster, each gluing one component's rows at its 512 columns, each
    row's digits copied between the blocks' shared memory) at the step of
    lvl1, lvl256 or the 8-bit model, with the set's js and js = 0, on
    random key bytes and with every key byte -128 (its digits come from its
    own glue), a ragged last lane tile and the rotations 0, N-1, N and 2N-1
    among the lanes."""
    require_cuda()
    gen = torch.Generator().manual_seed(8000 + b + len(step))
    k1, levels, base_log, n_d, js_set = WIDE_SCHEDULE_STEPS[step]
    for js in sorted({js_set, 0}):
        for fill in (None, -128):
            _, ext, acc, t = _step_operands(gen, k1, 1024, levels, n_d, b, js,
                                            fill)
            _assert_wide_merged(acc, t, ext, base_log, levels, js)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("k1", [1, 4, 5, 8])
def test_cuda_wide_merged_other_cluster_sizes(k1):
    """On the card at N = 1024, gadget (2, 15), js = 2, B = 13: K9 with k + 1
    components, its clusters of 2·(k+1) blocks — 2 and 8 (portable) and 10
    and 16 (the non-portable sizes above 8) — bit-equal to its plain
    version and to K2 then K5."""
    require_cuda()
    gen = torch.Generator().manual_seed(8100 + k1)
    _, ext, acc, t = _step_operands(gen, k1, 1024, 2, 2, 13, 2)
    _assert_wide_merged(acc, t, ext, 15, 2, 2)
    torch.cuda.synchronize()


# ------------------- the other two models: tree PBS and 8-bit WoP-PBS

# (k+1, N, levels, base_log) of the two models' blind rotations: the tree
# model's PARAMS_SHORTINT_1BIT (R = 35) and the 8-bit model's
# PARAMS_WOPPBS_8BIT (N = 1024, R = 18); both give one limb a digit
MODEL_STEPS = {"shortint_1bit": (5, 512, 7, 6), "woppbs_8bit": (3, 1024, 6, 7)}


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 9, 13, 288])
@pytest.mark.parametrize("model", sorted(MODEL_STEPS))
def test_cuda_model_steps_match_plain(model, b):
    """On the card at the two models' blind-rotation shapes, n_d = 1, js in
    {0, 1} (1: both sets' truncation of the BSK): K1 and K5 bit-equal to
    their plain versions, K2 (at the tree's new gadget (7, 6) and the 8-bit
    model's (6, 7) at N = 1024) then K5 equal to K1; at N = 512 also K10a
    equal to K2 permuted; and every digit and key byte -128 at js = 1."""
    require_cuda()
    gen = torch.Generator().manual_seed(7500 + b + (model == "woppbs_8bit"))
    k1, n, levels, base_log = MODEL_STEPS[model]
    for js, fill in ((0, None), (1, None), (1, -128)):
        dig, ext, acc, t = _step_operands(gen, k1, n, levels, 1, b, js, fill)
        _assert_wide_step(dig, ext, acc, t, base_log, levels, js)
        d2 = kx.rot_diff_digits(acc, t, base_log, levels, 1)
        assert torch.equal(d2, kx.rot_diff_digits_plain(acc, t, base_log,
                                                        levels, 1))
        if n <= 512:
            flat = kx.rot_diff_digits_flat(acc, t, base_log, levels, 1)
            assert torch.equal(flat, d2.permute(2, 3, 0, 1, 4).reshape(
                1, b, k1 * levels * n))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 9, 13, 288])
def test_cuda_tree_step_schedules_match_plain(b):
    """On the card at the tree model's step (k+1 = 5, N = 512, L = 7,
    n_d = 1), js in {0, 1}, every byte -128 at js = 1: K6, K10b and K11 on
    the same digits as K5, and K9 (its own glue), bit-equal to their plain
    versions and to K5 — the glue_out, longk, bucket and merged steps the
    CLI admits for PARAMS_SHORTINT_1BIT."""
    require_cuda()
    gen = torch.Generator().manual_seed(7550 + b)
    k1, n, levels, base_log = MODEL_STEPS["shortint_1bit"]
    for js, fill in ((0, None), (1, None), (1, -128)):
        dig, ext, acc, t = _step_operands(gen, k1, n, levels, 1, b, js, fill)
        want = kx.extprod_step2(dig, ext, acc.clone(), js)
        dig_bm = dig.reshape(k1 * levels, 1, b, n).permute(1, 2, 0,
                                                           3).contiguous()
        acc_bm = acc.permute(1, 0, 2).contiguous()
        k6 = kx.extprod_step(dig_bm, ext, acc_bm, js)
        assert torch.equal(k6, kx.extprod_step_plain(dig_bm, ext, acc_bm,
                                                     js))
        assert torch.equal(k6.permute(1, 0, 2), want)
        flat = dig.permute(2, 3, 0, 1, 4).reshape(1, b, k1 * levels * n)
        k10 = kx.extprod_step_longk(flat, ext, acc.clone(), js)
        assert torch.equal(k10, kx.extprod_step_longk_plain(
            flat, ext, acc.clone(), js))
        assert torch.equal(k10, want)
        k11 = kx.extprod_step3(dig, ext, acc.clone(), js)
        assert torch.equal(k11, kx.extprod_step3_plain(dig, ext, acc.clone(),
                                                       js))
        assert torch.equal(k11, want)
        k9 = kx.cmux_step_merged(t, ext, acc.clone(), base_log, levels, js)
        assert torch.equal(k9, kx.cmux_step_merged_plain(
            t, ext, acc.clone(), base_log, levels, js))
        d2 = kx.rot_diff_digits(acc, t, base_log, levels, 1)
        assert torch.equal(k9, kx.extprod_step2(d2, ext, acc.clone(), js))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 13, 300])
def test_cuda_selection_product_matches_plain(lanes):
    """On the card: the tree's selection product mask0·p0 + mask1·p1
    (polynomial.polymul_shared_digits: K3 at R = 2, G = 1, O = 5, n_d = 1,
    js = 0, N = 512) bit-equal to K3's plain version on the card and, up to
    13 lanes, to the same function on the CPU, and in launches of 5 lanes, for the tree's masks and for
    any int8 digits, with extreme polynomials among the random ones."""
    from tfhe_aes2_tpu_torch.models import shortint_1bit as tm1b

    require_cuda()
    gen = torch.Generator().manual_seed(7600 + lanes)
    n = 512
    polys = torch.randint(-2 ** 63, 2 ** 63 - 1, (lanes, 2, 5, n),
                          generator=gen, dtype=torch.int64)
    polys[0, 0, 0] = -2 ** 63
    polys[-1, 1, 4] = 2 ** 63 - 1
    for digits in (tm1b.selection_masks(n, "cpu"),
                   torch.randint(-128, 128, (2, n), generator=gen,
                                 dtype=torch.int8)):
        got = polynomial.polymul_shared_digits(digits.cuda(), polys.cuda())
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(polynomial, "_K3_LANES", 5)
            assert torch.equal(got, polynomial.polymul_shared_digits(
                digits.cuda(), polys.cuda()))
        ext = kx.split_polys_ext(polys.cuda()).permute(1, 3, 2, 0,
                                                       4).contiguous()
        dig = digits.cuda()[None, :, None, :].expand(lanes, 2, 1,
                                                     n).contiguous()
        assert torch.equal(got, kx.extprod_grouped_fused_plain(
            dig, ext, 1, 0)[:, :, 0])
        if lanes <= 13:
            assert torch.equal(got.cpu(), polynomial.polymul_shared_digits(
                digits, polys))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("js", [0, 3])
@pytest.mark.parametrize("lanes,g", [(1, 1), (13, 1), (3, 11), (2, 24)])
def test_cuda_wide_grouped_one_limb_match_plain(js, lanes, g):
    """On the card at N = 1024, k = 2, the 8-bit model's cbs gadget (4, 6)
    (R = 12, one limb a digit): K3 and K8 (their N = 1024 split builds at
    n_d = 1) bit-equal to their plain versions at js = 3
    (PARAMS_WOPPBS_8BIT's vertical packing) and 0, G = 1 as the model runs
    them and ragged G-tiles; K8 recombined equal to K3; every byte -128 at
    (13, 1)."""
    require_cuda()
    gen = torch.Generator().manual_seed(7700 + 100 * js + 10 * lanes + g)
    n, k1, r, n_d = 1024, 3, 12, 1
    for fill in ((None, -128) if (lanes, g) == (13, 1) else (None,)):
        lo, hi = (-128, 128) if fill is None else (fill, fill + 1)
        dig = torch.randint(lo, hi, (lanes, r, n_d * g, n), generator=gen,
                            dtype=torch.int8).cuda()
        ext = torch.randint(lo, hi, (lanes, k1, r, 8 - js, 2 * n),
                            generator=gen, dtype=torch.int8).cuda()
        fused = kx.extprod_grouped_fused(dig, ext, n_d, js)
        assert torch.equal(fused,
                           kx.extprod_grouped_fused_plain(dig, ext, n_d, js))
        dig_8 = dig.reshape(lanes, r, n_d, g, n).permute(2, 0, 3, 1,
                                                        4).contiguous()
        ext_8 = ext.permute(3, 0, 2, 1, 4).contiguous()
        parts = kx.extprod_partials_grouped(dig_8, ext_8, js)
        assert torch.equal(parts, kx.extprod_partials_grouped_plain(
            dig_8, ext_8, js))
        assert torch.equal(polynomial.recombine_partials(parts, js),
                           fused.permute(0, 2, 1, 3))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 16, 288])
def test_cuda_limb_matmul_model_shapes_match_plain(b):
    """On the card: K4 at the two models' contractions, each at its set's
    truncation — the tree's packing keyswitch (pksk, all 8 planes: K = 1280,
    N = 2560) and keyswitch, the 8-bit model's keyswitch (gadget (8, 2):
    K = 16384, one limb) and pfKS — bit-equal to its plain version."""
    from tfhe_aes2_tpu_torch.models import shortint_1bit as tm1b
    from tfhe_aes2_tpu_torch.ops import params as params_mod
    from tfhe_aes2_tpu_torch.ops import truncation

    require_cuda()
    gen = torch.Generator().manual_seed(7800 + b)
    tree, p8 = tm1b.PARAMS_SHORTINT_1BIT, params_mod.PARAMS_WOPPBS_8BIT

    def nd(base_log):
        return torus.limbs_for_bound(decomposition.digit_bound(base_log))
    shapes = [
        (nd(tree.ks_base_log), tree.lwe_dimension * tree.ks_level,
         (tree.glwe_dimension + 1) * tree.polynomial_size, 0),
        (nd(tree.ks_base_log), tree.big_lwe_dimension * tree.ks_level,
         tree.lwe_dimension + 1, truncation.ksk_j_start(tree)),
        (nd(p8.ks_base_log), p8.big_lwe_dimension * p8.ks_level,
         p8.lwe_dimension + 1, truncation.ksk_j_start(p8)),
        (nd(p8.pfks_base_log), (p8.big_lwe_dimension + 1) * p8.pfks_level,
         (p8.glwe_dimension + 1) ** 2 * p8.polynomial_size,
         truncation.pfpksk_j_start(p8))]
    for n_d, k, n, js in shapes:
        d = torch.randint(-128, 128, (n_d, b, k), generator=gen,
                          dtype=torch.int8).cuda()
        m = kmm.kmajor_key_planes(torch.randint(
            -128, 128, (8 - js, k, n), generator=gen, dtype=torch.int8).cuda())
        assert torch.equal(kmm.fused_limb_matmul(d, m, js),
                           kmm.fused_limb_matmul_plain(d, m, js))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_one_device_mesh_matches_staged():
    """On the card: the sharded entry point over make_mesh(1) (dp) at
    PARAMS_TEST, 2 blocks x 1 round, bit-equal to encrypt_blocks_staged on
    the same context and inputs, and decrypted to the 1-round oracle."""
    from tfhe_aes2_tpu_torch.aes_128 import fhe, plain
    from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as model
    from tfhe_aes2_tpu_torch.ops.lowering import Lowering
    from tfhe_aes2_tpu_torch.parallel import distributed, mesh

    require_cuda()
    p, strat = distributed.PARAMS["test"], distributed.STRATEGY
    client, keys, ks_ct, block_cts, blocks = distributed.demo_inputs(
        p, 2, 3, "cuda", exact=False)
    ks, cts = torus.to_tensor(ks_ct, "cuda"), torus.to_tensor(block_cts,
                                                               "cuda")
    m = mesh.make_mesh(1)
    assert m.devices.tolist() == [torch.device("cuda", 0)]
    out = mesh.make_sharded_encrypt_blocks_fn(strat, p, 1, m, Lowering())(
        keys, ks, cts)
    ctx = model.FheContext(params=p, sks=keys, lowering=Lowering())
    want = fhe.encrypt_blocks_staged(strat, ctx, strat.fresh(ks, ctx, 3),
                                     cts, 1).array
    assert torch.equal(out, want)
    assert (strat.decrypt_client(client, torus.to_numpy(out))
            == plain.expand_key_and_encrypt_blocks(distributed.KEY, blocks,
                                                   1))


@pytest.mark.cuda
def test_cuda_stream_ptr_refuses_a_device_not_current():
    """On the card: a launch's stream is taken only for the current device
    (the C side launches there); another index, or the CPU, raises."""
    from tfhe_aes2_tpu_torch.ops.kernels import build

    require_cuda()
    current = torch.cuda.current_device()
    assert build.stream_ptr("cuda") == build.stream_ptr(
        torch.device("cuda", current))
    with pytest.raises(RuntimeError, match="current device"):
        build.stream_ptr(torch.device("cuda", current + 1))
    with pytest.raises(RuntimeError, match="current device"):
        build.stream_ptr("cpu")


@pytest.mark.cuda
def test_cuda_noise_floor_lvl64():
    """On the card: noise.measure_sbox_floor at PARAMS_SQRD_LVL_64 with the
    kernels dropping the truncated planes: exact decode, js (2, 5, 1, 4),
    both log2 stds under their bars (58.6, 59.2)."""
    from tfhe_aes2_tpu_torch import noise
    from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as model
    from tfhe_aes2_tpu_torch.ops.lowering import Lowering

    require_cuda()
    p = noise.SBOX_FLOOR_SETS["lvl64"][0]
    client, ctx = model.generate_keys(p, seed=5, device="cuda",
                                      lowering=Lowering())
    js, dual, out = noise.measure_sbox_floor(p, client, ctx, "lvl64")
    assert js == (2, 5, 1, 4) and dual <= 58.6 and out <= 59.2


@pytest.mark.cuda
def test_cuda_bench_stage_dissection_lvl64():
    """On the card: bench.stage_dissection at PARAMS_SQRD_LVL_64, 2 blocks
    (256 lanes): the four stages, each positive, the pbs stage's int8 share
    of the card's peak between 0 and 1."""
    from tfhe_aes2_tpu_torch import bench
    from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as model
    from tfhe_aes2_tpu_torch.ops.lowering import Lowering

    require_cuda()
    p = bench.PARAMS["lvl64"]
    client, ctx = model.generate_keys(p, seed=11, device="cuda",
                                      lowering=Lowering())
    out = bench.stage_dissection(client, ctx, p, 2, "cuda")
    assert set(out) == {"ks", "pbs", "pfks", "vp"}
    assert all(v > 0 for v in out.values())
    assert 0 < bench.int8_peak_share(p, 2, out["pbs"]) < 1


@pytest.mark.cuda
def test_cuda_bench_run_two_blocks_lvl64():
    """On the card: bench.run at PARAMS_SQRD_LVL_64, 2 blocks x 10 rounds,
    compressed to q' = 2^16, no latency figures or stages: verified, the
    card's name and power limit in secondary.card, the default lowering,
    and a positive throughput."""
    from tfhe_aes2_tpu_torch import bench

    require_cuda()
    res = bench.run("lvl64", n_blocks=2, rounds=10, reps=2, compress=16,
                    device="cuda", latency=False, stages=False)
    assert "error" not in res and res["value"] > 0
    sec = res["secondary"]
    assert sec["card"] and sec["device"] == torch.cuda.get_device_name(0)
    assert sec["lowering"] == ["gridg", "fused", False]
    assert sec["stage_ms_per_round"] is None and len(res["reps_s"]) == 2
