"""Kernels K1-K11 of the PyTorch port: each plain version against the JAX
package's Pallas function (interpret mode) on the same numpy-made int8
inputs, at j_start 0 and at a truncated j_start; K5-K11 also at N=256, at an
odd batch and at a batch of 1. Both sides are exact
integer arithmetic mod 2^64, so the tolerance is 0 (bit-equality). The
CUDA kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_aes2_tpu.ops.pallas import extprod as jx
from tfhe_aes2_tpu.ops.pallas import matmul as jmm

from tfhe_aes2_tpu_torch.ops import polynomial as tpoly
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx
from tfhe_aes2_tpu_torch.ops.kernels import matmul as kmm
from tests.torch_port_common import t8, t64, u64


def _acc_pair(acc):
    """uint64 [O, B, N] -> the TPU kernels' u32 (lo, hi) layout [O, 2, B, N]."""
    lo = jnp.asarray(acc & np.uint64(0xFFFFFFFF), jnp.uint32)
    hi = jnp.asarray(acc >> np.uint64(32), jnp.uint32)
    return jnp.stack([lo, hi], axis=1)


def _from_pair(lo, hi):
    return np.asarray(lo).astype(np.uint64) | (
        np.asarray(hi).astype(np.uint64) << np.uint64(32))


def test_k2_rot_diff_digits_matches_pallas():
    rng = np.random.default_rng(101)
    n, k1, levels, b, base_log, n_d = 64, 3, 2, 8, 12, 2
    acc = rng.integers(0, 2 ** 64, (k1, b, n), dtype=np.uint64)
    t = rng.integers(0, 2 * n, (b,), dtype=np.int32)
    ref = np.asarray(jx.rot_diff_digits(_acc_pair(acc), jnp.asarray(t),
                                        base_log, levels, n_d,
                                        interpret=True))
    got = kx.rot_diff_digits(t64(acc), torch.from_numpy(t), base_log,
                             levels, n_d).numpy()
    np.testing.assert_array_equal(got.reshape(ref.shape), ref)


@pytest.mark.parametrize("js", [0, 2])
def test_k1_extprod_step2g_matches_pallas(js):
    rng = np.random.default_rng(102 + js)
    n, k1, levels, b, base_log, n_d = 64, 3, 2, 8, 12, 2
    acc = rng.integers(0, 2 ** 64, (k1, b, n), dtype=np.uint64)
    dig = rng.integers(-128, 128, (k1, levels, n_d, b, n)).astype(np.int8)
    ext = rng.integers(-128, 128, (k1, k1 * levels, 8 - js, 2 * n)
                       ).astype(np.int8)
    t_next = rng.integers(0, 2 * n, (b,), dtype=np.int32)
    ref_acc, ref_dig = jx.extprod_step2g(
        jnp.asarray(dig), jnp.asarray(ext), _acc_pair(acc),
        jnp.asarray(t_next), base_log=base_log, levels=levels,
        interpret=True, j_start=js)
    ref_acc = np.asarray(ref_acc)
    got_acc, got_dig = kx.extprod_step2g(t8(dig), t8(ext), t64(acc),
                                         torch.from_numpy(t_next), base_log,
                                         levels, js)
    np.testing.assert_array_equal(u64(got_acc),
                                  _from_pair(ref_acc[:, 0], ref_acc[:, 1]))
    np.testing.assert_array_equal(got_dig.numpy(), np.asarray(ref_dig))


@pytest.mark.parametrize("js,g", [(0, 5), (4, 24), (5, 1)])
def test_k3_extprod_grouped_fused_matches_pallas(js, g):
    rng = np.random.default_rng(110 + js)
    n, b, r, o, n_d = 64, 3, 4, 2, 2
    dig = rng.integers(-128, 128, (b, r, n_d * g, n)).astype(np.int8)
    ext = rng.integers(-128, 128, (b, o, r, 8 - js, 2 * n)).astype(np.int8)
    pair = np.asarray(jx.extprod_grouped_fused(
        jnp.asarray(dig), jnp.asarray(ext), n_d=n_d, j_start=js,
        interpret=True))
    got = kx.extprod_grouped_fused(t8(dig), t8(ext), n_d, js)
    np.testing.assert_array_equal(u64(got),
                                  _from_pair(pair[:, :, 0], pair[:, :, 1]))


# (N, B): an odd batch at N=64, a batch of 1 at N=256
STEP_SHAPES = [(64, 5), (256, 1)]


def _step_inputs(seed, n, b, js, k1=2, levels=2, n_d=2):
    """Batch-major operands of one CMux update, all 8 key planes with the
    planes below js zeroed: digit planes [n_d, B, R, N], ext planes
    [8, R, O, 2N], acc uint64 [B, O, N]."""
    rng = np.random.default_rng(seed)
    r = k1 * levels
    dig = rng.integers(-128, 128, (n_d, b, r, n)).astype(np.int8)
    ext = rng.integers(-128, 128, (8, r, k1, 2 * n)).astype(np.int8)
    ext[:js] = 0
    acc = rng.integers(0, 2 ** 64, (b, k1, n), dtype=np.uint64)
    return dig, ext, acc, k1, levels


@pytest.mark.parametrize("js", [0, 2])
@pytest.mark.parametrize("n,b", STEP_SHAPES)
def test_k5_extprod_step2_matches_pallas(n, b, js):
    dig, ext, acc, k1, levels = _step_inputs(140 + js, n, b, js)
    dig_rf = np.ascontiguousarray(dig.transpose(2, 0, 1, 3))  # [R, n_d, B, N]
    ext_or = np.ascontiguousarray(ext[js:].transpose(2, 1, 0, 3))
    acc_of = np.ascontiguousarray(acc.transpose(1, 0, 2))     # [O, B, N]
    ref = np.asarray(jx.extprod_step2(
        jnp.asarray(dig_rf), jnp.asarray(ext_or), _acc_pair(acc_of),
        interpret=True, j_start=js))
    acc_t, before = t64(acc_of), acc_of.copy()
    got = kx.extprod_step2(t8(dig_rf).reshape((k1, levels) + dig_rf.shape[1:]),
                           t8(ext_or), acc_t, js)
    assert got is acc_t                  # in place, like the TPU kernel
    np.testing.assert_array_equal(acc_of, before)   # not through to numpy
    np.testing.assert_array_equal(u64(got), _from_pair(ref[:, 0], ref[:, 1]))


@pytest.mark.parametrize("js", [0, 2])
@pytest.mark.parametrize("n,b", STEP_SHAPES)
def test_k6_extprod_step_matches_pallas(n, b, js):
    dig, ext, acc, _, _ = _step_inputs(150 + js, n, b, js)
    lo = jnp.asarray(acc & np.uint64(0xFFFFFFFF), jnp.uint32)
    hi = jnp.asarray(acc >> np.uint64(32), jnp.uint32)
    ref = jx.extprod_step(jnp.asarray(dig), jnp.asarray(ext[js:]), lo, hi,
                          interpret=True, j_start=js)
    acc_t = t64(acc)
    ext_or = np.ascontiguousarray(ext[js:].transpose(2, 1, 0, 3))
    got = kx.extprod_step(t8(dig), t8(ext_or), acc_t, js)
    np.testing.assert_array_equal(u64(acc_t), acc)      # input untouched
    np.testing.assert_array_equal(u64(got), _from_pair(*ref))


@pytest.mark.parametrize("n,b", STEP_SHAPES)
def test_k7_extprod_partials_matches_pallas(n, b):
    dig, ext, _, _, _ = _step_inputs(160, n, b, 0)
    ref = np.asarray(jx.extprod_partials(jnp.asarray(dig), jnp.asarray(ext),
                                         interpret=True))
    got = kx.extprod_partials(t8(dig), t8(ext))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("js", [0, 4])
@pytest.mark.parametrize("n,b,g", [(64, 3, 5), (256, 1, 2)])
def test_k8_extprod_partials_grouped_matches_pallas(n, b, g, js):
    rng = np.random.default_rng(170 + js)
    r, o, n_d = 3, 2, 2
    dig = rng.integers(-128, 128, (n_d, b, g, r, n)).astype(np.int8)
    ext = rng.integers(-128, 128, (8 - js, b, r, o, 2 * n)).astype(np.int8)
    ref = np.asarray(jx.extprod_partials_grouped(
        jnp.asarray(dig), jnp.asarray(ext), interpret=True, j_start=js))
    got = kx.extprod_partials_grouped(t8(dig), t8(ext), js)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not got[:js].any()            # rows below js are zeros
    # recombined, the partial sums are K3's product on K3's layouts
    fused = kx.extprod_grouped_fused(
        t8(dig.transpose(1, 3, 0, 2, 4).reshape(b, r, n_d * g, n)),
        t8(ext.transpose(1, 3, 2, 0, 4)), n_d, js)          # [B, O, G, N]
    np.testing.assert_array_equal(
        u64(tpoly.recombine_partials(got, js)),
        u64(fused.permute(0, 2, 1, 3)))


@pytest.mark.parametrize("js", [0, 2])
def test_k7_recombined_equals_k6_update(js):
    """K7 takes all 8 key planes; with the planes below js zeroed, its
    partial sums folded mod 2^64 are exactly what K6 adds at j_start=js."""
    dig, ext, acc, _, _ = _step_inputs(180 + js, 64, 7, js)
    parts = kx.extprod_partials(t8(dig), t8(ext))
    ext_or = np.ascontiguousarray(ext[js:].transpose(2, 1, 0, 3))
    got = kx.extprod_step(t8(dig), t8(ext_or), t64(acc), js)
    np.testing.assert_array_equal(
        u64(t64(acc) + tpoly.recombine_partials(parts)), u64(got))


@pytest.mark.parametrize("js", [0, 2])
def test_k2_then_k5_equals_k1(js):
    """The `grid` step (K2 then K5) and the `gridg` step (K1) take the
    accumulator and the digits through the same values."""
    rng = np.random.default_rng(190 + js)
    n, k1, levels, b, base_log, n_d = 64, 3, 2, 5, 12, 2
    acc = rng.integers(0, 2 ** 64, (k1, b, n), dtype=np.uint64)
    ext = rng.integers(-128, 128, (k1, k1 * levels, 8 - js, 2 * n)
                       ).astype(np.int8)
    t_now = torch.from_numpy(rng.integers(0, 2 * n, (b,), dtype=np.int32))
    t_next = torch.from_numpy(rng.integers(0, 2 * n, (b,), dtype=np.int32))
    dig = kx.rot_diff_digits(t64(acc), t_now, base_log, levels, n_d)
    acc1, dig1 = kx.extprod_step2g(dig, t8(ext), t64(acc), t_next, base_log,
                                   levels, js)
    acc5 = kx.extprod_step2(dig, t8(ext), t64(acc), js)
    np.testing.assert_array_equal(u64(acc5), u64(acc1))
    np.testing.assert_array_equal(
        kx.rot_diff_digits(acc5, t_next, base_log, levels, n_d).numpy(),
        dig1.numpy())


def _cmux_inputs(seed, n, b, js, k1=2, levels=2, base_log=12):
    """Component-major operands of one whole CMux step: acc uint64
    [O, B, N], t int32 [B], the prepared BSK entry ext_or int8
    [O, R, 8-js, 2N]; base_log 12 gives n_d = 2 digit limbs."""
    rng = np.random.default_rng(seed)
    acc = rng.integers(0, 2 ** 64, (k1, b, n), dtype=np.uint64)
    t = rng.integers(0, 2 * n, (b,), dtype=np.int32)
    ext_or = rng.integers(-128, 128, (k1, k1 * levels, 8 - js, 2 * n)
                          ).astype(np.int8)
    return acc, t, ext_or, levels, base_log, 2


@pytest.mark.parametrize("js", [0, 2])
@pytest.mark.parametrize("n,b", STEP_SHAPES)
def test_k9_cmux_step_merged_matches_pallas(n, b, js):
    acc, t, ext_or, levels, base_log, _ = _cmux_inputs(200 + js, n, b, js)
    ref = np.asarray(jx.cmux_step_merged(
        jnp.asarray(t), jnp.asarray(ext_or), _acc_pair(acc), base_log, levels,
        interpret=True, j_start=js))
    acc_t = t64(acc)
    got = kx.cmux_step_merged(torch.from_numpy(t), t8(ext_or), acc_t,
                              base_log, levels, js)
    assert got is not acc_t              # a second buffer, not the TPU alias
    np.testing.assert_array_equal(u64(acc_t), acc)      # input untouched
    np.testing.assert_array_equal(u64(got), _from_pair(ref[:, 0], ref[:, 1]))


@pytest.mark.parametrize("n,b", STEP_SHAPES)
def test_k10a_rot_diff_digits_flat_matches_pallas(n, b):
    acc, t, _, levels, base_log, n_d = _cmux_inputs(210, n, b, 0, k1=3)
    ref = np.asarray(jx.rot_diff_digits_flat(
        _acc_pair(acc), jnp.asarray(t), base_log, levels, n_d,
        interpret=True))
    got = kx.rot_diff_digits_flat(t64(acc), torch.from_numpy(t), base_log,
                                  levels, n_d)
    assert got.shape == (n_d, b, 3 * levels * n) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("js", [0, 2])
@pytest.mark.parametrize("n,b", STEP_SHAPES)
def test_k10b_extprod_step_longk_matches_pallas(n, b, js):
    """The Pallas function gets its own plane-major key layout ext_oj
    [O, 8-js, R, 2N]; the port's takes the prepared entry ext_or."""
    acc, _, ext_or, levels, _, n_d = _cmux_inputs(220 + js, n, b, js)
    rng = np.random.default_rng(225 + js)
    dig = rng.integers(-128, 128, (n_d, b, ext_or.shape[1] * n)
                       ).astype(np.int8)
    ref = np.asarray(jx.extprod_step_longk(
        jnp.asarray(dig), jnp.asarray(ext_or.transpose(0, 2, 1, 3)),
        _acc_pair(acc), interpret=True, j_start=js))
    acc_t = t64(acc)
    got = kx.extprod_step_longk(t8(dig), t8(ext_or), acc_t, js)
    assert got is acc_t                  # in place, like the TPU kernel
    np.testing.assert_array_equal(u64(got), _from_pair(ref[:, 0], ref[:, 1]))


@pytest.mark.parametrize("js", [0, 2])
@pytest.mark.parametrize("n,b", STEP_SHAPES)
def test_k11_extprod_step3_matches_pallas(n, b, js):
    acc, _, ext_or, levels, _, n_d = _cmux_inputs(230 + js, n, b, js)
    rng = np.random.default_rng(235 + js)
    k1, r = ext_or.shape[:2]
    dig = rng.integers(-128, 128, (r, n_d, b, n)).astype(np.int8)
    ref = np.asarray(jx.extprod_step3(
        jnp.asarray(dig), jnp.asarray(ext_or), _acc_pair(acc),
        interpret=True, j_start=js))
    acc_t = t64(acc)
    got = kx.extprod_step3(t8(dig).reshape(k1, levels, n_d, b, n),
                           t8(ext_or), acc_t, js)
    assert got is acc_t                  # in place, like the TPU kernel
    np.testing.assert_array_equal(u64(got), _from_pair(ref[:, 0], ref[:, 1]))


@pytest.mark.parametrize("js", [0, 2])
def test_merged_longk_bucket_steps_equal_k2_then_k5(js):
    """One step of each schedule takes the accumulator to the same value:
    K9 = K10b after K10a = K11 after K2 = K5 after K2."""
    acc, t, ext_or, levels, base_log, n_d = _cmux_inputs(240 + js, 64, 5, js,
                                                         k1=3)
    t, ext = torch.from_numpy(t), t8(ext_or)
    dig = kx.rot_diff_digits(t64(acc), t, base_log, levels, n_d)
    want = u64(kx.extprod_step2(dig, ext, t64(acc), js))
    np.testing.assert_array_equal(
        u64(kx.cmux_step_merged(t, ext, t64(acc), base_log, levels, js)),
        want)
    flat = kx.rot_diff_digits_flat(t64(acc), t, base_log, levels, n_d)
    np.testing.assert_array_equal(
        flat.reshape(n_d, 5, 3, levels, 64).permute(2, 3, 0, 1, 4).numpy(),
        dig.numpy())
    np.testing.assert_array_equal(
        u64(kx.extprod_step_longk(flat, ext, t64(acc), js)), want)
    np.testing.assert_array_equal(
        u64(kx.extprod_step3(dig, ext, t64(acc), js)), want)


@pytest.mark.parametrize("b,k,n,n_d,js", [
    (256, 256, 128, 1, 5),     # keyswitch-like: base-3 digits, 3 key planes
    (256, 384, 256, 3, 1),     # pfKS-like: base-16 digits, 7 key planes
    (256, 256, 128, 2, 0),     # no truncation
])
def test_k4_fused_limb_matmul_matches_pallas(b, k, n, n_d, js):
    rng = np.random.default_rng(120 + js)
    d = rng.integers(-128, 128, (n_d, b, k)).astype(np.int8)
    m = rng.integers(-128, 128, (8 - js, k, n)).astype(np.int8)
    ref = np.asarray(jmm.fused_limb_matmul(jnp.asarray(d), jnp.asarray(m),
                                           j_start=js, interpret=True))
    got = kmm.fused_limb_matmul(t8(d), t8(m), js)
    np.testing.assert_array_equal(u64(got), ref)


def test_k4_plain_takes_unpadded_shapes():
    """The port's K4 takes every shape (the TPU kernel only 128-multiples):
    a ragged contraction equals the zero-padded one."""
    rng = np.random.default_rng(130)
    d = rng.integers(-128, 128, (3, 5, 77)).astype(np.int8)
    m = rng.integers(-128, 128, (7, 77, 33)).astype(np.int8)
    got = kmm.fused_limb_matmul(t8(d), t8(m), 1)
    d_pad = np.pad(d, ((0, 0), (0, 0), (0, 51)))
    m_pad = np.pad(m, ((0, 0), (0, 51), (0, 0)))
    np.testing.assert_array_equal(u64(got), u64(kmm.fused_limb_matmul(
        t8(d_pad), t8(m_pad), 1)))


def test_wrappers_refuse_bad_shapes():
    with pytest.raises(ValueError):
        kmm.fused_limb_matmul(torch.zeros((1, 4, 8), dtype=torch.int8),
                              torch.zeros((3, 9, 4), dtype=torch.int8), 5)
    with pytest.raises(ValueError):
        kx.extprod_grouped_fused(torch.zeros((2, 3, 4, 8), dtype=torch.int8),
                                 torch.zeros((2, 2, 3, 6, 16),
                                             dtype=torch.int8), 2, 3)
    z8 = lambda *shape: torch.zeros(shape, dtype=torch.int8)
    with pytest.raises(ValueError):      # K7 takes all 8 key planes
        kx.extprod_partials(z8(2, 3, 4, 8), z8(6, 4, 2, 16))
    with pytest.raises(ValueError):      # K6: acc must be batch-major
        kx.extprod_step(z8(2, 3, 4, 8), z8(2, 4, 6, 16),
                        torch.zeros((2, 3, 8), dtype=torch.int64), 2)
    with pytest.raises(ValueError):      # K8: plane count != 8 - j_start
        kx.extprod_partials_grouped(z8(2, 3, 5, 4, 8), z8(6, 3, 4, 2, 16), 4)
    z64 = lambda *shape: torch.zeros(shape, dtype=torch.int64)
    z32 = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    with pytest.raises(ValueError):      # K9: R must be O·levels
        kx.cmux_step_merged(z32(3), z8(2, 5, 6, 16), z64(2, 3, 8), 12, 2, 2)
    with pytest.raises(ValueError):      # K10a: one t per lane
        kx.rot_diff_digits_flat(z64(2, 3, 8), z32(4), 12, 2, 2)
    with pytest.raises(ValueError):      # K10b: flat row length must be R·N
        kx.extprod_step_longk(z8(2, 3, 24), z8(2, 4, 6, 16), z64(2, 3, 8), 2)
    with pytest.raises(ValueError):      # K11: acc must be component-major
        kx.extprod_step3(z8(2, 2, 2, 3, 8), z8(2, 4, 6, 16), z64(3, 2, 8), 2)
