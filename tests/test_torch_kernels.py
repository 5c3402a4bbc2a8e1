"""Kernels K1-K4 of the PyTorch port: each plain version against the JAX
package's Pallas function (interpret mode) on the same numpy-made int8
inputs, at j_start 0 and at the truncated j_start. Both sides are exact
integer arithmetic mod 2^64, so the tolerance is 0 (bit-equality). The
CUDA kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_aes2_tpu.ops.pallas import extprod as jx
from tfhe_aes2_tpu.ops.pallas import matmul as jmm

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
