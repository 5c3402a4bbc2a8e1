"""The N = 1024 parameter sets (lvl1, lvl4, lvl256) in the PyTorch port.

Each kernel's plain version at N = 1024 against the JAX package's Pallas
function in interpret mode, on the same numpy-made int8 inputs: K1 and K5 at
both N = 1024 blind-rotation gadgets, K2, K3 and K8 at the vertical
packing's js of lvl256 (3) and lvl1/lvl4 (4), K4 with four digit limbs.
Both sides are exact integer arithmetic mod 2^64: the tolerance is 0. Then
the truncation's js for every set, one circuit bootstrap at N = 1024, k = 2
with lvl1's gadgets, and the noise budgets of lvl1/lvl4 against the AES
pipeline, each held against the JAX package. The CUDA kernels at N = 1024
are held against these plain versions on the card by
tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tfhe_aes2_tpu.aes_128 import fhe as jfhe
from tfhe_aes2_tpu.models import shortint_woppbs_1bit as jm1
from tfhe_aes2_tpu.ops import circuit_bootstrap as jcbs
from tfhe_aes2_tpu.ops import keys as jkeys
from tfhe_aes2_tpu.ops import params as jparams
from tfhe_aes2_tpu.ops import truncation as jtrunc
from tfhe_aes2_tpu.ops.pallas import extprod as jx
from tfhe_aes2_tpu.ops.pallas import matmul as jmm

from tfhe_aes2_tpu_torch.aes_128 import fhe as tfhe
from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as tm1
from tfhe_aes2_tpu_torch.ops import circuit_bootstrap as tcbs
from tfhe_aes2_tpu_torch.ops import decomposition, torus
from tfhe_aes2_tpu_torch.ops import keys as tkeys
from tfhe_aes2_tpu_torch.ops import params as tparams
from tfhe_aes2_tpu_torch.ops import polynomial as tpoly
from tfhe_aes2_tpu_torch.ops import truncation as ttrunc
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx
from tfhe_aes2_tpu_torch.ops.kernels import matmul as kmm
from tests.torch_port_common import jax_server_keys, t8, t64, u64
from tests.test_torch_kernels import _acc_pair, _from_pair

N = 1024
K1 = 3                    # k + 1 at k = 2, every N = 1024 set
# the N = 1024 blind-rotation gadgets (levels, base_log): lvl1/lvl4, lvl256
WIDE_GADGETS = [(2, 15), (4, 9)]


@pytest.mark.parametrize("levels,base_log", WIDE_GADGETS)
def test_k1_and_k5_match_pallas_at_n1024(levels, base_log):
    """K1 (the step and the next step's glue) and K5 (the step alone) at
    N = 1024, R = 3·levels, B = 8, js = 2; K2 then K5 equals K1."""
    rng = np.random.default_rng(1024 + levels)
    b, n_d, js = 8, 2, 2
    acc = rng.integers(0, 2 ** 64, (K1, b, N), dtype=np.uint64)
    dig = rng.integers(-128, 128, (K1, levels, n_d, b, N)).astype(np.int8)
    ext = rng.integers(-128, 128, (K1, K1 * levels, 8 - js, 2 * N)
                       ).astype(np.int8)
    t_next = rng.integers(0, 2 * N, (b,), dtype=np.int32)
    t_next[:4] = [0, N - 1, N, 2 * N - 1]
    ref_acc, ref_dig = jx.extprod_step2g(
        jnp.asarray(dig), jnp.asarray(ext), _acc_pair(acc),
        jnp.asarray(t_next), base_log=base_log, levels=levels,
        interpret=True, j_start=js)
    ref_acc = _from_pair(np.asarray(ref_acc)[:, 0], np.asarray(ref_acc)[:, 1])
    got_acc, got_dig = kx.extprod_step2g(t8(dig), t8(ext), t64(acc),
                                         torch.from_numpy(t_next), base_log,
                                         levels, js)
    np.testing.assert_array_equal(u64(got_acc), ref_acc)
    np.testing.assert_array_equal(got_dig.numpy(), np.asarray(ref_dig))
    dig_rf = dig.reshape((K1 * levels,) + dig.shape[2:])
    ref5 = np.asarray(jx.extprod_step2(
        jnp.asarray(dig_rf), jnp.asarray(ext), _acc_pair(acc),
        interpret=True, j_start=js))
    got5 = kx.extprod_step2(t8(dig), t8(ext), t64(acc), js)
    np.testing.assert_array_equal(u64(got5), _from_pair(ref5[:, 0],
                                                         ref5[:, 1]))
    np.testing.assert_array_equal(u64(got5), ref_acc)
    np.testing.assert_array_equal(
        kx.rot_diff_digits(got5, torch.from_numpy(t_next), base_log, levels,
                           n_d).numpy(), got_dig.numpy())


@pytest.mark.parametrize("levels,base_log", WIDE_GADGETS)
def test_k2_matches_pallas_at_n1024(levels, base_log):
    rng = np.random.default_rng(2048 + levels)
    b, n_d = 8, 2
    acc = rng.integers(0, 2 ** 64, (K1, b, N), dtype=np.uint64)
    t = rng.integers(0, 2 * N, (b,), dtype=np.int32)
    t[:4] = [0, N - 1, N, 2 * N - 1]
    ref = np.asarray(jx.rot_diff_digits(_acc_pair(acc), jnp.asarray(t),
                                        base_log, levels, n_d,
                                        interpret=True))
    got = kx.rot_diff_digits(t64(acc), torch.from_numpy(t), base_log,
                             levels, n_d).numpy()
    np.testing.assert_array_equal(got.reshape(ref.shape), ref)


@pytest.mark.parametrize("js", [3, 4])
def test_k3_and_k8_match_pallas_at_n1024(js):
    """The vertical packing's product at N = 1024, one cbs level (R = 3),
    two limbs, a ragged G-tile: K3 and K8 against their Pallas functions;
    K8 recombined equals K3."""
    rng = np.random.default_rng(3072 + js)
    b, r, g, n_d = 1, K1, 3, 2
    dig = rng.integers(-128, 128, (b, r, n_d * g, N)).astype(np.int8)
    ext = rng.integers(-128, 128, (b, K1, r, 8 - js, 2 * N)).astype(np.int8)
    pair = np.asarray(jx.extprod_grouped_fused(
        jnp.asarray(dig), jnp.asarray(ext), n_d=n_d, j_start=js,
        interpret=True))
    fused = kx.extprod_grouped_fused(t8(dig), t8(ext), n_d, js)
    np.testing.assert_array_equal(u64(fused),
                                  _from_pair(pair[:, :, 0], pair[:, :, 1]))
    dig_8 = np.ascontiguousarray(
        dig.reshape(b, r, n_d, g, N).transpose(2, 0, 3, 1, 4))
    ext_8 = np.ascontiguousarray(ext.transpose(3, 0, 2, 1, 4))
    ref = np.asarray(jx.extprod_partials_grouped(
        jnp.asarray(dig_8), jnp.asarray(ext_8), interpret=True, j_start=js))
    parts = kx.extprod_partials_grouped(t8(dig_8), t8(ext_8), js)
    np.testing.assert_array_equal(parts.numpy(), ref)
    np.testing.assert_array_equal(
        u64(tpoly.recombine_partials(parts, js)),
        u64(fused.permute(0, 2, 1, 3)))


def test_k4_four_limbs_matches_pallas():
    """K4 with four digit limbs (lvl1's pfKS gadget (1, 24): digits up to
    2^23), B = 128, K = 256, js = 1."""
    rng = np.random.default_rng(4096)
    b, k, n, n_d, js = 128, 256, 128, 4, 1
    d = rng.integers(-128, 128, (n_d, b, k)).astype(np.int8)
    m = rng.integers(-128, 128, (8 - js, k, n)).astype(np.int8)
    ref = np.asarray(jmm.fused_limb_matmul(jnp.asarray(d), jnp.asarray(m),
                                           j_start=js, interpret=True))
    got = kmm.fused_limb_matmul(t8(d), t8(m), js)
    np.testing.assert_array_equal(u64(got), ref)


SETS = {"lvl1": (2, 5, 1, 4), "lvl4": (2, 5, 1, 4), "lvl64": (2, 5, 1, 4),
        "lvl256": (2, 5, 1, 3)}


@pytest.mark.parametrize("name", list(SETS))
def test_truncation_matches_the_jax_package(name):
    """The limb planes each set's keys drop (bsk, ksk, pfpksk, vp): the
    port's rules give the JAX package's js (tests/test_params_all_sets.py)."""
    from tfhe_aes2_tpu_torch import cli

    p = cli.PARAM_CHOICES[name]
    jp = {"lvl1": jparams.PARAMS_SQRD_LVL_1, "lvl4": jparams.PARAMS_SQRD_LVL_4,
          "lvl64": jparams.PARAMS_SQRD_LVL_64,
          "lvl256": jparams.PARAMS_SQRD_LVL_256}[name]
    assert p.__dict__ == jp.__dict__
    got = (ttrunc.bsk_j_start(p), ttrunc.ksk_j_start(p),
           ttrunc.pfpksk_j_start(p), ttrunc.vp_ggsw_j_start(p))
    want = (jtrunc.bsk_j_start(jp), jtrunc.ksk_j_start(jp),
            jtrunc.pfpksk_j_start(jp), jtrunc.vp_ggsw_j_start(jp))
    assert got == want == SETS[name]


# lvl1 with n = 4: its ring, gadgets and noise (N = 1024, k = 2, pbs
# (2, 15), ks (4, 3), cbs (1, 10), pfKS (1, 24): four digit limbs in K4),
# INSECURE, so that the blind rotation takes four steps. The pfKS key's
# noise is multiplied by digits up to 2^23, so a test set's larger noise
# would not decode here.
WIDE_FIELDS = dict(tparams.PARAMS_SQRD_LVL_1.__dict__, lwe_dimension=4,
                   max_noise_level_squared=64)


def test_circuit_bootstrap_at_n1024_matches_the_jax_package():
    """One circuit bootstrap (keyswitch, scaling PBS, pfKS with four digit
    limbs, a 3->3-bit lookup in one polynomial: no CMux tree, three
    rotation stages) at N = 1024, k = 2, with lvl1's gadgets, bit-equal to
    the JAX package on raw keys (every limb plane kept: its matmul path),
    and decrypting to the LUT's values."""
    jp = jparams.WopbsParams(**WIDE_FIELDS)
    tp = tparams.WopbsParams(**WIDE_FIELDS)
    jkeys_pair = jkeys.generate_keys(jp, seed=11)
    jclient, jsks = jkeys_pair
    _, raw = tkeys.keys_from_numpy(
        tp, jclient.lwe_sk, jclient.glwe_sk, np.asarray(jsks.bsk),
        np.asarray(jsks.ksk), np.asarray(jsks.pfpksk), np.asarray(jsks.pksk),
        device="cpu")
    prepared = tkeys.prepare_server_keys(raw, tp, truncate=False)
    assert torus.limbs_for_bound(decomposition.digit_bound(
        tp.pfks_base_log)) == 4
    jprep = jax_server_keys(jkeys_pair, False)
    vals = np.array([5, 2])
    bits = (vals[:, None] >> np.arange(2, -1, -1)) & 1      # [2, 3], MSB first
    cts = jclient.encrypt_bits(bits)
    f = lambda v: (v * 3 + 1) % 8                                   # noqa
    lut = jcbs.generate_lut(3, 3, f, jp)
    np.testing.assert_array_equal(tcbs.generate_lut(3, 3, f, tp), lut)
    out = tcbs.circuit_bootstrap_vertical_packing(t64(cts), t64(lut),
                                                  prepared, tp)
    ggsw = jcbs.circuit_bootstrap_bits(jnp.asarray(cts), jprep, jp)
    ref = np.asarray(jcbs.vertical_packing(ggsw, jnp.asarray(lut), jp,
                                           use_conv="matmul"))
    np.testing.assert_array_equal(u64(out), ref)
    want = (np.array([f(v) for v in vals])[:, None]
            >> np.arange(2, -1, -1)) & 1
    np.testing.assert_array_equal(jclient.decrypt_bits(u64(out)), want)


def test_lvl1_and_lvl4_budgets_refuse_the_aes_pipeline():
    """max_noise_level_squared is 1 at lvl1 and 4 at lvl4, below what the
    SBOX+GalMul pipeline's XORs need (ARK0's fresh ^ fresh is 2; the key
    schedule's XOR chain reaches 5 before its first bootstrap): on the
    latency path both packages stop with NoiseError before any bootstrap,
    here on PARAMS_TEST's ring with those budgets."""
    for budget in (1, 4):
        jp = dataclasses.replace(jparams.PARAMS_TEST,
                                 max_noise_level_squared=budget)
        tp = dataclasses.replace(tparams.PARAMS_TEST,
                                 max_noise_level_squared=budget)
        client, sks = jkeys.generate_keys(jp, seed=3)
        tclient, traw = tkeys.keys_from_numpy(
            tp, client.lwe_sk, client.glwe_sk, np.asarray(sks.bsk),
            np.asarray(sks.ksk), np.asarray(sks.pfpksk),
            np.asarray(sks.pksk), device="cpu")
        tctx = tm1.context_from_keys(tp, traw)
        strategy = tfhe.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt
        key_ct = strategy.encrypt_key_client(tclient, bytes(16))
        block_ct = strategy.encrypt_client(tclient, [bytes(16)])[0]
        with pytest.raises(tm1.NoiseError, match="NoiseTooBig"):
            tfhe.encrypt_block_latency(strategy, tctx, t64(key_ct),
                                       t64(block_ct))
        jctx = jm1.FheContext(params=jp,
                              sks=jax.tree_util.tree_map(jnp.asarray, sks))
        with pytest.raises(jm1.NoiseError, match="NoiseTooBig"):
            jfhe.encrypt_block_latency(
                jfhe.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt, jctx,
                jnp.asarray(key_ct), jnp.asarray(block_ct))
