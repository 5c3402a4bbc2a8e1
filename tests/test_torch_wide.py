"""The N = 1024 parameter sets (lvl1, lvl4, lvl256) in the PyTorch port.

Each kernel's plain version at N = 1024 against the JAX package's Pallas
function in interpret mode, on the same numpy-made int8 inputs: K1 and K5 at
both N = 1024 blind-rotation gadgets, K2, K3 and K8 at the vertical
packing's js of lvl256 (3) and lvl1/lvl4 (4), K4 with four digit limbs; K6,
K7, K10a, K10b and K11 (the glue_out, longk and bucket steps) at lvl256's
and the 8-bit model's step, R cut to 3 rows.
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
from tfhe_aes2_tpu.ops import blind_rotate as jbr
from tfhe_aes2_tpu.models import shortint_woppbs_1bit as jm1
from tfhe_aes2_tpu.ops import circuit_bootstrap as jcbs
from tfhe_aes2_tpu.ops import keys as jkeys
from tfhe_aes2_tpu.ops import params as jparams
from tfhe_aes2_tpu.ops import truncation as jtrunc
from tfhe_aes2_tpu.ops.pallas import extprod as jx
from tfhe_aes2_tpu.ops.pallas import matmul as jmm

from tfhe_aes2_tpu_torch.aes_128 import fhe as tfhe
from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as tm1
from tfhe_aes2_tpu_torch.ops import blind_rotate as tbr
from tfhe_aes2_tpu_torch.ops import circuit_bootstrap as tcbs
from tfhe_aes2_tpu_torch.ops import decomposition, torus
from tfhe_aes2_tpu_torch.ops import keys as tkeys
from tfhe_aes2_tpu_torch.ops import params as tparams
from tfhe_aes2_tpu_torch.ops import polynomial as tpoly
from tfhe_aes2_tpu_torch.ops import truncation as ttrunc
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx
from tfhe_aes2_tpu_torch.ops.kernels import matmul as kmm
from tfhe_aes2_tpu_torch.ops.lowering import Lowering
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


# The steps of the schedules longk, bucket and glue_out at N = 1024, k = 2:
# lvl256's gadget (4, 9) with two limbs and its BSK truncation js = 2, the
# 8-bit model's (6, 7) with one limb and js = 1; the products cut to R = 3
# rows (O = 3, one level), the glue to one component.
WIDE_STEPS = {"lvl256": (4, 9, 2, 2), "woppbs_8bit": (6, 7, 1, 1)}


def _wide_step_inputs(seed, name, b=9, r=3):
    """Batch-major digit planes int8 [n_d, B, R, N], all 8 key planes int8
    [8, R, O, 2N] with the planes below js zeroed, the prepared entry
    ext_or int8 [O, R, 8-js, 2N] of the same planes, and acc uint64
    [O, B, N]."""
    _, _, n_d, js = WIDE_STEPS[name]
    rng = np.random.default_rng(seed)
    dig = rng.integers(-128, 128, (n_d, b, r, N)).astype(np.int8)
    ext = rng.integers(-128, 128, (8, r, K1, 2 * N)).astype(np.int8)
    ext[:js] = 0
    ext_or = np.ascontiguousarray(ext[js:].transpose(2, 1, 0, 3))
    acc = rng.integers(0, 2 ** 64, (K1, b, N), dtype=np.uint64)
    return dig, ext, ext_or, acc, js


@pytest.mark.parametrize("name", sorted(WIDE_STEPS))
def test_k6_and_k7_match_pallas_at_n1024(name):
    """K6 (the glue_out step, a new [B, O, N] tensor) and K7 (all 8 key
    planes as int32 buckets) at N = 1024; K7 recombined is K6's update."""
    dig, ext, ext_or, acc, js = _wide_step_inputs(6100 + len(name), name)
    acc_bm = np.ascontiguousarray(acc.transpose(1, 0, 2))
    lo = jnp.asarray(acc_bm & np.uint64(0xFFFFFFFF), jnp.uint32)
    hi = jnp.asarray(acc_bm >> np.uint64(32), jnp.uint32)
    ref = jx.extprod_step(jnp.asarray(dig), jnp.asarray(ext[js:]), lo, hi,
                          interpret=True, j_start=js)
    got = kx.extprod_step(t8(dig), t8(ext_or), t64(acc_bm), js)
    np.testing.assert_array_equal(u64(got), _from_pair(*ref))
    parts = kx.extprod_partials(t8(dig), t8(ext))
    np.testing.assert_array_equal(
        parts.numpy(), np.asarray(jx.extprod_partials(
            jnp.asarray(dig), jnp.asarray(ext), interpret=True)))
    np.testing.assert_array_equal(
        u64(t64(acc_bm) + tpoly.recombine_partials(parts)), u64(got))


@pytest.mark.parametrize("name", sorted(WIDE_STEPS))
def test_k10a_matches_pallas_at_n1024(name):
    """K10a (longk's glue, the flat layout [n_d, B, R·N]) at N = 1024 with
    the set's gadget, one component, the rotations 0, N-1, N and 2N-1 among
    the lanes."""
    levels, base_log, n_d, _ = WIDE_STEPS[name]
    rng = np.random.default_rng(6200 + levels)
    b = 9
    acc = rng.integers(0, 2 ** 64, (1, b, N), dtype=np.uint64)
    t = rng.integers(0, 2 * N, (b,), dtype=np.int32)
    t[:4] = [0, N - 1, N, 2 * N - 1]
    ref = np.asarray(jx.rot_diff_digits_flat(
        _acc_pair(acc), jnp.asarray(t), base_log, levels, n_d,
        interpret=True))
    got = kx.rot_diff_digits_flat(t64(acc), torch.from_numpy(t), base_log,
                                  levels, n_d)
    assert got.shape == (n_d, b, levels * N)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name", sorted(WIDE_STEPS))
def test_k10b_and_k11_match_pallas_at_n1024(name):
    """K10b (the longk update on flat digits; the Pallas function takes its
    plane-major key [O, 8-js, R, 2N]) and K11 (the bucket update on K2's
    layout [R, n_d, B, N]) at N = 1024, in place; both equal K5's update."""
    dig, _, ext_or, acc, js = _wide_step_inputs(6300 + len(name), name)
    n_d, b, r, _ = dig.shape
    flat = np.ascontiguousarray(dig.reshape(n_d, b, r * N))
    ref = np.asarray(jx.extprod_step_longk(
        jnp.asarray(flat), jnp.asarray(ext_or.transpose(0, 2, 1, 3)),
        _acc_pair(acc), interpret=True, j_start=js))
    got = kx.extprod_step_longk(t8(flat), t8(ext_or), t64(acc), js)
    np.testing.assert_array_equal(u64(got), _from_pair(ref[:, 0], ref[:, 1]))
    dig_rf = np.ascontiguousarray(dig.transpose(2, 0, 1, 3))  # [R, n_d, B, N]
    ref = np.asarray(jx.extprod_step3(
        jnp.asarray(dig_rf), jnp.asarray(ext_or), _acc_pair(acc),
        interpret=True, j_start=js))
    dig5 = t8(dig_rf).reshape(K1, 1, n_d, b, N)
    got11 = kx.extprod_step3(dig5, t8(ext_or), t64(acc), js)
    np.testing.assert_array_equal(u64(got11),
                                  _from_pair(ref[:, 0], ref[:, 1]))
    np.testing.assert_array_equal(u64(got11), u64(got))
    np.testing.assert_array_equal(
        u64(kx.extprod_step2(dig5, t8(ext_or), t64(acc), js)), u64(got))


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


# the JAX package's environment for each schedule of the blind rotation
BR_ENV = {"longk": {"TFHE_BR_KERNEL": "longk"},
          "bucket": {"TFHE_BR_KERNEL": "bucket"},
          "glue_out": {"TFHE_BR_GLUE": "xla"}}


@pytest.mark.parametrize("br", sorted(BR_ENV))
def test_blind_rotation_at_n1024_matches_jax_under_matching_env(monkeypatch,
                                                                br):
    """One blind rotation of 2 steps at lvl256's geometry (N = 1024, k = 2,
    gadget (4, 9), the BSK truncated at js = 2) on an odd batch of 3 and a
    random u64 BSK, prepared by each package: the port under Lowering(br)
    on the CPU (the plain versions of K10a + K10b, K2 + K11, torch glue +
    K6) equals the JAX package's Pallas path in interpret mode under the
    environment that selects the same schedule there."""
    fields = dict(tparams.PARAMS_SQRD_LVL_256.__dict__, lwe_dimension=2)
    jp, tp = jparams.WopbsParams(**fields), tparams.WopbsParams(**fields)
    for name in ("TFHE_BR_KERNEL", "TFHE_BR_GLUE", "TFHE_VP_FUSED"):
        monkeypatch.delenv(name, raising=False)
    for name, value in BR_ENV[br].items():
        monkeypatch.setenv(name, value)
    assert Lowering.from_env() == Lowering(br)
    rng = np.random.default_rng(1240)
    bsk = rng.integers(0, 2 ** 64, (2, tp.pbs_level, K1, K1, N),
                       dtype=np.uint64)
    lwe = rng.integers(0, 2 ** 64, (3, 3), dtype=np.uint64)
    acc = rng.integers(0, 2 ** 64, (K1, N), dtype=np.uint64)
    ref = np.asarray(jbr.blind_rotate_glwe(
        jnp.asarray(lwe), jbr.prepare_bsk(jnp.asarray(bsk), jp),
        jnp.asarray(acc), jp, use_conv="pallas"))
    js = ttrunc.bsk_j_start(tp)
    assert js == 2
    got = tbr.blind_rotate_glwe(t64(lwe), tkeys.prepare_bsk(t64(bsk), js),
                                t64(acc), tp, Lowering(br))
    np.testing.assert_array_equal(u64(got), ref)


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
