"""Primitive modules of the PyTorch port against the JAX package, bit for
bit on numpy-made inputs: truncation rules, torus limb splits and the
exact contraction, gadget decomposition, LWE ops, negacyclic polynomials,
and key generation / preparation / client encryption."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tfhe_aes2_tpu.native
from tfhe_aes2_tpu.ops import decomposition as jdec
from tfhe_aes2_tpu.ops import keys as jkeys
from tfhe_aes2_tpu.ops import lwe as jlwe
from tfhe_aes2_tpu.ops import params as jparams
from tfhe_aes2_tpu.ops import polynomial as jpoly
from tfhe_aes2_tpu.ops import torus as jtorus
from tfhe_aes2_tpu.ops import truncation as jtrunc

from tfhe_aes2_tpu_torch.ops import decomposition as tdec
from tfhe_aes2_tpu_torch.ops import keys as tkeys
from tfhe_aes2_tpu_torch.ops import lwe as tlwe
from tfhe_aes2_tpu_torch.ops import params as tparams
from tfhe_aes2_tpu_torch.ops import polynomial as tpoly
from tfhe_aes2_tpu_torch.ops import torus as ttorus
from tfhe_aes2_tpu_torch.ops import truncation as ttrunc
from tests.torch_port_common import (jax_server_keys, port_keys, port_params,
                                     t64, u64)

SETS = ["PARAMS_SQRD_LVL_1", "PARAMS_SQRD_LVL_4", "PARAMS_SQRD_LVL_64",
        "PARAMS_SQRD_LVL_256", "PARAMS_TEST", "PARAMS_TEST_N256"]


@pytest.mark.parametrize("name", SETS)
def test_params_and_truncation_rules_match(name):
    jp, tp = getattr(jparams, name), getattr(tparams, name)
    assert jp.__dict__ == tp.__dict__
    for fn in ("bsk_j_start", "ksk_j_start", "pfpksk_j_start",
               "vp_ggsw_j_start"):
        assert getattr(ttrunc, fn)(tp) == getattr(jtrunc, fn)(jp), fn


def test_truncation_values_at_lvl64_and_test():
    rules = (ttrunc.bsk_j_start, ttrunc.ksk_j_start, ttrunc.pfpksk_j_start,
             ttrunc.vp_ggsw_j_start)
    assert [f(tparams.PARAMS_SQRD_LVL_64) for f in rules] == [2, 5, 1, 4]
    assert [f(tparams.PARAMS_TEST) for f in rules] == [2, 4, 2, 5]


TRUNC_ENV = ("TFHE_BSK_TRUNC", "TFHE_KSK_TRUNC", "TFHE_VP_TRUNC",
             "TFHE_TRUNC_BUDGET")
TRUNC_SWITCHES = {"bsk_off": {"TFHE_BSK_TRUNC": "0"},
                  "ksk_off": {"TFHE_KSK_TRUNC": "0"},
                  "vp_off": {"TFHE_VP_TRUNC": "0"},
                  "budget_quarter": {"TFHE_TRUNC_BUDGET": "0.25"},
                  "vp_off_budget_quarter": {"TFHE_VP_TRUNC": "0",
                                            "TFHE_TRUNC_BUDGET": "0.25"},
                  "budget_zero": {"TFHE_TRUNC_BUDGET": "0"}}


def _set_trunc_env(monkeypatch, env):
    for name in TRUNC_ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("switch", sorted(TRUNC_SWITCHES))
def test_truncation_switches_match_at_every_set(switch, monkeypatch):
    """The JAX package's four truncation switches, read by both packages
    at each call: the same js per key at every set of ops/params.py."""
    _set_trunc_env(monkeypatch, TRUNC_SWITCHES[switch])
    names = [n for n in dir(jparams) if isinstance(getattr(jparams, n),
                                                   jparams.WopbsParams)]
    assert len(names) >= 9
    for name in names:
        jp, tp = getattr(jparams, name), getattr(tparams, name)
        for fn in ("bsk_j_start", "ksk_j_start", "pfpksk_j_start",
                   "vp_ggsw_j_start"):
            assert getattr(ttrunc, fn)(tp) == getattr(jtrunc, fn)(jp), \
                (name, fn)


def test_truncation_switches_disable_their_keys(monkeypatch):
    p = tparams.PARAMS_SQRD_LVL_64
    rules = (ttrunc.bsk_j_start, ttrunc.ksk_j_start, ttrunc.pfpksk_j_start,
             ttrunc.vp_ggsw_j_start)
    expect = {"bsk_off": [0, 5, 1, 4], "ksk_off": [2, 0, 0, 4],
              "vp_off": [2, 5, 1, 0], "vp_off_budget_quarter": [1, 5, 1, 0]}
    for switch, js in expect.items():
        _set_trunc_env(monkeypatch, TRUNC_SWITCHES[switch])
        assert [f(p) for f in rules] == js, switch


@pytest.mark.parametrize("switch", ["vp_off", "bsk_off", "ksk_off",
                                    "budget_quarter"])
def test_prepared_keys_match_under_a_switch(keys_test, monkeypatch, switch):
    """PARAMS_TEST's prepared keys under one switch: the port's int8
    planes and vp_js equal the JAX package's prepared planes
    (tests/torch_port_common.jax_server_keys) under the same switch."""
    _set_trunc_env(monkeypatch, TRUNC_SWITCHES[switch])
    client, raw = port_keys(keys_test)
    p = client.params
    prep = tkeys.prepare_server_keys(raw, p, truncate=True)
    jprep = jax_server_keys(keys_test, True)
    jp = keys_test[0].params
    assert prep.vp_js == jtrunc.vp_ggsw_j_start(jp)
    np.testing.assert_array_equal(prep.bsk.numpy(), np.asarray(jprep.bsk))
    np.testing.assert_array_equal(
        prep.ksk.numpy(), np.asarray(jprep.ksk).reshape(prep.ksk.shape))
    np.testing.assert_array_equal(
        prep.pfpksk.numpy(),
        np.asarray(jprep.pfpksk).reshape(prep.pfpksk.shape))


@pytest.mark.parametrize("js", [0, 1, 3, 7])
def test_truncate_u64_values_matches(js):
    x = np.random.default_rng(js).integers(0, 2 ** 64, 500, dtype=np.uint64)
    ref = np.asarray(jtrunc.truncate_u64_values(jnp.asarray(x), js))
    np.testing.assert_array_equal(u64(ttrunc.truncate_u64_values(t64(x), js)),
                                  ref)


def test_torus_limb_splits_match():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2 ** 64, (7, 33), dtype=np.uint64)
    x[0, :4] = [0, 2 ** 63, 2 ** 64 - 1, 0x8080808080808080]
    np.testing.assert_array_equal(ttorus.split_u64_signed(t64(x)).numpy(),
                                  np.asarray(jtorus.split_u64_signed(x)))
    for n_limbs, bound in ((1, 100), (2, 1 << 14), (3, 1 << 15)):
        d = rng.integers(-bound, bound + 1, (5, 40)).astype(np.int32)
        np.testing.assert_array_equal(
            ttorus.split_int32_signed(torch.from_numpy(d), n_limbs).numpy(),
            np.asarray(jtorus.split_int32_signed(d, n_limbs)))
        assert ttorus.limbs_for_bound(bound) == jtorus.limbs_for_bound(bound)


@pytest.mark.parametrize("js", [0, 3])
def test_exact_matmul_matches(js):
    rng = np.random.default_rng(2 + js)
    bound = 1 << 15
    d = rng.integers(-bound, bound + 1, (6, 300)).astype(np.int32)
    m = rng.integers(0, 2 ** 64, (300, 21), dtype=np.uint64)
    ref = np.asarray(jtorus.exact_matmul(
        jnp.asarray(d), jtorus.split_u64_signed(jnp.asarray(m))[js:], bound,
        max_k=300, m_j_start=js))
    planes = ttorus.split_u64_signed(t64(m))[js:]
    got = ttorus.exact_matmul(torch.from_numpy(d), planes, bound, max_k=300,
                              m_j_start=js)
    np.testing.assert_array_equal(u64(got), ref)
    with pytest.raises(ValueError):
        ttorus.exact_matmul(torch.from_numpy(d), planes, bound,
                            max_k=1 << 20, m_j_start=js)


@pytest.mark.parametrize("base_log,levels", [(12, 3), (3, 4), (16, 2), (32, 2)])
def test_decompose_matches(base_log, levels):
    x = np.random.default_rng(base_log).integers(0, 2 ** 64, (4, 50),
                                                 dtype=np.uint64)
    got = tdec.decompose(t64(x), base_log, levels).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jdec.decompose(x, base_log, levels)))


def test_lwe_ops_match():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2 ** 64, (3, 9), dtype=np.uint64)
    b = rng.integers(0, 2 ** 64, (3, 9), dtype=np.uint64)
    bits = np.array([0, 1, 1])
    np.testing.assert_array_equal(u64(tlwe.add(t64(a), t64(b))),
                                  np.asarray(jlwe.add(a, b)))
    np.testing.assert_array_equal(
        u64(tlwe.trivial_bits(torch.from_numpy(bits), 8)),
        np.asarray(jlwe.trivial_bits(bits, 8)))


def test_polynomial_rotations_match():
    rng = np.random.default_rng(4)
    n = 32
    p = rng.integers(0, 2 ** 64, (5, 2, n), dtype=np.uint64)
    t = rng.integers(0, 2 * n, (5, 2), dtype=np.int32)
    np.testing.assert_array_equal(
        u64(tpoly.monomial_mul(t64(p), torch.from_numpy(t))),
        np.asarray(jpoly.monomial_mul(p, t)))
    for s in (0, 1, n - 1, n, n + 3, 2 * n - 1):
        np.testing.assert_array_equal(
            u64(tpoly.monomial_mul_static(t64(p), s)),
            np.asarray(jpoly.monomial_mul_static(p, s)))


def test_nc_limb_product_matches_negacyclic_product():
    """The plain truth of K1-K3 equals the JAX package's negacirculant
    contraction (polymul_digits_shared) with all 8 planes."""
    rng = np.random.default_rng(5)
    n, r, o, b = 16, 3, 2, 4
    bound = 1 << 11
    digits = rng.integers(-bound, bound + 1, (b, r, n)).astype(np.int32)
    polys = rng.integers(0, 2 ** 64, (r, o, n), dtype=np.uint64)
    ref = np.asarray(jpoly.polymul_digits_shared(jnp.asarray(digits),
                                                 jnp.asarray(polys), bound))
    dig = ttorus.split_int32_signed(torch.from_numpy(digits), 2)
    ext = ttorus.split_u64_signed(tpoly.negacyclic_extend(t64(polys)))
    got = tpoly.nc_limb_product(dig[:, None], ext.permute(1, 2, 0, 3)[None],
                                0)[0]
    np.testing.assert_array_equal(u64(got), ref)


def test_keygen_byte_identical_without_native(monkeypatch):
    """With the JAX package's native ChaCha core forced off, both packages
    draw the same numpy streams: byte-identical keys at PARAMS_TEST."""
    def no_native(*args, **kwargs):
        raise RuntimeError("native core disabled for this test")

    monkeypatch.setattr(tfhe_aes2_tpu.native, "NativeRng", no_native)
    jc, jsks = jkeys.generate_keys(jparams.PARAMS_TEST, seed=11)
    tc, raw = tkeys.generate_keys_numpy(tparams.PARAMS_TEST, seed=11,
                                        device="cpu", native=False)
    np.testing.assert_array_equal(tc.lwe_sk, jc.lwe_sk)
    np.testing.assert_array_equal(tc.glwe_sk, jc.glwe_sk)
    for name in ("bsk", "ksk", "pfpksk", "pksk"):
        np.testing.assert_array_equal(raw[name], np.asarray(getattr(jsks,
                                                                    name)))
    # the client streams continue identically too
    np.testing.assert_array_equal(tc.encrypt_bits([1, 0, 1]),
                                  jc.encrypt_bits([1, 0, 1]))


def test_client_key_and_prepared_layouts(keys_test):
    client, sks = port_keys(keys_test)
    jc = keys_test[0]
    cts = jc.encrypt_bits(np.array([0, 1, 1, 0]))
    np.testing.assert_array_equal(client.decrypt_phase(cts),
                                  jc.decrypt_phase(cts))
    np.testing.assert_array_equal(client.decrypt_bits(cts), [0, 1, 1, 0])

    p = port_params(jc.params)
    for truncate in (False, True):
        prep = tkeys.prepare_server_keys(sks, p, truncate=truncate)
        js = (ttrunc.bsk_j_start(p), ttrunc.ksk_j_start(p),
              ttrunc.pfpksk_j_start(p), ttrunc.vp_ggsw_j_start(p)) \
            if truncate else (0, 0, 0, 0)
        assert 8 - prep.bsk.shape[3] == js[0]
        assert 8 - prep.ksk.shape[0] == js[1]
        assert 8 - prep.pfpksk.shape[0] == js[2]
        assert prep.vp_js == js[3]
        assert prep.bsk.dtype == torch.int8
    # the BSK planes recombine to the raw key's [p, -p] rows
    prep = tkeys.prepare_server_keys(sks, p, truncate=False)
    weights = torch.tensor([1 << (8 * i) for i in range(8)],
                           dtype=torch.int64)
    rec = (prep.bsk.to(torch.int64) * weights[:, None]).sum(dim=-2)
    raw = np.asarray(keys_test[1].bsk)                 # [n, L, u, o, N]
    rows = raw.transpose(0, 3, 2, 1, 4).reshape(
        raw.shape[0], raw.shape[3], -1, raw.shape[-1])  # [n, o, u·L, N]
    np.testing.assert_array_equal(u64(rec)[..., : raw.shape[-1]], rows)
