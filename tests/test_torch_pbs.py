"""Keyswitch, pfKS, blind rotation, circuit bootstrap and vertical packing
of the PyTorch port against the JAX package on identical keys and
ciphertexts (numpy-made), bit for bit.

truncate=False: every port contraction is exact mod 2^64, like the JAX
package's CPU path (raw u64 keys, matmul lowering).
truncate=True: the port drops the same limb planes as the JAX package's
prepared-key Pallas path (interpret mode), built the way
tests/test_keyswitch_pbs.py builds it, and vertical_packing(use_conv="pallas").
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tfhe_aes2_tpu.ops import blind_rotate as jbr
from tfhe_aes2_tpu.ops import circuit_bootstrap as jcbs
from tfhe_aes2_tpu.ops import keyswitch as jks

from tfhe_aes2_tpu_torch.ops import blind_rotate as tbr
from tfhe_aes2_tpu_torch.ops import circuit_bootstrap as tcbs
from tfhe_aes2_tpu_torch.ops import keys as tkeys
from tfhe_aes2_tpu_torch.ops import keyswitch as tks
from tests.torch_port_common import jax_server_keys, port_keys, t64, u64


VALS = np.array([0x3a, 0xc5])


@pytest.fixture(scope="module")
def setup(keys_test):
    client, raw = port_keys(keys_test)
    p = client.params
    prepared = {t: tkeys.prepare_server_keys(raw, p, truncate=t)
                for t in (False, True)}
    jax_sets = {t: jax_server_keys(keys_test, t) for t in (False, True)}
    bits = np.unpackbits(VALS.astype(np.uint8)[:, None], axis=-1)  # [2, 8]
    cts = keys_test[0].encrypt_bits(bits)            # [2, 8, kN+1] uint64
    return keys_test[0], p, prepared, jax_sets, bits, cts


@pytest.fixture(scope="module")
def ggsws(setup):
    """circuit_bootstrap_bits of both packages, per truncate setting."""
    jclient, p, prepared, jax_sets, _, cts = setup
    return {t: (tcbs.circuit_bootstrap_bits(t64(cts), prepared[t], p),
                jcbs.circuit_bootstrap_bits(jnp.asarray(cts), jax_sets[t],
                                            jclient.params))
            for t in (False, True)}


@pytest.mark.parametrize("truncate", [False, True])
def test_keyswitch_and_pfks_match(setup, truncate):
    jclient, p, prepared, jax_sets, _, cts = setup
    jp = jclient.params
    sks, jsks = prepared[truncate], jax_sets[truncate]
    dual = tks.keyswitch(t64(cts), sks.ksk, p)
    ref = np.asarray(jks.keyswitch(jnp.asarray(cts), jsks.ksk, jp))
    np.testing.assert_array_equal(u64(dual), ref)
    glwes = tks.pfks_all(t64(cts), sks.pfpksk, p)
    ref = np.asarray(jks.pfks_all(jnp.asarray(cts), jsks.pfpksk, jp))
    np.testing.assert_array_equal(u64(glwes), ref)


def test_mod_switch_and_sample_extract_match(setup):
    jp, p = setup[0].params, setup[1]
    rng = np.random.default_rng(9)
    x = rng.integers(0, 2 ** 64, (3, 40), dtype=np.uint64)
    np.testing.assert_array_equal(
        tbr.mod_switch(t64(x), p.log2_poly_size).numpy(),
        np.asarray(jbr.mod_switch(x, jp.log2_poly_size)))
    glwe = rng.integers(0, 2 ** 64, (3, p.glwe_dimension + 1,
                                     p.polynomial_size), dtype=np.uint64)
    np.testing.assert_array_equal(u64(tbr.sample_extract0(t64(glwe))),
                                  np.asarray(jbr.sample_extract0(glwe)))


@pytest.mark.parametrize("truncate", [False, True])
def test_pbs_and_circuit_bootstrap_match(setup, ggsws, truncate):
    """circuit_bootstrap_bits (keyswitch; the blind rotation with K2 once
    and K1 per step; pfKS) bit-equal, and the scaling PBS decrypts."""
    jclient, p, prepared, _, bits, cts = setup
    ggsw, ref = ggsws[truncate]
    np.testing.assert_array_equal(u64(ggsw), np.asarray(ref))
    dual = tks.keyswitch(t64(cts), prepared[truncate].ksk, p)
    lwe = tbr.pbs_bit_to_level(dual, prepared[truncate].bsk, p.cbs_base_log,
                               p)
    phase = jclient.decrypt_phase(u64(lwe))
    err = (phase - (bits.astype(np.uint64)
                    << np.uint64(64 - p.cbs_base_log))).astype(np.int64)
    assert np.abs(err).max() < 1 << (64 - p.cbs_base_log - 5)


@pytest.mark.parametrize("truncate", [False, True])
def test_vertical_packing_matches(setup, ggsws, truncate):
    """An 8->3-bit LUT (CMux tree + rotation stage at N=64) through the
    port's K3 path and the JAX package's."""
    jclient, p, prepared, _, _, _ = setup
    jp = jclient.params
    lut = jcbs.generate_lut(8, 3, lambda v: (v * 7) % 8, jp)
    np.testing.assert_array_equal(
        tcbs.generate_lut(8, 3, lambda v: (v * 7) % 8, p), lut)
    ggsw, jggsw = ggsws[truncate]
    out = tcbs.vertical_packing(ggsw, t64(lut), p, prepared[truncate].vp_js)
    ref = np.asarray(jcbs.vertical_packing(
        jggsw, jnp.asarray(lut), jp,
        use_conv="pallas" if truncate else "matmul"))
    np.testing.assert_array_equal(u64(out), ref)
    expect = [[(int(v) * 7 % 8 >> (2 - o)) & 1 for o in range(3)]
              for v in VALS]
    np.testing.assert_array_equal(jclient.decrypt_bits(u64(out)), expect)
