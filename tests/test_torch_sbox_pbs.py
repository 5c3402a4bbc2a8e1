"""The depth-11 AES pipeline (aes_128/sbox_pbs.py: the SBOX by circuit
bootstrap, the Galois multiplication leveled) and its strategy
ShortintWoppbs1BitSboxPbsAesEncrypt, against the JAX package on identical
keys and ciphertexts, bit for bit, metadata included."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tfhe_aes2_tpu.aes_128 import fhe as jfhe
from tfhe_aes2_tpu.aes_128 import fhe_encryption
from tfhe_aes2_tpu.aes_128 import sbox_pbs as jsp
from tfhe_aes2_tpu.models import shortint_woppbs_1bit as jm1

from tfhe_aes2_tpu_torch.aes_128 import fhe as tfhe, gf_256_mul, plain
from tfhe_aes2_tpu_torch.aes_128 import sbox_pbs as tsp
from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as tm1
from tfhe_aes2_tpu_torch.ops import params as tparams
from tests.torch_port_common import port_keys, t64, u64


@pytest.fixture(scope="module")
def contexts(keys_test):
    jclient, jsks = keys_test
    jctx = jm1.FheContext(params=jclient.params,
                          sks=jax.tree_util.tree_map(jnp.asarray, jsks))
    client, raw = port_keys(keys_test)
    return jclient, jctx, tm1.context_from_keys(client.params, raw, False)


def _state_pair(jclient, jctx, tctx, seed):
    """One AES state [16, 8] of fresh bit encryptions in both packages."""
    bits = np.random.default_rng(seed).integers(0, 2, (16, 8))
    cts = jclient.encrypt_bits(bits)
    return (jm1.fresh_bitct(jnp.asarray(cts), jctx, lane_ndim=2),
            tm1.fresh_bitct(t64(cts), tctx, lane_ndim=2), bits)


def _same(jct, tct):
    np.testing.assert_array_equal(u64(tct.array), np.asarray(jct.array))
    np.testing.assert_array_equal(tct.noise_sq, jct.noise_sq)
    np.testing.assert_array_equal(tct.degree, jct.degree)
    sizes = np.frompyfunc(len, 1, 1)
    np.testing.assert_array_equal(sizes(tct.comps), sizes(jct.comps))


@pytest.mark.parametrize("b", [1, 2, 3])
def test_gf_256_mul_matches_the_jax_package(contexts, b):
    """The leveled multiply by 1, 2 and 3 (shift, XOR, the 0x1b reduction
    folded into bit lanes 3, 4, 6, 7), and that it decrypts to the product
    in GF(256) of every byte."""
    jclient, jctx, tctx = contexts
    ja, ta, bits = _state_pair(jclient, jctx, tctx, 10 + b)
    jo, to = jsp.gf_256_mul(jctx, ja, b), tsp.gf_256_mul(tctx, ta, b)
    _same(jo, to)
    want = [gf_256_mul(int(x), b)
            for x in np.packbits(bits.astype(np.uint8), axis=-1)[:, 0]]
    got = np.packbits(jclient.decrypt_bits(u64(to.array)).astype(np.uint8),
                      axis=-1)[:, 0]
    assert list(got) == want


def test_mix_columns_matches_the_jax_package(contexts):
    """Leveled MixColumns on the same ciphertexts: arrays, noise, degree and
    component sets alike, decrypting to the clear MixColumns."""
    jclient, jctx, tctx = contexts
    ja, ta, bits = _state_pair(jclient, jctx, tctx, 20)
    to = tsp.mix_columns(tctx, ta)
    _same(jsp.mix_columns(jctx, ja), to)
    a = [int(x) for x in np.packbits(bits.astype(np.uint8), axis=-1)[:, 0]]
    want = [gf_256_mul(a[4 * c + r], 2) ^ gf_256_mul(a[4 * c + (r + 1) % 4], 3)
            ^ a[4 * c + (r + 2) % 4] ^ a[4 * c + (r + 3) % 4]
            for c in range(4) for r in range(4)]          # byte 4c + r
    got = np.packbits(jclient.decrypt_bits(u64(to.array)).astype(np.uint8),
                      axis=-1)[:, 0]
    assert list(got) == want


def test_light_two_rounds_match_the_jax_package(keys_test_n256):
    """The light AES run of the reference's pairing test (two rounds, the
    key schedule computed in the clear and encrypted) under
    ShortintWoppbs1BitSboxPbsAesEncrypt at PARAMS_TEST_N256 with the noise
    budget 256 that its XOR depth needs: the port's encrypt_blocks_eager
    bit-equal to the JAX package's and decrypting to the plain 2-round
    oracle."""
    jclient, jsks = keys_test_n256
    jp = dataclasses.replace(jclient.params, max_noise_level_squared=256)
    tp = dataclasses.replace(tparams.PARAMS_TEST_N256,
                             max_noise_level_squared=256)
    jctx = jm1.FheContext(params=jp,
                          sks=jax.tree_util.tree_map(jnp.asarray, jsks))
    _, raw = port_keys(keys_test_n256)
    tctx = tm1.context_from_keys(tp, raw, False)
    rng = np.random.default_rng(42)
    key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    blocks = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()]
    ks_ct = fhe_encryption.encrypt_word_array(jclient,
                                              plain.key_schedule(key))
    block_cts = fhe_encryption.encrypt_blocks(jclient, blocks)

    jstrat = jfhe.ShortintWoppbs1BitSboxPbsAesEncrypt
    tstrat = tfhe.ShortintWoppbs1BitSboxPbsAesEncrypt
    jeks = jm1.fresh_bitct(jnp.asarray(ks_ct), jctx, lane_ndim=3)
    teks = tm1.fresh_bitct(t64(ks_ct), tctx, lane_ndim=3)
    jout = jfhe.encrypt_blocks_eager(jstrat, jctx, jeks,
                                     jnp.asarray(block_cts), 2)
    tout = tfhe.encrypt_blocks_eager(tstrat, tctx, teks, t64(block_cts), 2)
    np.testing.assert_array_equal(u64(tout.array), np.asarray(jout.array))
    np.testing.assert_array_equal(tout.noise_sq, jout.noise_sq)
    assert (fhe_encryption.decrypt_blocks(jclient, u64(tout.array))
            == plain.expand_key_and_encrypt_blocks(key, blocks, 2))
