"""The port's 8-bit WoP-PBS model
(tfhe_aes2_tpu_torch/models/shortint_woppbs_8bit.py) against the JAX
package's, bit for bit (tolerance 0), at PARAMS_TEST_8BIT (N = 256) on the
CPU: the circuit bootstrap of small-key bits, the bit extraction (K4 + the
scaling PBS), the byte bootstrap through a LUT (K1/K2, K4, K3) followed by
the extraction, the linear noise tracking of LinearBitCt, and the strategy
ShortintWoppbs8BitSboxPbsAesEncrypt through one AES round on a clear key
schedule. Both packages run on the same keys (the JAX package's, carried
across with keys_from_numpy) and the same ciphertexts; the port keeps every
limb plane (truncate=False), as the JAX package's CPU arithmetic does."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tfhe_aes2_tpu.aes_128 import SBOX
from tfhe_aes2_tpu.aes_128 import fhe as jfhe
from tfhe_aes2_tpu.aes_128 import plain as jplain
from tfhe_aes2_tpu.models import shortint_woppbs_8bit as jm
from tfhe_aes2_tpu.ops import bit_extract as jbe
from tfhe_aes2_tpu.ops import circuit_bootstrap as jcbs
from tfhe_aes2_tpu.ops import keys as jkeys
from tfhe_aes2_tpu.ops.params import PARAMS_TEST_8BIT as P
from tfhe_aes2_tpu_torch.aes_128 import fhe as tfhe
from tfhe_aes2_tpu_torch.models import shortint_woppbs_8bit as tm
from tfhe_aes2_tpu.models.shortint_woppbs_1bit import NoiseError as JNoise
from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as tm1
from tfhe_aes2_tpu_torch.ops import bit_extract as tbe
from tfhe_aes2_tpu_torch.ops import circuit_bootstrap as tcbs
from tests.torch_port_common import port_keys, t64, u64


@pytest.fixture(scope="module")
def both():
    """(JAX client, JAX context, port client, port context) on one key set."""
    client, sks = jkeys.generate_keys(P, seed=13)
    jctx = jm.FheContext(P, jkeys.prepare_server_keys(
        jax.tree_util.tree_map(jnp.asarray, sks), P))
    tclient, tsks = port_keys((client, sks))
    tctx = tm.context_from_keys(tclient.params, tsks, truncate=False)
    return client, jctx, tclient, tctx


def _enc_bits(client, bits, seed):
    client.rng = np.random.default_rng(seed)
    return client.encrypt_bits_small(np.asarray(bits))


def _byte_bits(byts):
    return np.unpackbits(np.asarray(byts, np.uint8)[..., None], axis=-1)


def test_circuit_bootstrap_bits_small_matches_jax(both):
    """Two small-key bits -> GGSWs [2, L, k+1, k+1, N]: the scaling PBS of
    each level and the pfKS, with no keyswitch in front."""
    client, jctx, _, tctx = both
    ct = _enc_bits(client, [1, 0], 1)
    want = np.asarray(jcbs.circuit_bootstrap_bits_small(jnp.asarray(ct),
                                                        jctx.sks, P))
    got = u64(tcbs.circuit_bootstrap_bits_small(t64(ct), tctx.sks,
                                                tctx.params, tctx.lowering))
    assert got.shape == (2, P.cbs_level, 2, 2, P.polynomial_size)
    assert np.array_equal(got, want)


def test_extract_bits_matches_jax(both):
    """A full-width ciphertext of each of two bytes at 2^56 -> 8 small-key
    bits each, MSB first: 8 keyswitches and 7 scaling PBS."""
    client, jctx, tclient, tctx = both
    byts = np.array([0b10110101, 0x3C], np.uint64)
    client.rng = np.random.default_rng(2)
    ct = client.encrypt_encodings_big(byts << np.uint64(56))
    want = np.asarray(jbe.extract_bits(jnp.asarray(ct), jctx.sks, P, 56, 8))
    got = u64(tbe.extract_bits(t64(ct), tctx.sks, tctx.params, 56, 8,
                               tctx.lowering))
    assert got.shape == (2, 8, P.lwe_dimension + 1)
    assert np.array_equal(got, want)
    dec = np.packbits(tclient.decrypt_bits_small(got).astype(np.uint8),
                      axis=-1)[:, 0]
    assert list(dec) == [int(x) for x in byts]


@pytest.fixture(scope="module")
def sbox_two_bytes(both):
    """Two encrypted bytes and the JAX package's bootstrap_from_bits through
    the SBOX LUT and extraction of them."""
    client, jctx, _, _ = both
    byts = np.array([0x53, 0xA7], np.uint8)
    ct = _enc_bits(client, _byte_bits(byts), 3)
    lut = jctx.generate_lookup_table(lambda v: int(SBOX[v]))
    fw = jctx.bootstrap_from_bits(jm.fresh_linear_bitct(jnp.asarray(ct),
                                                        jctx), lut)
    out = jctx.extract_bits_from_ciphertext(fw)
    return byts, ct, lut, np.asarray(fw.array), np.asarray(out.array)


def test_bootstrap_from_bits_and_extract_match_jax(both, sbox_two_bytes):
    """The AES byte op on 2 bytes: the byte's circuit bootstrap and its
    vertical-packing lookup (K3) into a FullWidthCt, then the 8 bits back;
    bit-equal at both steps, and the bits decrypt to SBOX[x]."""
    _, _, tclient, tctx = both
    byts, ct, lut, want_fw, want = sbox_two_bytes
    assert np.array_equal(
        tctx.generate_lookup_table(lambda v: int(SBOX[v])), lut)
    fw = tctx.bootstrap_from_bits(tm.fresh_linear_bitct(t64(ct), tctx), lut)
    assert np.array_equal(u64(fw.array), want_fw)
    out = tctx.extract_bits_from_ciphertext(fw)
    assert out.lane_shape == (2, 8)
    assert (out.noise_sq == 1).all()
    assert np.array_equal(u64(out.array), want)
    dec = np.packbits(tclient.decrypt_bits_small(u64(out.array))
                      .astype(np.uint8), axis=-1)[:, 0]
    assert list(dec) == [int(SBOX[x]) for x in byts]


@pytest.mark.parametrize("xors", [10, 11])
def test_linear_xor_noise_matches_jax(both, xors):
    """LinearBitCt's XOR adds noise levels linearly: a chain of `xors` XORs
    of fresh bits reaches noise xors + 1, which passes up to the budget of
    11 and raises NoiseError above it, in both packages; below it the
    ciphertexts are bit-equal and decrypt to the XOR of the bits."""
    client, jctx, tclient, tctx = both
    bits = np.random.default_rng(40 + xors).integers(0, 2, (xors + 1, 8))
    ct = _enc_bits(client, bits, 41)
    jacc = jm.fresh_linear_bitct(jnp.asarray(ct[0]), jctx)
    tacc = tm.fresh_linear_bitct(t64(ct[0]), tctx)
    for i in range(1, xors + 1):
        if i == 11:
            with pytest.raises(JNoise, match="NoiseTooBig"):
                jacc ^ jm.fresh_linear_bitct(jnp.asarray(ct[i]), jctx)
            with pytest.raises(tm1.NoiseError, match="NoiseTooBig"):
                tacc ^ tm.fresh_linear_bitct(t64(ct[i]), tctx)
            return
        jacc = jacc ^ jm.fresh_linear_bitct(jnp.asarray(ct[i]), jctx)
        tacc = tacc ^ tm.fresh_linear_bitct(t64(ct[i]), tctx)
        assert isinstance(tacc, tm.LinearBitCt)
        assert np.array_equal(tacc.noise_sq, jacc.noise_sq)
    assert (tacc.noise_sq == xors + 1).all()
    assert np.array_equal(u64(tacc.array), np.asarray(jacc.array))
    assert np.array_equal(tclient.decrypt_bits_small(u64(tacc.array)),
                          np.bitwise_xor.reduce(bits, axis=0))
    # a trivial bit adds no noise, and the lane type survives the pipeline's
    # lane ops
    triv = tctx.trivial_bits(np.zeros(8, np.uint8))
    assert (triv.noise_sq == 0).all()
    moved = (tacc ^ triv).take_lanes(np.arange(7, -1, -1), axis=0)
    assert isinstance(moved, tm.LinearBitCt)
    assert isinstance(tm.LinearBitCt.concat_lanes(
        [moved.slice_lanes(slice(0, 4)), moved.reshape_lanes(2, 4)
         .slice_lanes(slice(1, 2)).reshape_lanes(4)]), tm.LinearBitCt)


def test_strategy_one_round_matches_jax(both):
    """ShortintWoppbs8BitSboxPbsAesEncrypt through one AES round (AddRoundKey,
    then the final round: SubBytes of 16 bytes, ShiftRows, AddRoundKey) on
    an encrypted clear key schedule: the same encryptions as the JAX
    strategy's from the same random stream, bit-equal outputs, and the
    1-round plain oracle's block."""
    client, jctx, tclient, tctx = both
    js = jfhe.ShortintWoppbs8BitSboxPbsAesEncrypt
    ts = tfhe.ShortintWoppbs8BitSboxPbsAesEncrypt
    rng = np.random.default_rng(21)
    key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    blocks = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()]
    client.rng = np.random.default_rng(22)
    tclient.rng = np.random.default_rng(22)
    blk = ts.encrypt_client(tclient, blocks)
    assert np.array_equal(blk, js.encrypt_client(client, blocks))
    ks_ct = _enc_bits(client, _byte_bits(np.frombuffer(
        b"".join(jplain.key_schedule(key)), np.uint8).reshape(44, 4)), 23)
    want = jfhe.encrypt_blocks_eager(
        js, jctx, js.fresh(jnp.asarray(ks_ct), jctx), jnp.asarray(blk), 1)
    got = tfhe.encrypt_blocks_eager(ts, tctx, ts.fresh(t64(ks_ct), tctx),
                                    t64(blk), 1)
    assert isinstance(got, tm.LinearBitCt) and got.lane_shape == (1, 16, 8)
    assert np.array_equal(u64(got.array), np.asarray(want.array))
    assert ts.decrypt_client(tclient, u64(got.array)) \
        == jplain.expand_key_and_encrypt_blocks(key, blocks, 1)
