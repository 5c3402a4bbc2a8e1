"""The port's tree-PBS model (tfhe_aes2_tpu_torch/models/shortint_1bit.py)
against the JAX package's, bit for bit (tolerance 0), at PARAMS_TEST_S1 on
the CPU: the packing keyswitch (K4), the tree's selection product (K3, whose
plain version stands in for the JAX package's materialised negacirculant),
the bootstrap with a clear and with an encrypted test vector (K2 + K1 and
K4), a 3-bit tree, the SBOX of 2 bytes and the strategy's client codecs.
Both packages run on the same keys (the JAX package's, carried across with
keys_from_numpy) and the same ciphertexts; the port keeps every limb plane
(truncate=False), as the JAX package's CPU arithmetic does."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tfhe_aes2_tpu.aes_128 import SBOX
from tfhe_aes2_tpu.aes_128 import fhe as jfhe
from tfhe_aes2_tpu.models import shortint_1bit as jm
from tfhe_aes2_tpu.ops import keys as jkeys
from tfhe_aes2_tpu.ops import packing_keyswitch as jpks
from tfhe_aes2_tpu.ops import polynomial as jpoly
from tfhe_aes2_tpu_torch.aes_128 import fhe as tfhe
from tfhe_aes2_tpu_torch.models import shortint_1bit as tm
from tfhe_aes2_tpu_torch.ops import packing_keyswitch as tpks
from tfhe_aes2_tpu_torch.ops import polynomial as tpoly
from tests.torch_port_common import port_keys, t64, u64

P = jm.PARAMS_TEST_S1


@pytest.fixture(scope="module")
def both():
    """(JAX client, JAX context, port client, port context) on one key set."""
    client, sks = jkeys.generate_keys(P, seed=17)
    jctx = jm.FheContext(params=P, sks=jkeys.prepare_server_keys(
        jax.tree_util.tree_map(jnp.asarray, sks), P))
    tclient, tsks = port_keys((client, sks))
    tctx = tm.context_from_keys(tclient.params, tsks, truncate=False)
    return client, jctx, tclient, tctx


def _enc(client, bits, seed):
    """Small-key encryptions of bits at 2^62, from a numpy seed."""
    client.rng = np.random.default_rng(seed)
    return client.encrypt_encodings_small(
        np.asarray(bits, np.uint64) << np.uint64(62))


def _dec(client, arr):
    phase = client.decrypt_phase_small(np.asarray(arr))
    return ((phase + np.uint64(1 << 61)) >> np.uint64(62)) & np.uint64(1)


def test_the_port_copies_the_parameter_sets():
    assert tm.PARAMS_TEST_S1.__dict__ == jm.PARAMS_TEST_S1.__dict__
    assert tm.PARAMS_SHORTINT_1BIT.__dict__ == jm.PARAMS_SHORTINT_1BIT.__dict__


def test_pack_lwe_matches_jax(both):
    """pack_lwe (K4 over the prepared pksk's 8 planes), pack_lwe_list and
    the context's packing_keyswitch on a [2, 3] batch of ciphertexts."""
    client, jctx, _, tctx = both
    ct = _enc(client, np.random.default_rng(1).integers(0, 2, (2, 3)), 2)
    want = np.asarray(jpks.pack_lwe(jnp.asarray(ct), jctx.sks.pksk, P))
    got = u64(tpks.pack_lwe(t64(ct), tctx.sks.pksk, tctx.params))
    assert got.shape == (2, 3, P.glwe_dimension + 1, P.polynomial_size)
    assert np.array_equal(got, want)
    want = np.asarray(jpks.pack_lwe_list(jnp.asarray(ct), jctx.sks.pksk, P))
    got = u64(tpks.pack_lwe_list(t64(ct), tctx.sks.pksk, tctx.params))
    assert np.array_equal(got, want)
    got = u64(tctx.packing_keyswitch(tm.Bit1Ct(t64(ct), tctx)))
    assert np.array_equal(got, np.asarray(jctx.packing_keyswitch(
        jm.Bit1Ct(jnp.asarray(ct), jctx))))


@pytest.mark.parametrize("lanes_a_launch", [None, 2])
@pytest.mark.parametrize("digits", ["masks", "random int8"])
def test_polymul_shared_digits_matches_polymul_digits_grouped(
        digits, lanes_a_launch, monkeypatch):
    """K3's route (its plain version here) equals the JAX package's
    materialised-negacirculant product Σ_r d[r] ⊛ p[b, r] for the tree's
    0/1 masks and for any int8 digits, on random u64 polynomials: in one
    launch, and in launches of 2 lanes (the last one lane)."""
    rng = np.random.default_rng(7 if digits == "masks" else 8)
    b, r, o, n = 5, 2, 2, 128
    if digits == "masks":
        d = tm.selection_masks(n, "cpu").numpy()
    else:
        d = rng.integers(-128, 128, (r, n), dtype=np.int8)
    polys = rng.integers(0, 2 ** 64, (b, r, o, n), dtype=np.uint64)
    want = sum(np.asarray(jpoly.polymul_digits_grouped(
        jnp.broadcast_to(jnp.asarray(d[i].astype(np.int32)), (b, 1, n)),
        jnp.asarray(polys[:, i:i + 1]), 128)) for i in range(r))
    if lanes_a_launch:
        monkeypatch.setattr(tpoly, "_K3_LANES", lanes_a_launch)
    got = u64(tpoly.polymul_shared_digits(torch.from_numpy(d), t64(polys)))
    assert np.array_equal(got, want)


def test_tv_from_ct_arrays_matches_jax(both):
    """The encrypted test vector of a [2, 4] batch of pairs: two packing
    keyswitches and one selection product."""
    client, jctx, _, tctx = both
    bits = np.random.default_rng(3).integers(0, 2, (2, 2, 4))
    ct0, ct1 = _enc(client, bits[0], 4), _enc(client, bits[1], 5)
    want = np.asarray(jm._tv_from_ct_arrays(jnp.asarray(ct0),
                                            jnp.asarray(ct1),
                                            jctx.sks.pksk, P))
    got = u64(tm._tv_from_ct_arrays(t64(ct0), t64(ct1), tctx.sks.pksk,
                                    tctx.params))
    assert np.array_equal(got, want)
    got = u64(tctx.test_vector_from_ciphertexts(tm.Bit1Ct(t64(ct0), tctx),
                                                tm.Bit1Ct(t64(ct1), tctx)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("tv", ["clear", "encrypted"])
def test_bootstrap_matches_jax(both, tv):
    """bootstrap on 4 ciphertexts with the clear NOT test vector, and with
    per-lane encrypted test vectors selecting between two encrypted bits;
    the result decrypts to what the test vector selects."""
    client, jctx, tclient, tctx = both
    bits = np.array([0, 1, 1, 0])
    ct = _enc(client, bits, 6)
    if tv == "clear":
        jtv = jctx.test_vector_from_cleartext_fn(lambda b: 1 - b)
        ttv = tctx.test_vector_from_cleartext_fn(lambda b: 1 - b)
        assert np.array_equal(u64(ttv), np.asarray(jtv))
        expect = 1 - bits
    else:
        sel = np.array([[1, 1, 0, 0], [0, 1, 0, 1]])
        c0, c1 = _enc(client, sel[0], 7), _enc(client, sel[1], 8)
        jtv = jctx.test_vector_from_ciphertexts(
            jm.Bit1Ct(jnp.asarray(c0), jctx), jm.Bit1Ct(jnp.asarray(c1), jctx))
        ttv = tctx.test_vector_from_ciphertexts(
            tm.Bit1Ct(t64(c0), tctx), tm.Bit1Ct(t64(c1), tctx))
        expect = np.where(bits == 0, sel[0], sel[1])
    want = np.asarray(jctx.bootstrap(jm.Bit1Ct(jnp.asarray(ct), jctx),
                                     jtv).array)
    got = u64(tctx.bootstrap(tm.Bit1Ct(t64(ct), tctx), ttv).array)
    assert np.array_equal(got, want)
    assert np.array_equal(_dec(tclient, got), expect)


@pytest.mark.parametrize("word", [0b101, 0b010, 0b111])
def test_calculate_multivariate_function_matches_jax(both, word):
    """A 3-bit tree (two levels of bootstrap + packing + selection, then the
    leaf bootstrap), bit-equal and decrypting to f(word)."""
    client, jctx, tclient, tctx = both
    f = lambda v: (v * 3 + 1 + (v >> 2)) % 2
    ct = _enc(client, [(word >> (2 - i)) & 1 for i in range(3)], 10 + word)
    want = np.asarray(jm.calculate_multivariate_function(
        jctx, jm.Bit1Ct(jnp.asarray(ct), jctx),
        jm.generate_multivariate_test_vector(jctx, 3, f)).array)
    tvs = tm.generate_multivariate_test_vector(tctx, 3, f)
    got = u64(tm.calculate_multivariate_function(
        tctx, tm.Bit1Ct(t64(ct), tctx), tvs).array)
    assert np.array_equal(got, want)
    assert int(_dec(tclient, got)) == f(word)


@pytest.fixture(scope="module")
def sbox_two_bytes(both):
    """Two encrypted bytes [2, 8] and the JAX package's SBOX of them."""
    client, jctx, _, _ = both
    byts = np.array([0xC5, 0x3A], np.uint8)
    ct = _enc(client, np.unpackbits(byts[:, None], axis=-1), 20)
    state = jm.fresh_lane_bit1ct(jnp.asarray(ct), jctx, lane_ndim=2)
    want = np.asarray(jm.Shortint1BitByteOps(jctx).sub_bytes(state).array)
    return byts, ct, want


def test_sub_bytes_on_two_bytes_matches_jax(both, sbox_two_bytes):
    """Shortint1BitByteOps.sub_bytes: 2 bytes x 8 output bits x 255
    bootstraps, every tree level one batch; bit-equal, and the bytes
    decrypt to SBOX[x]."""
    _, _, tclient, tctx = both
    byts, ct, want = sbox_two_bytes
    state = tm.fresh_lane_bit1ct(t64(ct), tctx, lane_ndim=2)
    out = tm.Shortint1BitByteOps(tctx).sub_bytes(state)
    assert out.lane_shape == (2, 8)
    got = u64(out.array)
    assert np.array_equal(got, want)
    dec = np.packbits(_dec(tclient, got).astype(np.uint8), axis=-1)[:, 0]
    assert list(dec) == [int(SBOX[x]) for x in byts]


def test_boot_matches_jax(both):
    """Shortint1BitByteOps.boot, the identity bootstrap of a word [4, 8]."""
    client, jctx, tclient, tctx = both
    bits = np.random.default_rng(30).integers(0, 2, (4, 8))
    ct = _enc(client, bits, 31)
    want = np.asarray(jm.Shortint1BitByteOps(jctx).boot(
        jm.fresh_lane_bit1ct(jnp.asarray(ct), jctx)).array)
    out = tm.Shortint1BitByteOps(tctx).boot(tm.fresh_lane_bit1ct(t64(ct),
                                                                 tctx))
    assert out.lane_shape == (4, 8)
    assert np.array_equal(u64(out.array), want)
    assert np.array_equal(_dec(tclient, u64(out.array)), bits)


def test_strategy_codecs_match_jax(both):
    """Shortint1BitSboxPbsAesEncrypt's client codecs: the same encryptions
    as the JAX strategy's from the same random stream, and each package's
    decryption of them gives the bytes back."""
    client, _, tclient, _ = both
    js = jfhe.Shortint1BitSboxPbsAesEncrypt
    ts = tfhe.Shortint1BitSboxPbsAesEncrypt
    key = bytes(range(16))
    blocks = [bytes(range(16, 32)), bytes(range(100, 116))]
    for jf, tf, data in ((js.encrypt_key_client, ts.encrypt_key_client, key),
                         (js.encrypt_client, ts.encrypt_client, blocks)):
        client.rng = np.random.default_rng(40)
        tclient.rng = np.random.default_rng(40)
        want, got = jf(client, data), tf(tclient, data)
        assert got.shape[-2:] == (8, P.lwe_dimension + 1)
        assert np.array_equal(got, want)
    assert ts.decrypt_client(tclient, got) == blocks
    assert js.decrypt_client(client, got) == blocks
    assert b"".join(ts.decrypt_client(
        tclient, ts.encrypt_key_client(tclient, key))) == key
