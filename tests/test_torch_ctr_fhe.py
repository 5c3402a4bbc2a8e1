"""The port's homomorphic CTR counter (aes_128/ctr_fhe.py) against the JAX
package's on the same keys and the same ciphertext at PARAMS_TEST_N256:
derived blocks and their metadata bit-equal (exact integer arithmetic on
both sides, tolerance 0), the byte-boundary and u64-wrap cases of
tests/test_ctr_fhe.py; then at PARAMS_TEST the rounds on a derived batch
under every new blind-rotation schedule, and `--fhe-counter` through the
port's CLI."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tfhe_aes2_tpu.aes_128 import ctr_fhe as jctr
from tfhe_aes2_tpu.models import shortint_woppbs_1bit as jm1

from tfhe_aes2_tpu_torch import cli
from tfhe_aes2_tpu_torch.aes_128 import ctr_fhe as tctr
from tfhe_aes2_tpu_torch.aes_128 import fhe as tfhe, fhe_encryption, plain
from tfhe_aes2_tpu_torch.aes_128 import scenario
from tfhe_aes2_tpu_torch.models.shortint_woppbs_1bit import fresh_bitct
from tfhe_aes2_tpu_torch.ops.lowering import Lowering
from tests.torch_port_common import port_context, private_keys, t64, u64

KEY = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
IV = bytes.fromhex("bdd219b8a08ded1a")


def _block(counter: int, iv: bytes = IV) -> bytes:
    return iv + counter.to_bytes(8, "big")


@pytest.fixture(scope="module")
def setup(keys_test_n256):
    """Both packages' contexts over the same raw keys, all limb planes kept
    (the JAX package's CPU arithmetic)."""
    jclient, jsks = private_keys(keys_test_n256)
    jctx = jm1.FheContext(params=jclient.params,
                          sks=jax.tree_util.tree_map(jnp.asarray, jsks))
    client, tctx = port_context(keys_test_n256, truncate=False)
    return jclient, jctx, client, tctx


def test_increment_lut_and_nine_lane_bootstrap_match_jax(setup):
    """The 9 -> 9 LUT and a circuit bootstrap at the counter's shape (9
    input lanes, 9 output bits): the main path only ever ran 8 -> 8 and
    8 -> 24."""
    jclient, jctx, _, tctx = setup
    lut = tctr.increment_lut(tctx)
    np.testing.assert_array_equal(lut, np.asarray(jctr.increment_lut(jctx)))
    assert lut.shape == (9, 2, 256)
    bits = np.array([1] + [int(b) for b in f"{0xff:08b}"], np.uint8)
    cts = jclient.encrypt_bits(bits)                        # [9, kN+1]
    jout = jctx.circuit_bootstrap(jm1.fresh_bitct(jnp.asarray(cts), jctx),
                                  jnp.asarray(lut))
    tout = tctx.circuit_bootstrap(fresh_bitct(t64(cts), tctx), lut)
    np.testing.assert_array_equal(u64(tout.array), np.asarray(jout.array))
    np.testing.assert_array_equal(tout.noise_sq, jout.noise_sq)
    np.testing.assert_array_equal(jclient.decrypt_bits(u64(tout.array)),
                                  [1] + [0] * 8)            # 0xff + 1


def test_derive_ctr_blocks_bit_equal_to_jax_across_a_byte_boundary(setup):
    """Counter 255 -> 256 -> 257: the carry crosses a byte; the IV half
    passes through untouched; ciphertexts equal the JAX package's."""
    jclient, jctx, client, tctx = setup
    block0_ct = fhe_encryption.encrypt_blocks(jclient, [_block(255)])[0]
    ref = np.asarray(jctr.derive_ctr_blocks(jctx, jnp.asarray(block0_ct), 3))
    got = u64(tctr.derive_ctr_blocks(tctx, t64(block0_ct), 3))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[1, :8], block0_ct[:8])
    assert (fhe_encryption.decrypt_blocks(client, got)
            == [_block(c) for c in (255, 256, 257)])


def test_derive_ctr_blocks_staged_wraps_like_u64(setup):
    """The carry out of the top counter byte is dropped; the staged name is
    the same loop here."""
    jclient, _, client, tctx = setup
    assert tctr.derive_ctr_blocks_staged is tctr.derive_ctr_blocks
    block0 = _block((1 << 64) - 1, bytes(8))
    block0_ct = fhe_encryption.encrypt_blocks(jclient, [block0])[0]
    got = u64(tctr.derive_ctr_blocks_staged(tctx, t64(block0_ct), 2))
    assert (fhe_encryption.decrypt_blocks(client, got)
            == [block0, bytes(16)])


def test_derived_blocks_meta_equals_jax(setup):
    jclient, jctx, _, tctx = setup
    block0_ct = fhe_encryption.encrypt_blocks(jclient, [_block(1)])[0]
    for count in (1, 2):
        jnoise, jcomps = jctr.derived_blocks_meta(jctx,
                                                  jnp.asarray(block0_ct),
                                                  count)
        noise, comps = tctr.derived_blocks_meta(tctx, t64(block0_ct), count)
        np.testing.assert_array_equal(noise, jnoise)
        assert comps.shape == jcomps.shape == (16, 8)
        ids = [next(iter(s)) for s in comps.reshape(-1)]
        assert all(len(s) == 1 for s in comps.reshape(-1))
        assert len(set(ids)) == 128          # one fresh id per lane
    batch = tctr.derive_ctr_batch(tctx, t64(block0_ct), 2)
    np.testing.assert_array_equal(batch.noise_sq, noise)
    assert batch.array.shape[:3] == (2, 16, 8)


STRAT = tfhe.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt


def _serve_derived(keys, br):
    """One fhe_counter request of 2 blocks at 2 rounds under schedule `br`
    (truncated keys, the production setting) -> (client, ctx, out, timings).
    Each call's client draws from a new generator of one seed, so every
    call encrypts the same request."""
    client, ctx = port_context(keys, truncate=True, lowering=Lowering(br))
    key_ct, block_cts = scenario.encrypt_request(
        client, ctx, STRAT, KEY, scenario.ctr_blocks(IV, 1))
    out, timings = scenario.serve_request(ctx, STRAT, key_ct, block_cts,
                                          rounds=2, fhe_counter_count=2)
    return client, ctx, out, timings


@pytest.fixture(scope="module")
def derived_default(keys_test):
    return _serve_derived(keys_test, "gridg")


def test_rounds_on_a_derived_batch_decrypt_to_the_oracle(derived_default):
    client, ctx, out, timings = derived_default
    assert set(timings) == {"key_expansion_s", "ctr_derive_s", "blocks_s",
                            "blocks_per_s"}
    assert out.array.shape[:3] == (2, 16, 8)
    assert (scenario.read_response(client, ctx, STRAT, out)
            == plain.expand_key_and_encrypt_blocks(
                KEY, scenario.ctr_blocks(IV, 2), 2))


@pytest.mark.parametrize("br", ["merged", "longk", "bucket"])
def test_derived_batch_ciphertexts_equal_under_each_schedule(
        keys_test, derived_default, br):
    """The server-derived request gives the default schedule's ciphertexts
    bit for bit under K9, K10a + K10b and K2 + K11."""
    _, _, out, _ = _serve_derived(keys_test, br)
    np.testing.assert_array_equal(u64(out.array),
                                  u64(derived_default[2].array))


def test_fhe_counter_single_block_skips_the_latency_path(keys_test):
    """With fhe_counter one block at 10 rounds does not take the fused
    latency path (its timings name the expansion and the derivation)."""
    client, ctx = port_context(keys_test, truncate=True)
    key_ct, block_cts = scenario.encrypt_request(
        client, ctx, STRAT, KEY, scenario.ctr_blocks(IV, 1))
    _, timings = scenario.serve_request(ctx, STRAT, key_ct, block_cts,
                                        rounds=1, fhe_counter_count=1)
    assert "ctr_derive_s" in timings and "fused_latency_s" not in timings


def test_cli_fhe_counter_scenario(capsys):
    """The user-facing path: the port's CLI with --fhe-counter through the
    full scenario (FHE key schedule + server-derived keystream + compressed
    response), verified against the plain oracle."""
    rc = cli.main(["--key", "76b8e0ada0f13d90405d6ae55386bd28",
                   "--iv", "bdd219b8a08ded1a", "--number-of-outputs", "2",
                   "--params", "test", "--rounds", "2", "--fhe-counter",
                   "--compress-output", "16"], device="cpu")
    assert rc == 0
    text = capsys.readouterr().out
    assert "derived homomorphically" in text
    assert "ok: FHE keystream verified" in text
