"""The reference's wire decode against a toy LWE it encrypts itself, and
its secret key against the one the port's keygen draws from the seed."""

import numpy as np
import pytest

from benchmark.reference import check, secret_key, wire


def toy_encrypt(rng, sk, bits, log2q, noise):
    """Small-key LWE of `bits` at q'/2 mod q' = 2^log2q, with uniform noise
    in [-noise, noise]."""
    q = 1 << log2q
    a = rng.integers(0, q, size=bits.shape + sk.shape, dtype=np.int64)
    e = rng.integers(-noise, noise + 1, size=bits.shape)
    b = (a @ sk + bits.astype(np.int64) * (q // 2) + e) % q
    return np.concatenate([a, b[..., None]], axis=-1).astype("<u2")


def test_decode_and_phase_error():
    rng = np.random.default_rng(7)
    sk = secret_key.small_lwe_key(3, 677)
    bits = rng.integers(0, 2, size=(4, 16, 8)).astype(np.uint8)
    words = toy_encrypt(rng, sk, bits, 16, 1000)
    assert (wire.decode(words, sk, 16) == bits).all()
    err = wire.phase_error(words, sk, 16, bits)
    assert err.max() <= 1000 / 2 ** 14 and err.max() > 0
    # against the other bit: every error is past the decode's threshold
    assert (wire.phase_error(words, sk, 16, 1 - bits) > 1).all()


def test_compare_counts_wrong_bits_and_failed_requests():
    rng = np.random.default_rng(8)
    sk = secret_key.small_lwe_key(4, 40)
    key = bytes(range(16))
    blocks = [bytes(16), bytes([1] * 16)]
    want = check.keystream_bits(key, blocks)
    good = toy_encrypt(rng, sk, want, 16, 100)
    bad = good.copy()
    bad[1, 3, 2, -1] ^= 1 << 15                       # one bit flipped
    got = check.compare([(key, blocks, good), (key, blocks, bad)], sk, 16)
    assert (got["wrong_bits"], got["failed_requests"], got["answers"]) == \
        (1, 1, 2)
    assert 1 < got["phase_err_max"] <= 2


@pytest.mark.parametrize("seed", [0, 11, 2 ** 31 + 5])
def test_secret_key_is_the_keygens(seed):
    from tfhe_aes2_tpu_torch.ops import keys, params
    p = params.PARAMS_TEST
    client, _ = keys.generate_keys_numpy(p, seed=seed, device="cpu",
                                         native=False)
    assert (secret_key.small_lwe_key(seed, p.lwe_dimension)
            == client.lwe_sk.astype(np.int64)).all()


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 9])
def test_secret_key_is_the_8bit_keygens(seed):
    """The 8-bit model's keys come from the same keygen order."""
    from tfhe_aes2_tpu_torch.ops import keys, params
    p = params.PARAMS_TEST_8BIT
    client, _ = keys.generate_keys_numpy(p, seed=seed, device="cpu",
                                         native=False)
    assert (secret_key.small_lwe_key(seed, p.lwe_dimension)
            == client.lwe_sk.astype(np.int64)).all()
