"""The port's binding of the native C++ client core (tfhe_aes2_tpu_torch/
native.py) against the JAX package's (tfhe_aes2_tpu/native.py), and the
evaluation-key stream of the port's keygen (ops/keys.py, _KeygenRng)
against the JAX package's: byte-identical keys from one seed with the
native ChaCha20 core, and with the numpy stream.

Both bindings build native/ with cmake + ninja, each into its own
directory; where that build fails here, the cases that need it skip (as
tests/test_native.py does), decided inside a fixture. Exact integer
arithmetic: array equality everywhere."""

import logging
from pathlib import Path

import numpy as np
import pytest

import tfhe_aes2_tpu.native as jnative
from tfhe_aes2_tpu.ops import keys as jkeys
from tfhe_aes2_tpu.ops import params as jparams

from tfhe_aes2_tpu_torch import native as tnative
from tfhe_aes2_tpu_torch.ops import keys as tkeys
from tfhe_aes2_tpu_torch.ops import params as tparams

KEY_NAMES = ("bsk", "ksk", "pfpksk", "pksk")
STD = 2.0 ** -20


@pytest.fixture(scope="module")
def both_native():
    """Both packages' libraries, or a skip naming the failed build."""
    try:
        return jnative.lib(), tnative.lib()
    except Exception as ex:  # noqa: BLE001 — any build failure skips
        pytest.skip(f"native build failed here: {type(ex).__name__}: {ex}")


def _no_jax_native(monkeypatch):
    def no_native(*args, **kwargs):
        raise RuntimeError("native core disabled for this test")
    monkeypatch.setattr(jnative, "NativeRng", no_native)


def _broken_build(monkeypatch, tmp_path):
    """The port's core as it is where its build fails: no library loaded,
    the sources looked for where there are none."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "SOURCE_DIR", tmp_path / "no-native")


@pytest.mark.parametrize("fill", ["uniform_u64", "uniform_u64_par",
                                  "gaussian_u64", "gaussian_u64_par"])
def test_rng_fills_match_jax(both_native, fill):
    args = (1000,) if fill.startswith("uniform") else (1000, STD)
    for seed in (0, 11, 2 ** 40 + 3):
        want = getattr(jnative.NativeRng(seed), fill)(*args)
        got = getattr(tnative.NativeRng(seed), fill)(*args)
        np.testing.assert_array_equal(got, want)


def test_lwe_encrypt_and_decrypt_match_jax(both_native):
    rng = np.random.default_rng(3)
    sk = rng.integers(0, 2, 64, dtype=np.uint64)
    msgs = rng.integers(0, 2, 9, dtype=np.uint64) << np.uint64(63)
    want = jnative.NativeRng(5).lwe_encrypt(sk, msgs, STD)
    got = tnative.NativeRng(5).lwe_encrypt(sk, msgs, STD)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tnative.lwe_decrypt_phase(sk, got),
                                  jnative.lwe_decrypt_phase(sk, want))


@pytest.mark.parametrize("base_log,levels", [(12, 3), (15, 2), (3, 4)])
def test_decompose_matches_jax(both_native, base_log, levels):
    xs = np.random.default_rng(32).integers(0, 1 << 64, 64, dtype=np.uint64)
    np.testing.assert_array_equal(tnative.decompose(xs, base_log, levels),
                                  jnative.decompose(xs, base_log, levels))


def test_negacyclic_mul_matches_jax(both_native):
    rng = np.random.default_rng(31)
    a = rng.integers(0, 1 << 10, 64, dtype=np.uint64)
    b = rng.integers(0, 1 << 64, 64, dtype=np.uint64)
    np.testing.assert_array_equal(tnative.negacyclic_mul(a, b),
                                  jnative.negacyclic_mul(a, b))


def test_keys_byte_identical_with_native(both_native):
    """Native on in both packages (their default where it builds): the
    same seed gives the same secret keys, evaluation keys and client
    stream."""
    jc, jsks = jkeys.generate_keys(jparams.PARAMS_TEST, seed=11)
    tc, raw = tkeys.generate_keys_numpy(tparams.PARAMS_TEST, seed=11,
                                        device="cpu")
    assert tc.keygen_stream == "chacha20"
    np.testing.assert_array_equal(tc.lwe_sk, jc.lwe_sk)
    np.testing.assert_array_equal(tc.glwe_sk, jc.glwe_sk)
    for name in KEY_NAMES:
        np.testing.assert_array_equal(raw[name],
                                      np.asarray(getattr(jsks, name)))
    np.testing.assert_array_equal(tc.encrypt_bits([1, 0, 1]),
                                  jc.encrypt_bits([1, 0, 1]))


def test_native_false_takes_the_numpy_stream(monkeypatch):
    """native=False draws the numpy stream, the JAX package's with its
    native core off, whether or not the core builds here."""
    _no_jax_native(monkeypatch)
    jc, jsks = jkeys.generate_keys(jparams.PARAMS_TEST_N256, seed=4)
    tc, raw = tkeys.generate_keys_numpy(tparams.PARAMS_TEST_N256, seed=4,
                                        device="cpu", native=False)
    assert tc.keygen_stream == "numpy"
    for name in KEY_NAMES:
        np.testing.assert_array_equal(raw[name],
                                      np.asarray(getattr(jsks, name)))


def test_the_two_streams_differ(both_native):
    _, native_keys = tkeys.generate_keys_numpy(tparams.PARAMS_TEST, seed=2,
                                               device="cpu", native=True)
    _, numpy_keys = tkeys.generate_keys_numpy(tparams.PARAMS_TEST, seed=2,
                                              device="cpu", native=False)
    assert not np.array_equal(native_keys["ksk"], numpy_keys["ksk"])


def test_failed_build_falls_back_to_numpy_and_logs(monkeypatch, tmp_path,
                                                   caplog):
    """Where the core does not build, keygen falls back to the numpy
    stream, as the JAX package does, and logs why."""
    _broken_build(monkeypatch, tmp_path)
    _no_jax_native(monkeypatch)
    with caplog.at_level(logging.WARNING, logger=tkeys.__name__):
        tc, raw = tkeys.generate_keys_numpy(tparams.PARAMS_TEST, seed=6,
                                            device="cpu")
    assert tc.keygen_stream == "numpy"
    assert "native ChaCha20 core unavailable" in caplog.text
    _, jsks = jkeys.generate_keys(jparams.PARAMS_TEST, seed=6)
    for name in KEY_NAMES:
        np.testing.assert_array_equal(raw[name],
                                      np.asarray(getattr(jsks, name)))


def test_native_true_raises_where_the_build_fails(monkeypatch, tmp_path):
    _broken_build(monkeypatch, tmp_path)
    with pytest.raises(OSError):
        tkeys.generate_keys_numpy(tparams.PARAMS_TEST, seed=6, device="cpu",
                                  native=True)


def test_generate_keys_reports_its_stream(monkeypatch, tmp_path):
    _broken_build(monkeypatch, tmp_path)
    client, sks = tkeys.generate_keys(tparams.PARAMS_TEST, seed=1,
                                      device="cpu")
    assert client.keygen_stream == "numpy"
    assert sks.bsk.dtype.is_signed


def test_build_goes_to_the_ports_own_directory():
    """The port builds under tfhe_aes2_tpu_torch/_build/, never into the
    JAX package's native/build/."""
    assert tnative.BUILD_DIR == Path(tnative.__file__).parent / "_build"
    assert tnative.SOURCE_DIR == Path(jnative.__file__).parents[1] / "native"
