"""Output compression of the PyTorch port (ops/compression.py) against the
JAX package's on the same keys and ciphertexts: the modulus switch, the
compressed ciphertexts, the bytes on the wire and the client's decode, at
both moduli, with tolerance 0; then the scenario and the CLI end to end on
the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest

from tfhe_aes2_tpu.ops import compression as jcomp

from tfhe_aes2_tpu_torch import cli
from tfhe_aes2_tpu_torch.aes_128 import aes_lib, scenario
from tfhe_aes2_tpu_torch.ops import compression as tcomp
from tfhe_aes2_tpu_torch.ops import keys as tkeys
from tests.torch_port_common import (jax_server_keys, port_context, port_keys,
                                     t64)

KEY = bytes(range(16))


@pytest.mark.parametrize("log2q", [16, 32])
def test_mod_switch_q_matches_jax(log2q):
    rng = np.random.default_rng(41 + log2q)
    x = rng.integers(0, 2 ** 64, (7, 33), dtype=np.uint64)
    half = np.uint64(1 << (63 - log2q))
    x[0, :4] = [0, 2 ** 64 - 1, 2 ** 64 - int(half), int(half) - 1]  # wrap edges
    ref = np.asarray(jcomp.mod_switch_q(jnp.asarray(x), log2q))
    got = tcomp.mod_switch_q(t64(x), log2q).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    assert tcomp.pack_bytes(got, log2q) == jcomp.pack_bytes(ref, log2q)


@pytest.mark.parametrize("truncate", [False, True])
@pytest.mark.parametrize("log2q", [16, 32])
def test_compress_pack_unpack_decrypt_match_jax(keys_test, log2q, truncate):
    """compress_bits -> pack_bytes -> unpack_bytes -> decrypt, byte- and
    bit-identical to the JAX package on one batch of AES-block-shaped
    ciphertexts; truncate=True holds the port's truncated KSK against the
    JAX package's prepared planes."""
    jclient, _ = keys_test
    client, raw = port_keys(keys_test)
    p = client.params
    sks = tkeys.prepare_server_keys(raw, p, truncate=truncate)
    jsks = jax_server_keys(keys_test, truncate)
    rng = np.random.default_rng(43)
    bits = rng.integers(0, 2, (2, 16, 8))
    big = jclient.encrypt_bits(bits)

    ref = np.asarray(jcomp.compress_bits(jnp.asarray(big), jsks,
                                         jclient.params, log2q))
    got = tcomp.compress_bits(t64(big), sks, p, log2q)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))

    blob = tcomp.pack_bytes(got, log2q)
    assert blob == jcomp.pack_bytes(ref, log2q)
    assert len(blob) == ref.size * (2 if log2q <= 16 else 4)
    back = tcomp.unpack_bytes(blob, tuple(got.shape), log2q)
    np.testing.assert_array_equal(back,
                                  jcomp.unpack_bytes(blob, ref.shape, log2q))
    np.testing.assert_array_equal(
        tcomp.decrypt_bits_compressed(client, back, log2q), bits)
    blocks = tcomp.decrypt_blocks_compressed(client, back, log2q)
    assert blocks == jcomp.decrypt_blocks_compressed(jclient, back, log2q)
    assert blocks == [np.packbits(b.astype(np.uint8), axis=-1)[..., 0]
                      .tobytes() for b in bits]


def test_compress_bits_refuses_moduli_outside_the_wire_widths(keys_test):
    client, ctx = port_context(keys_test, truncate=True)
    cts = t64(client.encrypt_bits(np.zeros(2, np.int64)))
    for log2q in (7, 33):
        with pytest.raises(ValueError):
            tcomp.compress_bits(cts, ctx.sks, ctx.params, log2q)


@pytest.mark.parametrize("log2q", [16, 32])
def test_scenario_with_compressed_output(keys_test, log2q, capsys):
    """The latency path (1 block, 10 rounds) answered through the compressed
    response decrypts to the AES authority's keystream."""
    client, ctx = port_context(keys_test, truncate=True)
    out, _ = scenario.run_client_server_aes_scenario(
        client, ctx, KEY, bytes(8), 1, rounds=10, compress_log2q=log2q)
    assert out == aes_lib.encrypt_blocks(KEY, scenario.ctr_blocks(bytes(8), 1))
    n1 = client.params.lwe_dimension + 1
    assert (f"compressed response: {16 * 8 * n1 * log2q // 8} bytes"
            in capsys.readouterr().out)


def test_cli_with_compressed_output_ends_in_ok(capsys):
    rc = cli.main(["--key", KEY.hex(), "--iv", "00" * 8,
                   "--number-of-outputs", "2", "--params", "test",
                   "--rounds", "2", "--compress-output", "16"], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and lines[-1].startswith("ok")
    assert "lowering: br=gridg vp=fused" in lines
    assert any(ln.startswith("compressed response:") for ln in lines)
