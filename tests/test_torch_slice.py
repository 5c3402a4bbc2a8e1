"""The port's main path end to end at PARAMS_TEST, and its import hygiene.

With truncate=False the port's key_schedule_staged + encrypt_blocks_staged
(1 block, 2 rounds) is bit-equal to the JAX package's staged path on the
same keys and ciphertexts — expanded key, output ciphertexts and BitCt
metadata alike. With truncate=True (the production setting) the outputs
decrypt to the clear oracles, on the batch path and on the latency path,
and the latency request after a staged run copies no constant to the
device (ops/torus.device_const)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tfhe_aes2_tpu.aes_128 import fhe as jfhe
from tfhe_aes2_tpu.models import shortint_woppbs_1bit as jm1

from tfhe_aes2_tpu_torch import cli
from tfhe_aes2_tpu_torch.aes_128 import aes_lib, fhe as tfhe, fhe_encryption
from tfhe_aes2_tpu_torch.aes_128 import plain, scenario
from tfhe_aes2_tpu_torch.ops.torus import device_const
from tests.torch_port_common import port_context, t64, u64

KEY = bytes(range(16))
REPO = Path(__file__).resolve().parents[1]


def _structure(comps):
    """Component sets up to relabelling: each lane's set size, and the
    size of every pairwise intersection."""
    flat = comps.reshape(-1)
    sizes = np.array([len(s) for s in flat])
    inter = np.array([[len(a & b) for b in flat] for a in flat])
    return sizes, inter


def test_staged_slice_bit_equal_to_jax(keys_test):
    jclient, jsks = keys_test
    jctx = jm1.FheContext(params=jclient.params,
                          sks=jax.tree_util.tree_map(jnp.asarray, jsks))
    _, tctx = port_context(keys_test, truncate=False)
    blocks = scenario.ctr_blocks(bytes(8), 1)
    key_ct = fhe_encryption.encrypt_byte_array(jclient, KEY)
    block_cts = fhe_encryption.encrypt_blocks(jclient, blocks)

    jstrat = jfhe.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt
    tstrat = tfhe.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt
    jeks = jfhe.key_schedule_staged(jstrat, jctx, jnp.asarray(key_ct))
    teks = tfhe.key_schedule_staged(tstrat, tctx, t64(key_ct))
    np.testing.assert_array_equal(u64(teks.array), np.asarray(jeks.array))
    np.testing.assert_array_equal(teks.noise_sq, jeks.noise_sq)

    jout = jfhe.encrypt_blocks_staged(jstrat, jctx, jeks,
                                      jnp.asarray(block_cts), 2)
    tout = tfhe.encrypt_blocks_staged(tstrat, tctx, teks, t64(block_cts), 2)
    np.testing.assert_array_equal(u64(tout.array), np.asarray(jout.array))
    np.testing.assert_array_equal(tout.noise_sq, jout.noise_sq)
    np.testing.assert_array_equal(tout.degree, jout.degree)
    for got, ref in zip(_structure(tout.comps), _structure(jout.comps)):
        np.testing.assert_array_equal(got, ref)
    assert (fhe_encryption.decrypt_blocks(jclient, u64(tout.array))
            == plain.expand_key_and_encrypt_blocks(KEY, blocks, 2))


def test_truncated_paths_decrypt_to_oracles(keys_test):
    client, ctx = port_context(keys_test, truncate=True)
    out, timings = scenario.run_client_server_aes_scenario(
        client, ctx, KEY, bytes(8), 1, rounds=2)
    assert set(timings) == {"key_expansion_s", "blocks_s", "blocks_per_s"}
    # the staged run put every constant of the latency path on the device:
    # the request asks for 105 and copies none
    uploads, hits = device_const.uploads, device_const.hits
    out, timings = scenario.run_client_server_aes_scenario(
        client, ctx, KEY, bytes(8), 1, rounds=10)
    assert (device_const.uploads, device_const.hits) == (uploads, hits + 105)
    assert set(timings) == {"fused_latency_s"}
    assert out == aes_lib.encrypt_blocks(KEY, scenario.ctr_blocks(bytes(8), 1))


@pytest.mark.parametrize("flag", [["--implementation", "shortint-woppbs-8bit"],
                                  ["--implementation", "shortint-1bit"]])
def test_cli_refuses_unported_options(flag, monkeypatch):
    """The other two models are dispatched, each to its own model's keygen
    (no NotImplementedError is left); what they refuse, as in the JAX CLI,
    is the 1-bit WoP-PBS model's --compress-output, before keygen."""
    from tfhe_aes2_tpu_torch.models import shortint_1bit, shortint_woppbs_8bit

    class Reached(Exception):
        pass

    def stop(*args, **kwargs):
        raise Reached
    model = (shortint_woppbs_8bit if flag[1] == "shortint-woppbs-8bit"
             else shortint_1bit)
    monkeypatch.setattr(model, "generate_keys", stop)
    argv = ["--key", KEY.hex(), "--iv", "00" * 8, "--number-of-outputs", "2",
            "--params", "test"] + flag
    with pytest.raises(Reached):
        cli.main(argv, device="cpu")
    with pytest.raises(SystemExit):
        cli.main(argv + ["--compress-output", "16"], device="cpu")


def test_package_imports_neither_jax_nor_the_jax_package():
    """Every module of tfhe_aes2_tpu_torch, and chip_smoke.py, import in a
    fresh interpreter without pulling in jax or tfhe_aes2_tpu."""
    code = """
import importlib, pkgutil, sys
import tfhe_aes2_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "tfhe_aes2_tpu"
       or m.startswith("tfhe_aes2_tpu.")]
assert not bad, bad
print("ok", len([m for m in sys.modules if m.startswith("tfhe_aes2_tpu_torch")]))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
