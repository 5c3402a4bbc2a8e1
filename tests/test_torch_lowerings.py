"""The port's lowerings (ops/lowering.py): every schedule of the blind
rotation (K1 | K2 + K5 | K9 | K10a + K10b | K2 + K11 | torch glue + K6) and both forms of the vertical
packing (K3 | K8 + recombination) against the JAX package under the
environment that selects the counterpart there, and against each other
through the whole AES slice. Exact integer arithmetic on both sides:
tolerance 0 (array equality) everywhere.

The JAX functions are called eagerly, as tests/test_polynomial.py calls
them: they read the environment at each call, whereas the staged programs
of tfhe_aes2_tpu/aes_128/fhe.py bake it in when they are traced.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tfhe_aes2_tpu.ops import blind_rotate as jbr
from tfhe_aes2_tpu.ops import circuit_bootstrap as jcbs
from tfhe_aes2_tpu.ops import keyswitch as jks

from tfhe_aes2_tpu_torch.aes_128 import aes_lib, fhe as tfhe, fhe_encryption
from tfhe_aes2_tpu_torch.aes_128 import plain, scenario
from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as tm1
from tfhe_aes2_tpu_torch.ops import blind_rotate as tbr
from tfhe_aes2_tpu_torch.ops import circuit_bootstrap as tcbs
from tfhe_aes2_tpu_torch.ops import keys as tkeys
from tfhe_aes2_tpu_torch.ops.lowering import Lowering
from tests.torch_port_common import jax_server_keys, port_keys, t64, u64

KEY = bytes(range(16))
ENV_NAMES = ("TFHE_BR_KERNEL", "TFHE_BR_GLUE", "TFHE_VP_FUSED")
# Lowering.br -> the JAX package's environment for the same schedule
BR_ENV = {"gridg": {"TFHE_BR_KERNEL": "gridg"},
          "grid": {"TFHE_BR_KERNEL": "grid"},
          "merged": {"TFHE_BR_KERNEL": "merged"},
          "longk": {"TFHE_BR_KERNEL": "longk"},
          "bucket": {"TFHE_BR_KERNEL": "bucket"},
          "glue_out": {"TFHE_BR_GLUE": "xla"}}


def _set_env(monkeypatch, env):
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)


# ------------------------------------------------------ Lowering.from_env

@pytest.mark.parametrize("env,expect", [
    ({}, Lowering("gridg", "fused")),
    ({"TFHE_BR_KERNEL": "grid"}, Lowering("grid", "fused")),
    ({"TFHE_BR_KERNEL": "merged"}, Lowering("merged", "fused")),
    ({"TFHE_BR_KERNEL": "longk", "TFHE_VP_FUSED": "0"},
     Lowering("longk", "partials")),
    ({"TFHE_BR_KERNEL": "bucket"}, Lowering("bucket", "fused")),
    ({"TFHE_BR_GLUE": "xla", "TFHE_BR_KERNEL": "merged"},
     Lowering("glue_out", "fused")),
    ({"TFHE_BR_GLUE": "xla"}, Lowering("glue_out", "fused")),
    ({"TFHE_BR_GLUE": "xla", "TFHE_BR_KERNEL": "grid", "TFHE_VP_FUSED": "0"},
     Lowering("glue_out", "partials")),
    ({"TFHE_BR_KERNEL": "gridg", "TFHE_BR_GLUE": "pallas",
      "TFHE_VP_FUSED": "0"}, Lowering("gridg", "partials")),
])
def test_from_env_maps_the_jax_names(monkeypatch, env, expect):
    _set_env(monkeypatch, env)
    assert Lowering.from_env() == expect
    assert Lowering() == Lowering("gridg", "fused")


@pytest.mark.parametrize("kernel", ["fastest", "glue_out"])
def test_from_env_refuses_what_the_port_lacks(monkeypatch, kernel):
    """No schedule of that name: `glue_out` is the port's own word, chosen
    in the environment by TFHE_BR_GLUE=xla."""
    _set_env(monkeypatch, {"TFHE_BR_KERNEL": kernel})
    with pytest.raises(ValueError, match="schedule"):
        Lowering.from_env()


def test_lowering_refuses_unknown_values_and_is_frozen():
    with pytest.raises(ValueError):
        Lowering(br="fastest")
    for br in ("merged", "longk", "bucket"):
        assert Lowering(br=br).vp == "fused"
    with pytest.raises(ValueError):
        Lowering(vp="int32")
    with pytest.raises(AttributeError):
        Lowering().br = "grid"


def test_context_takes_the_lowering_or_the_environment(monkeypatch,
                                                       keys_test):
    _, raw = port_keys(keys_test)
    p = keys_test[0].params
    _set_env(monkeypatch, {"TFHE_BR_KERNEL": "grid", "TFHE_VP_FUSED": "0"})
    assert (tm1.context_from_keys(p, raw).lowering
            == Lowering("grid", "partials"))
    assert (tm1.context_from_keys(p, raw, lowering=Lowering()).lowering
            == Lowering())


# ------------------------------------------------- against the JAX package

@pytest.fixture(scope="module")
def setup(keys_test):
    """Prepared keys of both packages (truncated planes), two encrypted
    bytes, their keyswitched bits and the port's GGSWs."""
    jclient, _ = keys_test
    client, raw = port_keys(keys_test)
    p = client.params
    sks = tkeys.prepare_server_keys(raw, p, truncate=True)
    jsks = jax_server_keys(keys_test, True)
    bits = np.unpackbits(np.array([0x3a, 0xc5], np.uint8)[:, None], axis=-1)
    cts = jclient.encrypt_bits(bits)                       # [2, 8, kN+1]
    dual = np.asarray(jks.keyswitch(jnp.asarray(cts), jsks.ksk,
                                    jclient.params))       # [2, 8, n+1]
    ggsw = tcbs.circuit_bootstrap_bits(t64(cts), sks, p)
    return jclient, p, sks, jsks, cts, dual, ggsw


@pytest.mark.parametrize("br", ["gridg", "grid", "glue_out", "merged",
                                "longk", "bucket"])
def test_blind_rotate_matches_jax_under_matching_env(setup, monkeypatch, br):
    jclient, p, sks, jsks, _, dual, _ = setup
    rng = np.random.default_rng(31)
    shifted = dual.reshape(-1, dual.shape[-1])[:5].copy()  # an odd batch
    shifted[:, -1] += np.uint64(1 << 62)
    acc = rng.integers(0, 2 ** 64, (p.glwe_dimension + 1, p.polynomial_size),
                       dtype=np.uint64)
    _set_env(monkeypatch, BR_ENV[br])
    assert Lowering.from_env().br == br
    ref = np.asarray(jbr.blind_rotate_glwe(
        jnp.asarray(shifted), jsks.bsk, jnp.asarray(acc), jclient.params,
        use_conv="pallas"))
    got = tbr.blind_rotate_glwe(t64(shifted), sks.bsk, t64(acc), p,
                                Lowering.from_env())
    np.testing.assert_array_equal(u64(got), ref)


@pytest.mark.parametrize("vp", ["fused", "partials"])
def test_vertical_packing_matches_jax_under_matching_env(setup, monkeypatch,
                                                         vp):
    jclient, p, sks, _, _, _, ggsw = setup
    _set_env(monkeypatch, {"TFHE_VP_FUSED": "1" if vp == "fused" else "0"})
    assert Lowering.from_env().vp == vp
    lut = tcbs.generate_lut(8, 3, lambda v: (v * 5 + 1) % 8, p)
    ref = np.asarray(jcbs.vertical_packing(
        jnp.asarray(u64(ggsw)), jnp.asarray(lut), jclient.params,
        use_conv="pallas"))
    got = tcbs.vertical_packing(ggsw, t64(lut), p, sks.vp_js,
                                Lowering.from_env())
    np.testing.assert_array_equal(u64(got), ref)
    expect = [[((v * 5 + 1) % 8 >> (2 - o)) & 1 for o in range(3)]
              for v in (0x3a, 0xc5)]
    np.testing.assert_array_equal(jclient.decrypt_bits(u64(got)), expect)


@pytest.mark.parametrize("br,vp", [("grid", "partials"),
                                   ("glue_out", "fused")])
def test_circuit_bootstrap_matches_jax_prepared_path(setup, br, vp):
    """The whole WoP-PBS of a non-default lowering against the JAX
    package's default one on its prepared keys."""
    jclient, p, sks, jsks, cts, _, ggsw = setup
    low = Lowering(br, vp)
    got = tcbs.circuit_bootstrap_bits(t64(cts), sks, p, low)
    np.testing.assert_array_equal(u64(got), u64(ggsw))
    ref = np.asarray(jcbs.circuit_bootstrap_bits(jnp.asarray(cts), jsks,
                                                 jclient.params))
    np.testing.assert_array_equal(u64(got), ref)


# ------------------------------------------------- the slice as a whole

@pytest.fixture(scope="module")
def slice_default(keys_test):
    """Inputs and the default lowering's ciphertexts of the latency path and
    of the staged batch path (2 rounds) at PARAMS_TEST, truncated keys."""
    jclient, _ = keys_test
    client, raw = port_keys(keys_test)
    blocks = scenario.ctr_blocks(bytes(8), 1)
    key_ct = t64(fhe_encryption.encrypt_byte_array(jclient, KEY))
    block_cts = t64(fhe_encryption.encrypt_blocks(jclient, blocks))
    outs = _run_slice(tm1.context_from_keys(client.params, raw, True,
                                            Lowering()), key_ct, block_cts)
    return client, raw, blocks, key_ct, block_cts, outs


def _run_slice(ctx, key_ct, block_cts):
    strat = tfhe.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt
    lat = tfhe.encrypt_block_latency(strat, ctx, key_ct, block_cts)
    eks = tfhe.key_schedule_staged(strat, ctx, key_ct)
    staged = tfhe.encrypt_blocks_staged(strat, ctx, eks, block_cts, 2)
    return u64(lat.array), u64(eks.array), u64(staged.array)


def test_slice_default_lowering_decrypts_to_aes(slice_default):
    client, _, blocks, _, _, (lat, _, staged) = slice_default
    assert (fhe_encryption.decrypt_blocks(client, lat)
            == aes_lib.encrypt_blocks(KEY, blocks))
    assert (fhe_encryption.decrypt_blocks(client, staged)
            == plain.expand_key_and_encrypt_blocks(KEY, blocks, 2))


@pytest.mark.parametrize("br,vp", [("grid", "partials"),
                                   ("glue_out", "partials"),
                                   ("merged", "fused"),
                                   ("longk", "partials"),
                                   ("bucket", "fused")])
def test_slice_ciphertexts_equal_under_every_lowering(slice_default, br, vp):
    client, raw, _, key_ct, block_cts, default = slice_default
    ctx = tm1.context_from_keys(client.params, raw, True, Lowering(br, vp))
    outs = _run_slice(ctx, key_ct, block_cts)
    for got, ref, what in zip(outs, default,
                              ("latency path", "expanded key", "2 rounds")):
        np.testing.assert_array_equal(got, ref, err_msg=what)
