"""The port's noise checks (tfhe_aes2_tpu_torch/noise.py) against the JAX
package on the CPU, on the same keys and ciphertexts.

measure_sbox_floor's phases, each held against the JAX function that
computes the same arithmetic: the keyswitch (PARAMS_TEST and
PARAMS_TEST_N256) against ks.keyswitch on the value-truncated KSK
(tests/test_noise_floor.py's emulation); at PARAMS_TEST, the circuit
bootstrap against cbs.circuit_bootstrap_bits_small on the JAX package's
prepared (plane-dropping) keys and the vertical packing against
cbs.vertical_packing(use_conv="pallas") (interpret mode, ~8 s each). The
blind rotation is not held against the value-truncation emulation: dropping the
low planes of the negacyclic extension [x, -x], as the Pallas kernels and
the port's K1/K3 do, differs from truncating x and negating wherever one of
x's dropped balanced digits is -128 (pinned below). noise.measure's flow and
statistics against noise_probe.py's on the same keys, at full planes."""

import copy
import json

import jax.numpy as jnp
import numpy as np
import pytest

import noise_probe
from tfhe_aes2_tpu.ops import circuit_bootstrap as jcbs
from tfhe_aes2_tpu.ops import keys as jkeys_mod
from tfhe_aes2_tpu.ops import keyswitch as jks
from tfhe_aes2_tpu.ops import params as jparams
from tfhe_aes2_tpu.ops import truncation as jtrunc
from tfhe_aes2_tpu.ops.torus import split_u64_signed

from tfhe_aes2_tpu_torch import noise
from tfhe_aes2_tpu_torch.ops import params as tparams
from tests.torch_port_common import (jax_server_keys, port_context,
                                     port_params, private_keys, u64)


@pytest.fixture(scope="module", params=["test", "test_n256"])
def floor_setup(request, keys_test, keys_test_n256):
    keys = (keys_test if request.param == "test"
            else private_keys(keys_test_n256))
    client, ctx = port_context(keys, truncate=True)
    return keys, client, ctx, noise.sbox_floor_phases(ctx.params, client,
                                                      ctx)


def test_sbox_floor_keyswitch_matches_emulation(floor_setup):
    """The duals: bit-equal to the JAX package's keyswitch on the KSK
    truncated by value (test_noise_floor.py:59-64)."""
    (jclient, jsks), _, ctx, (_, cts, dual, _, _) = floor_setup
    p = jclient.params
    ksk_t = jtrunc.truncate_u64_values(jnp.asarray(jsks.ksk),
                                       jtrunc.ksk_j_start(p))
    want = np.asarray(jks.keyswitch(jnp.asarray(u64(cts)), ksk_t, p))
    np.testing.assert_array_equal(u64(dual), want)


@pytest.mark.parametrize("floor_setup", ["test"], indirect=True)
def test_sbox_floor_bootstrap_matches_prepared_keys(floor_setup):
    """The GGSWs: bit-equal to circuit_bootstrap_bits_small on the JAX
    package's prepared keys (the planes its Pallas kernels read)."""
    keys, _, ctx, (_, _, dual, ggsw, _) = floor_setup
    want = jcbs.circuit_bootstrap_bits_small(
        jnp.asarray(u64(dual)), jax_server_keys(keys, True), keys[0].params)
    np.testing.assert_array_equal(u64(ggsw), np.asarray(want))


@pytest.mark.parametrize("floor_setup", ["test"], indirect=True)
def test_sbox_floor_vertical_packing_matches_pallas(floor_setup):
    """The SBOX+GalMul outputs: bit-equal to the JAX package's vertical
    packing with its GGSW planes dropped (Pallas, interpret mode), and
    decoding to S(x)·1 ‖ ·2 ‖ ·3 of each byte."""
    (jclient, _), client, ctx, (_, _, _, ggsw, out) = floor_setup
    lut = jcbs.generate_lut(8, 24, noise.sbox_gal_mul, jclient.params)
    want = jcbs.vertical_packing(jnp.asarray(u64(ggsw)), jnp.asarray(lut),
                                 jclient.params, use_conv="pallas")
    np.testing.assert_array_equal(u64(out), np.asarray(want))
    js, dual_std, out_std = noise.measure_sbox_floor(ctx.params, client, ctx)
    assert js == noise.truncated_js(ctx.params)
    assert 0 < dual_std < 62 and 0 < out_std < 62


def test_plane_drop_of_the_extension_is_not_negated_truncation(keys_test):
    """Why the blind rotation is held against the prepared keys: the port's
    BSK planes (K1's operand) recombine to [trunc(x), trunc(-x)], which is
    not [trunc(x), -trunc(x)] at the coefficients where one of x's js
    dropped balanced digits is -128, about js/256 of them."""
    client, ctx = port_context(keys_test, truncate=True)
    p = ctx.params
    js = 8 - ctx.sks.bsk.shape[3]
    x = np.asarray(keys_test[1].bsk, np.uint64)
    neg = (np.uint64(0) - x)
    planes = np.asarray(split_u64_signed(jnp.asarray(neg)))
    kept = sum(planes[i].astype(np.int64).astype(np.uint64)
               << np.uint64(8 * i) for i in range(js, 8))
    t_neg = np.asarray(jtrunc.truncate_u64_values(jnp.asarray(neg), js))
    np.testing.assert_array_equal(kept, t_neg)
    neg_t = np.uint64(0) - np.asarray(jtrunc.truncate_u64_values(
        jnp.asarray(x), js))
    low = (x + np.uint64(sum(1 << (8 * i + 7) for i in range(js)))) \
        & np.uint64((1 << (8 * js)) - 1)
    has_min = np.zeros(x.shape, bool)
    for i in range(js):                       # a balanced digit of -128
        has_min |= ((low >> np.uint64(8 * i)) & np.uint64(0xFF)) == 0
    assert has_min.any()
    np.testing.assert_array_equal(t_neg != neg_t, has_min & (t_neg != neg_t))
    assert 0 < (t_neg != neg_t).mean() < 2 * js / 256
    assert js == noise.truncated_js(p)[0]


def test_sbox_floor_refuses_untruncated_keys(keys_test):
    client, ctx = port_context(keys_test, truncate=False)
    with pytest.raises(ValueError, match="truncate=True"):
        noise.measure_sbox_floor(ctx.params, client, ctx)


@pytest.mark.parametrize("js,dual_bar,out_bar,fails", [
    (None, 62.0, 62.0, False), (None, 1.0, 62.0, True),
    (None, 62.0, 1.0, True), ((0, 0, 0, 0), 62.0, 62.0, True)])
def test_sbox_floor_bars(keys_test, monkeypatch, js, dual_bar, out_bar,
                         fails):
    """A set's row: its js and both floors checked, NoiseCheckError on
    either bar or on other js."""
    client, ctx = port_context(keys_test, truncate=True)
    row = (ctx.params, js or noise.truncated_js(ctx.params), dual_bar,
           out_bar)
    monkeypatch.setitem(noise.SBOX_FLOOR_SETS, "test", row)
    if fails:
        with pytest.raises(noise.NoiseCheckError):
            noise.measure_sbox_floor(ctx.params, client, ctx)
    else:
        assert noise.measure_sbox_floor(ctx.params, client, ctx,
                                        "test")[0] == row[1]


def test_sbox_floor_sets_copy_the_jax_bars():
    """The port's copy of the four sets' js and bars is the JAX package's
    (tests/test_params_all_sets.py, and test_noise_floor.py's lvl64 bars),
    on the port's copies of the same parameter sets."""
    from tests.test_params_all_sets import SETS

    assert set(noise.SBOX_FLOOR_SETS) == set(SETS)
    for name, (jp, js, dual_bar, out_bar) in SETS.items():
        tp, tjs, tdual, tout = noise.SBOX_FLOOR_SETS[name]
        assert port_params(jp) is tp
        assert (tjs, tdual, tout) == (js, dual_bar, out_bar)
        assert noise.truncated_js(tp) == js
    assert noise.SBOX_FLOOR_SETS["lvl64"][2:] == (58.6, 59.2)


def test_measure_flow_matches_noise_probe(keys_test, monkeypatch):
    """noise.run_flow + flow_stats at full planes (truncate=False), 2
    blocks x 1 round, against noise_probe.measure run on the same keys
    and the same client randomness (at PARAMS_TEST in place of lvl64):
    every statistic equal."""
    jclient, jsks = keys_test
    client, ctx = port_context(keys_test, truncate=False)
    client.rng = copy.deepcopy(jclient.rng)
    monkeypatch.setattr(jparams, "PARAMS_SQRD_LVL_64", jclient.params)
    monkeypatch.setattr(jkeys_mod, "generate_keys",
                        lambda params, seed: (jclient, jsks))
    want = noise_probe.measure(2, 1, 11)
    out, blocks, _ = noise.run_flow(client, ctx, 2, 1)
    got = noise.flow_stats(client, out, blocks, 1)
    assert got.pop("verified") and want.pop("verified")
    for key in got:
        assert got[key] == want[key], key


def test_measure_keys_on_the_cpu():
    """noise.measure's record, truncations on, at PARAMS_TEST: the probe's
    keys and the port's own, verified."""
    res = noise.measure(1, 1, seed=11, params=tparams.PARAMS_TEST,
                        device="cpu")
    assert res["verified"] and res["samples"] == 128
    assert res["params"] == "PARAMS_TEST" and res["device"] == "cpu"
    assert res["js"] == dict(zip(("bsk", "ksk", "pfpksk", "vp"),
                                 noise.truncated_js(tparams.PARAMS_TEST)))
    assert {"log2_std", "log2_max_abs_err", "decode_margin_stds",
            "variance", "blocks", "rounds"} <= set(res)
    noise.check(res)


@pytest.mark.parametrize("verified,log2_std,asserting,raises", [
    (True, 58.4, "1", False), (True, 59.1, "1", True),
    (False, 50.0, "1", True), (False, 60.0, "0", False)])
def test_main_prints_json_and_asserts(monkeypatch, capsys, verified,
                                      log2_std, asserting, raises):
    """python -m tfhe_aes2_tpu_torch.noise: one JSON line, then the
    assertions (verified, log2_std <= 59) unless NOISE_ASSERT=0."""
    res = {"verified": verified, "log2_std": log2_std}
    seen = {}
    monkeypatch.setattr(noise, "measure",
                        lambda *a, **k: (seen.update(args=a, **k), res)[1])
    monkeypatch.setenv("NOISE_ASSERT", asserting)
    monkeypatch.setenv("NOISE_BLOCKS", "3")
    if raises:
        with pytest.raises(noise.NoiseCheckError):
            noise.main(["--device", "cpu"])
    else:
        assert noise.main(["--device", "cpu"]) == 0
    assert seen == {"args": (3, 10, 11), "device": "cpu"}
    assert json.loads(capsys.readouterr().out.strip()) == res
