"""On a CUDA device the CLI and the server take the parameter sets with
N = 1024 (lvl1, lvl4, lvl256, and the 8-bit model's PARAMS_WOPPBS_8BIT)
under every lowering — (gridg | grid | merged | longk | bucket | glue_out)
x (fused | partials), whose kernels all take N <= 1024 (extprod.N_MAX);
the CLI reads the set the chosen model runs. The refusal path stays: a set
above what the kernels take (N = 2048, or N = 1024 with N_MAX narrowed to
512 here) is refused before any keygen or request, on the card only. On the CPU every set runs under every lowering.
CPU only: the refusal comes before anything touches a card, and the
accepting runs are stopped where keygen or key loading would begin."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tfhe_aes2_tpu_torch import cli, serve
from tfhe_aes2_tpu_torch.aes_128 import fhe as fhe_mod
from tfhe_aes2_tpu_torch.aes_128 import scenario
from tfhe_aes2_tpu_torch.models import shortint_1bit as model_1b
from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as model
from tfhe_aes2_tpu_torch.models import shortint_woppbs_8bit as model_8
from tfhe_aes2_tpu_torch.ops import blind_rotate as br_mod
from tfhe_aes2_tpu_torch.ops import circuit_bootstrap as cbs_mod
from tfhe_aes2_tpu_torch.ops import params as params_mod
from tfhe_aes2_tpu_torch.ops import serialization, truncation
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx
from tfhe_aes2_tpu_torch.ops.lowering import (BR_CHOICES, VP_CHOICES,
                                              Lowering)

ARGV = ["--key", "00" * 16, "--iv", "00" * 8, "--number-of-outputs", "1"]
WIDE = ["lvl1", "lvl4", "lvl256"]
WIDE_BR = ["gridg", "grid", "merged", "longk", "bucket", "glue_out"]
# the lowering the refusal tests run with the kernels narrowed to N <= 512
# (K9's, which took N <= 512 until it had a cluster layout at N = 1024)
NARROW_BR = ["merged"]


def _narrow(monkeypatch):
    """Every kernel takes N <= 512 on the card."""
    monkeypatch.setattr(kx, "N_MAX", 512)


def _set_lowering(monkeypatch, br, vp="fused"):
    """The environment that selects Lowering(br, vp) (Lowering.from_env)."""
    for name in ("TFHE_BR_KERNEL", "TFHE_BR_GLUE", "TFHE_VP_FUSED",
                 "TFHE_VP_NTT"):
        monkeypatch.delenv(name, raising=False)
    if br == "glue_out":
        monkeypatch.setenv("TFHE_BR_GLUE", "xla")
    else:
        monkeypatch.setenv("TFHE_BR_KERNEL", br)
    if vp == "partials":
        monkeypatch.setenv("TFHE_VP_FUSED", "0")
    assert Lowering.from_env() == Lowering(br, vp)


class Reached(Exception):
    """Raised where keygen or key loading would begin."""


def _stop(*args, **kwargs):
    raise Reached


def test_the_wide_sets_are_the_ones_above_the_kernels_limit():
    """The sets with N = 1024 are the wide ones; every lowering of WIDE_BR x
    (fused | partials), which is all of them, takes them on the card, every
    kernel up to N_MAX."""
    above = {name for name, p in cli.PARAM_CHOICES.items()
             if p.polynomial_size > 512}
    assert above == set(WIDE)
    assert {p.polynomial_size for name, p in cli.PARAM_CHOICES.items()
            if name in WIDE} == {1024}
    assert set(WIDE_BR) == set(BR_CHOICES)
    takes = {(br, vp) for br in BR_CHOICES for vp in VP_CHOICES
             if kx.device_refusal(1024, "cuda", Lowering(br, vp)) is None}
    assert takes == {(br, vp) for br in WIDE_BR for vp in VP_CHOICES}
    # every wrapper but K7 runs under some lowering
    assert set(kx.WRAPPERS) - {k for br in BR_CHOICES for vp in VP_CHOICES
                            for k in Lowering(br, vp).kernels()} == {
        "extprod_partials"}
    assert all(kx.device_refusal(512, "cuda", Lowering(br, vp)) is None
               for br in BR_CHOICES for vp in VP_CHOICES)
    assert kx.device_refusal(2048, "cuda", Lowering()) is not None


@pytest.mark.parametrize("vp", VP_CHOICES)
@pytest.mark.parametrize("br", BR_CHOICES)
def test_each_lowering_launches_the_kernels_it_names(br, vp, monkeypatch):
    """Lowering.kernels(), which device_refusal reads, names exactly the
    kernel wrappers that the blind rotation and the vertical packing call
    under that lowering: each wrapper of ops/kernels/extprod.py is spied on
    while both run on small random operands on the CPU."""
    called = set()
    for name in kx.WRAPPERS:
        def spy(*args, _name=name, _fn=getattr(kx, name), **kwargs):
            called.add(_name)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(kx, name, spy)
    p = params_mod.PARAMS_TEST
    k1, n = p.glwe_dimension + 1, p.polynomial_size
    gen = torch.Generator().manual_seed(5)

    def i64(*shape):
        return torch.randint(-2 ** 62, 2 ** 62, shape, generator=gen,
                             dtype=torch.int64)
    low = Lowering(br, vp)
    bsk = torch.randint(-128, 128, (2, k1, k1 * p.pbs_level, 6, 2 * n),
                        generator=gen, dtype=torch.int8)
    br_mod.blind_rotate_glwe(i64(3, 3), bsk, i64(k1, n), p, low)
    ggsw = i64(2, 2, p.cbs_level, k1, k1, n)
    cbs_mod.vertical_packing(ggsw, i64(1, 1, n), p, 4, low)
    assert called == set(low.kernels())


@pytest.mark.parametrize("br", NARROW_BR)
@pytest.mark.parametrize("name", WIDE)
def test_cli_refuses_n1024_on_cuda_before_keygen(name, br, monkeypatch,
                                                 capsys):
    """With the kernels narrowed to N <= 512, the CLI refuses the N = 1024
    sets under br on the card with argparse's error, before keygen."""
    _set_lowering(monkeypatch, br)
    _narrow(monkeypatch)
    monkeypatch.setattr(model, "generate_keys", _stop)
    with pytest.raises(SystemExit) as exc:
        cli.main(ARGV + ["--params", name], device="cuda")
    assert exc.value.code == 2                   # argparse's error exit
    err = capsys.readouterr().err
    assert ("polynomial_size 1024" in err and "N <= 512" in err
            and name in err and f"br={br}" in err)


@pytest.mark.parametrize("vp", VP_CHOICES)
@pytest.mark.parametrize("br", WIDE_BR)
@pytest.mark.parametrize("name", WIDE)
def test_cli_on_cuda_takes_n1024_to_keygen(name, br, vp, monkeypatch):
    _set_lowering(monkeypatch, br, vp)
    monkeypatch.setattr(model, "generate_keys", _stop)
    with pytest.raises(Reached):
        cli.main(ARGV + ["--params", name], device="cuda")


@pytest.mark.parametrize("name", WIDE + ["lvl64", "test"])
def test_cli_on_cpu_takes_every_set_to_keygen(name, monkeypatch):
    monkeypatch.setattr(model, "generate_keys", _stop)
    with pytest.raises(Reached):
        cli.main(ARGV + ["--params", name], device="cpu")


def test_cli_on_cuda_takes_lvl64_to_keygen(monkeypatch):
    monkeypatch.setattr(model, "generate_keys", _stop)
    with pytest.raises(Reached):
        cli.main(ARGV + ["--params", "lvl64"], device="cuda")


@pytest.mark.parametrize("br", NARROW_BR)
def test_cli_refuses_the_8bit_model_on_cuda_before_keygen(br, monkeypatch,
                                                         capsys):
    """The 8-bit model always runs PARAMS_WOPPBS_8BIT (N = 1024), so the
    refusal reads that set, not --params: with the kernels narrowed to
    N <= 512 and lvl64 (N = 512) named, it is still refused before
    keygen."""
    _set_lowering(monkeypatch, br)
    _narrow(monkeypatch)
    monkeypatch.setattr(model_8, "generate_keys", _stop)
    monkeypatch.setattr(model, "generate_keys", _stop)
    with pytest.raises(SystemExit) as exc:
        cli.main(ARGV + ["--implementation", "shortint-woppbs-8bit",
                         "--params", "lvl64"], device="cuda")
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert ("woppbs 8bit" in err and "polynomial_size 1024" in err
            and f"br={br}" in err and "N <= 512" in err)


@pytest.mark.parametrize("vp", VP_CHOICES)
@pytest.mark.parametrize("br", WIDE_BR)
def test_cli_on_cuda_takes_the_8bit_model_to_keygen(br, vp, monkeypatch):
    """Under WIDE_BR x (fused | partials) the 8-bit model goes on to keygen,
    at PARAMS_WOPPBS_8BIT whatever --params says."""
    _set_lowering(monkeypatch, br, vp)
    seen = []

    def keygen(params, **kwargs):
        seen.append((params, kwargs["device"], kwargs["lowering"]))
        raise Reached
    monkeypatch.setattr(model_8, "generate_keys", keygen)
    with pytest.raises(Reached):
        cli.main(ARGV + ["--implementation", "shortint-woppbs-8bit",
                         "--params", "lvl64"], device="cuda")
    assert seen == [(params_mod.PARAMS_WOPPBS_8BIT, "cuda", Lowering(br, vp))]


@pytest.mark.parametrize("params,want", [
    ("test", "PARAMS_TEST_S1"), ("test-n256", "PARAMS_TEST_S1"),
    ("lvl64", "PARAMS_SHORTINT_1BIT"), ("lvl256", "PARAMS_SHORTINT_1BIT")])
def test_cli_runs_the_tree_model_at_its_own_sets(params, want, monkeypatch):
    """--implementation shortint-1bit runs PARAMS_TEST_S1 when --params
    starts with "test" and PARAMS_SHORTINT_1BIT (N = 512) otherwise, through
    Shortint1BitSboxPbsAesEncrypt; under merged on cuda neither is refused,
    whatever --params names. Keygen and the scenario runner are replaced, so
    nothing is computed."""
    _set_lowering(monkeypatch, "merged")
    keygen, runs = [], []
    client = SimpleNamespace(keygen_stream="numpy")

    def fake_keys(pset, **kwargs):
        keygen.append((pset, kwargs["device"]))
        return client, SimpleNamespace(lowering=kwargs["lowering"])

    def fake_run(client, ctx, key, iv, count, **kwargs):
        runs.append((client, kwargs["strategy"], kwargs["rounds"]))
        return [], {}
    monkeypatch.setattr(model_1b, "generate_keys", fake_keys)
    monkeypatch.setattr(scenario, "run_client_server_aes_scenario", fake_run)
    assert cli.main(ARGV + ["--implementation", "shortint-1bit", "--params",
                            params, "--rounds", "2"], device="cuda") == 0
    assert keygen == [(getattr(model_1b, want), "cuda")]
    assert runs == [(client, fhe_mod.Shortint1BitSboxPbsAesEncrypt, 2)]


@pytest.mark.parametrize("flag", [["--compress-output", "16"],
                                  ["--fhe-counter"]])
@pytest.mark.parametrize("impl", ["shortint-woppbs-8bit", "shortint-1bit"])
def test_cli_keeps_the_1bit_options_to_the_1bit_model(impl, flag,
                                                      monkeypatch):
    """--compress-output and --fhe-counter need the shortint-woppbs-1bit
    model's big-key bits and circuit bootstrap, as in the JAX CLI: with the
    other two models they are refused before keygen."""
    monkeypatch.setattr(model_8, "generate_keys", _stop)
    monkeypatch.setattr(model_1b, "generate_keys", _stop)
    with pytest.raises(SystemExit) as exc:
        cli.main(ARGV + ["--implementation", impl] + flag, device="cpu")
    assert exc.value.code == 2


def _bundle(path, params):
    """A bundle of lvl1's parameters with stand-in key arrays: no key is
    generated."""
    z = np.zeros(4, dtype=np.uint64)
    serialization.save_server_keys(
        path, SimpleNamespace(bsk=z, ksk=z, pfpksk=z, pksk=z), params)
    return path


@pytest.mark.parametrize("br", NARROW_BR)
def test_server_refuses_an_n1024_bundle_on_cuda(br, tmp_path, monkeypatch):
    """With the kernels narrowed to N <= 512, the server refuses a bundle of
    lvl1's parameters under br on the card as it loads, before the keys
    move."""
    _narrow(monkeypatch)
    monkeypatch.setattr(serialization, "server_keys_on", _stop)
    monkeypatch.setattr(model, "context_from_keys", _stop)
    keys = _bundle(str(tmp_path / "keys.npz"), params_mod.PARAMS_SQRD_LVL_1)
    with pytest.raises(ValueError, match="polynomial_size 1024"):
        serve.serve(keys, str(tmp_path / "s.sock"), max_requests=1,
                    device="cuda", lowering=Lowering(br))


@pytest.mark.parametrize("vp", VP_CHOICES)
@pytest.mark.parametrize("br", BR_CHOICES)
def test_device_refusal_above_every_kernel(br, vp, monkeypatch):
    """device_refusal itself, for each lowering: at N = 2048, above N_MAX,
    it names on the card each kernel the lowering runs and the largest N
    they take, and nothing on the CPU; with N_MAX narrowed to 512, it
    refuses N = 1024 under every lowering on the card, and nothing on the
    CPU."""
    low = Lowering(br, vp)
    why = kx.device_refusal(2048, "cuda", low)
    assert why is not None and "polynomial_size 2048" in why
    assert f"br={br}, vp={vp}" in why and "N <= 1024" in why
    assert all(name in why for name in low.kernels())
    assert kx.device_refusal(2048, "cpu", low) is None
    _narrow(monkeypatch)
    why = kx.device_refusal(1024, "cuda", low)
    assert why is not None and "polynomial_size 1024" in why
    assert f"br={br}, vp={vp}" in why and "N <= 512" in why
    assert all(name in why for name in low.kernels())
    assert kx.device_refusal(1024, "cpu", low) is None
    assert kx.device_refusal(512, "cuda", low) is None


# under the CRT-NTT (TFHE_VP_NTT=1): refused where the set's selectors keep
# at most 4 planes at N = 1024 (the NTT's primes have no 2048-th root)
NTT_SETS = [("PARAMS_SQRD_LVL_1", True), ("PARAMS_SQRD_LVL_4", True),
            ("PARAMS_SQRD_LVL_256", False), ("PARAMS_WOPPBS_8BIT", False),
            ("PARAMS_SQRD_LVL_64", False), ("PARAMS_TEST", False)]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("name,refused", NTT_SETS)
def test_device_refusal_of_the_ntt_at_n1024(name, refused, device):
    """The refusal matches the JAX package's ValueError, on either device
    (it is arithmetic, not a kernel's limit); at lvl256 and the 8-bit set
    (vp_js 3: 5 planes) the NTT falls back to K3/K8, as there."""
    p = getattr(params_mod, name)
    vp_js = truncation.vp_ggsw_j_start(p)
    low = Lowering(ntt=True)
    assert low.vp_ntt(vp_js) == (vp_js >= 4)
    why = kx.device_refusal(p.polynomial_size, device, low, vp_js)
    assert (why is not None) == refused
    if refused:
        assert "no primitive 2048-th root mod 13313" in why
    assert kx.device_refusal(p.polynomial_size, device, Lowering(),
                             vp_js) is None


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("name", ["lvl1", "lvl4"])
def test_cli_refuses_the_ntt_at_n1024_before_keygen(name, device,
                                                    monkeypatch, capsys):
    _set_lowering(monkeypatch, "gridg")
    monkeypatch.setenv("TFHE_VP_NTT", "1")
    monkeypatch.setattr(model, "generate_keys", _stop)
    with pytest.raises(SystemExit) as exc:
        cli.main(ARGV + ["--params", name], device=device)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "no primitive 2048-th root mod 13313" in err and name in err


def test_cli_takes_lvl256_to_keygen_under_the_ntt(monkeypatch):
    _set_lowering(monkeypatch, "gridg")
    monkeypatch.setenv("TFHE_VP_NTT", "1")
    monkeypatch.setattr(model, "generate_keys", _stop)
    with pytest.raises(Reached):
        cli.main(ARGV + ["--params", "lvl256"], device="cuda")


def test_server_refuses_the_ntt_at_lvl1(tmp_path, monkeypatch):
    monkeypatch.setattr(serialization, "server_keys_on", _stop)
    keys = _bundle(str(tmp_path / "keys.npz"), params_mod.PARAMS_SQRD_LVL_1)
    with pytest.raises(ValueError, match="2048-th root"):
        serve.serve(keys, str(tmp_path / "s.sock"), max_requests=1,
                    device="cpu", lowering=Lowering(ntt=True))


@pytest.mark.parametrize("vp", VP_CHOICES)
@pytest.mark.parametrize("vp_js", [4, 3])
def test_the_ntt_lowering_launches_the_kernels_it_names(vp, vp_js,
                                                        monkeypatch):
    """Under ntt, Lowering.kernels(vp_js) names no vertical-packing kernel
    where the NTT runs (4 kept planes) and the fallback's where it does
    not (5), as the wrappers called show."""
    called = set()
    for name in kx.WRAPPERS:
        def spy(*args, _name=name, _fn=getattr(kx, name), **kwargs):
            called.add(_name)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(kx, name, spy)
    p = params_mod.PARAMS_TEST
    k1, n = p.glwe_dimension + 1, p.polynomial_size
    gen = torch.Generator().manual_seed(6)
    low = Lowering("gridg", vp, ntt=True)
    bsk = torch.randint(-128, 128, (1, k1, k1 * p.pbs_level, 6, 2 * n),
                        generator=gen, dtype=torch.int8)
    lwe = torch.randint(-2 ** 62, 2 ** 62, (2, 2), generator=gen)
    br_mod.blind_rotate_glwe(lwe, bsk, torch.zeros((k1, n),
                                                   dtype=torch.int64), p, low)
    ggsw = torch.randint(-2 ** 62, 2 ** 62, (2, 2, p.cbs_level, k1, k1, n),
                         generator=gen)
    cbs_mod.vertical_packing(ggsw, torch.zeros((1, 1, n), dtype=torch.int64),
                             p, vp_js, low)
    assert called == set(low.kernels(vp_js))
    assert ("extprod_grouped_fused" in called
            or "extprod_partials_grouped" in called) == (vp_js == 3)


@pytest.mark.parametrize("lowering", [
    None, Lowering("grid", "partials"), Lowering("longk"),
    Lowering("bucket"), Lowering("glue_out", "partials"),
    Lowering("merged")])
def test_server_on_cuda_loads_an_n1024_bundle(lowering, tmp_path,
                                              monkeypatch):
    """Under the default lowering (from the environment, here unset),
    under (grid, partials) and under the longk, bucket, glue_out and merged
    schedules the server goes on to move the keys onto the card."""
    for name in ("TFHE_BR_KERNEL", "TFHE_BR_GLUE", "TFHE_VP_FUSED",
                 "TFHE_VP_NTT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(serialization, "server_keys_on", _stop)
    keys = _bundle(str(tmp_path / "keys.npz"),
                   params_mod.PARAMS_SQRD_LVL_256)
    with pytest.raises(Reached):
        serve.serve(keys, str(tmp_path / "s.sock"), max_requests=1,
                    device="cuda", lowering=lowering)


def test_server_on_cpu_loads_an_n1024_bundle(tmp_path, monkeypatch):
    monkeypatch.setattr(model, "context_from_keys", _stop)
    keys = _bundle(str(tmp_path / "keys.npz"), params_mod.PARAMS_SQRD_LVL_1)
    with pytest.raises(Reached):
        serve.serve(keys, str(tmp_path / "s.sock"), max_requests=1,
                    device="cpu")
