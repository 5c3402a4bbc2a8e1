"""The CLI and the server refuse, on a CUDA device, the parameter sets whose
polynomial size the CUDA kernels do not take (N = 1024: lvl1, lvl4,
lvl256), before any keygen or request; on the CPU they take them. CPU
only: the refusal comes before anything touches a card, and the accepting
runs are stopped where keygen or key loading would begin."""

from types import SimpleNamespace

import numpy as np
import pytest

from tfhe_aes2_tpu_torch import cli, serve
from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as model
from tfhe_aes2_tpu_torch.ops import params as params_mod
from tfhe_aes2_tpu_torch.ops import serialization
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx

ARGV = ["--key", "00" * 16, "--iv", "00" * 8, "--number-of-outputs", "1"]
WIDE = ["lvl1", "lvl4", "lvl256"]


class Reached(Exception):
    """Raised where keygen or key loading would begin."""


def _stop(*args, **kwargs):
    raise Reached


def test_the_wide_sets_are_the_ones_above_the_kernels_limit():
    above = {name for name, p in cli.PARAM_CHOICES.items()
             if p.polynomial_size > kx.N_MAX}
    assert above == set(WIDE)
    assert kx.N_MAX == 512


@pytest.mark.parametrize("name", WIDE)
def test_cli_refuses_n1024_on_cuda_before_keygen(name, monkeypatch, capsys):
    monkeypatch.setattr(model, "generate_keys", _stop)
    with pytest.raises(SystemExit) as exc:
        cli.main(ARGV + ["--params", name], device="cuda")
    assert exc.value.code == 2                   # argparse's error exit
    err = capsys.readouterr().err
    assert "ROADMAP.md Queue 1" in err and "1024" in err and name in err


@pytest.mark.parametrize("name", WIDE + ["lvl64", "test"])
def test_cli_on_cpu_takes_every_set_to_keygen(name, monkeypatch):
    monkeypatch.setattr(model, "generate_keys", _stop)
    with pytest.raises(Reached):
        cli.main(ARGV + ["--params", name], device="cpu")


def test_cli_on_cuda_takes_lvl64_to_keygen(monkeypatch):
    monkeypatch.setattr(model, "generate_keys", _stop)
    with pytest.raises(Reached):
        cli.main(ARGV + ["--params", "lvl64"], device="cuda")


def _bundle(path, params):
    """A bundle of lvl1's parameters with stand-in key arrays: no key is
    generated."""
    z = np.zeros(4, dtype=np.uint64)
    serialization.save_server_keys(
        path, SimpleNamespace(bsk=z, ksk=z, pfpksk=z, pksk=z), params)
    return path


def test_server_refuses_an_n1024_bundle_on_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(model, "context_from_keys", _stop)
    keys = _bundle(str(tmp_path / "keys.npz"), params_mod.PARAMS_SQRD_LVL_1)
    with pytest.raises(ValueError, match="ROADMAP.md Queue 1"):
        serve.serve(keys, str(tmp_path / "s.sock"), max_requests=1,
                    device="cuda")


def test_server_on_cpu_loads_an_n1024_bundle(tmp_path, monkeypatch):
    monkeypatch.setattr(model, "context_from_keys", _stop)
    keys = _bundle(str(tmp_path / "keys.npz"), params_mod.PARAMS_SQRD_LVL_1)
    with pytest.raises(Reached):
        serve.serve(keys, str(tmp_path / "s.sock"), max_requests=1,
                    device="cpu")
