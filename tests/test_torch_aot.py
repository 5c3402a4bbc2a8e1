"""The port's warm-up (tfhe_aes2_tpu_torch/aot.py) and its kernel store's
manifest (ops/kernels/build.py), on the CPU: TFHE_AOT on, off and by
default as the JAX package reads it; a manifest that differs names the
changed field and rebuilds every source; a warm-up whose build fails makes
wait(), the first launch and the CLI raise, never a silent CPU run; and
the warm-up launches exactly the kernels the context's lowering names
(Lowering.kernels() at its keys' kept planes, and K4). nvcc is replaced by
a stand-in where a build is needed: this host has none."""

import json
import logging
import os
import sys
import textwrap

import pytest
import torch

from tfhe_aes2_tpu_torch import aot, cli
from tfhe_aes2_tpu_torch.aes_128 import scenario
from tfhe_aes2_tpu_torch.ops.kernels import build
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx
from tfhe_aes2_tpu_torch.ops.kernels import matmul as kmm
from tfhe_aes2_tpu_torch.ops.lowering import Lowering
from tests.torch_port_common import port_context

ARGV = ["--key", "00" * 16, "--iv", "00" * 8, "--number-of-outputs", "1",
        "--params", "test", "--rounds", "1"]
FINGERPRINT = {"nvcc": "Build cuda_12.4.r12.4/compiler.0", "device":
               "NVIDIA H100 80GB HBM3", "capability": "9.0",
               "torch": "2.5.0"}


@pytest.mark.parametrize("env,device,on", [
    ("1", "cpu", True), ("1", "cuda", True), ("0", "cuda", False),
    ("0", "cpu", False), (None, "cpu", False), ("", "cpu", False)])
def test_tfhe_aot_on_off_and_default(monkeypatch, env, device, on):
    if env is None:
        monkeypatch.delenv("TFHE_AOT", raising=False)
    else:
        monkeypatch.setenv("TFHE_AOT", env)
    assert aot.enabled(device) == on


@pytest.mark.parametrize("present", [True, False])
def test_tfhe_aot_default_follows_the_card(monkeypatch, present):
    """Unset, the warm-up runs for a CUDA device where one is present."""
    monkeypatch.delenv("TFHE_AOT", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: present)
    assert aot.enabled("cuda") == present
    assert not aot.enabled("cpu")


def test_tfhe_aot_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("TFHE_AOT_DIR", raising=False)
    assert aot.store_dir() is None
    monkeypatch.setenv("TFHE_AOT_DIR", str(tmp_path))
    assert aot.store_dir() == str(tmp_path)
    monkeypatch.setenv("TFHE_AOT_DIR", "0")
    fresh = [aot.store_dir() for _ in range(2)]
    assert fresh[0] != fresh[1] and all(
        not any(os.scandir(d)) for d in fresh)


@pytest.mark.parametrize("field", sorted(FINGERPRINT))
def test_stale_fields_name_the_changed_field(tmp_path, field):
    (tmp_path / "manifest.json").write_text(json.dumps(FINGERPRINT))
    assert build.stale_fields(tmp_path, FINGERPRINT) == []
    assert build.stale_fields(tmp_path, {**FINGERPRINT,
                                         field: "other"}) == [field]
    assert build.stale_fields(tmp_path / "none", FINGERPRINT) == sorted(
        FINGERPRINT)


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc: prints a version, or copies a loadable shared
    object to its -o path and logs each source it 'compiled'. The build
    module's store, loaded libraries and device fingerprint are isolated."""
    import _ctypes
    script = tmp_path / "nvcc"
    script.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import shutil, sys
        if "--version" in sys.argv:
            print("Build cuda_12.4.r12.4/compiler.0")
            sys.exit(0)
        out = sys.argv[sys.argv.index("-o") + 1]
        shutil.copy({_ctypes.__file__!r}, out)
        with open({str(tmp_path / "compiled.log")!r}, "a") as f:
            f.write(sys.argv[-1] + "\\n")
        """))
    script.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(script))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "store")
    device = {"name": "NVIDIA H100 80GB HBM3"}

    def fingerprint():
        return {"nvcc": "Build cuda_12.4.r12.4/compiler.0",
                "device": device["name"], "capability": "9.0",
                "torch": torch.__version__}
    monkeypatch.setattr(build, "fingerprint", fingerprint)

    def compiled():
        log = tmp_path / "compiled.log"
        n = len(log.read_text().splitlines()) if log.exists() else 0
        log.unlink(missing_ok=True)
        return n
    return device, compiled


def test_store_rebuilds_on_a_changed_manifest(fake_nvcc, caplog):
    """A fresh store builds every source and writes its manifest; the same
    fingerprint loads what is there; a changed device rebuilds every
    source and logs the field."""
    device, compiled = fake_nvcc
    build.build_all()
    assert compiled() == len(build.SOURCES)
    manifest = json.loads((build.BUILD_DIR / "manifest.json").read_text())
    assert manifest == build.fingerprint()
    build._libs.clear()
    build.build_all()
    assert compiled() == 0
    build._libs.clear()
    device["name"] = "NVIDIA H200"
    with caplog.at_level(logging.INFO, logger=build.__name__):
        build.build_all()
    assert compiled() == len(build.SOURCES)
    assert "device changed" in caplog.text
    assert json.loads((build.BUILD_DIR / "manifest.json").read_text())[
        "device"] == "NVIDIA H200"


def test_warmup_builds_into_the_store_it_is_given(fake_nvcc, tmp_path):
    _, compiled = fake_nvcc
    handle = aot.warmup_staged("cpu", store=str(tmp_path / "aot"))
    handle.wait(timeout=120)
    assert build.BUILD_DIR == tmp_path / "aot"
    assert compiled() == len(build.SOURCES) and handle.build_s is not None
    assert handle.wait_s is not None and build._libs


def _failing_nvcc(monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    monkeypatch.setattr(build, "_libs", {})


def test_failed_warmup_raises_from_wait_and_the_first_launch(monkeypatch,
                                                             keys_test):
    """The JAX package's pending programs fall back to jit; the port's
    warm-up does not: wait() raises the build's error, the load attached
    after it never runs, and the wrappers' first library lookup raises
    the same error."""
    _failing_nvcc(monkeypatch)
    _, ctx = port_context(keys_test, True, Lowering())
    handle = aot.warmup_staged("cpu")
    handle.attach(ctx)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        handle.wait(timeout=120)
    assert handle.loaded == () and handle.load_s is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library("cmux")


def test_cli_raises_when_its_forced_warmup_fails(monkeypatch):
    """TFHE_AOT=1 on the CPU forces the warm-up; its failed build stops
    the CLI before the first request instead of running it."""
    _failing_nvcc(monkeypatch)
    monkeypatch.setenv("TFHE_AOT", "1")
    ran = []
    monkeypatch.setattr(scenario, "run_client_server_aes_scenario",
                        lambda *a, **k: ran.append(1))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cli.main(ARGV, device="cpu")
    assert ran == []


LOWERINGS = [Lowering(), Lowering("grid", "partials"), Lowering("merged"),
             Lowering("longk"), Lowering("bucket"),
             Lowering("glue_out", "partials"), Lowering(ntt=True),
             Lowering("longk", "partials", ntt=True)]


@pytest.mark.parametrize("low", LOWERINGS,
                         ids=[f"{x.br}-{x.vp}-{'ntt' if x.ntt else 'k'}"
                              for x in LOWERINGS])
def test_warmup_touches_only_the_contexts_kernels(low, keys_test,
                                                  monkeypatch):
    """warm_kernels launches each kernel the context's lowering names at
    its keys' kept planes (none for the vertical packing under the NTT at
    PARAMS_TEST's 3 planes) and K4, and nothing else."""
    called = set()
    for module, names in ((kx, kx.WRAPPERS), (kmm, ["fused_limb_matmul"])):
        for name in names:
            def spy(*args, _name=name, _fn=getattr(module, name), **kwargs):
                called.add(_name)
                return _fn(*args, **kwargs)
            monkeypatch.setattr(module, name, spy)
    _, ctx = port_context(keys_test, True, low)
    loaded = aot.warm_kernels(ctx)
    assert called == set(loaded) == set(low.kernels(ctx.sks.vp_js)) | {
        "fused_limb_matmul"}
    assert low.ntt == (not {"extprod_grouped_fused",
                            "extprod_partials_grouped"} & called)
