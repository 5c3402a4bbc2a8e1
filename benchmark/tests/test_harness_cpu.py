"""The harness driven on the CPU with the kernels' plain versions: each
cell's run end to end (set-up, window, reference check) at
PARAMS_TEST_N256, the control and the planted faults seen as `correct`
false at PARAMS_TEST, the trace's arithmetic on synthetic events, and the
refusal to run without a card. This path (run_cell with device cpu and a
test parameter set) is not reachable from benchmark.run's command line,
and its result holds no device metric."""

import dataclasses
import json
import types

import pytest
import torch

from benchmark import harness, run, spec
from benchmark import trace as trace_mod

CPU = torch.device("cpu")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
BATCH = [c for c in CELLS if spec.mix(spec.workload(c)["traffic"])["blocks"]
         > 1]


def params_for(cell, name):
    """A test set with the noise budget of the cell's configuration."""
    from tfhe_aes2_tpu_torch.ops import params
    budget = spec.config(spec.workload(cell)["config"])["param_values"][
        "max_noise_level_squared"]
    return dataclasses.replace(getattr(params, name),
                               max_noise_level_squared=budget)


def run_cpu(cell, seed, params_name="PARAMS_TEST", control=False):
    blocks = 2 if cell in BATCH else 1
    return harness.run_cell(cell, seed, 0.0, False, CPU,
                            params=params_for(cell, params_name),
                            mix_changes={"pool": 2, "blocks": blocks},
                            control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_verifies(cell):
    out = run_cpu(cell, 2 ** 31 + 17, "PARAMS_TEST_N256")
    e2e, _ = spec.cell_metrics(BENCH, cell)
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "check"
    assert set(out["check"]) == set(spec.workload(cell)["limits"])
    assert out["device"]["platform"] == "cpu"
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """One limb plane less (the configuration's control_env)."""
    out = run_cpu(cell, 5, control=True)
    assert not out["correct"]
    assert out["check"]["phase_err_max"]["value"] > 1


def _step_unchanged(monkeypatch):
    from tfhe_aes2_tpu_torch.ops.kernels import extprod
    monkeypatch.setattr(extprod, "extprod_step2g",
                        lambda dig, bsk, acc, *a, **k: (acc, dig))


def _half_batch(monkeypatch):
    from tfhe_aes2_tpu_torch.aes_128 import fhe
    orig = fhe.encrypt_blocks_staged

    def half(strategy, ctx, eks, blocks, rounds, blocks_meta=None):
        h = max(1, blocks.shape[0] // 2)
        out = orig(strategy, ctx, eks, blocks[:h], rounds)
        reps = -(-blocks.shape[0] // h)
        return types.SimpleNamespace(
            array=torch.cat([out.array] * reps)[:blocks.shape[0]])
    monkeypatch.setattr(fhe, "encrypt_blocks_staged", half)


def _answer_altered(monkeypatch):
    from tfhe_aes2_tpu_torch.ops import compression
    orig = compression.compress_bits

    def flip(cts, sks, params, log2q=32):
        comp = orig(cts, sks, params, log2q).clone()
        flat = comp.view(-1, comp.shape[-1])
        flat[0, -1] = (flat[0, -1] + (1 << (log2q - 1))) % (1 << log2q)
        return comp
    monkeypatch.setattr(compression, "compress_bits", flip)


FAULTS = [(c, f) for c in CELLS for f in (_step_unchanged, _answer_altered)]
FAULTS += [(c, _half_batch) for c in BATCH]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run_cpu(cell, 6)
    assert not out["correct"]
    assert out["check"]["wrong_bits"]["value"] > 0


def _event(name, start, end, cuda, annotation=False):
    return (name, cuda, annotation, start, end)


def test_trace_view_and_readers():
    """A 1 s window with two requests: busy 0.6 s, so 40% idle; the CMux
    kernels 0.5 s; the gaps named by the innermost harness range."""
    ev = [_event("bench.window", 0, 1e6, False),
          _event("bench.request", 0, 5e5, False),
          _event("bench.upload", 0, 1e5, False),
          _event("bench.request", 5e5, 1e6, False),
          _event("bench.readback", 9e5, 1e6, False),
          _event("void extprod_step2g_kernel<2, 2>(signed char const*)",
                 1e5, 3e5, True),
          _event("void extprod_step2g_kernel<2, 2>(signed char const*)",
                 2e5, 4e5, True),                        # overlaps
          _event("void rot_diff_digits_kernel(unsigned long)", 6e5, 7e5,
                 True),
          _event("Memcpy HtoD (Pageable -> Device)", 7e5, 8e5, True),
          _event("elementwise_kernel", 8e5, 8.5e5, True),
          _event("fused_limb_matmul_kernel", -1e5, 5e4, True),  # clipped
          _event("aten::add", 0, 1, False),
          _event("bench.rounds", 0, 1e6, True, True),   # not device work
          _event("void (anonymous namespace)::k3<1>(int)", 4e5, 4e5, True)]
    cfg = spec.config("lvl64-galmul")
    tv, breakdown = trace_mod.view(ev, requests=2, blocks=32, config=cfg,
                                   mix={"kind": "reused_key"})
    assert tv.window_s == 1.0 and tv.busy_s == pytest.approx(0.6)
    assert len(tv.kernels) == 6 and len(tv.ops) == 7
    read = {m: spec.metric_reader(m).read
            for m in ("device_idle_share.batch", "kernel_launches.batch",
                      "noncmux_device_ms.request", "cmux_roofline")}
    assert read["device_idle_share.batch"](tv, {}) == pytest.approx(40.0)
    assert read["kernel_launches.batch"](
        tv, {"unit": "launches/block"}) == 6 / 32
    # outside the CMux set: the copy, torch's kernel, K4's clipped 0.05 s
    assert read["noncmux_device_ms.request"](
        tv, {"unit": "ms/request"}) == pytest.approx(1e3 * 0.2 / 2)
    ops = 32 * 1280 * 677 * 75 * 512 ** 2 * 11 * 2
    assert read["cmux_roofline"](tv, {}) == pytest.approx(
        100 * ops / (0.5 * 1979e12))
    assert breakdown["device_ops"][0] == ["extprod_step2g_kernel<2, 2>",
                                          pytest.approx(0.4)]
    gaps = dict(breakdown["idle_gaps"])
    assert gaps == {"bench.request": pytest.approx(0.2),
                    "bench.readback": pytest.approx(0.15),
                    "bench.upload": pytest.approx(0.05)}


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.cuda
def test_cell_on_the_card(capsys):
    """One short run of the first cell on a card: the result line's keys,
    the device, `correct`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert run.main(["--workload", CELLS[0], "--seed", "12", "--seconds",
                     "1", "--trace", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0 and list(out)[-1] == "check"
