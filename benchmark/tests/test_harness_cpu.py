"""The harness driven on the CPU with the kernels' plain versions: each
cell's run end to end (set-up, window, reference check) at
PARAMS_TEST_N256, the control and the planted faults seen as `correct`
false at PARAMS_TEST, the trace's arithmetic on synthetic events, and the
refusal to run without a card. A configuration whose file carries
`cpu_test` runs at its test set and rounds instead, its key expanded in the
clear; a test-only 8-bit WoP-PBS configuration
(tests/configs/woppbs8-test.json) runs that way through a cell given by
monkeypatch. This path (run_cell with device cpu and a test parameter set)
is not reachable from benchmark.run's command line, and its result holds no
device metric."""

import copy
import dataclasses
import json
import math
import types

import numpy as np
import pytest
import torch

from benchmark import harness, program, run, spec
from benchmark import trace as trace_mod
from benchmark.reference import aes

CPU = torch.device("cpu")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
BATCH = [c for c in CELLS if spec.mix(spec.workload(c)["traffic"])["blocks"]
         > 1]


def params_for(cell, name):
    """The configuration's `cpu_test` set where it states one, else a test
    set with the noise budget of the cell's configuration."""
    from tfhe_aes2_tpu_torch.ops import params
    cfg = spec.config(spec.workload(cell)["config"])
    if "cpu_test" in cfg:
        return getattr(params, cfg["cpu_test"]["params"])
    budget = cfg["param_values"]["max_noise_level_squared"]
    return dataclasses.replace(getattr(params, name),
                               max_noise_level_squared=budget)


def clear_key_schedule(sessions):
    """fhe.key_schedule_staged's stand-in: the client decrypts the key it
    sent, the reference expands it in the clear, and the client encrypts
    the 176 bytes as lanes [44, 4, 8], wrapped as fresh bits (the FHE
    expansion's words end booted, at fresh noise). `sessions` holds the
    run's session (open_session recorded)."""
    def expand(strategy, ctx, key_ct):
        session = sessions[-1]
        client, p = session.client, session.params
        arr = key_ct.cpu().numpy()
        bits = (client.decrypt_bits_small(arr)
                if arr.shape[-1] == p.lwe_dimension + 1
                else client.decrypt_bits(arr))
        key = np.packbits(bits.astype(np.uint8), axis=-1).tobytes()
        words = bytes(sum(aes.expand_key(key), []))
        cts = strategy.encrypt_key_client(client, words)
        return strategy.fresh(session.upload(cts.reshape(44, 4, 8, -1)), ctx,
                              lane_ndim=3)
    return expand


def run_cpu(cell, seed, params_name="PARAMS_TEST", control=False):
    """One run of `cell` on the CPU; a configuration with `cpu_test` runs
    its rounds on a pool of 1 request, its key expanded in the clear."""
    from tfhe_aes2_tpu_torch.aes_128 import fhe
    cpu_test = spec.config(spec.workload(cell)["config"]).get("cpu_test")
    blocks = 2 if cell in BATCH else 1
    changes = {"pool": 1 if cpu_test else 2, "blocks": blocks}
    with pytest.MonkeyPatch.context() as mp:
        if cpu_test:
            sessions, opened = [], program.open_session

            def open_session(*a, **k):
                sessions.append(opened(*a, **k))
                return sessions[-1]
            mp.setattr(program, "open_session", open_session)
            mp.setattr(fhe, "key_schedule_staged",
                       clear_key_schedule(sessions))
        return harness.run_cell(cell, seed, 0.0, False, CPU,
                                params=params_for(cell, params_name),
                                mix_changes=changes, control=control,
                                rounds=cpu_test["rounds"] if cpu_test
                                else 10)


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
    """The first answer bit flipped where its modulus switch produces it
    (after the keyswitch for big-key bits, alone for small-key bits)."""
    from tfhe_aes2_tpu_torch.ops import compression
    orig = compression.mod_switch_q

    def flip(x, log2q):
        comp = orig(x, log2q).clone()
        flat = comp.view(-1, comp.shape[-1])
        flat[0, -1] = (flat[0, -1] + (1 << (log2q - 1))) % (1 << log2q)
        return comp
    monkeypatch.setattr(compression, "mod_switch_q", flip)


FAULTS = [(c, f) for c in CELLS for f in (_step_unchanged, _answer_altered)]
FAULTS += [(c, _half_batch) for c in BATCH]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run_cpu(cell, 6)
    assert not out["correct"]
    assert out["check"]["wrong_bits"]["value"] > 0


EIGHT_BIT = json.loads((spec.HERE / "tests" / "configs" /
                        "woppbs8-test.json").read_text())
EIGHT_BIT_CELL = {
    "name": "woppbs8-test.reusedkey1", "config": "woppbs8-test",
    "traffic": "reusedkey1", "chips": 1,
    "why": "a test-only cell: the 8-bit model, 1 block a request",
    "limits": {"wrong_bits": 0, "phase_err_max": 1.0}}


@pytest.fixture
def eight_bit_cell(monkeypatch):
    """The test-only 8-bit configuration and its cell, found by name as
    the files BENCHMARK.json names are (the cell reports what the
    reusedkey1 cells report)."""
    config, workload, bench = spec.config, spec.workload, spec.benchmark()
    cell, like = EIGHT_BIT_CELL["name"], "lvl256-sboxpbs.reusedkey1"
    for entry in bench["end_to_end"] + bench["per_layer"]:
        if like in entry.get("workloads", ()):
            entry["workloads"].append(cell)
    monkeypatch.setattr(spec, "benchmark", lambda: copy.deepcopy(bench))
    monkeypatch.setattr(spec, "config", lambda name: copy.deepcopy(
        EIGHT_BIT) if name == EIGHT_BIT["name"] else config(name))
    monkeypatch.setattr(spec, "workload", lambda name: copy.deepcopy(
        EIGHT_BIT_CELL) if name == cell else workload(name))
    return cell


def test_eight_bit_cell_runs_from_its_file(eight_bit_cell, monkeypatch):
    """Sound: `correct`, and a block-round takes 16 x (8 x cbs_level + 7)
    blind-rotation lanes, the count the configuration's
    round_blind_rotations states at its own set (624 at cbs_level 4)."""
    from tfhe_aes2_tpu_torch.ops import blind_rotate as br
    lanes, rotate = [], br.pbs_bit_to_level

    def counted(lwe_small, *a, **k):
        lanes.append(math.prod(lwe_small.shape[:-1]))
        return rotate(lwe_small, *a, **k)
    monkeypatch.setattr(br, "pbs_bit_to_level", counted)
    out = run_cpu(eight_bit_cell, 2 ** 31 + 23)
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    assert out["check"]["wrong_bits"]["value"] == 0
    assert set(out["metrics"]) == {"request_s", "setup_s"}
    cbs_level = params_for(eight_bit_cell, None).cbs_level
    rounds = EIGHT_BIT["cpu_test"]["rounds"]
    # the warm pass and each request: 1 block of `rounds` rounds
    block_rounds = (1 + out["attempted"]) * rounds
    assert sum(lanes) == block_rounds * 16 * (8 * cbs_level + 7) == \
        block_rounds * 368
    assert EIGHT_BIT["circuit"]["round_blind_rotations"] == \
        16 * (8 * EIGHT_BIT["param_values"]["cbs_level"] + 7)


def test_eight_bit_control_is_not_correct(eight_bit_cell):
    """The configuration's control_env drops a BSK plane at the test set
    too (TFHE_TRUNC_BUDGET 4096 would drop only a pfPKSK plane there, and
    reads `correct`)."""
    out = run_cpu(eight_bit_cell, 5, control=True)
    assert not out["correct"]
    assert out["check"]["phase_err_max"]["value"] > 1


def test_eight_bit_answer_altered_is_not_correct(eight_bit_cell,
                                                 monkeypatch):
    _answer_altered(monkeypatch)
    out = run_cpu(eight_bit_cell, 6)
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
