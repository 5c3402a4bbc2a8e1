"""Every piece BENCHMARK.json names loads from its file by name, agrees
with the entry, and keeps to the benchmark's contract; the configurations'
numbers are the port's named sets, and the frozen CMux work is the bench
entry's kept-dot count."""

import json
import re

import pytest

from benchmark import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = spec.workload(cell)
    assert {k: wl[k] for k in ("name", "config", "traffic", "chips", "why")} \
        == entry
    assert cell == f"{entry['config']}.{entry['traffic']}"
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    assert wl["limits"]["wrong_bits"] == 0
    assert 0 < wl["limits"]["phase_err_max"] <= 1
    mix = spec.mix(entry["traffic"])
    kind = spec.kind(mix["kind"])
    assert all(callable(getattr(kind, f)) for f in ("build", "serve", "warm"))
    e2e, per_layer = spec.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer
    assert {m["moves"] for m in per_layer} <= names


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    from benchmark import program
    data = spec.config(cfg["name"])
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"] == []
    program.param_set(data)                # raises where the numbers differ
    from tfhe_aes2_tpu_torch.aes_128 import fhe
    assert hasattr(fhe, data["strategy"])
    assert any(cfg["name"] == w["config"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_reader_loads(entry):
    assert callable(spec.metric_reader(entry["name"]).read)
    assert entry["source"] == "device_trace"
    assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert set(entry["workloads"]) <= set(CELLS)


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for thing in metrics + BENCH["configs"] + BENCH["workloads"]:
        assert NAME.match(thing["name"]), thing["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] == "host_clock"
        assert 0.01 <= m["bound"] <= 0.25
    assert len({m["name"] for m in metrics}) == len(metrics)


@pytest.mark.parametrize("params_name,ops", [
    ("PARAMS_SQRD_LVL_64", 4.325e8), ("PARAMS_SQRD_LVL_256", 8.305e8)])
def test_frozen_cmux_work_is_the_kept_dot_count(params_name, ops):
    """cmux_roofline's work a lane-step, at KEPT_DOTS = 11, is the
    bench entry's kept_dot_ops over its 128 lanes and n steps."""
    from tfhe_aes2_tpu_torch import bench
    from tfhe_aes2_tpu_torch.ops import params
    reader = spec.metric_reader("cmux_roofline")
    cfg = next(spec.config(c["name"]) for c in BENCH["configs"]
               if spec.config(c["name"])["params"] == params_name)
    p = getattr(params, params_name)
    per_lane_step = reader.lane_step_ops(cfg["param_values"])
    assert per_lane_step == pytest.approx(ops, rel=1e-3)
    assert per_lane_step * 128 * p.lwe_dimension == bench.kept_dot_ops(p, 1)


def test_frozen_blind_rotation_counts():
    """Per block 10 rounds x 128 bits; a fresh key adds 1,600 (the latency
    path's 11 scans of 32 + 9 x 288 + 256 lanes = 2,880 with its block)."""
    reader = spec.metric_reader("cmux_roofline")
    circuit = spec.config("lvl64-galmul")["circuit"]
    assert reader.blind_rotations(circuit, "fresh_key", 1, 1) == \
        32 + 9 * 288 + 256
    assert reader.blind_rotations(circuit, "reused_key", 16, 1) == 20480
