"""Every piece BENCHMARK.json names loads from its file by name, agrees
with the entry, and keeps to the benchmark's contract; the configurations'
numbers are the port's named sets, each names the model whose bits its
strategy makes, and the frozen CMux work is the bench entry's kept-dot
count. The test-only 8-bit configuration (tests/configs/woppbs8-test.json)
is held to the same."""

import json
import re

import pytest

from benchmark import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
EIGHT_BIT = json.loads((spec.HERE / "tests" / "configs" /
                        "woppbs8-test.json").read_text())
CONFIGS = [spec.config(c["name"]) for c in BENCH["configs"]] + [EIGHT_BIT]


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


# int8 operations a lane-step, by parameter set (a set not listed here is
# held by the exact comparison alone)
LANE_STEP_OPS = {"PARAMS_SQRD_LVL_64": 4.325e8, "PARAMS_SQRD_LVL_256": 8.305e8,
                 "PARAMS_WOPPBS_8BIT": 7.927e8}


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_frozen_cmux_work_is_the_kept_dot_count(cfg):
    """cmux_roofline's work a lane-step, at the configuration's kept_dots
    (11 where it states none), is the bench entry's kept_dot_ops over its
    128 lanes and n steps."""
    from tfhe_aes2_tpu_torch import bench
    from tfhe_aes2_tpu_torch.ops import params
    reader = spec.metric_reader("cmux_roofline")
    p = getattr(params, cfg["params"])
    per_lane_step = reader.lane_step_ops(cfg)
    if cfg["params"] in LANE_STEP_OPS:
        assert per_lane_step == pytest.approx(LANE_STEP_OPS[cfg["params"]],
                                              rel=1e-3)
    assert per_lane_step * 128 * p.lwe_dimension == bench.kept_dot_ops(p, 1)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_model_makes_the_strategys_bits(cfg):
    """The configuration's model (stated, or the default) is the module
    that defines the bit type its strategy's `fresh` returns, on a context
    that model builds at a test set."""
    from benchmark import program
    from tfhe_aes2_tpu_torch.aes_128 import fhe
    from tfhe_aes2_tpu_torch.ops import keys, params
    from tfhe_aes2_tpu_torch.ops.torus import to_tensor
    p = getattr(params, cfg.get("cpu_test", {}).get("params", "PARAMS_TEST"))
    model = program.model_module(cfg)
    assert model.__name__ == "tfhe_aes2_tpu_torch.models." + cfg.get(
        "model", "shortint_woppbs_1bit")
    client, raw = keys.generate_keys(p, seed=3, device="cpu")
    ctx = model.context_from_keys(p, raw)
    strategy = getattr(fhe, cfg["strategy"])
    cts = to_tensor(strategy.encrypt_client(client, [bytes(16)]), ctx.device)
    bits = strategy.fresh(cts, ctx, lane_ndim=2)
    assert type(bits).__module__ == model.__name__


def test_eight_bit_counts():
    """624 rotations a block-round, 7,800 a fresh key, 7 dots."""
    reader = spec.metric_reader("cmux_roofline")
    circuit = EIGHT_BIT["circuit"]
    assert reader.blind_rotations(circuit, "reused_key", 1, 1) == 6240
    assert reader.blind_rotations(circuit, "fresh_key", 1, 1) == \
        6240 + 200 * 39
    assert reader.work_ops(EIGHT_BIT, "reused_key", 1, 1) == \
        6240 * 785 * 3 * 18 * 1024 ** 2 * 7 * 2


KINDS = sorted(f.stem for f in (spec.HERE / "traffic").glob("*.py")
               if f.stem not in ("__init__", "common"))


@pytest.mark.parametrize("name", ["lvl64-galmul", "lvl256-sboxpbs"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("blocks,requests", [(1, 1), (1, 3), (16, 1),
                                             (16, 3)])
def test_frozen_blind_rotation_counts(name, kind, blocks, requests):
    """Where a configuration states no rotation count, one a bootstrapped
    bit: per block 10 rounds x 128 bits; a fresh key adds 1,600 a request
    (the latency path's 11 scans of 32 + 9 x 288 + 256 lanes = 2,880 with
    its block)."""
    reader = spec.metric_reader("cmux_roofline")
    circuit = spec.config(name)["circuit"]
    assert not {"round_blind_rotations", "key_schedule_blind_rotations"} \
        & set(circuit)
    fresh = 1600 if kind == "fresh_key" else 0
    assert reader.blind_rotations(circuit, kind, blocks, requests) == \
        blocks * 10 * 128 + requests * fresh
