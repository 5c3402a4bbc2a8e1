"""The port's bench entry points (tfhe_aes2_tpu_torch/bench.py and
bench_round.py) on the CPU: the JSON line's keys against the JAX package's
bench.py, verification of every output, the stall rejection, the kept-dot
op count, the stage dissection, and the refusal to run without a card.

run() goes through PARAMS_TEST, added to bench.PARAMS by the test alone: a
10-round, 10-block batch at PARAMS_TEST_N256 ("test") takes minutes on the
CPU's plain versions, at PARAMS_TEST seconds; the same code runs either
way."""

import ast
import json
import pathlib

import pytest
import torch

from tfhe_aes2_tpu_torch import bench, bench_round
from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as model
from tfhe_aes2_tpu_torch.ops import params as tparams

REPO = pathlib.Path(__file__).resolve().parent.parent
STAGES = {"ks", "pbs", "pfks", "vp"}


def _bench_py_keys():
    """(top-level keys, secondary keys) of the JSON line the JAX package's
    bench.py prints, read from its source: the dict holding "ttfb_s", its
    "secondary" dict and the keys assigned into `latency`, which it
    unpacks there."""
    tree = ast.parse((REPO / "bench.py").read_text())
    top = next(n for n in ast.walk(tree) if isinstance(n, ast.Dict)
               and any(isinstance(k, ast.Constant) and k.value == "ttfb_s"
                       for k in n.keys))
    names = [k.value if k is not None else None for k in top.keys]
    secondary = top.values[names.index("secondary")]
    latency = {n.slice.value for n in ast.walk(tree)
               if isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store)
               and isinstance(n.value, ast.Name) and n.value.id == "latency"}
    return ({k for k in names if k is not None},
            {k.value for k in secondary.keys if k is not None} | latency)


def test_run_on_the_cpu_has_bench_py_keys_and_verifies(monkeypatch):
    """One block, 10 rounds, compressed to q' = 2^16, latency and stages on:
    run returns bench.py's keys with the TPU's two renamed and the card,
    device and lowering added; the batch verified (else "error") and the
    1-block, fused and 10-block outputs too (else run raises)."""
    monkeypatch.setitem(bench.PARAMS, "test-n64", tparams.PARAMS_TEST)
    res = bench.run("test-n64", n_blocks=1, rounds=10, reps=1, compress=16,
                    device="cpu")
    top, secondary = _bench_py_keys()
    assert "channel_ready_s" in top
    assert {"cmux_scan_mxu_utilization",
            "cmux_scan_mxu_utilization_def"} <= secondary
    assert set(res) == top - {"channel_ready_s"} | {"context_ready_s"}
    assert set(res["secondary"]) == (
        secondary - {"cmux_scan_mxu_utilization",
                     "cmux_scan_mxu_utilization_def"}
        | {"cmux_scan_int8_peak_share", "cmux_scan_int8_peak_share_def",
           "card", "device", "lowering"})
    sec = res["secondary"]
    assert "error" not in res and res["value"] > 0
    assert res["metric"] == "fhe_aes128_ctr_blocks_per_s"
    assert res["output"] == "compressed-q16" and res["reps_kept"] == 1
    assert res["vs_baseline"] == pytest.approx(res["value"] * 240)
    assert sec["params"] == "test-n64" and sec["card"] is None
    assert sec["device"] == "cpu" and res["context_ready_s"] is None
    assert sec["lowering"] == ["gridg", "fused", False]
    assert set(sec["stage_ms_per_round"]) == STAGES
    assert sec["cmux_scan_int8_peak_share"] == pytest.approx(
        bench.int8_peak_share(tparams.PARAMS_TEST, 1,
                              sec["stage_ms_per_round"]["pbs"]))
    assert sec["circuit_bootstraps_per_s"] == pytest.approx(
        160 * res["value"])
    for key in ("reused_key_latency_s", "latency_1block_s",
                "latency_1block_fused_s", "scenario_10_outputs_s"):
        assert sec[key] > 0
    assert sec["latency_1block_s"] <= sec["latency_1block_fused_s"]
    json.dumps(res)


@pytest.mark.parametrize("reps,mean,kept,median", [
    ([1.0, 1.1, 0.9, 5.0, 1.05], 1.0125, 4, 1.05),
    ([117.86, 1.32], 59.59, 2, 117.86),       # two reps: the upper median
    ([1.0, 1.0, 1.0, 10.0], 1.0, 3, 1.0),
    ([2.0, 2.9, 3.1], 8.0 / 3, 3, 2.9),
])
def test_stall_rejection(reps, mean, kept, median):
    """bench.py's rule: reps above 1.5 x the median (sorted[len // 2]) are
    dropped, the figure is the mean of the rest."""
    got_mean, got_kept, got_median = bench.stall_rejected(reps)
    assert got_mean == pytest.approx(mean)
    assert len(got_kept) == kept and got_median == median


@pytest.mark.parametrize("name,ops16", [
    ("lvl64", 599_711_652_249_600),
    ("lvl64mxu", 485_766_438_322_176),
    ("test", 755_914_244_096),
])
def test_kept_dot_ops_equal_bench_py(name, ops16):
    """bench.py:307-329's count at 16 blocks (k1 · R · dots · lanes · N² ·
    2 · n, 11 kept dots at js = 2 and two digit limbs in each set), linear
    in the blocks, and its share of the H100's 1,979 TOPS."""
    p = bench.PARAMS[name]
    assert bench.kept_dot_ops(p, 16) == ops16
    assert bench.kept_dot_ops(p, 1) * 16 == ops16
    assert bench.int8_peak_share(p, 16, 1000.0) == pytest.approx(
        ops16 / 1979e12)
    assert bench.PEAK_INT8_OPS == 1979e12


def test_stage_dissection_returns_the_four_stages():
    """ks, pbs, pfks and vp in ms, each positive, at one block."""
    p = tparams.PARAMS_TEST
    client, ctx = model.generate_keys(p, seed=11, device="cpu")
    out = bench.stage_dissection(client, ctx, p, 1, "cpu")
    assert set(out) == STAGES and all(v > 0 for v in out.values())


def test_no_card_raises(monkeypatch):
    """--device cuda (the default) on a host without a CUDA device raises
    before anything runs; neither entry point falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (bench.main, bench_round.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--device", "cuda"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])


def test_bench_round_main_at_the_test_set(monkeypatch, capsys):
    """bench_round.main at PARAMS_TEST_N256, one block, BENCH_WHICH=ks,pbs,vp:
    exit 0 and a last stdout line with those three stages' times."""
    for key, value in (("BENCH_PARAMS", "test"), ("BENCH_BLOCKS", "1"),
                       ("BENCH_ITERS", "1"), ("BENCH_WHICH", "ks,pbs,vp")):
        monkeypatch.setenv(key, value)
    assert bench_round.main(["--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["card"] is None and set(res["stages"]) == {"ks", "pbs", "vp"}
    assert all(s["steady_ms"] > 0 and s["first_s"] > 0
               for s in res["stages"].values())
    with pytest.raises(ValueError, match="unknown stages"):
        bench_round.run("test", 1, 1, ("ks", "mix"), "cpu")
