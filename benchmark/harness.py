"""One run of one cell: set-up, the measured window, the trace's per-layer
metrics and the comparison that decides `correct`.

Set-up (counted in setup_s, from the process's start to the window's):
import, keygen from the seed, key preparation and the port's warm-up
(program.py), the traffic kind's pool of client-encrypted requests and its
own set-up such as a key expanded once, then one warm pass at the cell's
shapes. The window: requests back to back, one client that waits for each
answer (a closed loop), until `seconds` have passed; the last request runs
to its end. Each request runs from its ciphertexts on the host to its wire
words on the host. After the window: the peak device memory, the program's
state freed, then the reference's check of every answer."""

from __future__ import annotations

import contextlib
import gc
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import program, spec
from benchmark import trace as trace_mod
from benchmark.program import log, sync
from benchmark.reference import check, secret_key

TRAFFIC_STREAM = 0x74726166      # the traffic's draws apart from keygen's


def since_start() -> float:
    """Seconds since this process started (/proc: 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


@contextlib.contextmanager
def env(values: dict):
    """The environment with `values` set, restored after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: torch.device, params=None, mix_changes=None,
             control: bool = False, rounds: int = 10) -> dict:
    """-> the result line's object (`check` last). params / mix_changes /
    rounds replace the configuration's set, parts of the mix and the AES
    rounds a request runs (the CPU tests; the reference then checks the
    reference crate's partial AES); control=True runs the configuration's
    lower-precision control (its `control_env`)."""
    bench = spec.benchmark()
    wl = spec.workload(cell)
    cfg = spec.config(wl["config"])
    mix = dict(spec.mix(wl["traffic"]), **(mix_changes or {}))
    kind = spec.kind(mix["kind"])
    e2e, per_layer = spec.cell_metrics(bench, cell)
    with env(cfg["control_env"] if control else {}):
        session = program.open_session(cfg, seed, device, params)
        n_lwe = session.params.lwe_dimension
        t0 = time.time()
        pool = kind.build(session, mix,
                          np.random.default_rng([seed, TRAFFIC_STREAM]))
        sync(device)
        log(f"pool of {len(pool.requests)} requests and the kind's set-up "
            f"{time.time() - t0:.3f} s")
        t0 = time.time()
        kind.warm(session, pool, mix, rounds)
        sync(device)
        log(f"warm pass {time.time() - t0:.3f} s")
        setup_s = since_start()
        log(f"set-up {setup_s:.3f} s")

        answers = []
        prof = (profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
                if trace else contextlib.nullcontext())
        with prof:
            with record_function(trace_mod.WINDOW):
                t0 = time.perf_counter()
                while True:
                    req = pool.requests[len(answers) % len(pool.requests)]
                    with record_function("bench.request"):
                        words = kind.serve(session, pool, req, rounds)
                    answers.append((req.key, req.blocks, words))
                    if time.perf_counter() - t0 >= seconds:
                        break
                window_s = time.perf_counter() - t0
        requests = len(answers)
        blocks = sum(len(a[1]) for a in answers)
        log(f"window {window_s:.3f} s: {requests} requests, {blocks} blocks")
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    session.close()
    del pool, session
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    metrics, breakdown = {}, None
    if trace:
        t0 = time.time()
        tv, breakdown = trace_mod.view(trace_mod.raw_events(prof), requests,
                                       blocks, cfg, mix)
        del prof
        dev.update(busy_s=tv.busy_s, window_s=tv.window_s)
        for entry in per_layer:
            value = spec.metric_reader(entry["name"]).read(tv, entry)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
        log(f"trace read in {time.time() - t0:.3f} s: {len(tv.ops)} device "
            f"ops, busy {tv.busy_s:.6f} of {tv.window_s:.6f} s")
    else:
        # each all work over all of the window
        values = {"blocks_per_s": blocks / window_s,
                  "request_s": window_s / requests, "setup_s": setup_s}
        for entry in e2e:
            metrics[entry["name"]] = {"value": values[entry["name"]],
                                      "unit": entry["unit"]}

    t0 = time.time()
    got = check.compare(answers, secret_key.small_lwe_key(seed, n_lwe),
                        cfg["compress_log2q"], rounds)
    log(f"reference check {time.time() - t0:.3f} s over {got['answers']} "
        "answers")
    limits = wl["limits"]
    numbers = {k: {"value": got[k], "limit": limits[k]} for k in limits}
    correct = all(v["value"] <= v["limit"] for v in numbers.values())
    out = {"correct": correct, "attempted": requests,
           "failed": got["failed_requests"], "metrics": metrics,
           "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = numbers
    return out
