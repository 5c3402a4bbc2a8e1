"""Standing multi-process gate: an executed, decrypt-verified run of the
lane-sharded program at production geometry across processes (the JAX
package's multichip_gate.py).

N single-device processes (parallel/distributed.py, layout `lanehost`) run
one block through 1 round at PARAMS_SQRD_LVL_64 (keyswitch, 677-step blind
rotation, pfKS, vertical packing), the 16-byte axis split N ways across the
processes, each process decrypt-verifying its bytes against the plain
oracle. The processes meet through a file:// rendezvous in a fresh
temporary directory, so no port is picked and released before it is bound;
tcp:// is used only with an explicit --coordinator host:port, as on a real
multi-host launch. On "cuda" the kernels are built once here, before the
processes start (each would otherwise run nvcc itself).

    python -m tfhe_aes2_tpu_torch.parallel.gate --processes N --out PATH \\
        --backend gloo [--device cuda|cpu] [--params lvl64] [--rounds 1]

The record goes to --out only. Prints "ok: gate ..." and exits 0 when every
process verified; exits 1 otherwise, the processes' output tails in the
record. On a timeout the gate kills its own children by PID.
"""

from __future__ import annotations

import argparse
import datetime
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from tfhe_aes2_tpu_torch.parallel.distributed import BACKENDS, PARAMS

ROOT = Path(__file__).resolve().parents[2]


def run_processes(cmds, timeout: float, cwd=ROOT):
    """Start every command, wait for all within one shared `timeout`
    (seconds). Returns (return codes, outputs, timed_out); on a timeout
    each child still running is killed by its own PID."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=cwd)
             for cmd in cmds]
    deadline = time.time() + timeout
    outs, timed_out = [], False
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(0.1, deadline - time.time()))[0])
    except subprocess.TimeoutExpired:
        timed_out = True
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate()[0] for p in procs]
    return [p.returncode for p in procs], outs, timed_out


def worker_command(rank: int, n: int, init: str, args) -> list[str]:
    return [sys.executable, "-m", "tfhe_aes2_tpu_torch.parallel.distributed",
            "--backend", args.backend, "--init-method", init,
            "--num-processes", str(n), "--process-id", str(rank),
            "--device", args.device, "--params", args.params,
            "--rounds", str(args.rounds), "--blocks-per-device", "1",
            "--layout", "lanehost", "--timeout", str(args.timeout)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tfhe_aes2_tpu_torch.parallel.gate")
    ap.add_argument("--processes", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--backend", required=True, choices=BACKENDS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--params", choices=tuple(PARAMS), default="lvl64")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--coordinator", default=None,
                    help="host:port: meet over tcp:// instead of file://")
    ap.add_argument("--timeout", type=float, default=1800.0)
    args = ap.parse_args(argv)
    n = args.processes
    if n < 1 or 16 % n:
        ap.error(f"--processes {n} must divide the 16 bytes of a block")

    t0 = time.time()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda on a host without CUDA")
        from tfhe_aes2_tpu_torch.ops.kernels import build
        build.build_all()
    build_s = time.time() - t0
    with tempfile.TemporaryDirectory(prefix="tfhe_gate_") as tmp:
        init = (f"tcp://{args.coordinator}" if args.coordinator
                else f"file://{tmp}/rendezvous")
        rcs, outs, timed_out = run_processes(
            [worker_command(r, n, init, args) for r in range(n)],
            args.timeout)
    ok = not timed_out and all(
        rc == 0 and f"ok: process {r} verified" in out
        for r, (rc, out) in enumerate(zip(rcs, outs)))
    wall = time.time() - t0
    record = {
        "date": datetime.date.today().isoformat(),
        "params": args.params,
        "layout": "lanehost",
        "processes": n,
        "lane_shards": n,
        "blocks": 1,
        "rounds": args.rounds,
        "backend": args.backend,
        "rendezvous": "tcp" if args.coordinator else "file",
        "device": (torch.cuda.get_device_name(0) if args.device == "cuda"
                   else "cpu"),
        "executed": True,
        "decrypt_verified": ok,
        "timed_out": timed_out,
        "build_s": round(build_s, 1),
        "wall_s": round(wall, 1),
        "worker_lines": [next((ln for ln in out.splitlines()
                               if ln.startswith("ok: process")), None)
                         for out in outs],
        "error": None if ok else "\n".join(
            f"--- process {r} rc={rc} ---\n{out[-1500:]}"
            for r, (rc, out) in enumerate(zip(rcs, outs))),
    }
    Path(args.out).write_text(json.dumps(record, indent=1) + "\n")
    if not ok:
        print(f"gate FAILED in {wall:.1f} s -> {args.out}", file=sys.stderr)
        return 1
    print(f"ok: gate verified {n} processes x 1 device, layout lanehost, "
          f"{args.params}, {args.rounds} round(s), {args.backend}, in "
          f"{wall:.1f} s -> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
