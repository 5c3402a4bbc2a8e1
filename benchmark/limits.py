"""The readings that the limits of `correct` are set from, and the
control: one cell on many seeds in one process (set-up is paid a seed, the
import and the kernel load once), each run as the benchmark runs it with
--trace 0, printing the numbers compared:

    python3 -m benchmark.limits --workload <cell> --seeds 1,2,3 \
        --seconds <run_seconds> [--control]

--control runs the configuration's lower-precision control (its
`control_env`: one more limb plane dropped). A JSON line a seed, then one
summary line: for each number the largest reading (sound runs: the lower
reading) and the smallest (the control: the upper reading). The
benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import sys
import traceback

import torch

from benchmark import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.limits: no CUDA device", file=sys.stderr)
        return 2
    readings: dict = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        try:
            out = harness.run_cell(args.workload, seed, args.seconds, False,
                                   torch.device("cuda", 0),
                                   control=args.control)
        except Exception:       # a control that crashes has failed
            traceback.print_exc()
            print(json.dumps({"seed": seed, "control": args.control,
                              "crashed": True}), flush=True)
            continue
        for k, v in out["check"].items():
            readings.setdefault(k, []).append(v["value"])
        print(json.dumps({"seed": seed, "control": args.control,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "check": out["check"],
                          "metrics": out["metrics"]}), flush=True)
    print(json.dumps({"workload": args.workload, "control": args.control,
                      "max": {k: max(v) for k, v in readings.items()},
                      "min": {k: min(v) for k, v in readings.items()},
                      "n": {k: len(v) for k, v in readings.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
