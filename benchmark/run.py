"""Run one cell of the benchmark once, from the root of a checkout:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
--trace 0, its per-layer metrics from a torch.profiler trace of the window
with --trace 1), `device`, with --trace 1 `breakdown`, and last `check`:
each number the reference compared, beside its limit (also the last lines
of standard error). Exits non-zero, with no result, where there is no
CUDA device or fewer than the cell asks for, where the program cannot be
imported, or where JAX or the JAX package was loaded by the time the
window closed."""

from __future__ import annotations

import argparse
import json
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "tfhe_aes2_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (tfhe_aes2_tpu_torch, the port, is not)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number")

    import torch

    from benchmark import harness, spec
    cells = {w["name"]: w for w in spec.benchmark()["workloads"]}
    if args.workload not in cells:
        ap.error(f"no cell {args.workload} in BENCHMARK.json")
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, v in out["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
