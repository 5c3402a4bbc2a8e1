"""Where the time of one latency-path request, or of one steady batch, goes
on the card:

    python3 tfhe_aes2_tpu_torch/csrc/probes/latency_trace.py [--blocks N]

Keygen at PARAMS_SQRD_LVL_64 (seed 0) under the default lowering. With no
--blocks (or 0): one latency-path request (1 block, key expansion and 10
rounds in 11 blind rotations). With --blocks N: the key expanded once
(key_schedule_staged), then the bench's steady rep (tfhe_aes2_tpu_torch
/bench.py): N CTR blocks through encrypt_blocks_staged, 10 rounds, the
output compressed to q' = 2^16 and read back to the host. The work runs
once as a warm-up (the kernels' build included), again timed by the host
clock, then again under torch.profiler (CPU and CUDA activity), and is
decrypted against the AES authority. From the trace's device events it
prints the device's busy time (the union of kernel intervals), the idle
share of the unprofiled run's wall time that leaves (kernel times do not
change under the profiler), and the device time by kernel
group (K1, K2, K3, K4, torch's own kernels), then a JSON line of the same.
The profiler adds host time to every launch, so the profiled wall time is
longer than the warm-up's; the device times are the kernels' own.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))
from tfhe_aes2_tpu_torch.aes_128 import aes_lib, fhe, scenario  # noqa: E402
from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as model  # noqa: E402,E501
from tfhe_aes2_tpu_torch.ops import compression, keys, params  # noqa: E402,E501
from tfhe_aes2_tpu_torch.ops.lowering import Lowering  # noqa: E402

KEY = bytes.fromhex("76b8e0ada0f13d90405d6ae55386bd28")
IV = bytes.fromhex("bdd219b8a08ded1a")
GROUPS = (("K1 extprod_step2g", "extprod_step2g_kernel"),
          ("K2 rot_diff_digits", "rot_diff_digits_kernel"),
          ("K3 extprod_grouped_fused", "extprod_grouped_fused_kernel"),
          ("K4 fused_limb_matmul", "fused_limb_matmul_kernel"))


def group_of(name: str) -> str:
    for label, key in GROUPS:
        if key in name:
            return label
    return "torch kernels"


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def work(client, ctx, strategy, blocks: int):
    """(run, check): run() does the traced work once and returns its
    output, check(output) is whether it decrypts to the AES keystream."""
    if blocks == 0:
        request = scenario.encrypt_request(client, ctx, strategy, KEY,
                                           scenario.ctr_blocks(IV, 1))
        expect = aes_lib.encrypt_blocks(KEY, scenario.ctr_blocks(IV, 1))
        return (lambda: scenario.serve_request(ctx, strategy, *request,
                                               rounds=10)[0],
                lambda out: scenario.read_response(client, ctx, strategy,
                                                   out) == expect)
    clear = scenario.ctr_blocks(IV, blocks)
    key_ct, block_cts = scenario.encrypt_request(client, ctx, strategy, KEY,
                                                 clear)
    eks = fhe.key_schedule_staged(strategy, ctx, key_ct)
    return (lambda: compression.wire_array(compression.compress_bits(
                fhe.encrypt_blocks_staged(strategy, ctx, eks, block_cts,
                                          10).array, ctx.sks, ctx.params,
                16), 16),
            lambda out: compression.decrypt_blocks_compressed(
                client, out, 16) == aes_lib.encrypt_blocks(KEY, clear))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=0,
                    help="trace a steady batch of this many blocks (0: one "
                    "latency-path request)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("latency_trace: no CUDA device", file=sys.stderr)
        return 1
    p = params.PARAMS_SQRD_LVL_64
    strategy = fhe.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt
    client, raw = keys.generate_keys(p, seed=0, device="cuda")
    ctx = model.context_from_keys(p, raw, lowering=Lowering())
    run, check = work(client, ctx, strategy, args.blocks)
    what = (f"{args.blocks}-block steady rep" if args.blocks
            else "latency path")
    run()  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    out = run()
    torch.cuda.synchronize()
    wall_plain = time.time() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        out = run()
        torch.cuda.synchronize()
        wall_prof = time.time() - t0
    if not check(out):
        raise AssertionError(f"{what}: keystream mismatch")
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("latency_trace: the profiler recorded no device events",
              file=sys.stderr)
        return 1
    by_group: dict = {}
    for e in kernels:
        g = by_group.setdefault(group_of(e.name), [0, 0.0])
        g[0] += 1
        g[1] += e.time_range.elapsed_us()
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    print(f"{what}: {wall_plain:.3f} s unprofiled, {wall_prof:.3f} s "
          f"profiled; device busy {busy / 1e6:.3f} s = idle "
          f"{1 - busy / 1e6 / wall_plain:.1%} of the unprofiled run "
          f"({1 - busy / span:.1%} of the profiled span from first to last "
          "kernel)")
    for label, (count, us) in sorted(by_group.items(), key=lambda x: -x[1][1]):
        print(f"  {label}: {count} launches, {us / 1e6:.4f} s device time")
    if not any(label in by_group for label, _ in GROUPS):
        print("  (the trace attributes no device time to the port's kernels; "
              "its key_averages by device time follow)")
        print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                        row_limit=15))
    print(json.dumps({"work": what, "wall_s": wall_plain,
                      "wall_profiled_s": wall_prof, "device_busy_s": busy / 1e6, "span_s": span / 1e6,
                      "groups": {k: {"launches": c, "device_s": us / 1e6}
                                 for k, (c, us) in by_group.items()},
                      "device": torch.cuda.get_device_name(0),
                      "card": subprocess.run(
                          ["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
