"""Dissect one production AES round on one CUDA device: where does the time go?

    python -m tfhe_aes2_tpu_torch.bench_round [--device cuda|cpu]

The port of the JAX package's bench_round.py. Times, at BENCH_BLOCKS blocks
(default 4) of the set BENCH_PARAMS (lvl64 by default; bench.PARAMS's
names):
  ks     big->small keyswitch of all 128·blocks bits
  pbs    the scaling PBS (a full n-step blind rotation) of all bits
  pfks   the fused pfKS (all k+1 functions) of the PBS outputs
  ggsw   ks + pbs + pfks (the circuit bootstrap's front end)
  vp     the vertical packing of an 8->24 LUT under the GGSWs
  cbs    circuit_bootstrap_vertical_packing
  round  one middle round (cbs + ShiftRows + MixColumns + AddRoundKey)

Env: BENCH_BLOCKS, BENCH_WHICH (csv of the stages above, all by default),
BENCH_ITERS (default 3), BENCH_PARAMS. --device defaults to cuda and a host
without a CUDA device raises (bench.bench_device).

What a figure holds: host seconds from a synchronised device to the next
synchronisation after one call, the least of BENCH_ITERS calls after a
first one (logged apart). That is the device's time for the stage's
kernels and torch operations, plus whatever of the host's work the device
waits on: the enqueue of each launch (the blind rotation enqueues one or
two launches a CMux step, n steps), torch's allocator, and in `round` the
model's host-side noise and component tracking of its XORs. No readback:
the stage's output stays on the device. The last line of stdout is one
JSON object {stage: {"first_s", "steady_ms"}} with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from tfhe_aes2_tpu_torch.aes_128 import sbox_gal_mul_pbs as pipe
from tfhe_aes2_tpu_torch.bench import PARAMS, bench_device, card, time_stage
from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as model
from tfhe_aes2_tpu_torch.ops import blind_rotate as br
from tfhe_aes2_tpu_torch.ops import circuit_bootstrap as cbs
from tfhe_aes2_tpu_torch.ops import keyswitch as ks
from tfhe_aes2_tpu_torch.ops.torus import to_tensor

STAGES = ("ks", "pbs", "pfks", "ggsw", "vp", "cbs", "round")


def log(msg: str) -> None:
    print(f"[round] {msg}", file=sys.stderr, flush=True)


def run(params_name: str = "lvl64", blocks: int = 4, iters: int = 3,
        which=STAGES, device="cuda") -> dict:
    """{stage: {"first_s", "steady_ms"}} for each stage in `which`."""
    dev = bench_device(device)
    unknown = set(which) - set(STAGES)
    if unknown:
        raise ValueError(f"BENCH_WHICH: unknown stages {sorted(unknown)}")
    p = PARAMS[params_name]
    client, ctx = model.generate_keys(p, seed=3, device=dev)
    sks, low = ctx.sks, ctx.lowering
    log(f"device={dev} card={card(dev)} params={params_name} blocks={blocks} "
        f"N={p.polynomial_size} k={p.glwe_dimension} n={p.lwe_dimension} "
        f"lowering=({low.br}, {low.vp})")

    rng = np.random.default_rng(0)
    nbits = blocks * 128
    big = to_tensor(client.encrypt_bits(rng.integers(0, 2, nbits)), dev)
    lut24 = to_tensor(cbs.generate_lut(
        8, 24, lambda v: int(rng.integers(0, 1 << 24)), p), dev)
    out = {}

    def timed(name, fn):
        res, first, best = time_stage(fn, dev, iters)
        out[name] = {"first_s": first, "steady_ms": best * 1e3}
        log(f"{name:6s} first {first:8.3f}s  steady {best * 1e3:10.3f}ms")
        return res

    def stage(name, fn):
        return timed(name, fn) if name in which else fn()

    dual = stage("ks", lambda: ks.keyswitch(big, sks.ksk, p))
    if {"pbs", "pfks"} & set(which):
        lwe1 = stage("pbs", lambda: br.pbs_bit_to_level(
            dual, sks.bsk, p.cbs_base_log, p, low))
        if "pfks" in which:
            timed("pfks", lambda: ks.pfks_all(lwe1, sks.pfpksk, p))
    if {"ggsw", "vp"} & set(which):
        ggsw = stage("ggsw", lambda: cbs.circuit_bootstrap_bits(
            big, sks, p, low))
        if "vp" in which:
            ggsw_b = ggsw.reshape((blocks, 16, 8) + ggsw.shape[1:])
            timed("vp", lambda: cbs.vertical_packing(ggsw_b, lut24, p,
                                                     sks.vp_js, low))
    big_b = big.reshape(blocks, 16, 8, -1)
    if "cbs" in which:
        timed("cbs", lambda: cbs.circuit_bootstrap_vertical_packing(
            big_b, lut24, sks, p, low))
    if "round" in which:
        key_arr = to_tensor(client.encrypt_bits(
            rng.integers(0, 2, nbits)).reshape(blocks, 16, 8, -1), dev)

        def round_fn():
            state = model.fresh_bitct(big_b, ctx, lane_ndim=2)
            key = model.fresh_bitct(key_arr, ctx, lane_ndim=2)
            return pipe.middle_round(ctx, state, key).array

        timed("round", round_fn)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tfhe_aes2_tpu_torch.bench_round")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    env = os.environ
    which = [w for w in env.get("BENCH_WHICH", ",".join(STAGES)).split(",")
             if w]
    dev = bench_device(args.device)
    res = run(env.get("BENCH_PARAMS", "lvl64"),
              int(env.get("BENCH_BLOCKS", "4")),
              int(env.get("BENCH_ITERS", "3")), which, dev)
    print(json.dumps({"card": card(dev), "stages": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
