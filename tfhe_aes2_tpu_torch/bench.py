"""Benchmark: FHE AES-128 CTR blocks/s on one CUDA device.

    python -m tfhe_aes2_tpu_torch.bench [--device cuda|cpu]

The port of the JAX package's bench.py. Runs the production parameter set
(sqrd_lvl_64, the reference's submitted configuration, main.rs:83) end to
end: seeded keygen, FHE key expansion (key_schedule_staged) and a batch of
CTR blocks through encrypt_blocks_staged with the output compressed to
q' = 2^16 on the device, decrypted by the client and checked against the
AES authority; then prints ONE JSON line, last on stdout, with bench.py's
keys {"metric", "value", "unit", "vs_baseline", "secondary", ...}.

Baseline: the same literature estimate as bench.py, 1/240 blocks/s (4 min a
block for tfhe-rs WoP-PBS AES-128 on a multi-core CPU; BASELINE.md, "the
provenance of the 1x mark"), labelled in the JSON's "baseline".

Env knobs, bench.py's with its defaults: BENCH_BLOCKS (16), BENCH_PARAMS
(lvl64 | lvl64mxu | test = PARAMS_TEST_N256), BENCH_ROUNDS (10), BENCH_REPS
(5), BENCH_COMPRESS (16; 0 reads back the raw big-key output), BENCH_LATENCY
(1), BENCH_STAGES (1), BENCH_AOT (1).
The kernels' schedule is the JAX package's TFHE_BR_KERNEL / TFHE_BR_GLUE /
TFHE_VP_FUSED / TFHE_VP_NTT environment (Lowering.from_env, as the CLI).
--device defaults to cuda, and a host without a CUDA device raises: the
bench never falls back to the CPU. --device cpu runs the plain versions of
the kernels (for tests; its times are the CPU's, not a device's).

Every timed region starts on an idle device and ends in the host readback
of the response (the compressed words as numpy), which waits for the
device: so it holds the device's time and the host's enqueue of every
launch where the host is the slower of the two. Nothing is compiled in a
timed region: the kernels are built by nvcc before the first launch, on a
background thread while keygen runs (aot.warmup_staged; BENCH_AOT=0 leaves
the build and the loads to the first launches). A first call still pays
CUDA's lazy module loads and the allocator's growth, so the 1-block,
latency and 10-block figures keep bench.py's second attempt.

The JSON keeps bench.py's keys and meanings except:
  secondary.cmux_scan_int8_peak_share(_def), in place of
      cmux_scan_mxu_utilization(_def): the same kept-dot op count of the
      blind rotation over (the pbs stage's ms x 1,979 TOPS, the H100 SXM
      dense int8 peak);
  context_ready_s, in place of channel_ready_s: the seconds the warm-up's
      device context and cuBLAS took (aot.WarmupHandle.context_ready_s);
  secondary.card (nvidia-smi's name and power limit; null on the CPU),
      secondary.device and secondary.lowering are new;
  key_expansion_incl_compile_s holds the run's wait on the warm-up (the
      build and the kernel loads) and the first key expansion.
BENCH_AOT_DUMP has no counterpart: the build store is written by the build
itself (ops/kernels/build.py). Before the JSON line, stderr gets each
kernel's launches over one steady rep (a line starting "[bench] launches").
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from tfhe_aes2_tpu_torch import aot
from tfhe_aes2_tpu_torch.aes_128 import aes_lib, fhe, fhe_encryption
from tfhe_aes2_tpu_torch.aes_128 import scenario
from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as model
from tfhe_aes2_tpu_torch.ops import blind_rotate as br
from tfhe_aes2_tpu_torch.ops import circuit_bootstrap as cbs
from tfhe_aes2_tpu_torch.ops import compression, decomposition
from tfhe_aes2_tpu_torch.ops import keys as keys_mod
from tfhe_aes2_tpu_torch.ops import keyswitch as ks
from tfhe_aes2_tpu_torch.ops import params as params_mod
from tfhe_aes2_tpu_torch.ops import torus, truncation
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx
from tfhe_aes2_tpu_torch.ops.kernels import matmul as kmm
from tfhe_aes2_tpu_torch.ops.lowering import Lowering

BASELINE_BLOCKS_PER_S = 1.0 / 240.0
PEAK_INT8_OPS = 1979e12      # H100 SXM dense int8 tensor-core rate, ops/s
PARAMS = {"lvl64": params_mod.PARAMS_SQRD_LVL_64,
          "lvl64mxu": params_mod.PARAMS_SQRD_LVL_64_MXU,
          "test": params_mod.PARAMS_TEST_N256}
KEY = bytes.fromhex("76b8e0ada0f13d90405d6ae55386bd28")
IV = bytes.fromhex("bdd219b8a08ded1a")
STRATEGY = fhe.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def bench_device(device) -> torch.device:
    """The device to run on; a CUDA device on a host without one raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench measures the card "
                           "(pass --device cpu to run the plain versions)")
    return device


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card(device: torch.device) -> str | None:
    """nvidia-smi's name and power limit of the card, None on the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[device.index or 0]


def time_stage(fn, device: torch.device, reps: int):
    """(fn's result, the first call's seconds, the least of `reps` more
    calls' seconds), each from a synchronised device to the next."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return out, first, best


def stall_rejected(reps: list[float]):
    """bench.py's stall rejection: reps above 1.5 x the median are dropped;
    -> (mean of the rest, the kept reps, the median)."""
    med = sorted(reps)[len(reps) // 2]
    kept = [r for r in reps if r <= 1.5 * med]
    return sum(kept) / len(kept), kept, med


def kept_dot_ops(params, n_blocks: int) -> int:
    """The blind rotation's int8 operations at n_blocks (bench.py's count):
    the kept limb-plane dots (i, j) with j >= the BSK's js and i + j < 8,
    (k+1) x (k+1)L rows, 128 lanes a block, N x N products a polynomial
    pair, 2 operations a multiply-add, n CMux steps."""
    js = truncation.bsk_j_start(params)
    n_d = torus.limbs_for_bound(
        decomposition.digit_bound(params.pbs_base_log))
    dots = sum(1 for j in range(js, 8) for i in range(n_d) if i + j < 8)
    k1 = params.glwe_dimension + 1
    n_poly = params.polynomial_size
    return (k1 * k1 * params.pbs_level * dots * n_blocks * 128 * n_poly
            * n_poly * 2 * params.lwe_dimension)


def int8_peak_share(params, n_blocks: int, pbs_ms: float) -> float:
    """kept_dot_ops over (pbs_ms x the H100's dense int8 peak)."""
    return kept_dot_ops(params, n_blocks) / (pbs_ms / 1e3) / PEAK_INT8_OPS


def launch_counts(ctx) -> dict:
    """The launch counters of the kernels ctx's lowering runs and K4's."""
    names = ctx.lowering.kernels(ctx.sks.vp_js) + ("fused_limb_matmul",)
    return {name: getattr(kmm if name == "fused_limb_matmul" else kx,
                          name).launches for name in names}


def stage_dissection(client, ctx, params, n_blocks: int, device) -> dict:
    """ks / pbs / pfks / vp ms at the bench batch (bench.py's
    _stage_dissection): the big->small keyswitch, the scaling PBS and the
    pfKS of n_blocks x 128 encrypted bits, and the 8->24 vertical packing
    under their GGSWs, each the least of 2 timed calls after a warm one.
    Each stage runs once a round a SubBytes batch, so these are ms a round."""
    dev = torch.device(device)
    p, sks, low = params, ctx.sks, ctx.lowering
    rng = np.random.default_rng(0)
    big = torus.to_tensor(client.encrypt_bits(
        rng.integers(0, 2, n_blocks * 128)), dev)
    lut24 = torus.to_tensor(cbs.generate_lut(
        8, 24, lambda v: int(rng.integers(0, 1 << 24)), p), dev)
    out = {}

    def timed(name, fn):
        res, _, best = time_stage(fn, dev, 2)
        out[name] = best * 1e3
        return res

    dual = timed("ks", lambda: ks.keyswitch(big, sks.ksk, p))
    lwe1 = timed("pbs", lambda: br.pbs_bit_to_level(dual, sks.bsk,
                                                    p.cbs_base_log, p, low))
    timed("pfks", lambda: ks.pfks_all(lwe1, sks.pfpksk, p))
    ggsw = cbs.circuit_bootstrap_bits(big, sks, p, low)
    ggsw = ggsw.reshape((n_blocks, 16, 8) + ggsw.shape[1:])
    timed("vp", lambda: cbs.vertical_packing(ggsw, lut24, p, sks.vp_js, low))
    log(f"stage ms/round: {out}")
    return out


def run(params_name: str = "lvl64", n_blocks: int = 16, rounds: int = 10,
        reps: int = 5, compress: int = 16, device="cuda",
        latency: bool = True, stages: bool = True,
        aot_on: bool = True) -> dict:
    """The body of bench.py's main: returns the JSON line's object, or
    bench.py's verify_failed object where the batch's keystream differs from
    the AES authority. The latency figures (rounds == 10) each raise
    RuntimeError where theirs differs."""
    dev = bench_device(device)
    params = PARAMS[params_name]
    lowering = Lowering.from_env()
    refusal = kx.device_refusal(params.polynomial_size, dev, lowering,
                                truncation.vp_ggsw_j_start(params))
    if refusal:
        raise ValueError(f"BENCH_PARAMS={params_name} on {dev}: {refusal}")
    smi = card(dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device={name} card={smi} params={params_name} blocks={n_blocks} "
        f"rounds={rounds} lowering=({lowering.br}, {lowering.vp}, "
        f"ntt={lowering.ntt})")

    handle = aot.warmup_staged(dev) if aot_on and aot.enabled(dev) else None
    t0 = time.time()
    client, raw = keys_mod.generate_keys(params, seed=11, device=dev)
    log(f"keygen {time.time() - t0:.3f}s ({client.keygen_stream} stream)")
    t0 = time.time()
    ctx = model.context_from_keys(params, raw, lowering=lowering)
    del raw
    sync(dev)
    log(f"key preparation {time.time() - t0:.3f}s")

    blocks_clear = scenario.ctr_blocks(IV, n_blocks)
    key_ct, block_cts = scenario.encrypt_request(client, ctx, STRATEGY, KEY,
                                                 blocks_clear)
    t_wait = 0.0
    if handle is not None:
        handle.attach(ctx)
        handle.wait()
        t_wait = handle.wait_s
        log(f"warm-up: context {handle.context_ready_s}s, build "
            f"{handle.build_s:.3f}s, {len(handle.loaded)} kernels loaded "
            f"in {handle.load_s:.3f}s, waited {t_wait:.3f}s")

    t0 = time.time()
    eks = fhe.key_schedule_staged(STRATEGY, ctx, key_ct)
    sync(dev)
    t_expand = time.time() - t0
    log(f"key expansion (first) {t_expand:.3f}s")

    def respond(out) -> np.ndarray:
        """The server's output read back: compressed wire words, or the raw
        big-key ciphertexts."""
        if compress:
            return compression.wire_array(compression.compress_bits(
                out.array, ctx.sks, params, compress), compress)
        return torus.to_numpy(out.array)

    def decrypt(resp) -> list[bytes]:
        if compress:
            return compression.decrypt_blocks_compressed(client, resp,
                                                         compress)
        return fhe_encryption.decrypt_blocks(client, resp)

    def batch(cts):
        return respond(fhe.encrypt_blocks_staged(STRATEGY, ctx, eks, cts,
                                                 rounds))

    t0 = time.time()
    resp = batch(block_cts)
    t_first = time.time() - t0
    log(f"blocks first run {t_first:.3f}s")

    times, launches = [], None
    for rep in range(reps):
        before = launch_counts(ctx)
        t0 = time.time()
        resp = batch(block_cts)
        times.append(time.time() - t0)
        if launches is None:
            launches = {k: v - before[k]
                        for k, v in launch_counts(ctx).items()}
        log(f"steady rep{rep} {times[-1]:.3f}s")
    t_steady, kept, med = stall_rejected(times)
    blocks_per_s = n_blocks / t_steady
    log(f"steady mean {t_steady:.3f}s over {len(kept)}/{len(times)} reps "
        f"(median {med:.3f}, spread {min(times):.3f}-{max(times):.3f}) -> "
        f"{blocks_per_s:.4f} blocks/s")

    if rounds == 10:
        ok = decrypt(resp) == aes_lib.encrypt_blocks(KEY, blocks_clear)
        log(f"verification vs AES authority: {ok}")
        if not ok:
            return {"metric": "fhe_aes128_ctr_blocks_per_s", "value": 0.0,
                    "unit": "blocks/s", "vs_baseline": 0.0,
                    "error": "verify_failed"}

    figures = {}
    if latency and rounds == 10:
        figures = latency_figures(client, ctx, key_ct, respond, decrypt, dev)

    stage_ms = (stage_dissection(client, ctx, params, n_blocks, dev)
                if stages else {})
    js = [truncation.bsk_j_start(params), truncation.ksk_j_start(params),
          truncation.pfpksk_j_start(params),
          truncation.vp_ggsw_j_start(params)]
    share = share_def = None
    if stage_ms.get("pbs"):
        share = int8_peak_share(params, n_blocks, stage_ms["pbs"])
        share_def = ("whole stage: kept-dot int8 ops / (pbs_ms x 1979 TOPS, "
                     "the H100 SXM dense int8 peak at 700 W); the "
                     "denominator holds the glue, the step loop's host "
                     "enqueue and the sample extract")
    log("launches over one steady rep: " + json.dumps(launches))
    return {
        "metric": "fhe_aes128_ctr_blocks_per_s",
        "value": blocks_per_s,
        "unit": "blocks/s",
        "vs_baseline": blocks_per_s / BASELINE_BLOCKS_PER_S,
        "baseline": "literature-estimate-1/240-blocks-per-s",
        "secondary": {
            "circuit_bootstraps_per_s": n_blocks * 16 * rounds / t_steady,
            "params": params_name,
            "js_bsk_ksk_pfpksk_vp": js,
            "stage_ms_per_round": stage_ms or None,
            "cmux_scan_int8_peak_share": share,
            "cmux_scan_int8_peak_share_def": share_def,
            "key_expansion_incl_compile_s": t_wait + t_expand,
            **figures,
            "card": smi,
            "device": name,
            "lowering": [lowering.br, lowering.vp, lowering.ntt],
        },
        "ttfb_s": t_wait + t_expand + t_first,
        "context_ready_s": (handle.context_ready_s if handle is not None
                            else None),
        "output": f"compressed-q{compress}" if compress else "raw-big-key",
        "reps_s": times,
        "reps_kept": len(kept),
    }


def latency_figures(client, ctx, key_ct, respond, decrypt, dev) -> dict:
    """bench.py's latency block at steady state, each output decrypted
    against the AES authority (RuntimeError where it differs): the key
    expansion again, one block under that key (the split path), one block
    through encrypt_block_latency (the fused path) and the exact 10-block
    scenario, the last three each on their second attempt."""
    def timed_twice(fn):
        for _ in range(2):
            t0 = time.time()
            out = fn()
            secs = time.time() - t0
        return out, secs

    def verify(resp, blocks, what):
        if decrypt(resp) != aes_lib.encrypt_blocks(KEY, blocks):
            raise RuntimeError(f"{what}: the keystream differs from the AES "
                               "authority")

    t0 = time.time()
    eks = fhe.key_schedule_staged(STRATEGY, ctx, key_ct)
    sync(dev)
    t_exp = time.time() - t0
    log(f"key expansion steady {t_exp:.3f}s")

    blk1_clear = scenario.ctr_blocks(IV, 1)
    blk1 = torus.to_tensor(STRATEGY.encrypt_client(client, blk1_clear), dev)
    out1, t_blk1 = timed_twice(lambda: respond(fhe.encrypt_blocks_staged(
        STRATEGY, ctx, eks, blk1, 10)))
    verify(out1, blk1_clear, "1-block split path")
    log(f"1-block split path {t_exp + t_blk1:.3f}s (expand {t_exp:.3f} + "
        f"block {t_blk1:.3f})")

    out_l, t_lat = timed_twice(lambda: respond(fhe.encrypt_block_latency(
        STRATEGY, ctx, key_ct, blk1)))
    verify(out_l, blk1_clear, "latency path")
    log(f"1-block latency (fused scans) {t_lat:.3f}s")

    blk10_clear = scenario.ctr_blocks(IV, 10)
    blk10 = torus.to_tensor(STRATEGY.encrypt_client(client, blk10_clear),
                            dev)
    out10, t_10 = timed_twice(lambda: respond(fhe.encrypt_blocks_staged(
        STRATEGY, ctx, eks, blk10, 10)))
    verify(out10, blk10_clear, "10-block scenario")
    log(f"10-output scenario {t_exp + t_10:.3f}s (expand {t_exp:.3f} + one "
        f"10-block batch {t_10:.3f})")
    return {"reused_key_latency_s": t_blk1,
            "latency_1block_s": min(t_lat, t_exp + t_blk1),
            "latency_1block_fused_s": t_lat,
            "scenario_10_outputs_s": t_exp + t_10}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tfhe_aes2_tpu_torch.bench")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    env = os.environ
    res = run(env.get("BENCH_PARAMS", "lvl64"),
              int(env.get("BENCH_BLOCKS", "16")),
              int(env.get("BENCH_ROUNDS", "10")),
              int(env.get("BENCH_REPS", "5")),
              int(env.get("BENCH_COMPRESS", "16")), args.device,
              latency=env.get("BENCH_LATENCY", "1") != "0",
              stages=env.get("BENCH_STAGES", "1") != "0",
              aot_on=env.get("BENCH_AOT", "1") != "0")
    print(json.dumps(res), flush=True)
    return 1 if "error" in res else 0


if __name__ == "__main__":
    sys.exit(main())
