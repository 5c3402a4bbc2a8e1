"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. device and build: the card's name and power limit, the nvcc build of
     every kernel from tfhe_aes2_tpu_torch/csrc/;
  2. kernel checks: K1 as the wrapper launches it (wgmma at N = 512 and
     1024, cmux_wg.cu) beside K1 on mma.sync (cmux.cu) at B in {1, 9, 32,
     64, 128, 160, 256, 288, 2048} at lvl64, and beside K5 then K2 at B in
     {1, 9, 32, 128, 160, 288, 2048} at lvl256 and B in {1, 16, 128} at the
     8-bit model's step, then K1-K11 at their
     PARAMS_SQRD_LVL_64 main-path shapes
     (K2 at B in {9, 128, 160, 256, 288}, K3 and K8 at the vertical
     packing's (lanes, G) in {(4, 8), (16, 8), (16, 24), (128, 1),
     (32, 24)}), each held bit-for-bit against its plain PyTorch version on
     the card, with median times (50 launches for kernels under 0.2 ms),
     each kernel's bound and the launch floor (an empty kernel timed the
     same way); and the cross-checks: K7's partial sums recombined equal
     K6's update (also with every byte -128), K8's equal K3 (also with
     every byte -128), K2 then K5 equals K1, K2 and K10a equal their plain
     versions and each other (K10a's flat layout is K2's permuted) for every
     gadget they are built for, and K6's update and one step
     of each of the schedules `merged` (K9), `longk` (K10a then K10b) and
     `bucket` (K2 then K11) equal K2 then K5, at B in {9, 128, 160, 256,
     288}, with the split of K10b's and of K11's rows at each B and the
     host's time to enqueue a `longk` and a `grid` step; K1, K5, K6, K9,
     K10b and K11, whose products run on the tensor cores, again over a
     grid of small and ragged shapes (N in {64, 256, 512}, B in {1, 9, 13,
     288}, js in {0, 2}, n_d in {1, 2, 3}; K11 split and unsplit) and at the
     extreme value -128 in every operand byte (K10b split at B=13, unsplit
     at B=201); and, as a yardstick printed beside them, the int8 rate one
     `torch._int_mm` reaches at K1's size (the port never calls it); at
     N = 1024 the longk, bucket and glue_out steps' kernels K6, K7, K10a,
     K10b and K11 (each row tile's columns two blocks of 512) at the steps
     of lvl1, lvl256 and the 8-bit model, B in {1, 9, 13, 160, 288}, the
     set's js and js in {0, 2}, K10b and K11 split and unsplit, every byte
     -128 at R = 12, K7's buckets recombined equal to K6's update, and K9
     (a lane tile's 2·O blocks one cluster) on its own glue's digits
     against its plain version and K2 then K5 over the same grid; and one
     step of each schedule against K2 then K5 at lvl256's and the 8-bit model's
     step, B in {9, 32, 128, 288}, timed at lvl256's B = 9 and 288 and the
     8-bit model's B = 32, with the splits chosen;
  3. fast end-to-end runs at PARAMS_TEST (2 rounds), decrypt-verified: the
     default lowering, then ("glue_out", "partials") with a compressed
     response, then the keystream server as a second OS process on the card
     (`python -m tfhe_aes2_tpu_torch.serve` under TFHE_BR_KERNEL=merged,
     loading a saved key bundle) answering one request whose two blocks it
     derives homomorphically from one uploaded block;
  4. the full-width run at PARAMS_SQRD_LVL_64 under the default lowering:
     seeded keygen, 2 CTR blocks through key_schedule_staged +
     encrypt_blocks_staged (10 rounds), then 1 block through
     encrypt_block_latency, each decrypted and checked against the AES
     authority, with every kernel's launch counter reset just before and
     read just after;
  5. the second path at full width, on the same keys and the same encrypted
     request as phase 4's single block: the latency path under
     Lowering("grid", "partials") (K2 + K5 per CMux step, K8 + torch
     recombination per vertical-packing stage), its ciphertext bit-equal to
     phase 4's and its compressed response (q' = 2^16) decrypted to the AES
     keystream; then one 160-lane blind rotation under "glue_out" (torch
     glue + K6 per step), bit-equal to the default schedule's, with K7 as
     K6's reference on that rotation's own operands. Launch counters reset
     and read around each;
  6. the third path at full width: the keystream server on phase 4's keys,
     saved to a bundle and loaded back (ops/serialization.py), serving on a
     thread of this process under Lowering("merged") so that the launch
     counters can be read. Request (a), phase 4's own encrypted key and
     single block: a fresh key, so the latency path, whose compressed answer
     must be byte-equal to the default lowering's; request (b), the same key
     with fhe_counter_count=2: an expanded-key cache hit, one homomorphic
     counter increment, ten rounds on the two derived blocks. Both decrypt
     to the AES authority's keystream. Then the counter derivation alone
     under the default, "longk" and "bucket" lowerings, bit-equal. Launch
     counters reset and read around each request and each derivation;
  7. the N = 1024 sets (lvl256, lvl1) at full width under the default
     lowering, decrypt-checked against the AES authority: lvl256 through
     cli.main with 1 block (the fused latency path) and with 2 (staged),
     and with 2 again under TFHE_BR_KERNEL=merged (K9 a CMux step), then
     under ShortintWoppbs1BitSboxPbsAesEncrypt (the depth-11 pipeline,
     its key expanded by the eager schedule), the lvl256 latency path under
     the default lowering and under ("grid", "partials"), ("longk",
     "fused"), ("bucket", "fused"), ("glue_out", "partials") and
     ("merged", "fused"), each bit-equal to the default's and decrypted to
     the AES keystream, the keystream server on a bundle of those lvl256
     keys under Lowering("merged") answering one fresh-key request (its
     compressed answer byte-equal to the default lowering's, decrypted to
     the AES keystream), then lvl1's SBOX+GalMul circuit bootstrap of one
     block's 16 bytes (its pfKS the K4 launch with four digit limbs;
     lvl1's noise budget stops the AES pipeline itself) and lvl4's under
     "longk" and "merged"; launch counters reset and read around each, K3's
     and K4's launches and the blind rotations tallied by shape; then K6,
     K9, K10a, K10b and K11 at each (B, js) of the rotations of the lvl256
     latency path's four lowerings and of lvl4's circuit bootstraps, and K3
     and K8 at the (lanes, G) the lvl256 latency
     path launched, each against its plain version, a row of the kernels
     JSON. Phase 2 also holds K1, K5 and K2 at N = 1024 (both N = 1024
     gadgets, B in {1, 9, 13, 288}, js in {0, 2}, every byte -128 at R = 12)
     and K4 at lvl1's pfKS and lvl256's keyswitch and pfKS against their
     plain versions, timed;
  8. the other two models at full width: the tree-PBS model's SBOX bit at
     PARAMS_TEST_S1 (255 bootstraps) and the 8-bit model's byte op
     (bootstrap_from_bits + extract_bits_from_ciphertext) at
     PARAMS_TEST_8BIT, each on the card and with the plain versions on the
     CPU on the same keys, bit-equal; the tree model's SBOX on 2 bytes at
     PARAMS_SHORTINT_1BIT (4,080 blind rotations, each tree level's
     selection product one K3 launch) decrypted to SBOX[x]; the 8-bit model
     through cli.main at PARAMS_WOPPBS_8BIT (N = 1024), 1 block, 2 rounds,
     under the default lowering, verified, then its 2 rounds again on the
     same keys and expanded key under (gridg, partials) (K8, no K3), under
     (longk, fused) (K10a + K10b, no K1) and under (merged, fused) (K9, no
     K1 or K2), each bit-equal to the verified run, and K6, K9, K10a, K10b
     and K11 against their plain versions at each (B, js) those longk and
     merged rounds launched. Launch counters reset and read around each
     run. Phase 2 also holds the two
     models' kernels against their plain versions: K1, K5, K2 (the new (7,
     6) build) and K10a at the tree's step (R = 35, one limb) and at the
     8-bit model's (N = 1024, R = 18), timed, with K6, K9, K10b and K11
     checked at the tree's step, which the CLI lets it run under glue_out,
     merged, longk and bucket, and with K10a timed there too at B = 2,048;
     K3 at the tree's selection product (R = 2, G = 1, O = 5), K3 and K8 at
     N = 1024 with one limb (their new split builds), and K4 at both models'
     keyswitches, the packing keyswitch and the 8-bit pfKS.
  9. the noise floors of the four sets, lvl64's end-to-end noise, a
     one-device mesh, the three 2-process gloo layouts and the gate
     (phase_scale_out);
  10. the last modules: lvl64 keygen through _KeygenRng (the native
     ChaCha20 stream where cmake builds native/, else numpy, as in the
     JAX package) and with the numpy stream, each timed, the first's keys
     equal to phase 4's; the CRT-NTT product (ops/ntt.py) at phase 2's
     vertical-packing shapes bit-equal to K3 on pre-truncated selectors
     and to itself on the CPU on random ones, each timed beside K3 and
     its float64 bound; the lvl64 latency path on phase 4's keys and
     request under Lowering(ntt=True) (no K3 launch), AES-verified,
     bit-equal to itself again with each distinct NTT call held against
     the CPU, and timed against the default in turns (ntt, default, ntt);
     the lvl256 latency path under it (5 kept planes: K3 as the fallback)
     bit-equal to phase 7's; and cli.main at lvl64 with one output as a
     subprocess with the warm-up (aot.py) and under TFHE_AOT=0, both
     verified, with the warm-up's context and wait seconds and both walls.
     The in-process runs of phases 3–9 take TFHE_AOT=0, as before the
     warm-up existed, so their launch counts are the paths' alone.
  11. the bench entry: K1 and K2 at B = 1280 and 2048, K3 at 256 lanes x
     G = 8 and 24, K4's keyswitch and pfKS at B = 2048 (with the
     torch._int_mm yardstick), each bit-equal to its plain version and
     timed (rows under the kernels JSON's `shapes`, labelled "bench"; the
     main-path rows stay phase 2's); lvl64mxu (k = 8, N = 256) through the CTR scenario,
     2 blocks x 10 rounds, AES-verified, then K1, K2 and K3 at the shapes
     its run launched them at; and `python -m tfhe_aes2_tpu_torch.bench`
     as a subprocess (lvl64, 16 blocks x 10 rounds, 3 reps, compressed to
     q' = 2^16, latency and stages on, its warm-up on): exit 0, every
     output AES-verified, its JSON line logged and its launches over one
     steady rep added to the kernels' counts.
The line before the last is the kernels JSON, each kernel's `shapes`
every shape it was held against its plain version at, with its
max_abs_err (ms and plain_ms null where the shape was not timed); the last
line is {"ok": true, "device": {...}}. Imports nothing of JAX or tfhe_aes2_tpu.

    python3 chip_smoke.py --kernels-only

stops after phase 2 and prints the kernels' measurements without the launch
counts and without the last line: the quick way to time a kernel change.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from tfhe_aes2_tpu_torch import cli, noise, serve
from tfhe_aes2_tpu_torch.aes_128 import SBOX, aes_lib, ctr_fhe, fhe, gf_256_mul
from tfhe_aes2_tpu_torch.aes_128 import plain, sbox_gal_mul_pbs, scenario
from tfhe_aes2_tpu_torch.models import shortint_1bit as tm1b
from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as model
from tfhe_aes2_tpu_torch.models import shortint_woppbs_8bit as tm8
from tfhe_aes2_tpu_torch.ops import blind_rotate, compression, decomposition
from tfhe_aes2_tpu_torch.ops import keys as keys_mod
from tfhe_aes2_tpu_torch.ops import ntt
from tfhe_aes2_tpu_torch.ops import params as params_mod
from tfhe_aes2_tpu_torch.ops import polynomial, serialization, torus, truncation
from tfhe_aes2_tpu_torch.ops.lowering import Lowering
from tfhe_aes2_tpu_torch.ops.kernels import build
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx
from tfhe_aes2_tpu_torch.ops.kernels import matmul as kmm
from tfhe_aes2_tpu_torch.parallel import distributed, gate, mesh

P = params_mod.PARAMS_SQRD_LVL_64
DEV = "cuda"
PEAK_INT8_OPS = 1979e12      # H100 SXM dense int8 tensor-core rate, ops/s
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 bytes/s
PEAK_FP64_OPS = 67e12        # H100 SXM dense float64 tensor-core rate, FLOP/s
KEY = bytes.fromhex("76b8e0ada0f13d90405d6ae55386bd28")
IV = bytes.fromhex("bdd219b8a08ded1a")

# int8_products: how each kernel computes its int8 products on the card —
# "mma.sync" (the tensor cores: nc_mma.cuh, matmul.cu) or None (the glue,
# no products)
KERNELS = {
    "extprod_step2g": dict(
        fn=kx.extprod_step2g, source="tfhe_aes2_tpu_torch/csrc/cmux.cu",
        source_wgmma="tfhe_aes2_tpu_torch/csrc/cmux_wg.cu",
        replaces="tfhe_aes2_tpu/ops/pallas/extprod.py:542",
        int8_products="wgmma at N = 512 and 1024, else mma.sync"),
    "rot_diff_digits": dict(
        fn=kx.rot_diff_digits, source="tfhe_aes2_tpu_torch/csrc/cmux.cu",
        replaces="tfhe_aes2_tpu/ops/pallas/extprod.py:386",
        int8_products=None),
    "extprod_grouped_fused": dict(
        fn=kx.extprod_grouped_fused, source="tfhe_aes2_tpu_torch/csrc/vp.cu",
        replaces="tfhe_aes2_tpu/ops/pallas/extprod.py:1154",
        int8_products="mma.sync"),
    "fused_limb_matmul": dict(
        fn=kmm.fused_limb_matmul, source="tfhe_aes2_tpu_torch/csrc/matmul.cu",
        replaces="tfhe_aes2_tpu/ops/pallas/matmul.py:82",
        int8_products="mma.sync"),
    "extprod_step2": dict(
        fn=kx.extprod_step2, source="tfhe_aes2_tpu_torch/csrc/cmux.cu",
        replaces="tfhe_aes2_tpu/ops/pallas/extprod.py:439",
        int8_products="mma.sync"),
    "extprod_step": dict(
        fn=kx.extprod_step, source="tfhe_aes2_tpu_torch/csrc/step.cu",
        replaces="tfhe_aes2_tpu/ops/pallas/extprod.py:307",
        int8_products="mma.sync"),
    "extprod_partials": dict(
        fn=kx.extprod_partials, source="tfhe_aes2_tpu_torch/csrc/step.cu",
        replaces="tfhe_aes2_tpu/ops/pallas/extprod.py:127",
        int8_products="mma.sync"),
    "extprod_partials_grouped": dict(
        fn=kx.extprod_partials_grouped,
        source="tfhe_aes2_tpu_torch/csrc/vp.cu",
        replaces="tfhe_aes2_tpu/ops/pallas/extprod.py:1071",
        int8_products="mma.sync"),
    "cmux_step_merged": dict(
        fn=kx.cmux_step_merged, source="tfhe_aes2_tpu_torch/csrc/merged.cu",
        source_n1024="tfhe_aes2_tpu_torch/csrc/merged_wide.cu",
        replaces="tfhe_aes2_tpu/ops/pallas/extprod.py:737",
        int8_products="mma.sync"),
    "rot_diff_digits_flat": dict(
        fn=kx.rot_diff_digits_flat,
        source="tfhe_aes2_tpu_torch/csrc/longk.cu",
        replaces="tfhe_aes2_tpu/ops/pallas/extprod.py:807",
        int8_products=None),
    "extprod_step_longk": dict(
        fn=kx.extprod_step_longk, source="tfhe_aes2_tpu_torch/csrc/longk.cu",
        replaces="tfhe_aes2_tpu/ops/pallas/extprod.py:892",
        int8_products="mma.sync"),
    "extprod_step3": dict(
        fn=kx.extprod_step3, source="tfhe_aes2_tpu_torch/csrc/bucket.cu",
        replaces="tfhe_aes2_tpu/ops/pallas/extprod.py:988",
        int8_products="mma.sync"),
}
# the library call timed beside a kernel (library_ms; the port never calls
# it): only K4's function has one, torch has no exact int8 negacirculant
# product
LIBRARY = {"fused_limb_matmul": "torch._int_mm per weight bucket + int64 "
                                "recombination"}
ROOT = Path(__file__).resolve().parent
STRATEGY = fhe.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt
# the kernels every model's default lowering launches
MAIN_PATH = ("extprod_step2g", "rot_diff_digits", "extprod_grouped_fused",
             "fused_limb_matmul")


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def _median_ms(fn, reps: int) -> float:
    """Median device time of `reps` launches of fn(), each between its own
    pair of events, all enqueued between two synchronisations behind a spin
    of the device (torch.cuda._sleep) that outlasts their enqueue: where the
    host takes longer to enqueue fn() than the device to run it (a wrapper
    costs ~30 us), events recorded on an idle device would time the host."""
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    sync()
    t0 = time.perf_counter()
    fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    sync()
    # ~2e6 cycles a ms at the H100's clock; a lower clock only spins longer
    torch.cuda._sleep(int(2e6 * min(200.0, 1.0 + 1.5 * reps * host_ms)))
    for start, end in events:
        start.record()
        fn()
        end.record()
    sync()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def enqueue_us(fn, reps: int = 50) -> float:
    """Host microseconds to enqueue one fn(): `reps` calls, none awaited,
    after one warm-up and a synchronisation."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    sync()
    return 1e6 * t / reps


def time_ms(fn, reps: int = 20) -> float:
    """Median device time of fn() over `reps` runs after one warm-up (20
    for the kernels: a median of 5 has been seen 20% off for one shape in
    one run); a kernel under 0.2 ms is near launch latency, where so few
    launches do not resolve it, and is timed again over 50."""
    fn()
    ms = _median_ms(fn, reps)
    return _median_ms(fn, 50) if ms < 0.2 else ms


def bound(macs: int, nbytes: int) -> tuple[float, str]:
    """Least time on the card: 2 ops per multiply-add at the int8 peak, or
    the bytes at the memory rate, whichever is larger."""
    t_ops = 2 * macs / PEAK_INT8_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pairs(n_d: int, js: int) -> int:
    """Limb-plane pairs (i, j) with j >= js and weight 2^(8(i+j)) < 2^64."""
    return sum(1 for i in range(n_d) for j in range(js, 8) if i + j < 8)


def rand_i8(gen, shape, lo=-128, hi=128):
    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int8,
                         device="cpu").to(DEV)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over the elements (0 exactly when bit-equal); int64
    differences are taken as exact Python ints, wrap-around included."""
    if torch.equal(a, b):
        return 0
    diff = (a.to(torch.int64) - b.to(torch.int64)).cpu().numpy()
    return max(abs(int(x)) for x in (diff.min(), diff.max())) or 1


def record(name: str, rows: list, macs: int, nbytes: int, ms, plain_ms,
           err: int) -> None:
    """A row of a kernel's comparison with its plain version at one shape:
    its max_abs_err and bound, and its times (ms, plain_ms) where the shape
    was timed, else None; fails on any difference. Only timed rows print."""
    b_ms, b_by = bound(macs, nbytes)
    rows.append(dict(name=name, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, max_abs_err=err, macs=macs,
                     nbytes=nbytes))
    if ms is not None:
        log(f"  {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms by {b_by}), max_abs_err {err}")
    if err != 0:
        raise AssertionError(f"{name} disagrees with its plain version")


# ------------------------------------------------------------------ phases

def phase_device() -> str:
    log("== phase 1: device and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    t0 = time.time()
    build.build_all()
    log(f"kernel build: {time.time() - t0:.1f} s (nvcc, sm_90a)")
    report = build.ptxas_report().splitlines()
    spills = [report[i - 1].split("'")[1] if i and "'" in report[i - 1]
              else ln for i, ln in enumerate(report)
              if "spill" in ln and " 0 bytes spill" not in ln]
    log(f"ptxas: {len(spills)} kernel instantiations report spills"
        + "".join(f"\n  {name}" for name in spills))
    # the main paths' instantiations: K1, K5 (K1 without glue), K6, K9 and
    # K10b (ND=2, JS=2), K7 (ND=2, JS=0, PARTIALS), K2 and K10a (ND=2, L=3,
    # base_log 12), K11 (ND=2), K3 and K8 (ND=2, JS=4), K4's keyswitch
    # (ND=1, JS=5) and pfKS (ND=3, JS=1)
    for i, ln in enumerate(report):
        if any(key in ln for key in (
                "step2g_kernelILi2ELi2ELb1E", "step2g_kernelILi2ELi2ELb0E",
                "rot_diff_digits_kernelILi2ELi3ELi12E",
                "rot_diff_digits_flat_kernelILi2ELi3ELi12E",
                "step_kernelILi2ELi2ELb0E", "step_kernelILi2ELi0ELb1E",
                "step3_kernelILi2E",
                "merged_kernelILi2ELi2E", "longk_kernelILi2ELi2E",
                "grouped_fused_kernelILi2ELi4E",
                "limb_matmul_kernelILi1ELi5E", "limb_matmul_kernelILi3ELi1E",
                # N = 1024 (the names above cover K1, K5, K3 and K8, whose
                # column split is chosen at run time): K3/K8 at lvl256's
                # js = 3, K2 at the two N = 1024 gadgets, K4 with four limbs
                "grouped_fused_kernelILi2ELi3E",
                "rot_diff_digits_kernelILi2ELi2ELi15E",
                "rot_diff_digits_kernelILi2ELi4ELi9E",
                "limb_matmul_kernelILi4ELi1E",
                # the other two models: K1 and K5 with one limb (ND=1,
                # JS=1), K2 and K10a at the tree's (7, 6), K2 at the 8-bit
                # model's (6, 7), K3's selection product (ND=1, JS=0), K3
                # and K8 split at N = 1024 with one limb (ND=1, JS=3), K4's
                # packing keyswitch (ND=1, JS=0) and the 8-bit pfKS (ND=2,
                # JS=1)
                "step2g_kernelILi1ELi1ELb1E", "step2g_kernelILi1ELi1ELb0E",
                "rot_diff_digits_kernelILi1ELi7ELi6E",
                "rot_diff_digits_flat_kernelILi1ELi7ELi6E",
                "rot_diff_digits_kernelILi1ELi6ELi7E",
                "grouped_fused_kernelILi1ELi0E",
                "grouped_fused_kernelILi1ELi3E",
                "limb_matmul_kernelILi1ELi0E",
                "limb_matmul_kernelILi2ELi1E",
                # longk, bucket and glue_out at N = 1024 (the column split
                # chosen at run time, no new builds): K10a at lvl256's
                # (4, 9), lvl1's (2, 15) and the 8-bit model's (6, 7); K6,
                # K10b and K11 with one limb (ND=1, JS=1)
                "rot_diff_digits_flat_kernelILi2ELi4ELi9E",
                "rot_diff_digits_flat_kernelILi2ELi2ELi15E",
                "rot_diff_digits_flat_kernelILi1ELi6ELi7E",
                "step_kernelILi1ELi1ELb0E", "longk_kernelILi1ELi1E",
                "step3_kernelILi1E",
                # K9 at N = 1024 (merged_wide.cu): lvl256's and lvl1's
                # (ND=2, JS=2), the 8-bit model's (ND=1, JS=1)
                "merged_wide_kernelILi2ELi2E", "merged_wide_kernelILi1ELi1E")):
            log("ptxas: " + " | ".join(x.strip() for x in report[i:i + 3]))
    return smi


def k11_split_of(b: int, n: int, nd: int, o: int, r: int, nj: int) -> int:
    """The split the K11 wrapper takes at this shape on this card."""
    return kx._bucket_splits(b, o, r, nj, kx._bucket_residency(n, nd), n)


def check_step_schedules(rows: dict, b: int, acc, t, ext, js: int, nd: int,
                         p=P, timed: bool = True, label: str = "",
                         dig=None):
    """K6, K9, K10a, K10b and K11 at batch b against their plain versions,
    K6's update and one step of `merged`, `longk` and `bucket` against K2
    then K5 on the same accumulator, mask element and BSK entry; then, if
    `timed`, each step timed as its schedule runs it. Each kernel's
    comparison is a row of rows[name] with its max_abs_err (K10b's at the
    wrapper's split and unsplit, K11's also with a row a block), timed if
    `timed`, else with ms and plain_ms None. p: the set whose gadget the
    glue takes (PARAMS_SQRD_LVL_64 by default). label: the rows' name
    prefix. dig: the digits K5, K6, K10b and K11 take, [k+1, L, n_d, B, N]
    (default K2's glue of acc; random or constant digits reach what the
    glue never gives); K9, which makes its own, is held against K2 then K5
    on the glue's."""
    lv, bl = p.pbs_level, p.pbs_base_log
    k1, _, n = acc.shape
    r = k1 * lv
    glue = kx.rot_diff_digits(acc, t, bl, lv, nd)
    own_glue = dig is None
    dig = glue if dig is None else dig
    macs = b * k1 * r * n * n * pairs(nd, js)
    want = kx.extprod_step2(dig, ext, acc.clone(), js)
    if not torch.equal(want, kx.extprod_step2_plain(dig, ext, acc.clone(),
                                                    js)):
        raise AssertionError(f"K5 differs from plain at {label}B={b}")
    scratch = acc.clone()

    def check_and_time(name, what, pairs_, fn, plain, nbytes, macs=macs,
                       as_k5=(), k5=want):
        """Each (got, ref) of pairs_ bit-equal and each of as_k5 (results
        in K5's layout) equal to K2 then K5 (k5); a row of rows[name] with
        the largest error, fn and plain timed into it if `timed`."""
        sync()
        err = max(max_abs_err(got, ref) for got, ref in pairs_)
        if not all(torch.equal(x, k5) for x in as_k5):
            raise AssertionError(f"{name}{what} differs from K2 then K5 at "
                                 f"{label}B={b}")
        record(f"{name} {label}B={b}{what}", rows[name], macs, nbytes,
               time_ms(fn) if timed else None,
               time_ms(plain, reps=2) if timed else None, err)
        return rows[name][-1]
    # K6: the same update on the batch-major layouts, into a new tensor
    dig_bm = dig.reshape(r, nd, b, n).permute(1, 2, 0, 3).contiguous()
    acc_bm = acc.permute(1, 0, 2).contiguous()
    k6 = kx.extprod_step(dig_bm, ext, acc_bm, js)
    check_and_time("extprod_step", "",
                   [(k6, kx.extprod_step_plain(dig_bm, ext, acc_bm, js))],
                   lambda: kx.extprod_step(dig_bm, ext, acc_bm, js),
                   lambda: kx.extprod_step_plain(dig_bm, ext, acc_bm, js),
                   dig.numel() + ext.numel() + acc.numel() * 16,
                   as_k5=[k6.permute(1, 0, 2)])
    # K9: the digits never leave the chip, so its bytes lose them; it makes
    # its own, so it is held against K2 then K5 on the glue's digits
    k9 = kx.cmux_step_merged(t, ext, acc, bl, lv, js)
    merged_ms = check_and_time(
        "cmux_step_merged", "" if own_glue else " (its own glue)",
        [(k9, kx.cmux_step_merged_plain(t, ext, acc, bl, lv, js))],
        lambda: kx.cmux_step_merged(t, ext, scratch, bl, lv, js),
        lambda: kx.cmux_step_merged_plain(t, ext, scratch, bl, lv, js),
        ext.numel() + acc.numel() * 16 + b * 4, as_k5=[k9],
        k5=want if own_glue else kx.extprod_step2(glue, ext, acc.clone(),
                                                   js))["ms"]
    # K10a on the accumulator, equal to K2's glue permuted; K10b on the
    # digits in its flat layout, at the wrapper's split and unsplit
    k10a = kx.rot_diff_digits_flat(acc, t, bl, lv, nd)
    check_and_time("rot_diff_digits_flat", "",
                   [(k10a, kx.rot_diff_digits_flat_plain(acc, t, bl, lv, nd)),
                    (k10a, glue.permute(2, 3, 0, 1, 4).reshape(nd, b,
                                                               r * n))],
                   lambda: kx.rot_diff_digits_flat(acc, t, bl, lv, nd),
                   lambda: kx.rot_diff_digits_flat_plain(acc, t, bl, lv, nd),
                   acc.numel() * 8 + k10a.numel() + b * 4, macs=0)
    flat = dig.permute(2, 3, 0, 1, 4).reshape(nd, b, r * n)
    split = kx._longk_splits(b, k1, r, n)
    ref = kx.extprod_step_longk_plain(flat, ext, acc.clone(), js)
    got = [kx.extprod_step_longk(flat, ext, acc.clone(), js),
           kx._launch_longk(flat, ext, acc.clone(), js, 1)]
    check_and_time("extprod_step_longk", f" (split {split}; unsplit)",
                   [(x, ref) for x in got],
                   lambda: kx.extprod_step_longk(flat, ext, scratch, js),
                   lambda: kx.extprod_step_longk_plain(flat, ext, scratch,
                                                       js),
                   flat.numel() + ext.numel() + acc.numel() * 16,
                   as_k5=got)["split"] = split
    # K11 on the digits, at the wrapper's split, unsplit and a row a block
    bsplit = k11_split_of(b, n, nd, k1, r, 8 - js)
    ref = kx.extprod_step3_plain(dig, ext, acc.clone(), js)
    got = [kx.extprod_step3(dig, ext, acc.clone(), js)] + [
        kx._launch_step3(dig, ext, acc.clone(), js, s) for s in (1, r)]
    check_and_time("extprod_step3",
                   f" (split {bsplit}; unsplit; a row a block)",
                   [(x, ref) for x in got],
                   lambda: kx.extprod_step3(dig, ext, scratch, js),
                   lambda: kx.extprod_step3_plain(dig, ext, scratch, js),
                   dig.numel() + ext.numel() + acc.numel() * 16,
                   as_k5=got)["split"] = bsplit
    if not timed:
        return

    def longk_step():
        kx.extprod_step_longk(kx.rot_diff_digits_flat(scratch, t, bl, lv, nd),
                              ext, scratch, js)

    def grid_step():
        kx.extprod_step2(kx.rot_diff_digits(scratch, t, bl, lv, nd), ext,
                         scratch, js)
    longk_ms = time_ms(longk_step)
    longk_us, grid_us = enqueue_us(longk_step), enqueue_us(grid_step)
    bucket_ms = time_ms(lambda: kx.extprod_step3(
        kx.rot_diff_digits(scratch, t, bl, lv, nd), ext, scratch, js))
    glue_out_ms = time_ms(lambda: kx.extprod_step(
        torus.split_int32_signed(blind_rotate.decompose_glwe(
            polynomial.monomial_mul(acc_bm, t[:, None]) - acc_bm, bl, lv),
            nd), ext, acc_bm, js))
    grid_ms = time_ms(grid_step)
    k1_ms = time_ms(lambda: kx.extprod_step2g(dig, ext, scratch, t, bl, lv,
                                              js))
    log(f"    one CMux step at {label}B={b}: gridg (K1) {k1_ms:.4f} ms, grid "
        f"(K2 then K5) {grid_ms:.4f} ms, merged (K9) {merged_ms:.4f} ms, "
        f"longk (K10a then K10b, K10b split {split}) {longk_ms:.4f} ms, "
        f"bucket (K2 then K11, K11 split {bsplit}) {bucket_ms:.4f} ms, "
        f"glue_out (torch glue then K6) {glue_out_ms:.4f} ms; all equal K2 "
        "then K5")
    log(f"    host enqueue of one step at {label}B={b}: longk {longk_us:.1f} "
        f"us, grid {grid_us:.1f} us")
    rows["extprod_step_longk"][-1]["step_ms"] = dict(
        gridg=k1_ms, grid=grid_ms, merged=merged_ms, longk=longk_ms,
        bucket=bucket_ms, glue_out=glue_out_ms, longk_enqueue_us=longk_us,
        grid_enqueue_us=grid_us)


def check_tensor_core_steps(gen) -> int:
    """K1, K5, K6, K9, K10b and K11 bit-equal to their plain versions over
    small, ragged and full shapes — K11 at the wrapper's split, unsplit and
    with a row a block — then at the extreme value: every digit and key
    byte -128 at the blind rotation's R=15, N=512, n_d=2, js=2, where each
    int32 bucket reaches n_d·R·N·2^14, the bound the wrappers admit (K9's
    digits come from its own glue, so only its key is extreme), at B=13
    (K10b split in 8) and B=201 (unsplit). Returns the number of
    comparisons made."""
    def compare(k1, lv, nd, bl, b, n, js, fill=None):
        acc = torch.randint(-2**62, 2**62, (k1, b, n), generator=gen,
                            dtype=torch.int64).to(DEV)
        t = torch.randint(0, 2 * n, (b,), generator=gen,
                          dtype=torch.int32).to(DEV)
        lo, hi = (-128, 128) if fill is None else (fill, fill + 1)
        dig = rand_i8(gen, (k1, lv, nd, b, n), lo, hi)
        ext = rand_i8(gen, (k1, k1 * lv, 8 - js, 2 * n), lo, hi)
        got = kx.extprod_step2g(dig, ext, acc.clone(), t, bl, lv, js)
        ref = kx.extprod_step2g_plain(dig, ext, acc.clone(), t, bl, lv, js)
        got9 = kx.cmux_step_merged(t, ext, acc, bl, lv, js)
        ref9 = kx.cmux_step_merged_plain(t, ext, acc, bl, lv, js)
        got5 = kx.extprod_step2(dig, ext, acc.clone(), js)
        ref5 = kx.extprod_step2_plain(dig, ext, acc.clone(), js)
        flat = dig.permute(2, 3, 0, 1, 4).reshape(nd, b, k1 * lv * n)
        got10 = kx.extprod_step_longk(flat, ext, acc.clone(), js)
        ref10 = kx.extprod_step_longk_plain(flat, ext, acc.clone(), js)
        dig_bm = dig.reshape(k1 * lv, nd, b, n).permute(1, 2, 0,
                                                        3).contiguous()
        acc_bm = acc.permute(1, 0, 2).contiguous()
        got6 = kx.extprod_step(dig_bm, ext, acc_bm, js)
        ref6 = kx.extprod_step_plain(dig_bm, ext, acc_bm, js)
        ref11 = kx.extprod_step3_plain(dig, ext, acc.clone(), js)
        got11 = [kx.extprod_step3(dig, ext, acc.clone(), js)] + [
            kx._launch_step3(dig, ext, acc.clone(), js, splits)
            for splits in (1, k1 * lv)]
        sync()
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
                and torch.equal(got9, ref9) and torch.equal(got5, ref5)
                and torch.equal(got10, ref10) and torch.equal(got6, ref6)
                and all(torch.equal(x, ref11) for x in got11)):
            raise AssertionError(f"K1, K5, K6, K9, K10b or K11 differs from "
                                 f"plain at N={n} B={b} js={js} n_d={nd} "
                                 f"fill={fill}")
        return 8

    done = 0
    for n in (64, 256, 512):
        for b in (1, 9, 13, 288):
            for js in (0, 2):
                for nd, bl in ((1, 6), (2, 12), (3, 20)):   # limbs, base_log
                    done += compare(2, 2, nd, bl, b, n, js)
    assert [kx._longk_splits(b, 5, 15, 512) for b in (13, 201)] == [8, 1]
    return (done + compare(5, 3, 2, 12, 13, 512, 2, fill=-128)
            + compare(5, 3, 2, 12, 201, 512, 2, fill=-128))


def check_glue_gadgets(gen, k1: int, n: int) -> None:
    """K2 and K10a (one kernel body, nc::glue_wide) at B in {9, 288} for
    every gadget they are built for, each gadget with its own limb count and
    lvl64's (3, 12) with one to three: each bit-equal to its plain version,
    and K10a equal to K2's output permuted to the flat layout."""
    done = 0
    for b in (9, 288):
        acc = torch.randint(-2**63, 2**63 - 1, (k1, b, n), generator=gen,
                            dtype=torch.int64).to(DEV)
        t = torch.randint(0, 2 * n, (b,), generator=gen,
                          dtype=torch.int32).to(DEV)
        for lv, bl in sorted(kx.GLUE_GADGETS):
            own = torus.limbs_for_bound(decomposition.digit_bound(bl))
            for nd in ((1, 2, 3) if (lv, bl) == (3, 12) else (own,)):
                k2 = kx.rot_diff_digits(acc, t, bl, lv, nd)
                flat = kx.rot_diff_digits_flat(acc, t, bl, lv, nd)
                if not (torch.equal(k2, kx.rot_diff_digits_plain(
                        acc, t, bl, lv, nd)) and torch.equal(
                        flat, kx.rot_diff_digits_flat_plain(
                            acc, t, bl, lv, nd)) and torch.equal(
                        flat, k2.permute(2, 3, 0, 1, 4).reshape(
                            nd, b, k1 * lv * n))):
                    raise AssertionError(
                        f"K2 or K10a differs at B={b}, gadget ({lv}, {bl}), "
                        f"n_d={nd}")
                done += 1
    log(f"  K2 and K10a bit-equal to plain and K10a == K2 permuted for every "
        f"built gadget {sorted(kx.GLUE_GADGETS)} at B in {{9, 288}} "
        f"({done} gadget and limb-count cases)")


def launch_floor_ms() -> float:
    """Device time of one empty kernel (tfhe_empty_kernel, csrc/cmux.cu),
    launched through ctypes as the wrappers launch theirs and timed as they
    are: the least any launch of this timing can read, which the byte
    bounds of the small glue launches (K2, K10a at B=9) lie below."""
    f = build.library("cmux").tfhe_empty_kernel
    f.argtypes, f.restype = [ctypes.c_void_p], ctypes.c_int
    return time_ms(lambda: build.check(f(build.stream_ptr(DEV)),
                                       "empty_kernel"))


def int8_library_rate(b: int, n: int, macs: int) -> None:
    """A yardstick, not a reference: one `torch._int_mm` of [b, n] x [n, n]
    int8 on the card, as the int8 tensor rate a library reaches at this M,
    and the time K1's multiply-adds would take at that rate."""
    try:
        x = torch.zeros((b, n), dtype=torch.int8, device=DEV)
        w = torch.zeros((n, n), dtype=torch.int8, device=DEV)
        ms = time_ms(lambda: torch._int_mm(x, w), reps=50)
    except (RuntimeError, AttributeError) as e:
        log(f"  int8 rate probe skipped: torch._int_mm refused [{b}, {n}] x "
            f"[{n}, {n}]: {str(e).splitlines()[0][:200]}")
        return
    rate = 2 * b * n * n / (ms * 1e-3)
    log(f"  int8 rate probe: torch._int_mm [{b}, {n}] x [{n}, {n}] "
        f"{ms:.4f} ms = {rate / 1e12:.2f} TOPS (one product of this size "
        f"is near launch latency); K1's step at B={b} is "
        f"{macs // (b * n * n)} such products")


def check_k2_at(rows, p, acc, t, label: str = "", timed: bool = True):
    """K2 at the set p's CMux glue on (acc, t), against its plain version
    (timed if `timed`)."""
    lv = p.pbs_level
    nd = torus.limbs_for_bound(decomposition.digit_bound(p.pbs_base_log))
    b = t.shape[0]
    got = kx.rot_diff_digits(acc, t, p.pbs_base_log, lv, nd)
    err = max_abs_err(got, kx.rot_diff_digits_plain(acc, t, p.pbs_base_log,
                                                    lv, nd))
    record(f"rot_diff_digits {label}B={b}", rows["rot_diff_digits"], 0,
           acc.numel() * 8 + got.numel() + b * 4,
           time_ms(lambda: kx.rot_diff_digits(acc, t, p.pbs_base_log, lv,
                                              nd)) if timed else None,
           time_ms(lambda: kx.rot_diff_digits_plain(
               acc, t, p.pbs_base_log, lv, nd), reps=2) if timed else None,
           err)


def check_k1_at(rows, p, dig, ext, acc, t, label: str = "",
                timed: bool = True):
    """K1 at the set p's CMux step on (dig, ext, acc, t), against its plain
    version (timed if `timed`); returns K1's (acc, digits)."""
    k1, n, lv = p.glwe_dimension + 1, p.polynomial_size, p.pbs_level
    nd = torus.limbs_for_bound(decomposition.digit_bound(p.pbs_base_log))
    js = truncation.bsk_j_start(p)
    b = t.shape[0]
    acc_k, dig_k = kx.extprod_step2g(dig, ext, acc.clone(), t,
                                     p.pbs_base_log, lv, js)
    acc_p, dig_p = kx.extprod_step2g_plain(dig, ext, acc.clone(), t,
                                           p.pbs_base_log, lv, js)
    sync()
    err = max(max_abs_err(acc_k, acc_p), max_abs_err(dig_k, dig_p))
    del acc_p, dig_p
    scratch = acc.clone()
    record(f"extprod_step2g {label}{kx.k1_path(n)} B={b}",
           rows["extprod_step2g"],
           b * k1 * k1 * lv * n * n * pairs(nd, js),
           dig.numel() * 2 + ext.numel() + acc.numel() * 16 + b * 4,
           time_ms(lambda: kx.extprod_step2g(
               dig, ext, scratch, t, p.pbs_base_log, lv, js))
           if timed else None,
           time_ms(lambda: kx.extprod_step2g_plain(
               dig, ext, scratch, t, p.pbs_base_log, lv, js), reps=2)
           if timed else None, err)
    return acc_k, dig_k


def check_k1_paths(rows, gen) -> None:
    """K1 at three steps: PARAMS_SQRD_LVL_64's (N = 512) from one lane
    through the latency path's batches to the 16-block batch's 2,048 lanes,
    PARAMS_SQRD_LVL_256's (N = 1024) likewise, and the 8-bit model's
    (N = 1024) at its scans of 16 and 128 lanes: the wrapper's (k1_path:
    wgmma at each N of extprod.WG_N, cmux_wg.cu) and a second reference,
    mma.sync's through its C entry (cmux.cu) where N <= 512 and K5 then K2
    at N = 1024, each bit-equal to the plain version and timed, and how
    many of the wrapper's launches took wgmma (launches_wg, the mechanism's
    counter); the rows name what they time ("wgmma", "mma.sync" or
    "K5+K2"), and that wgmma wins at every batch is read from them. At
    N = 1024 the card also reports how many clusters of 8 it holds at
    once."""
    f = kx._fn("cmux", "tfhe_extprod_step2g", [kx._P] * 5 + [kx._I] * 8
               + [kx._P])
    for label, p, batches in (
            ("", P, (1, 9, 32, 64, 128, 160, 256, 288, 2048)),
            (f"{WIDE} lvl256 ", P256, (1, 9, 32, 128, 160, 288, 2048)),
            (f"{WIDE} 8-bit ", P8, (1, 16, 128))):
        k1, n, lv = p.glwe_dimension + 1, p.polynomial_size, p.pbs_level
        nd = torus.limbs_for_bound(decomposition.digit_bound(p.pbs_base_log))
        js, bl = truncation.bsk_j_start(p), p.pbs_base_log

        def mma_sync(dig, ext, acc, t):
            out = torch.empty_like(dig)
            build.check(f(dig.data_ptr(), ext.data_ptr(), acc.data_ptr(),
                          t.data_ptr(), out.data_ptr(), t.shape[0], n, k1,
                          k1 * lv, lv, nd, js, bl, build.stream_ptr(DEV)),
                        "extprod_step2g")
            return acc, out

        def k5_k2(dig, ext, acc, t):
            acc = kx.extprod_step2(dig, ext, acc, js)
            return acc, kx.rot_diff_digits(acc, t, bl, lv, nd)
        calls = wg_calls = 0
        for b in batches:
            acc, t, dig, ext = step_operands(gen, k1, n, lv, nd, b, js)
            want = kx.extprod_step2g_plain(dig, ext, acc.clone(), t, bl, lv,
                                           js)
            macs = b * k1 * k1 * lv * n * n * pairs(nd, js)
            nbytes = dig.numel() * 2 + ext.numel() + acc.numel() * 16 + b * 4
            scratch = acc.clone()
            plain_ms = time_ms(lambda: kx.extprod_step2g_plain(
                dig, ext, scratch, t, bl, lv, js), reps=2)
            for name, fn in (
                    (kx.k1_path(n),
                     lambda a: kx.extprod_step2g(dig, ext, a, t, bl, lv, js)),
                    ("mma.sync", lambda a: mma_sync(dig, ext, a, t))
                    if n <= 512 else
                    ("K5+K2", lambda a: k5_k2(dig, ext, a, t))):
                before = kx.extprod_step2g.launches_wg
                got = fn(acc.clone())
                if name == kx.k1_path(n):
                    calls += 1
                    wg_calls += kx.extprod_step2g.launches_wg - before
                sync()
                err = max(max_abs_err(got[0], want[0]),
                          max_abs_err(got[1], want[1]))
                record(f"extprod_step2g {label}{name} B={b}",
                       rows["extprod_step2g"], macs, nbytes,
                       time_ms(lambda: fn(scratch)), plain_ms, err)
                if name == "mma.sync":
                    break
            del want
        line = (f"  K1 at {label.strip() or 'lvl64'}: {wg_calls} of the "
                f"wrapper's {calls} launches on wgmma (launches_wg)")
        if n in kx.WG_N:
            held = ctypes.c_int(0)
            build.check(kx._fn("cmux_wg", "tfhe_extprod_step2g_wg_clusters",
                               [ctypes.c_int] * 3
                               + [ctypes.POINTER(ctypes.c_int)])(
                n, nd, js, ctypes.byref(held)), "extprod_step2g")
            line += (f"; the card holds {held.value} clusters of "
                     f"{n // kx.WG_COLS} blocks at once "
                     "(cudaOccupancyMaxActiveClusters)")
        log(line)


def check_step_at(rows, gen, p, b: int, label: str = "",
                  timed: bool = True) -> None:
    """K2 and K1 at the set p's CMux step for batch b on fresh operands
    (step_operands), each against its plain version (timed if `timed`)."""
    k1, n, lv = p.glwe_dimension + 1, p.polynomial_size, p.pbs_level
    nd = torus.limbs_for_bound(decomposition.digit_bound(p.pbs_base_log))
    acc, t, dig, ext = step_operands(gen, k1, n, lv, nd, b,
                                     truncation.bsk_j_start(p))
    check_k2_at(rows, p, acc, t, label, timed)
    check_k1_at(rows, p, dig, ext, acc, t, label, timed)


def check_vp_at(rows, gen, p, lanes: int, g: int, label: str = "",
                timed: bool = True):
    """K3 at the set p's vertical-packing stage of `lanes` lanes and G = g
    accumulators a lane, against its plain version (timed if `timed`);
    returns its operands and K3's output."""
    k1, n = p.glwe_dimension + 1, p.polynomial_size
    r = k1 * p.cbs_level
    nd = torus.limbs_for_bound(decomposition.digit_bound(p.cbs_base_log))
    js = truncation.vp_ggsw_j_start(p)
    dig = rand_i8(gen, (lanes, r, nd * g, n))
    ext = rand_i8(gen, (lanes, k1, r, 8 - js, 2 * n))
    got = kx.extprod_grouped_fused(dig, ext, nd, js)
    err = max_abs_err(got, kx.extprod_grouped_fused_plain(dig, ext, nd, js))
    record(f"extprod_grouped_fused {label}lanes={lanes} G={g}",
           rows["extprod_grouped_fused"],
           lanes * g * k1 * r * n * n * pairs(nd, js),
           dig.numel() + ext.numel() + got.numel() * 8,
           time_ms(lambda: kx.extprod_grouped_fused(dig, ext, nd, js))
           if timed else None,
           time_ms(lambda: kx.extprod_grouped_fused_plain(dig, ext, nd, js),
                   reps=2) if timed else None, err)
    return dig, ext, got


def phase_kernels() -> tuple[dict, float]:
    """K1-K11 at main-path shapes vs their plain versions, and the
    cross-checks between kernels; returns every measurement by kernel and
    the launch floor (ms)."""
    log("== phase 2: kernel checks at PARAMS_SQRD_LVL_64 shapes")
    gen = torch.Generator().manual_seed(1234)
    k1, n, lv = P.glwe_dimension + 1, P.polynomial_size, P.pbs_level
    r = k1 * lv
    nd = torus.limbs_for_bound(decomposition.digit_bound(P.pbs_base_log))
    js = truncation.bsk_j_start(P)
    rows: dict[str, list] = {k: [] for k in KERNELS}
    check_k1_paths(rows, gen)

    for b in (9, 128, 160, 256, 288):     # 9: one byte of the CTR counter
        acc = torch.randint(-2**62, 2**62, (k1, b, n), generator=gen,
                            dtype=torch.int64).to(DEV)
        t = torch.randint(0, 2 * n, (b,), generator=gen,
                          dtype=torch.int32).to(DEV)
        # K2, at B=9 too: the `grid` and `bucket` derivations' shape
        check_k2_at(rows, P, acc, t)
        if b == 9:
            check_step_schedules(rows, b, acc, t, rand_i8(
                gen, (k1, r, 8 - js, 2 * n)), js, nd)
            continue
        # K1
        dig = rand_i8(gen, (k1, lv, nd, b, n))
        ext = rand_i8(gen, (k1, r, 8 - js, 2 * n))
        acc_k, dig_k = check_k1_at(rows, P, dig, ext, acc, t)
        scratch = acc.clone()
        macs = b * k1 * r * n * n * pairs(nd, js)
        # K5: the same step without its glue, and K2 then K5 against K1
        acc_5 = kx.extprod_step2(dig, ext, acc.clone(), js)
        ref = kx.extprod_step2_plain(dig, ext, acc.clone(), js)
        sync()
        err = max_abs_err(acc_5, ref)
        if not (torch.equal(acc_5, acc_k) and torch.equal(
                kx.rot_diff_digits(acc_5, t, P.pbs_base_log, lv, nd), dig_k)):
            raise AssertionError(f"K2 then K5 differs from K1 at B={b}")
        ms = time_ms(lambda: kx.extprod_step2(dig, ext, scratch, js))
        pms = time_ms(lambda: kx.extprod_step2_plain(dig, ext, scratch, js),
                      reps=2)
        record(f"extprod_step2 B={b}", rows["extprod_step2"], macs,
               dig.numel() + ext.numel() + acc.numel() * 16, ms, pms, err)
        # the `grid` step as the path runs it, K2 then K5 back to back:
        # K2 alone sits near launch latency, so the split of K1's step is
        # read from this pair, not from the sum of two isolated times
        pair_ms = time_ms(lambda: kx.extprod_step2(
            kx.rot_diff_digits(scratch, t, P.pbs_base_log, lv, nd), ext,
            scratch, js))
        log(f"    grid step (K2 then K5) B={b}: {pair_ms:.4f} ms against "
            f"K1's {rows['extprod_step2g'][-1]['ms']:.4f} ms")
        rows["extprod_step2"][-1]["grid_step_ms"] = pair_ms
        check_step_schedules(rows, b, acc, t, ext, js, nd)
    log("  cross-check: K2 then K5 == K1 at every B >= 128; K6 == K9 == K10b "
        "after K10a == K11 after K2 (split and unsplit) == K5 after K2 at "
        "every B")
    done = check_tensor_core_steps(gen)
    log(f"  K1, K5, K6, K9, K10b and K11 bit-equal to plain in {done} more "
        "comparisons: N in {64, 256, 512} x B in {1, 9, 13, 288} x js in "
        "{0, 2} x n_d in {1, 2, 3}, and every digit and key byte -128 at "
        "R=15, N=512, B in {13, 201} (K10b split 8 and unsplit; K11 at its "
        f"split ({k11_split_of(13, n, nd, k1, r, 8 - js)} and "
        f"{k11_split_of(201, n, nd, k1, r, 8 - js)}), unsplit and a row a "
        "block)")
    int8_library_rate(288, n, 288 * k1 * r * n * n * pairs(nd, js))

    # K7 at B=288: all 8 key planes (js=0); with the planes the BSK drops
    # zeroed, its partial sums recombined must be K6's update at js
    b = 288
    dig_bm = rand_i8(gen, (nd, b, r, n))
    ext8 = rand_i8(gen, (8, r, k1, 2 * n))
    ext8[:js] = 0
    acc_bm = torch.randint(-2**62, 2**62, (b, k1, n), generator=gen,
                           dtype=torch.int64).to(DEV)
    parts = kx.extprod_partials(dig_bm, ext8)
    ref = kx.extprod_partials_plain(dig_bm, ext8)
    sync()
    err = max_abs_err(parts, ref)
    acc_6 = kx.extprod_step(dig_bm, ext8[js:].permute(2, 1, 0, 3).contiguous(),
                            acc_bm, js)
    if not torch.equal(acc_bm + polynomial.recombine_partials(parts), acc_6):
        raise AssertionError("K7 recombined differs from K6's update")
    log("  cross-check: K7 recombined == K6's update at B=288")
    # K7 at the extreme value: every digit and key byte -128, each int32
    # bucket at n_d·R·N·2^14, the bound the wrapper admits
    dig_x = torch.full((nd, b, r, n), -128, dtype=torch.int8, device=DEV)
    ext_x = torch.full((8, r, k1, 2 * n), -128, dtype=torch.int8, device=DEV)
    parts_x = kx.extprod_partials(dig_x, ext_x)
    err = max(err, max_abs_err(parts_x, kx.extprod_partials_plain(dig_x,
                                                                  ext_x)))
    ext_x[:js] = 0
    if not torch.equal(acc_bm + polynomial.recombine_partials(
            kx.extprod_partials(dig_x, ext_x)), kx.extprod_step(
            dig_x, ext_x[js:].permute(2, 1, 0, 3).contiguous(), acc_bm, js)):
        raise AssertionError("K7 recombined differs from K6's update at the "
                             "value -128")
    log(f"  K7 with every digit and key byte -128 at B={b}: max_abs_err "
        f"{err} against plain, recombined == K6's update")
    del dig_x, ext_x, parts_x
    ms = time_ms(lambda: kx.extprod_partials(dig_bm, ext8))
    pms = time_ms(lambda: kx.extprod_partials_plain(dig_bm, ext8), reps=2)
    record(f"extprod_partials B={b}", rows["extprod_partials"],
           b * k1 * r * n * n * pairs(nd, 0),
           dig_bm.numel() + ext8.numel() + parts.numel() * 4, ms, pms, err)

    # K3: the three vertical-packing shapes of the main path (lanes, G)
    js_vp = truncation.vp_ggsw_j_start(P)
    nd_vp = torus.limbs_for_bound(decomposition.digit_bound(P.cbs_base_log))
    r_vp = k1 * P.cbs_level
    for lanes, g in ((4, 8), (16, 8), (16, 24), (128, 1), (32, 24)):
        dig, ext, got = check_vp_at(rows, gen, P, lanes, g)
        macs = lanes * g * k1 * r_vp * n * n * pairs(nd_vp, js_vp)
        # K8 on the same operands in its own layouts; recombined it is K3
        dig_8 = dig.reshape(lanes, r_vp, nd_vp, g, n).permute(
            2, 0, 3, 1, 4).contiguous()                    # [n_d, B, G, R, N]
        ext_8 = ext.permute(3, 0, 2, 1, 4).contiguous()    # [8-js, B, R, O, 2N]
        parts = kx.extprod_partials_grouped(dig_8, ext_8, js_vp)
        ref = kx.extprod_partials_grouped_plain(dig_8, ext_8, js_vp)
        sync()
        err = max_abs_err(parts, ref)
        if not torch.equal(polynomial.recombine_partials(parts, js_vp),
                           got.permute(0, 2, 1, 3)):
            raise AssertionError("K8 recombined differs from K3")
        ms = time_ms(lambda: kx.extprod_partials_grouped(dig_8, ext_8, js_vp))
        pms = time_ms(lambda: kx.extprod_partials_grouped_plain(
            dig_8, ext_8, js_vp), reps=2)
        rms = time_ms(lambda: polynomial.recombine_partials(parts, js_vp))
        record(f"extprod_partials_grouped lanes={lanes} G={g}",
               rows["extprod_partials_grouped"], macs,
               dig.numel() + ext.numel() + parts.numel() * 4, ms, pms, err)
        log(f"    torch recombination of its partial sums: {rms:.4f} ms")
    # K3 and K8 at the extreme value: every digit and key byte -128 at
    # (32, 24), K8 on its own layouts
    dig = torch.full((32, r_vp, nd_vp * 24, n), -128, dtype=torch.int8,
                     device=DEV)
    ext = torch.full((32, k1, r_vp, 8 - js_vp, 2 * n), -128,
                     dtype=torch.int8, device=DEV)
    fused = kx.extprod_grouped_fused(dig, ext, nd_vp, js_vp)
    if not torch.equal(fused, kx.extprod_grouped_fused_plain(dig, ext, nd_vp,
                                                             js_vp)):
        raise AssertionError("K3 differs from plain at the value -128")
    dig_8 = torch.full((nd_vp, 32, 24, r_vp, n), -128, dtype=torch.int8,
                       device=DEV)
    ext_8 = torch.full((8 - js_vp, 32, r_vp, k1, 2 * n), -128,
                       dtype=torch.int8, device=DEV)
    parts = kx.extprod_partials_grouped(dig_8, ext_8, js_vp)
    if not (torch.equal(parts, kx.extprod_partials_grouped_plain(
            dig_8, ext_8, js_vp)) and torch.equal(
            polynomial.recombine_partials(parts, js_vp),
            fused.permute(0, 2, 1, 3))):
        raise AssertionError("K8 differs from plain or from K3 at the value "
                             "-128")
    log("  K3 and K8 bit-equal to plain with every digit and key byte -128 "
        "at 32 lanes x G=24, K8 recombined equal to K3")
    check_glue_gadgets(gen, k1, n)
    floor = launch_floor_ms()
    log(f"  launch floor: an empty kernel queued behind the same device "
        f"spin takes {floor:.4f} ms")

    check_limb_matmul(rows, gen)
    log("  N=1024 (lvl1, lvl4, lvl256):")
    check_wide_steps(rows, gen)
    check_wide_schedules(rows, gen)
    check_wide_limb_matmul(rows, gen)
    log("  the tree-PBS model (PARAMS_SHORTINT_1BIT) and the 8-bit model "
        "(PARAMS_WOPPBS_8BIT):")
    check_model_steps(rows, gen)
    check_model_products(rows, gen)
    sync()
    return rows, floor


def k4_shapes(p=P):
    """The keyswitch's and the pfKS's (name, n_d, K, N, js) at the set p
    (PARAMS_SQRD_LVL_64 by default)."""
    kn = p.glwe_dimension * p.polynomial_size
    k1 = p.glwe_dimension + 1
    return [
        ("keyswitch", torus.limbs_for_bound(
            decomposition.digit_bound(p.ks_base_log)),
         kn * p.ks_level, p.lwe_dimension + 1, truncation.ksk_j_start(p)),
        ("pfKS", torus.limbs_for_bound(
            decomposition.digit_bound(p.pfks_base_log)),
         (kn + 1) * p.pfks_level, k1 * k1 * p.polynomial_size,
         truncation.pfpksk_j_start(p)),
    ]


def int_mm_yardstick(d, m, js):
    """A yardstick, not a reference, and never called by the port: K4's
    function as one torch._int_mm per weight bucket s (the bucket's digit
    planes and key planes concatenated along K, zero-padded to the call's
    limits: more than 16 rows, K and N multiples of 8) and the int64
    recombination. Returns `run`, which computes the product from operands
    laid out beforehand (that layout, a key preparation, is not timed)."""
    n_d, b, k = d.shape
    nj, _, n = m.shape
    bp, kp, np8 = max(b, 17), -(-k // 8) * 8, -(-n // 8) * 8
    ops = []
    for s in range(nj):
        ij = [(i, s - i) for i in range(n_d) if 0 <= s - i < nj]
        a = torch.zeros((bp, len(ij) * kp), dtype=torch.int8, device=DEV)
        w = torch.zeros((len(ij) * kp, np8), dtype=torch.int8, device=DEV)
        for q, (i, j) in enumerate(ij):
            a[:b, q * kp:q * kp + k] = d[i]
            w[q * kp:q * kp + k, :n] = m[j]
        ops.append((a, w, 8 * (s + js)))

    def run():
        out = torch.zeros((bp, np8), dtype=torch.int64, device=DEV)
        for a, w, shift in ops:
            out += torch._int_mm(a, w).to(torch.int64) << shift
        return out[:b, :n]
    return run


def yardstick(row: dict, what: str, d, m, js: int, ref) -> None:
    """Times int_mm_yardstick beside K4's row (same function: checked
    bit-equal to the plain version first); logs a refusal of torch._int_mm
    and goes on."""
    b = d.shape[1]
    try:
        run = int_mm_yardstick(d, m, js)
        same = torch.equal(run(), ref)
    except RuntimeError as e:
        log(f"    yardstick skipped: torch._int_mm refused {what} B={b}: "
            f"{str(e).splitlines()[0][:200]}")
        return
    if not same:
        raise AssertionError(f"the _int_mm yardstick differs from K4's "
                             f"plain version ({what} B={b})")
    row["int_mm_yardstick_ms"] = yms = time_ms(run)
    log(f"    yardstick (not the port's): torch._int_mm per weight bucket + "
        f"int64 recombination, {what} B={b}: {yms:.4f} ms against K4's "
        f"{row['ms']:.4f} ms")


def check_k4_at(rows, gen, shape, m, b: int, label: str = "",
                yard: bool = False) -> None:
    """K4 at k4_shapes()'s `shape` (name, n_d, K, N, js) for batch b, on
    the key planes m (K-major), against its plain version, timed; with the
    torch._int_mm yardstick beside it if `yard`."""
    what, nd_m, kk, nn, js_m = shape
    d = rand_i8(gen, (nd_m, b, kk))
    got = kmm.fused_limb_matmul(d, m, js_m)
    ref = kmm.fused_limb_matmul_plain(d, m, js_m)
    sync()
    err = max_abs_err(got, ref)
    record(f"fused_limb_matmul {label}{what} B={b} (split "
           f"{kmm._splits(b, kk, nn)})", rows["fused_limb_matmul"],
           b * kk * nn * pairs(nd_m, js_m),
           d.numel() + m.numel() + got.numel() * 8,
           time_ms(lambda: kmm.fused_limb_matmul(d, m, js_m)),
           time_ms(lambda: kmm.fused_limb_matmul_plain(d, m, js_m), reps=2),
           err)
    if yard:
        yardstick(rows["fused_limb_matmul"][-1], what, d, m, js_m, ref)


def check_limb_matmul(rows, gen) -> None:
    """K4 at the keyswitch and pfKS shapes for B in {9, 160, 256, 288},
    each bit-equal to its plain version and timed; a ragged shape; every
    byte -128 at the longest K the wrapper admits for three digit limbs,
    in one block a tile (no split); and the torch._int_mm yardstick."""
    for shape in k4_shapes():
        _, _, kk, nn, js_m = shape
        # K-major, as ops/keys.py prepares the keys the path passes
        m = kmm.kmajor_key_planes(rand_i8(gen, (8 - js_m, kk, nn)))
        for b in (9, 160, 256, 288):
            check_k4_at(rows, gen, shape, m, b, yard=b in (9, 288))
        del m
    for b, kk, nn, nd_m, js_m in ((13, 130, 40, 3, 1), (70, 4098, 678, 1, 5),
                                  (1, 77, 33, 2, 0), (289, 4098, 1000, 3, 1)):
        d, m = rand_i8(gen, (nd_m, b, kk)), rand_i8(gen, (8 - js_m, kk, nn))
        if not torch.equal(kmm.fused_limb_matmul(d, m, js_m),
                           kmm.fused_limb_matmul_plain(d, m, js_m)):
            raise AssertionError(f"K4 differs from plain at B={b} K={kk} "
                                 f"N={nn} n_d={nd_m} js={js_m}")
    # 3·K·2^14 < 2^31; 132 tiles of 96 x 64, so no split: one block holds
    # each bucket at its bound
    kk = ((1 << 31) - 1) // (3 << 14)
    d = torch.full((3, 96, kk), -128, dtype=torch.int8, device=DEV)
    m = torch.full((7, kk, 64 * 132), -128, dtype=torch.int8, device=DEV)
    assert kmm._splits(96, kk, 64 * 132) == 1
    if not torch.equal(kmm.fused_limb_matmul(d, m, 1),
                       kmm.fused_limb_matmul_plain(d, m, 1)):
        raise AssertionError("K4 differs from plain at the value -128")
    del d, m
    log("  K4 bit-equal to plain at 4 ragged shapes and with every byte -128 "
        f"at K={kk}, B=96, N=8448, n_d=3, js=1 (unsplit)")


@contextlib.contextmanager
def launch_shapes(labels=None):
    """Tally K3's and K4's calls by operand shape, and the blind rotations
    (each a chain of CMux steps, every step's kernels at the rotation's
    batch) by lowering, N, batch and js, while the block runs: the module
    attributes the path calls through are wrapped. A wrapper counts its
    launches on the function its module's name resolves to, so the
    recorders carry the counts while installed and hand them back. labels:
    {(K, N): name} for K4's contractions that are neither a keyswitch nor
    a pfKS."""
    tally: dict = {}
    k3, k4 = kx.extprod_grouped_fused, kmm.fused_limb_matmul
    rotate = blind_rotate.blind_rotate_glwe

    def k3_seen(dig, ext, n_d, j_start):
        key = f"K3 lanes={dig.shape[0]} G={dig.shape[2] // n_d}"
        tally[key] = tally.get(key, 0) + 1
        return k3(dig, ext, n_d, j_start)

    def k4_seen(d_planes, m_planes, j_start=0):
        # the keyswitch's N is n + 1 (< 1000), the pfKS's (k+1)²·N
        what = (labels or {}).get(tuple(m_planes.shape[1:])) or (
            "pfKS" if m_planes.shape[2] > 1000 else "KS")
        key = f"K4 {what} n_d={d_planes.shape[0]} B={d_planes.shape[1]}"
        tally[key] = tally.get(key, 0) + 1
        return k4(d_planes, m_planes, j_start)

    def rotate_seen(lwe, bsk, acc_glwe, params, lowering=Lowering()):
        key = (f"rotation br={lowering.br} N={params.polynomial_size} "
               f"B={lwe[..., 0].numel()} js={8 - bsk.shape[3]} gadget="
               f"({params.pbs_level},{params.pbs_base_log})")
        tally[key] = tally.get(key, 0) + 1
        return rotate(lwe, bsk, acc_glwe, params, lowering)
    k3_seen.launches, k4_seen.launches = k3.launches, k4.launches
    kx.extprod_grouped_fused, kmm.fused_limb_matmul = k3_seen, k4_seen
    blind_rotate.blind_rotate_glwe = rotate_seen
    try:
        yield tally
    finally:
        kx.extprod_grouped_fused, kmm.fused_limb_matmul = k3, k4
        blind_rotate.blind_rotate_glwe = rotate
        k3.launches, k4.launches = k3_seen.launches, k4_seen.launches


def step_batches(shapes, br: str) -> set:
    """The (N, B, js, gadget) of the blind rotations a launch_shapes tally
    saw under the schedule br: every CMux step of such a rotation launches
    br's kernels at that batch."""
    found = set()
    for key in shapes:
        kid, *fields = key.split()
        f = dict(x.split("=", 1) for x in fields if "=" in x)
        if kid == "rotation" and f["br"] == br:
            found.add((int(f["N"]), int(f["B"]), int(f["js"]), f["gadget"]))
    return found


def reset_counters() -> None:
    for spec in KERNELS.values():
        spec["fn"].launches = 0


def read_counters() -> dict:
    return {name: spec["fn"].launches for name, spec in KERNELS.items()}


def require_launches(what: str, counts: dict, names) -> None:
    log(f"launches, {what}: {counts}")
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched: {what}")


def wait_for_socket(addr: str, alive, what: str) -> None:
    """Until the server listens on `addr`; fails if `alive()` turns false or
    after 120 s. The socket file appears at bind(), a moment before
    listen(), and a connect in between is refused: so wait a moment more."""
    deadline = time.time() + 120
    while not os.path.exists(addr):
        if not alive():
            raise AssertionError(f"{what} ended before it listened")
        if time.time() > deadline:
            raise AssertionError(f"{what} never listened on {addr}")
        time.sleep(0.05)
    time.sleep(0.5)


def phase_test_params() -> None:
    log("== phase 3: end to end at PARAMS_TEST, 2 rounds")
    t0 = time.time()
    pt = params_mod.PARAMS_TEST
    client, raw = keys_mod.generate_keys(pt, seed=3, device=DEV)
    ctx = model.context_from_keys(pt, raw, lowering=Lowering())
    blocks = scenario.ctr_blocks(IV, 2)
    expect = plain.expand_key_and_encrypt_blocks(KEY, blocks, 2)
    out, _ = scenario.run_client_server_aes_scenario(
        client, ctx, KEY, IV, 2, rounds=2)
    assert out == expect, "PARAMS_TEST output mismatch"
    ctx = dataclasses.replace(ctx, lowering=Lowering("glue_out", "partials"))
    out, _ = scenario.run_client_server_aes_scenario(
        client, ctx, KEY, IV, 2, rounds=2, compress_log2q=32)
    assert out == expect, "PARAMS_TEST output mismatch under glue_out"
    log("PARAMS_TEST 2-round CTR x2 verified under the default lowering and "
        f"under (glue_out, partials) with a compressed response in "
        f"{time.time() - t0:.1f} s")

    # the server as a second process on the card, holding only the bundle
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        bundle, addr = f"{tmp}/server_keys.npz", f"{tmp}/fhe.sock"
        serialization.save_server_keys(bundle, raw, pt)
        proc = subprocess.Popen(
            [sys.executable, "-m", "tfhe_aes2_tpu_torch.serve", "--keys",
             bundle, "--address", addr, "--max-requests", "1"],
            env=dict(os.environ, TFHE_BR_KERNEL="merged"), cwd=ROOT,
            stderr=subprocess.PIPE, text=True)
        try:
            wait_for_socket(addr, lambda: proc.poll() is None,
                            "the server process")
            key_ct = STRATEGY.encrypt_key_client(client, KEY)
            block_cts = STRATEGY.encrypt_client(client, blocks[:1])
            _, arrays = serve.request_keystream(
                addr, key_ct, block_cts, rounds=2, compress=16,
                fhe_counter_count=2)
            _, err = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    got = compression.decrypt_blocks_compressed(client, arrays["comp"], 16)
    assert got == expect, "the server process's keystream mismatch"
    if proc.returncode != 0 or "lowering br=merged" not in err:
        raise AssertionError(f"server process rc {proc.returncode}: "
                             f"{err[-2000:]}")
    log("second-process server (TFHE_BR_KERNEL=merged, bundle from disk) "
        "derived 2 blocks from 1 and answered compressed; verified, exit 0, "
        f"in {time.time() - t0:.1f} s")


def phase_full_width():
    """The user's entry points at full width under the default lowering:
    the CTR scenario with 2 blocks (key_schedule_staged +
    encrypt_blocks_staged, 10 rounds), then 1 block through the same three
    steps the scenario is made of (encrypt_request, serve_request ->
    encrypt_block_latency, read_response), each decrypted and checked
    against the AES authority. Returns what phases 5 and 6 run again: the
    keys (raw and prepared), the single block's encrypted request and its
    output ciphertext, and the launch counts of both runs."""
    log("== phase 4: full width, PARAMS_SQRD_LVL_64, 10 rounds, lowering "
        "(gridg, fused)")
    t0 = time.time()
    client, raw = keys_mod.generate_keys(P, seed=0, device=DEV)
    ctx = model.context_from_keys(P, raw, lowering=Lowering())
    sync()
    log(f"keygen (seeded) + key preparation: {time.time() - t0:.1f} s")
    blocks = scenario.ctr_blocks(IV, 2)
    expect = aes_lib.encrypt_blocks(KEY, blocks)

    reset_counters()
    out2, t2 = scenario.run_client_server_aes_scenario(client, ctx, KEY, IV,
                                                       2, rounds=10)
    batch = read_counters()
    assert out2 == expect, "keystream mismatch on the batch path"
    require_launches("2-block batch path", batch, MAIN_PATH)

    request = scenario.encrypt_request(client, ctx, STRATEGY, KEY, blocks[:1])
    reset_counters()
    with launch_shapes() as shapes:
        out1, t1 = scenario.serve_request(ctx, STRATEGY, *request, rounds=10)
    latency = read_counters()
    log("latency path, K3 and K4 launches by shape: " + ", ".join(
        f"{key}: {count}" for key, count in sorted(shapes.items())))
    assert scenario.read_response(client, ctx, STRATEGY, out1) == expect[:1], \
        "keystream mismatch on the latency path"
    require_launches("1-block latency path", latency, MAIN_PATH)
    log(f"key expansion: {t2['key_expansion_s']:.2f} s; 10 rounds x 2 "
        f"blocks: {t2['blocks_s']:.2f} s; latency path (1 block, expansion "
        f"included): {t1['fused_latency_s']:.2f} s")
    log("2-block batch path and 1-block latency path decrypt to the AES "
        "authority's keystream")
    return client, raw, ctx, request, out1.array, batch, latency


def phase_second_path(client, ctx, request, out_default, latency_default,
                      k1_ms_160):
    """The unfused lowerings at full width, held bit-for-bit against the
    default lowering on phase 4's keys and inputs."""
    log("== phase 5: full width, second path: lowering (grid, partials) "
        "with a compressed response, then a glue_out rotation")
    expect = aes_lib.encrypt_blocks(KEY, scenario.ctr_blocks(IV, 1))
    ctx_gp = dataclasses.replace(ctx, lowering=Lowering("grid", "partials"))
    reset_counters()
    out, t = scenario.serve_request(ctx_gp, STRATEGY, *request, rounds=10)
    got = scenario.read_response(client, ctx_gp, STRATEGY, out,
                                 compress_log2q=16)
    grid = read_counters()
    assert got == expect, "keystream mismatch under (grid, partials)"
    if not torch.equal(out.array, out_default):
        raise AssertionError("(grid, partials) ciphertext differs from the "
                             "default lowering's")
    log(f"latency path under (grid, partials): {t['fused_latency_s']:.2f} s; "
        "ciphertext bit-equal to the default lowering's; compressed "
        "response (q' = 2^16) decrypts to the AES authority's keystream")
    require_launches("latency path under (grid, partials)", grid,
                     ("rot_diff_digits", "extprod_step2",
                      "extprod_partials_grouped", "fused_limb_matmul"))
    n_lwe = P.lwe_dimension
    wanted = {"rot_diff_digits": 11 * n_lwe, "extprod_step2": 11 * n_lwe,
              "extprod_partials_grouped":
                  latency_default["extprod_grouped_fused"],
              "extprod_step2g": 0, "extprod_grouped_fused": 0}
    for name, count in wanted.items():
        if grid[name] != count:
            raise AssertionError(f"{name}: {grid[name]} launches under "
                                 f"(grid, partials), expected {count}")

    # one batched blind rotation under glue_out against the default schedule
    b = 160
    gen = torch.Generator().manual_seed(77)
    lwe = torch.randint(-2**62, 2**62, (b, n_lwe + 1), generator=gen,
                        dtype=torch.int64).to(DEV)
    acc = torch.randint(-2**62, 2**62, (P.glwe_dimension + 1,
                                        P.polynomial_size), generator=gen,
                        dtype=torch.int64).to(DEV)
    bsk = ctx.sks.bsk
    sync()
    t0 = time.time()
    ref = blind_rotate.blind_rotate_glwe(lwe, bsk, acc, P, Lowering())
    t_host = time.time() - t0          # every launch enqueued, none awaited
    sync()
    t_default = time.time() - t0
    reset_counters()
    t0 = time.time()
    got = blind_rotate.blind_rotate_glwe(lwe, bsk, acc, P,
                                         Lowering(br="glue_out"))
    sync()
    t_glue = time.time() - t0
    # K7 in the part it has, K6's reference: one more update of this
    # rotation's accumulator with BSK entry 0, through K6 and through K7
    o_cnt, r_cnt, nj, two_n = bsk[0].shape
    js = 8 - nj
    nd = torus.limbs_for_bound(decomposition.digit_bound(P.pbs_base_log))
    rot = polynomial.monomial_mul(got, blind_rotate.mod_switch(
        lwe[:, 0], P.log2_poly_size)[:, None])
    planes = torus.split_int32_signed(blind_rotate.decompose_glwe(
        rot - got, P.pbs_base_log, P.pbs_level), nd)
    ext8 = torch.zeros((8, r_cnt, o_cnt, two_n), dtype=torch.int8, device=DEV)
    ext8[js:] = bsk[0].permute(2, 1, 0, 3)
    k6 = kx.extprod_step(planes, bsk[0], got, js)
    k7 = got + polynomial.recombine_partials(kx.extprod_partials(planes, ext8))
    glue = read_counters()
    if not torch.equal(got, ref):
        raise AssertionError("glue_out rotation differs from the default")
    if not torch.equal(k6, k7):
        raise AssertionError("K7 recombined differs from K6 on the path")
    log(f"blind rotation, B={b}, {n_lwe} steps: default {t_default:.3f} s, "
        f"glue_out {t_glue:.3f} s, bit-equal; K6 == K7 recombined on its "
        "operands")
    log(f"host share of the default rotation: wall {t_default:.4f} s, the "
        f"host had enqueued all {n_lwe} steps after {t_host:.4f} s "
        f"({1e6 * t_host / n_lwe:.1f} us a step), {n_lwe} x K1's "
        f"{k1_ms_160:.4f} ms at B={b} = {n_lwe * k1_ms_160 / 1e3:.4f} s")
    require_launches("glue_out rotation", glue,
                     ("extprod_step", "extprod_partials"))
    return grid, glue


class _Tee(io.TextIOBase):
    """Writes to a stream and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.kept = stream, io.StringIO()

    def write(self, text):
        self.kept.write(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


def require_counts(what: str, counts: dict, wanted: dict) -> None:
    log(f"launches, {what}: {counts}")
    for name, count in wanted.items():
        if counts[name] != count:
            raise AssertionError(f"{name}: {counts[name]} launches in "
                                 f"{what}, expected {count}")


def phase_server(client, raw, ctx, request, out_default):
    """The keystream server at full width under Lowering("merged"), then
    the counter derivation under the default, "longk" and "bucket"
    lowerings. Returns the launch counts of the two requests and the three
    derivations."""
    log("== phase 6: full width, third path: the keystream server under "
        "lowering (merged, fused), then the counter derivation under longk "
        "and bucket")
    n_lwe = P.lwe_dimension
    blocks = scenario.ctr_blocks(IV, 2)
    expect = aes_lib.encrypt_blocks(KEY, blocks)
    key_np, block_np = (torus.to_numpy(x) for x in request)
    want_a = compression.wire_array(
        compression.compress_bits(out_default, ctx.sks, P, 16), 16)
    off = {"extprod_step2g": 0, "rot_diff_digits": 0, "extprod_step2": 0,
           "rot_diff_digits_flat": 0, "extprod_step_longk": 0,
           "extprod_step3": 0}
    tee = _Tee(sys.stderr)
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stderr(tee):
        bundle, addr = f"{tmp}/server_keys.npz", f"{tmp}/fhe.sock"
        t0 = time.time()
        serialization.save_server_keys(bundle, raw, P)
        log(f"key bundle saved: {os.path.getsize(bundle) / 1e6:.0f} MB in "
            f"{time.time() - t0:.1f} s")
        failed = []

        def run():
            try:
                serve.serve(bundle, addr, max_requests=2, device=DEV,
                            lowering=Lowering("merged"))
            except BaseException as e:
                failed.append(e)
                raise

        server = threading.Thread(target=run, daemon=True)
        t0 = time.time()
        server.start()
        wait_for_socket(addr, server.is_alive, "the server thread")
        # (a) a fresh key with one block: the latency path fills the cache
        reset_counters()
        meta_a, arr_a = serve.request_keystream(addr, key_np, block_np,
                                                rounds=10, compress=16)
        sync()
        t_a = time.time() - t0
        served_a = read_counters()
        # (b) the same key, two blocks derived from the one uploaded
        t0 = time.time()
        reset_counters()
        meta_b, arr_b = serve.request_keystream(
            addr, key_np, block_np, rounds=10, compress=16,
            fhe_counter_count=2)
        sync()
        t_b = time.time() - t0
        served_b = read_counters()
        server.join(timeout=120)
        if server.is_alive() or failed:
            raise AssertionError(f"the server thread did not end: {failed}")
    notes = tee.kept.getvalue()
    got_a = compression.decrypt_blocks_compressed(client, arr_a["comp"], 16)
    got_b = compression.decrypt_blocks_compressed(client, arr_b["comp"], 16)
    assert got_a == expect[:1], "keystream mismatch, served request (a)"
    assert got_b == expect, "keystream mismatch, served request (b)"
    if not (arr_a["comp"].dtype == want_a.dtype
            and np.array_equal(arr_a["comp"], want_a)):
        raise AssertionError("request (a)'s compressed answer differs from "
                             "the default lowering's")
    if (notes.count("cache miss") != 1 or "fused latency path" not in notes
            or notes.count("expanded-key cache hit") != 1):
        raise AssertionError(f"server log: {notes[-2000:]}")
    require_counts("served request (a), latency path under merged", served_a,
                   dict(off, cmux_step_merged=11 * n_lwe))
    require_counts("served request (b), cache hit + 1 increment + 10 rounds "
                   "under merged", served_b,
                   dict(off, cmux_step_merged=(8 + 10) * n_lwe))
    for counts in (served_a, served_b):
        if min(counts["extprod_grouped_fused"],
               counts["fused_limb_matmul"]) <= 0:
            raise AssertionError("a served request ran no K3 or no K4")
    log(f"server: bundle loaded + request (a) {t_a:.2f} s (latency path, "
        f"answer byte-equal to the default lowering's); request (b) "
        f"{t_b:.2f} s (cache hit, 2 blocks derived from 1, 10 rounds); both "
        "decrypt to the AES authority's keystream")

    # the counter derivation alone, under three lowerings
    block0 = request[1][0]
    outs, counts, secs = {}, {}, {}
    for br in ("gridg", "longk", "bucket"):
        ctx_br = dataclasses.replace(ctx, lowering=Lowering(br))
        reset_counters()
        t0 = time.time()
        outs[br] = ctr_fhe.derive_ctr_blocks(ctx_br, block0, 2)
        sync()
        secs[br] = time.time() - t0
        counts[br] = read_counters()
    for br in ("longk", "bucket"):
        if not torch.equal(outs[br], outs["gridg"]):
            raise AssertionError(f"derived blocks under {br} differ from "
                                 "the default lowering's")
    steps = 8 * n_lwe
    require_counts("derivation under gridg", counts["gridg"],
                   dict(off, extprod_step2g=steps, rot_diff_digits=8,
                        cmux_step_merged=0))
    require_counts("derivation under longk", counts["longk"],
                   dict(off, rot_diff_digits_flat=steps,
                        extprod_step_longk=steps, cmux_step_merged=0))
    require_counts("derivation under bucket", counts["bucket"],
                   dict(off, rot_diff_digits=steps, extprod_step3=steps,
                        cmux_step_merged=0))
    got = STRATEGY.decrypt_client(client, torus.to_numpy(outs["gridg"]))
    assert got == blocks, "derived counter blocks decrypt wrong"
    log("counter derivation (1 increment = 8 bootstraps of 9 lanes): "
        + ", ".join(f"{br} {secs[br]:.2f} s" for br in outs)
        + "; the three arrays bit-equal, decrypting to counters 1 and 2")
    return [served_a, served_b] + list(counts.values())


# ------------------------------------------- N = 1024: lvl1, lvl4, lvl256

P1 = params_mod.PARAMS_SQRD_LVL_1
P4 = params_mod.PARAMS_SQRD_LVL_4
P256 = params_mod.PARAMS_SQRD_LVL_256
WIDE = "N=1024"       # the name prefix of the rows measured at N = 1024
# the kernels the merged lowering must launch (K9 a CMux step)
MERGED = ("cmux_step_merged", "extprod_grouped_fused", "fused_limb_matmul")
# the lowerings phase 7 runs the lvl256 latency path under, the default
# first, each with the kernels it must launch: a CMux step's and a vertical
# packing stage's (K4, the keyswitches', under every one)
LATENCY_LOWERINGS = (
    (Lowering(), MAIN_PATH),
    (Lowering("grid", "partials"), ("rot_diff_digits", "extprod_step2",
                                    "extprod_partials_grouped",
                                    "fused_limb_matmul")),
    (Lowering("longk"), ("rot_diff_digits_flat", "extprod_step_longk",
                         "extprod_grouped_fused", "fused_limb_matmul")),
    (Lowering("bucket"), ("rot_diff_digits", "extprod_step3",
                          "extprod_grouped_fused", "fused_limb_matmul")),
    (Lowering("glue_out", "partials"), ("extprod_step",
                                        "extprod_partials_grouped",
                                        "fused_limb_matmul")),
    (Lowering("merged"), MERGED))


def step_operands(gen, k1, n, lv, nd, b, js, fill=None):
    """A CMux step's operands at (k+1, N, L, n_d, B, js), the rotations 0,
    N-1, N and 2N-1 among the lanes; fill: every digit and key byte."""
    acc = torch.randint(-2**62, 2**62, (k1, b, n), generator=gen,
                        dtype=torch.int64).to(DEV)
    t = torch.randint(0, 2 * n, (b,), generator=gen, dtype=torch.int32)
    t[:min(b, 4)] = torch.tensor([0, n - 1, n, 2 * n - 1])[:min(b, 4)]
    lo, hi = (-128, 128) if fill is None else (fill, fill + 1)
    return (acc, t.to(DEV), rand_i8(gen, (k1, lv, nd, b, n), lo, hi),
            rand_i8(gen, (k1, k1 * lv, 8 - js, 2 * n), lo, hi))


def check_wide_steps(rows, gen) -> None:
    """K1 (on wgmma, 8 blocks of 128 columns a cluster, the glue reading
    across them) and K5 (two column halves) at N = 1024 for both N = 1024
    gadgets — lvl1/lvl4's (2, 15) at R = 6 and lvl256's (4, 9) at R = 12 —
    over B in {1, 9, 13, 288} and js in {0, 2}, each against its plain
    version, K2 then K5 equal to K1; again with every digit and key byte
    -128 at R = 12; K2 at N = 1024 for every gadget it is built for at B in
    {9, 288}; then K1, K5 and K2 timed at the main path's B = 288 and 160
    for both sets."""
    done = 0
    for lv, bl in ((2, 15), (4, 9)):
        for b, js, fill in ([(b, js, None) for b in (1, 9, 13, 288)
                             for js in (0, 2)]
                            + ([(13, 2, -128), (288, 2, -128)] if lv == 4
                               else [])):
            acc, t, dig, ext = step_operands(gen, 3, 1024, lv, 2, b, js, fill)
            got = kx.extprod_step2g(dig, ext, acc.clone(), t, bl, lv, js)
            ref = kx.extprod_step2g_plain(dig, ext, acc.clone(), t, bl, lv,
                                          js)
            a5 = kx.extprod_step2(dig, ext, acc.clone(), js)
            ref5 = kx.extprod_step2_plain(dig, ext, acc.clone(), js)
            sync()
            if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
                    and torch.equal(a5, ref5) and torch.equal(a5, got[0])
                    and torch.equal(kx.rot_diff_digits(a5, t, bl, lv, 2),
                                    got[1])):
                raise AssertionError(f"K1, K5 or K2 then K5 differs at "
                                     f"N=1024, gadget ({lv}, {bl}), B={b}, "
                                     f"js={js}, fill={fill}")
            done += 1
    log(f"  N=1024: K1 and K5 bit-equal to plain and K2 then K5 == K1 in "
        f"{done} cases: gadgets (2, 15) at R=6 and (4, 9) at R=12 x B in "
        "{1, 9, 13, 288} x js in {0, 2}, and every digit and key byte -128 "
        "at R=12, B in {13, 288}")
    cases = 0
    for b in (9, 288):
        acc, t, _, _ = step_operands(gen, 3, 1024, 1, 2, b, 7)
        for lv, bl in sorted(kx.GLUE_GADGETS):
            nd = torus.limbs_for_bound(decomposition.digit_bound(bl))
            if not torch.equal(kx.rot_diff_digits(acc, t, bl, lv, nd),
                               kx.rot_diff_digits_plain(acc, t, bl, lv, nd)):
                raise AssertionError(f"K2 differs at N=1024, B={b}, gadget "
                                     f"({lv}, {bl})")
            cases += 1
    log(f"  N=1024: K2 bit-equal to plain for every built gadget "
        f"{sorted(kx.GLUE_GADGETS)} at B in {{9, 288}} ({cases} cases)")
    for name, p in (("lvl256", P256), ("lvl1", P1)):
        lv, bl = p.pbs_level, p.pbs_base_log
        nd = torus.limbs_for_bound(decomposition.digit_bound(bl))
        js = truncation.bsk_j_start(p)
        for b in (160, 288):
            acc, t, dig, ext = step_operands(gen, 3, 1024, lv, nd, b, js)
            k1, _, n = acc.shape
            r = k1 * lv
            macs = b * k1 * r * n * n * pairs(nd, js)
            scratch = acc.clone()
            got = kx.extprod_step2g(dig, ext, acc.clone(), t, bl, lv, js)
            ref = kx.extprod_step2g_plain(dig, ext, acc.clone(), t, bl, lv,
                                          js)
            sync()
            err = max(max_abs_err(got[0], ref[0]), max_abs_err(got[1], ref[1]))
            record(f"extprod_step2g {WIDE} {kx.k1_path(n)} {name} B={b}",
                   rows["extprod_step2g"], macs,
                   dig.numel() * 2 + ext.numel() + acc.numel() * 16 + b * 4,
                   time_ms(lambda: kx.extprod_step2g(dig, ext, scratch, t, bl,
                                                     lv, js)),
                   time_ms(lambda: kx.extprod_step2g_plain(
                       dig, ext, scratch, t, bl, lv, js), reps=2), err)
            err = max_abs_err(kx.extprod_step2(dig, ext, acc.clone(), js),
                              kx.extprod_step2_plain(dig, ext, acc.clone(),
                                                     js))
            record(f"extprod_step2 {WIDE} {name} B={b}",
                   rows["extprod_step2"], macs,
                   dig.numel() + ext.numel() + acc.numel() * 16,
                   time_ms(lambda: kx.extprod_step2(dig, ext, scratch, js)),
                   time_ms(lambda: kx.extprod_step2_plain(dig, ext, scratch,
                                                          js), reps=2), err)
            out = kx.rot_diff_digits(acc, t, bl, lv, nd)
            err = max_abs_err(out, kx.rot_diff_digits_plain(acc, t, bl, lv,
                                                            nd))
            record(f"rot_diff_digits {WIDE} {name} B={b}",
                   rows["rot_diff_digits"], 0,
                   acc.numel() * 8 + out.numel() + b * 4,
                   time_ms(lambda: kx.rot_diff_digits(acc, t, bl, lv, nd)),
                   time_ms(lambda: kx.rot_diff_digits_plain(acc, t, bl, lv,
                                                            nd), reps=2),
                   err)


def check_wide_schedules(rows, gen) -> None:
    """The longk, bucket, glue_out and merged steps at N = 1024, where K6,
    K7, K10b and K11 split each row tile's columns between two blocks and
    K9's 2·O blocks of a lane tile are one cluster: K6, K10a, K10b (the
    wrapper's split and unsplit) and K11 (the wrapper's split, unsplit and
    a row a block) at the steps of lvl1 (R = 6, (2, 15)), lvl256 (R = 12,
    (4, 9)) and the 8-bit model (R = 18, (6, 7), one limb), B in {1, 9, 13,
    160, 288}, the set's js and js in {0, 2}, on random digits, each
    bit-equal to its plain version and to K5's update, K10a to K2 permuted,
    K9 (its own glue's digits) to its plain version and to K2 then K5; again
    with every digit and key byte -128 at R = 12 (check_step_schedules,
    untimed). K7 at N = 1024 (all 8 key planes)
    against its plain version, its buckets recombined equal to K6's
    update, also at -128, timed. Then one step of each schedule against K2
    then K5 at lvl256's and the 8-bit model's shapes, B in {9, 32, 128,
    288}, timed at lvl256's B = 9 and 288 and the 8-bit model's B = 32.
    The lvl256 latency path's, lvl4's circuit bootstrap's and the 8-bit
    rounds' own batches are checked where those run (check_path_steps)."""
    done = 0
    for name, p in (("lvl1", P1), ("lvl256", P256), ("8-bit", P8)):
        k1, n, lv = p.glwe_dimension + 1, p.polynomial_size, p.pbs_level
        nd = torus.limbs_for_bound(decomposition.digit_bound(p.pbs_base_log))
        js_set = truncation.bsk_j_start(p)
        cases = [(b, js, None) for b in (1, 9, 13, 160, 288)
                 for js in sorted({js_set, 0, 2})]
        if name == "lvl256":
            cases += [(13, 2, -128), (288, 2, -128)]
        for b, js, fill in cases:
            acc, t, dig, ext = step_operands(gen, k1, n, lv, nd, b, js, fill)
            check_step_schedules(
                rows, b, acc, t, ext, js, nd, p=p, timed=False,
                label=f"{WIDE} {name} js={js} "
                      + ("random digits " if fill is None else
                         f"every byte {fill} "), dig=dig)
            done += 1
    log(f"  N=1024: K6, K10a, K10b (split and unsplit), K11 (split, "
        f"unsplit, a row a block) and K9 bit-equal to plain and to K5, K10a "
        f"to K2 permuted, in {done} cases: lvl1 R=6, lvl256 R=12, 8-bit "
        "R=18 x B in {1, 9, 13, 160, 288} x js in {set's, 0, 2}, and every "
        "byte -128 at R=12, B in {13, 288}")
    # K7: all 8 key planes at lvl256's step; with the planes the BSK drops
    # zeroed, its buckets recombined are K6's update; again at -128; timed
    # on the random operands
    k1, n, r, nd, js, b = 3, 1024, 12, 2, 2, 288
    for fill in (None, -128):
        lo, hi = (-128, 128) if fill is None else (fill, fill + 1)
        dig_bm = rand_i8(gen, (nd, b, r, n), lo, hi)
        ext8 = rand_i8(gen, (8, r, k1, 2 * n), lo, hi)
        parts = kx.extprod_partials(dig_bm, ext8)
        low = ext8.clone()
        low[:js] = 0
        acc_bm = torch.randint(-2**62, 2**62, (b, k1, n), generator=gen,
                               dtype=torch.int64).to(DEV)
        if not torch.equal(
                acc_bm + polynomial.recombine_partials(
                    kx.extprod_partials(dig_bm, low)),
                kx.extprod_step(dig_bm, low[js:].permute(2, 1, 0,
                                                         3).contiguous(),
                                acc_bm, js)):
            raise AssertionError(f"K7 recombined differs from K6 at N=1024, "
                                 f"fill={fill}")
        record(f"extprod_partials {WIDE} lvl256 B={b}"
               + ("" if fill is None else f" every byte {fill}"),
               rows["extprod_partials"], b * k1 * r * n * n * pairs(nd, 0),
               dig_bm.numel() + ext8.numel() + parts.numel() * 4,
               None if fill else time_ms(lambda: kx.extprod_partials(dig_bm,
                                                                     ext8)),
               None if fill else time_ms(lambda: kx.extprod_partials_plain(
                   dig_bm, ext8), reps=2),
               max_abs_err(parts, kx.extprod_partials_plain(dig_bm, ext8)))
    log("  N=1024: K7 bit-equal to plain and recombined == K6's update at "
        "lvl256's step, B=288, also with every byte -128")
    for name, p, timed in (("lvl256", P256, (9, 288)), ("8-bit", P8, (32,))):
        k1, n, lv = p.glwe_dimension + 1, p.polynomial_size, p.pbs_level
        nd = torus.limbs_for_bound(decomposition.digit_bound(p.pbs_base_log))
        js = truncation.bsk_j_start(p)
        for b in (9, 32, 128, 288):
            acc, t, _, ext = step_operands(gen, k1, n, lv, nd, b, js)
            check_step_schedules(rows, b, acc, t, ext, js, nd, p=p,
                                 timed=b in timed, label=f"{WIDE} {name} ")
    log("  N=1024: one step of merged, longk, bucket and glue_out == K2 then "
        "K5 at lvl256's and the 8-bit model's step, B in {9, 32, 128, 288}")
    # K9's clusters of 2·O blocks, one block an SM: how many the card holds
    # at once, so how many waves a step's ceil(B/8) clusters take
    f = kx._fn("merged_wide", "tfhe_cmux_step_merged_wide_clusters",
               [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
    for name, p in (("lvl256", P256), ("8-bit", P8)):
        k1, lv = p.glwe_dimension + 1, p.pbs_level
        nd = torus.limbs_for_bound(decomposition.digit_bound(p.pbs_base_log))
        held = ctypes.c_int(0)
        build.check(f(k1, lv, nd, truncation.bsk_j_start(p),
                      ctypes.byref(held)), "cmux_step_merged")
        tiles = {b: -(-b // 8) for b in (9, 32, 128, 160, 288)}
        log(f"  N=1024: K9 at {name}'s step: the card holds {held.value} "
            f"clusters of {2 * k1} blocks at once "
            f"(cudaOccupancyMaxActiveClusters), {held.value * 2 * k1} of "
            f"its SMs; B = " + ", ".join(
                f"{b}: {c} clusters in {-(-c // max(1, held.value))} waves"
                for b, c in tiles.items()))


def check_path_steps(rows, gen, name: str, p, shapes, brs) -> None:
    """K6, K9, K10a, K10b (split and unsplit) and K11 (split, unsplit, a
    row a block) at each (B, js) of the blind rotations a run at the set p
    made under the schedules brs (its launch_shapes tally), against their
    plain versions and K2 then K5 (check_step_schedules, untimed, on K2's
    digits): every batch the run's CMux steps took is held against the
    plain versions."""
    k1, n, lv = p.glwe_dimension + 1, p.polynomial_size, p.pbs_level
    nd = torus.limbs_for_bound(decomposition.digit_bound(p.pbs_base_log))
    seen = set().union(*(step_batches(shapes, br) for br in brs))
    gadget = f"({lv},{p.pbs_base_log})"
    if not seen or any((x[0], x[3]) != (n, gadget) for x in seen):
        raise AssertionError(f"{name}: the rotations under {brs} ran at "
                             f"{sorted(seen)}, not only at N={n} with the "
                             f"gadget {gadget}")
    found = sorted({(b, js) for _, b, js, _ in seen})
    for b, js in found:
        acc, t, _, ext = step_operands(gen, k1, n, lv, nd, b, js)
        check_step_schedules(rows, b, acc, t, ext, js, nd, p=p, timed=False,
                             label=f"{WIDE} {name} path js={js} ")
    log(f"  {name}: K6, K9, K10a, K10b and K11 bit-equal to plain and to K2 "
        f"then K5 at the (B, js) of the rotations under {'/'.join(brs)}: "
        f"{found}")


def check_wide_limb_matmul(rows, gen) -> None:
    """K4 at lvl1's pfKS (four digit limbs) for B in {9, 288} and at
    lvl256's keyswitch and pfKS for B = 288, each against its plain
    version, timed."""
    for name, p, bs in (("lvl1", P1, (9, 288)), ("lvl256", P256, (288,))):
        for what, nd_m, kk, nn, js_m in k4_shapes(p):
            if name == "lvl1" and what != "pfKS":
                continue
            m = kmm.kmajor_key_planes(rand_i8(gen, (8 - js_m, kk, nn)))
            for b in bs:
                d = rand_i8(gen, (nd_m, b, kk))
                got = kmm.fused_limb_matmul(d, m, js_m)
                ref = kmm.fused_limb_matmul_plain(d, m, js_m)
                sync()
                record(f"fused_limb_matmul {WIDE} {name} {what} n_d={nd_m} "
                       f"B={b} (split {kmm._splits(b, kk, nn)})",
                       rows["fused_limb_matmul"],
                       b * kk * nn * pairs(nd_m, js_m),
                       d.numel() + m.numel() + got.numel() * 8,
                       time_ms(lambda: kmm.fused_limb_matmul(d, m, js_m)),
                       time_ms(lambda: kmm.fused_limb_matmul_plain(d, m,
                                                                   js_m),
                               reps=2), max_abs_err(got, ref))
            del m


def check_wide_vp(rows, gen, shapes) -> None:
    """K3 and K8 at N = 1024 at each (lanes, G) the lvl256 latency path
    launched K3 at (its launch_shapes tally), against their plain versions,
    K8 recombined equal to K3, timed; and with every digit and key byte
    -128 at the widest of them."""
    k1, n = P256.glwe_dimension + 1, P256.polynomial_size
    r = k1 * P256.cbs_level
    nd = torus.limbs_for_bound(decomposition.digit_bound(P256.cbs_base_log))
    js = truncation.vp_ggsw_j_start(P256)
    found = sorted({(int(k.split("lanes=")[1].split()[0]),
                     int(k.split("G=")[1])) for k in shapes
                    if k.startswith("K3 ")})
    if not found:
        raise AssertionError("the lvl256 latency path launched no K3")
    for lanes, g in found:
        dig = rand_i8(gen, (lanes, r, nd * g, n))
        ext = rand_i8(gen, (lanes, k1, r, 8 - js, 2 * n))
        fused = kx.extprod_grouped_fused(dig, ext, nd, js)
        ref = kx.extprod_grouped_fused_plain(dig, ext, nd, js)
        dig_8 = dig.reshape(lanes, r, nd, g, n).permute(2, 0, 3, 1,
                                                       4).contiguous()
        ext_8 = ext.permute(3, 0, 2, 1, 4).contiguous()
        parts = kx.extprod_partials_grouped(dig_8, ext_8, js)
        ref8 = kx.extprod_partials_grouped_plain(dig_8, ext_8, js)
        sync()
        if not torch.equal(polynomial.recombine_partials(parts, js),
                           fused.permute(0, 2, 1, 3)):
            raise AssertionError(f"K8 recombined differs from K3 at N=1024, "
                                 f"{lanes} lanes, G={g}")
        macs = lanes * g * k1 * r * n * n * pairs(nd, js)
        record(f"extprod_grouped_fused {WIDE} lvl256 lanes={lanes} G={g}",
               rows["extprod_grouped_fused"], macs,
               dig.numel() + ext.numel() + fused.numel() * 8,
               time_ms(lambda: kx.extprod_grouped_fused(dig, ext, nd, js)),
               time_ms(lambda: kx.extprod_grouped_fused_plain(dig, ext, nd,
                                                              js), reps=2),
               max_abs_err(fused, ref))
        record(f"extprod_partials_grouped {WIDE} lvl256 lanes={lanes} G={g}",
               rows["extprod_partials_grouped"], macs,
               dig.numel() + ext.numel() + parts.numel() * 4,
               time_ms(lambda: kx.extprod_partials_grouped(dig_8, ext_8, js)),
               time_ms(lambda: kx.extprod_partials_grouped_plain(
                   dig_8, ext_8, js), reps=2), max_abs_err(parts, ref8))
    lanes, g = max(found, key=lambda x: x[0] * x[1])
    dig = torch.full((lanes, r, nd * g, n), -128, dtype=torch.int8,
                     device=DEV)
    ext = torch.full((lanes, k1, r, 8 - js, 2 * n), -128, dtype=torch.int8,
                     device=DEV)
    fused = kx.extprod_grouped_fused(dig, ext, nd, js)
    dig_8 = torch.full((nd, lanes, g, r, n), -128, dtype=torch.int8,
                       device=DEV)
    ext_8 = torch.full((8 - js, lanes, r, k1, 2 * n), -128, dtype=torch.int8,
                       device=DEV)
    parts = kx.extprod_partials_grouped(dig_8, ext_8, js)
    if not (torch.equal(fused, kx.extprod_grouped_fused_plain(dig, ext, nd,
                                                              js))
            and torch.equal(parts, kx.extprod_partials_grouped_plain(
                dig_8, ext_8, js))
            and torch.equal(polynomial.recombine_partials(parts, js),
                            fused.permute(0, 2, 1, 3))):
        raise AssertionError("K3 or K8 differs at N=1024 at the value -128")
    log(f"  N=1024: K3 and K8 bit-equal to plain at the lvl256 path's "
        f"(lanes, G) {found} and with every byte -128 at {lanes} x {g}, K8 "
        "recombined equal to K3")


def run_cli(argv, what, wanted) -> tuple[dict, dict, float]:
    """cli.main on the card with the launch counters reset just before and
    read just after, K3's and K4's launches tallied by shape; returns (the
    counts, the tally, wall seconds). cli.main checks the keystream against
    the AES authority itself and raises if it differs."""
    log(f"-- {what}: python -m tfhe_aes2_tpu_torch.cli {' '.join(argv)}")
    reset_counters()
    t0 = time.time()
    with launch_shapes() as shapes:
        if cli.main(argv, device=DEV) != 0:
            raise AssertionError(f"{what}: cli.main did not return 0")
    sync()
    secs = time.time() - t0
    counts = read_counters()
    log(f"{what}: launches by shape: " + ", ".join(
        f"{key}: {count}" for key, count in sorted(shapes.items())))
    require_launches(what, counts, wanted)
    return counts, shapes, secs


def phase_wide(rows, gen, keep: dict):
    """The N = 1024 sets at full width under the default lowering, each
    decrypted and checked against the AES authority: lvl256 through the
    CLI with one block (the fused latency path) and with two (the staged
    key schedule and rounds), lvl256 under the reference's pairing
    ShortintWoppbs1BitSboxPbsAesEncrypt (the depth-11 pipeline, its key
    expanded by the eager schedule), and lvl1's SBOX+GalMul circuit
    bootstrap of one block's 16 bytes, the only K4 launch with four digit
    limbs (lvl1's budget, max_noise_level_squared 1, stops the AES
    pipeline at its first XOR, as in the JAX package), and lvl4's under
    longk and merged. Between them lvl256's 2 blocks through the CLI again
    under TFHE_BR_KERNEL=merged, the lvl256 latency path on one encrypted
    request under the default lowering and under LATENCY_LOWERINGS' five
    others, each bit-equal to the default's and verified, and the server on
    those keys under merged (serve_wide_merged). Then K3 and K8 at the
    (lanes, G) the lvl256 latency path launched. Returns the launch counts
    of the CLI's three runs, the pairing's, the other lowerings' latency
    runs, the served request and the three circuit bootstraps."""
    log("== phase 7: the N = 1024 sets at full width, default lowering "
        "(gridg, fused), merged through the CLI and the server, and the "
        "latency path under five others")
    argv = ["--key", KEY.hex(), "--iv", IV.hex(), "--params", "lvl256"]
    lat, lat_shapes, lat_s = run_cli(argv + ["--number-of-outputs", "1"],
                                     "lvl256, 1 block (latency path)",
                                     MAIN_PATH)
    batch, _, batch_s = run_cli(argv + ["--number-of-outputs", "2"],
                                "lvl256, 2 blocks (staged)", MAIN_PATH)
    log(f"lvl256 through cli.main: 1 block {lat_s:.2f} s and 2 blocks "
        f"{batch_s:.2f} s of wall time, keygen included; both verified "
        "against the AES authority")
    with environment(TFHE_BR_KERNEL="merged", TFHE_BR_GLUE=None,
                     TFHE_VP_FUSED=None):
        batch9, _, batch9_s = run_cli(
            argv + ["--number-of-outputs", "2"],
            "lvl256, 2 blocks (staged), TFHE_BR_KERNEL=merged", MERGED)
    if batch9["extprod_step2g"] or batch9["rot_diff_digits"]:
        raise AssertionError("lvl256 under merged launched K1 or K2")
    log(f"lvl256 through cli.main under TFHE_BR_KERNEL=merged, 2 blocks: "
        f"{batch9_s:.2f} s of wall time, keygen included; verified against "
        "the AES authority")

    t0 = time.time()
    client, raw = keys_mod.generate_keys(P256, seed=0, device=DEV)
    ctx = model.context_from_keys(P256, raw, lowering=Lowering())
    sync()
    log(f"lvl256 keygen (seeded) + key preparation: {time.time() - t0:.1f} s")
    reset_counters()
    out, t = scenario.run_client_server_aes_scenario(
        client, ctx, KEY, IV, 1,
        strategy=fhe.ShortintWoppbs1BitSboxPbsAesEncrypt)
    pairing = read_counters()
    assert out == aes_lib.encrypt_blocks(KEY, scenario.ctr_blocks(IV, 1))
    require_launches("lvl256 under ShortintWoppbs1BitSboxPbsAesEncrypt",
                     pairing, MAIN_PATH)
    log(f"lvl256 under ShortintWoppbs1BitSboxPbsAesEncrypt, 1 block: key "
        f"expansion (eager) {t['key_expansion_s']:.2f} s, 10 rounds "
        f"{t['blocks_s']:.2f} s ({pairing['rot_diff_digits']} bootstraps in "
        "all, one a round); verified against the AES authority")
    # the latency path on one encrypted request under the default lowering
    # and under four others, each with its own kernels a CMux step and a
    # vertical-packing stage, at N = 1024; each run's launches
    request = scenario.encrypt_request(client, ctx, STRATEGY, KEY,
                                       scenario.ctr_blocks(IV, 1))
    outs, runs, path_shapes = {}, [], {}
    for low, kernels in LATENCY_LOWERINGS:
        reset_counters()
        with launch_shapes() as shapes:
            out, t = scenario.serve_request(
                dataclasses.replace(ctx, lowering=low), STRATEGY, *request,
                rounds=10)
        sync()
        outs[low] = out.array
        counts = read_counters()
        path_shapes.update(shapes)
        got = scenario.read_response(client, ctx, STRATEGY, out)
        assert got == aes_lib.encrypt_blocks(KEY, scenario.ctr_blocks(IV, 1))
        log(f"lvl256 latency path under ({low.br}, {low.vp}): "
            f"{t['fused_latency_s']:.2f} s")
        if not torch.equal(out.array, outs[Lowering()]):
            raise AssertionError(f"lvl256: ({low.br}, {low.vp}) ciphertext "
                                 "differs from the default lowering's")
        require_launches(f"lvl256 latency path under ({low.br}, {low.vp})",
                         counts, kernels)
        if low != Lowering():
            runs.append(counts)
    log(f"lvl256: the {len(outs)} lowerings' ciphertexts bit-equal, all "
        "verified")
    runs.append(serve_wide_merged(client, raw, ctx, request,
                                  outs[Lowering()]))
    keep["lvl256"] = (client, ctx)             # phase 9's noise floor
    keep["lvl256_request"] = (request, outs[Lowering()])   # phase 10
    del ctx, raw
    check_path_steps(rows, gen, "lvl256", P256, path_shapes,
                     ("longk", "bucket", "glue_out", "merged"))

    runs += sbox_circuit_bootstrap("lvl1", P1, (Lowering(),))[0]
    counts, shapes = sbox_circuit_bootstrap(
        "lvl4", P4, (Lowering("longk"), Lowering("merged")))
    runs += counts
    check_path_steps(rows, gen, "lvl4", P4, shapes, ("longk", "merged"))
    check_wide_vp(rows, gen, lat_shapes)
    return [lat, batch, batch9, pairing] + runs


def serve_wide_merged(client, raw, ctx, request, out_default) -> dict:
    """The keystream server on a bundle of phase 7's lvl256 keys, saved and
    loaded back, serving on a thread under Lowering("merged") (K9 at
    N = 1024 a CMux step): one fresh-key request, the latency path, whose
    compressed answer must be byte-equal to the default lowering's and
    decrypt to the AES keystream. Returns its launch counts."""
    n_lwe = P256.lwe_dimension
    key_np, block_np = (torus.to_numpy(x) for x in request)
    want = compression.wire_array(
        compression.compress_bits(out_default, ctx.sks, P256, 16), 16)
    tee = _Tee(sys.stderr)
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stderr(tee):
        bundle, addr = f"{tmp}/server_keys.npz", f"{tmp}/fhe.sock"
        t0 = time.time()
        serialization.save_server_keys(bundle, raw, P256)
        log(f"lvl256 key bundle saved: {os.path.getsize(bundle) / 1e6:.0f} "
            f"MB in {time.time() - t0:.1f} s")
        failed = []

        def run():
            try:
                serve.serve(bundle, addr, max_requests=1, device=DEV,
                            lowering=Lowering("merged"))
            except BaseException as e:
                failed.append(e)
                raise

        server = threading.Thread(target=run, daemon=True)
        t0 = time.time()
        server.start()
        wait_for_socket(addr, server.is_alive, "the lvl256 server thread")
        reset_counters()
        _, arr = serve.request_keystream(addr, key_np, block_np, rounds=10,
                                         compress=16)
        sync()
        secs = time.time() - t0
        counts = read_counters()
        server.join(timeout=120)
        if server.is_alive() or failed:
            raise AssertionError(f"the lvl256 server thread did not end: "
                                 f"{failed}")
    notes = tee.kept.getvalue()
    got = compression.decrypt_blocks_compressed(client, arr["comp"], 16)
    if got != aes_lib.encrypt_blocks(KEY, scenario.ctr_blocks(IV, 1)):
        raise AssertionError("keystream mismatch, served lvl256 request")
    if not (arr["comp"].dtype == want.dtype
            and np.array_equal(arr["comp"], want)):
        raise AssertionError("the served lvl256 answer differs from the "
                             "default lowering's")
    if "cache miss" not in notes or "fused latency path" not in notes:
        raise AssertionError(f"lvl256 server log: {notes[-2000:]}")
    require_counts("served lvl256 request, latency path under merged",
                   counts, {"cmux_step_merged": 11 * n_lwe,
                            "extprod_step2g": 0, "rot_diff_digits": 0,
                            "extprod_step2": 0})
    require_launches("served lvl256 request", counts, MERGED)
    log(f"lvl256 server under (merged, fused): bundle loaded + one fresh-key "
        f"request {secs:.2f} s (latency path); the answer byte-equal to the "
        "default lowering's and decrypted to the AES keystream")
    return counts


def sbox_circuit_bootstrap(name: str, p, lowerings) -> tuple[list, dict]:
    """The SBOX+GalMul circuit bootstrap of one block's 16 bytes (128
    lanes) at the set p under each of `lowerings` on one set of seeded
    keys, each of S(x)·1, ·2, ·3 decrypted against the AES tables; the
    launch counters reset just before and read just after each run (the
    lowering's kernels and K4 must launch; at lvl1 K4 must take four digit
    limbs). Returns the runs' counts and their launch_shapes tally."""
    t0 = time.time()
    client, raw = keys_mod.generate_keys(p, seed=0, device=DEV)
    ctx = model.context_from_keys(p, raw, lowering=lowerings[0])
    sync()
    log(f"{name} keygen (seeded) + key preparation: {time.time() - t0:.1f} s")
    block = aes_lib.encrypt_blocks(KEY, scenario.ctr_blocks(IV, 1))[0]
    bits = np.unpackbits(np.frombuffer(block, np.uint8)[:, None], axis=-1)
    runs, tally = [], {}
    for lowering in lowerings:
        ctx = dataclasses.replace(ctx, lowering=lowering)
        state = model.fresh_bitct(torus.to_tensor(client.encrypt_bits(bits),
                                                  DEV), ctx, lane_ndim=2)
        reset_counters()
        t0 = time.time()
        with launch_shapes() as shapes:
            muls = sbox_gal_mul_pbs.sub_bytes_with_gal_mul(ctx, state)
        sync()
        cbs_s = time.time() - t0
        counts = read_counters()
        for mul, got in zip((1, 2, 3), muls):
            dec = np.packbits(client.decrypt_bits(torus.to_numpy(got.array))
                              .astype(np.uint8), axis=-1)[:, 0]
            want = [gf_256_mul(int(SBOX[x]), mul) for x in block]
            if list(dec) != want:
                raise AssertionError(f"{name} SBOX x {mul} decrypts wrong "
                                     f"under ({lowering.br}, {lowering.vp})")
        log(f"{name}: launches by shape: " + ", ".join(
            f"{key}: {count}" for key, count in sorted(shapes.items())))
        require_launches(f"{name} SBOX+GalMul circuit bootstrap under "
                         f"({lowering.br}, {lowering.vp})", counts,
                         lowering.kernels() + ("fused_limb_matmul",))
        if name == "lvl1" and not any(k.startswith("K4 pfKS n_d=4")
                                      for k in shapes):
            raise AssertionError("lvl1's pfKS did not launch K4 at n_d=4")
        log(f"{name} SBOX+GalMul circuit bootstrap of 16 bytes (128 lanes) "
            f"under ({lowering.br}, {lowering.vp}): {cbs_s:.2f} s; S(x)·1, "
            "·2, ·3 decrypt right for every byte")
        runs.append(counts)
        tally.update(shapes)
    return runs, tally


# ------------------- the other two models: tree PBS and 8-bit WoP-PBS

P_TREE = tm1b.PARAMS_SHORTINT_1BIT
P8 = params_mod.PARAMS_WOPPBS_8BIT
TREE = "tree"         # the name prefix of the rows measured at P_TREE


def check_model_steps(rows, gen) -> None:
    """K1, K5 and K2 at the two models' blind rotations — the tree's
    PARAMS_SHORTINT_1BIT (N = 512, R = 35, gadget (7, 6), the new K2 and
    K10a build) and the 8-bit model's PARAMS_WOPPBS_8BIT (N = 1024, R = 18,
    gadget (6, 7)), both one limb a digit — over B in {1, 9, 13, 288} and
    js in {0, 1}, with every byte -128 at js = 1: each against its plain
    version, K2 then K5 equal to K1; at the tree's N = 512 also K10a equal
    to K2 permuted, and K6, K9, K10b and K11 (the glue_out, merged, longk
    and bucket steps, which the CLI admits for the tree set) equal to their
    plain versions and to K5.
    Then K1, K5 and K2 timed at the widest B each model's path gives: the
    2-byte tree SBOX's first level (2,048 lanes) and a 16-byte circuit
    bootstrap of the 8-bit model (128 lanes), with its 4-byte one (32); at
    the tree's 2,048 lanes also K6, K9, K10a, K10b and K11
    (check_step_schedules)."""
    done = 0
    for name, p in ((TREE, P_TREE), ("8-bit", P8)):
        k1, n = p.glwe_dimension + 1, p.polynomial_size
        lv, bl = p.pbs_level, p.pbs_base_log
        nd = torus.limbs_for_bound(decomposition.digit_bound(bl))
        for b, js, fill in [(b, js, None) for b in (1, 9, 13, 288)
                            for js in (0, 1)] + [(13, 1, -128),
                                                 (288, 1, -128)]:
            acc, t, dig, ext = step_operands(gen, k1, n, lv, nd, b, js, fill)
            got = kx.extprod_step2g(dig, ext, acc.clone(), t, bl, lv, js)
            ref = kx.extprod_step2g_plain(dig, ext, acc.clone(), t, bl, lv,
                                          js)
            a5 = kx.extprod_step2(dig, ext, acc.clone(), js)
            d2 = kx.rot_diff_digits(acc, t, bl, lv, nd)
            ok = (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
                  and torch.equal(a5, kx.extprod_step2_plain(
                      dig, ext, acc.clone(), js))
                  and torch.equal(a5, got[0])
                  and torch.equal(kx.rot_diff_digits(a5, t, bl, lv, nd),
                                  got[1])
                  and torch.equal(d2, kx.rot_diff_digits_plain(acc, t, bl,
                                                               lv, nd)))
            if n <= 512:
                # the N <= 512 lowerings at the tree's step: K10a; K6, K10b
                # and K11 on the same digits as K5 and K9 on K2's, each
                # equal to its plain version and to K5
                flat = dig.permute(2, 3, 0, 1, 4).reshape(nd, b, k1 * lv * n)
                dig_bm = dig.reshape(k1 * lv, nd, b, n).permute(
                    1, 2, 0, 3).contiguous()
                acc_bm = acc.permute(1, 0, 2).contiguous()
                k6 = kx.extprod_step(dig_bm, ext, acc_bm, js)
                k9 = kx.cmux_step_merged(t, ext, acc.clone(), bl, lv, js)
                k10 = kx.extprod_step_longk(flat, ext, acc.clone(), js)
                k11 = kx.extprod_step3(dig, ext, acc.clone(), js)
                ok = (ok and torch.equal(
                    kx.rot_diff_digits_flat(acc, t, bl, lv, nd),
                    d2.permute(2, 3, 0, 1, 4).reshape(nd, b, k1 * lv * n))
                    and torch.equal(k6, kx.extprod_step_plain(
                        dig_bm, ext, acc_bm, js))
                    and torch.equal(k6.permute(1, 0, 2), a5)
                    and torch.equal(k9, kx.cmux_step_merged_plain(
                        t, ext, acc.clone(), bl, lv, js))
                    and torch.equal(k9, kx.extprod_step2(d2, ext,
                                                         acc.clone(), js))
                    and torch.equal(k10, kx.extprod_step_longk_plain(
                        flat, ext, acc.clone(), js))
                    and torch.equal(k10, a5)
                    and torch.equal(k11, kx.extprod_step3_plain(
                        dig, ext, acc.clone(), js))
                    and torch.equal(k11, a5))
            sync()
            if not ok:
                raise AssertionError(f"K1, K5, K2, K6, K9, K10a, K10b or K11 "
                                     f"differs at {name} B={b} js={js} "
                                     f"fill={fill}")
            done += 1
    log(f"  the two models' steps: K1 and K5 bit-equal to plain, K2 then K5 "
        f"== K1, K2 at gadgets (7, 6) and (6, 7), and at the tree's N = 512 "
        f"K10a, K6, K9, K10b and K11 bit-equal to plain and to K5, in "
        f"{done} cases (B in {{1, 9, 13, 288}} x js in {{0, 1}}, and every "
        f"byte -128 at B in {{13, 288}})")
    for name, p, bs in ((TREE, P_TREE, (2048,)), (f"{WIDE} 8-bit", P8,
                                                  (128, 32))):
        k1, n = p.glwe_dimension + 1, p.polynomial_size
        lv, bl = p.pbs_level, p.pbs_base_log
        nd = torus.limbs_for_bound(decomposition.digit_bound(bl))
        js = truncation.bsk_j_start(p)
        r = k1 * lv
        for b in bs:
            acc, t, dig, ext = step_operands(gen, k1, n, lv, nd, b, js)
            macs = b * k1 * r * n * n * pairs(nd, js)
            scratch = acc.clone()
            got = kx.extprod_step2g(dig, ext, acc.clone(), t, bl, lv, js)
            ref = kx.extprod_step2g_plain(dig, ext, acc.clone(), t, bl, lv,
                                          js)
            sync()
            record(f"extprod_step2g {name} B={b} R={r}",
                   rows["extprod_step2g"], macs,
                   dig.numel() * 2 + ext.numel() + acc.numel() * 16 + b * 4,
                   time_ms(lambda: kx.extprod_step2g(dig, ext, scratch, t,
                                                     bl, lv, js)),
                   time_ms(lambda: kx.extprod_step2g_plain(
                       dig, ext, scratch, t, bl, lv, js), reps=2),
                   max(max_abs_err(got[0], ref[0]),
                       max_abs_err(got[1], ref[1])))
            record(f"extprod_step2 {name} B={b} R={r}",
                   rows["extprod_step2"], macs,
                   dig.numel() + ext.numel() + acc.numel() * 16,
                   time_ms(lambda: kx.extprod_step2(dig, ext, scratch, js)),
                   time_ms(lambda: kx.extprod_step2_plain(dig, ext, scratch,
                                                          js), reps=2),
                   max_abs_err(kx.extprod_step2(dig, ext, acc.clone(), js),
                               kx.extprod_step2_plain(dig, ext, acc.clone(),
                                                      js)))
            out = kx.rot_diff_digits(acc, t, bl, lv, nd)
            record(f"rot_diff_digits {name} B={b} ({lv}, {bl})",
                   rows["rot_diff_digits"], 0,
                   acc.numel() * 8 + out.numel() + b * 4,
                   time_ms(lambda: kx.rot_diff_digits(acc, t, bl, lv, nd)),
                   time_ms(lambda: kx.rot_diff_digits_plain(acc, t, bl, lv,
                                                            nd), reps=2),
                   max_abs_err(out, kx.rot_diff_digits_plain(acc, t, bl, lv,
                                                             nd)))
            if name == TREE:
                # the other schedules' kernels (K6, K9, K10a, K10b, K11),
                # which the CLI admits for the tree set, timed at its step
                check_step_schedules(rows, b, acc, t, ext, js, nd, p=p,
                                     label=f"{TREE} ")


def check_model_products(rows, gen) -> None:
    """K3 at the tree's selection product (R = 2, G = 1, O = 5, n_d = 1,
    js = 0, N = 512; the 2-byte SBOX's first level, 1,024 pairs), through
    polynomial.polymul_shared_digits and on its own operands, against its
    plain version; K3 and K8 split at N = 1024 with one limb (the 8-bit model's
    vertical packing: R = 12, O = 3, G = 1, js = 3) at 16 and 4 lanes, K8
    recombined equal to K3, and with every byte -128; K4 at the tree's
    packing keyswitch and keyswitch and at the 8-bit model's keyswitch and
    pfKS. Each against its plain version, timed."""
    k1, n = P_TREE.glwe_dimension + 1, P_TREE.polynomial_size
    lanes = 1024
    polys = torch.randint(-2**63, 2**63 - 1, (lanes, 2, k1, n),
                          generator=gen, dtype=torch.int64).to(DEV)
    masks = tm1b.selection_masks(n, DEV)
    # K3's own operands, as polymul_shared_digits lays them out
    ext = kx.split_polys_ext(polys).permute(1, 3, 2, 0, 4).contiguous()
    dig = masks[None, :, None, :].expand(lanes, 2, 1, n).contiguous()
    got = kx.extprod_grouped_fused(dig, ext, 1, 0)
    ref = kx.extprod_grouped_fused_plain(dig, ext, 1, 0)
    sync()
    if not torch.equal(polynomial.polymul_shared_digits(masks, polys),
                       got[:, :, 0]):
        raise AssertionError("polymul_shared_digits differs from K3")
    record(f"extprod_grouped_fused {TREE} selection pairs={lanes} R=2 G=1",
           rows["extprod_grouped_fused"], lanes * k1 * 2 * n * n * 8,
           dig.numel() + ext.numel() + got.numel() * 8,
           time_ms(lambda: kx.extprod_grouped_fused(dig, ext, 1, 0)),
           time_ms(lambda: kx.extprod_grouped_fused_plain(dig, ext, 1, 0),
                   reps=2), max_abs_err(got, ref))
    sel_ms = time_ms(lambda: polynomial.polymul_shared_digits(masks, polys))
    log(f"    the whole selection product (limb split, permute, K3) on the "
        f"card: {sel_ms:.4f} ms")
    del polys, ext, dig, got, ref

    k1, n = P8.glwe_dimension + 1, P8.polynomial_size
    r = k1 * P8.cbs_level
    nd = torus.limbs_for_bound(decomposition.digit_bound(P8.cbs_base_log))
    js = truncation.vp_ggsw_j_start(P8)
    for lanes, g, fill in ((16, 1, None), (4, 1, None), (16, 1, -128)):
        lo, hi = (-128, 128) if fill is None else (fill, fill + 1)
        dig = rand_i8(gen, (lanes, r, nd * g, n), lo, hi)
        ext = rand_i8(gen, (lanes, k1, r, 8 - js, 2 * n), lo, hi)
        fused = kx.extprod_grouped_fused(dig, ext, nd, js)
        ref = kx.extprod_grouped_fused_plain(dig, ext, nd, js)
        dig_8 = dig.reshape(lanes, r, nd, g, n).permute(2, 0, 3, 1,
                                                       4).contiguous()
        ext_8 = ext.permute(3, 0, 2, 1, 4).contiguous()
        parts = kx.extprod_partials_grouped(dig_8, ext_8, js)
        ref8 = kx.extprod_partials_grouped_plain(dig_8, ext_8, js)
        sync()
        if not torch.equal(polynomial.recombine_partials(parts, js),
                           fused.permute(0, 2, 1, 3)):
            raise AssertionError(f"K8 recombined differs from K3 at the "
                                 f"8-bit model's {lanes} lanes, fill={fill}")
        if fill is not None:
            if not (torch.equal(fused, ref) and torch.equal(parts, ref8)):
                raise AssertionError("K3 or K8 differs at the 8-bit model's "
                                     "shape at the value -128")
            log(f"  {WIDE} 8-bit: K3 and K8 (n_d = 1 split builds) bit-equal "
                f"to plain with every byte -128 at {lanes} lanes")
            continue
        macs = lanes * g * k1 * r * n * n * pairs(nd, js)
        record(f"extprod_grouped_fused {WIDE} 8-bit lanes={lanes} G={g} "
               f"n_d={nd}", rows["extprod_grouped_fused"], macs,
               dig.numel() + ext.numel() + fused.numel() * 8,
               time_ms(lambda: kx.extprod_grouped_fused(dig, ext, nd, js)),
               time_ms(lambda: kx.extprod_grouped_fused_plain(dig, ext, nd,
                                                              js), reps=2),
               max_abs_err(fused, ref))
        record(f"extprod_partials_grouped {WIDE} 8-bit lanes={lanes} G={g} "
               f"n_d={nd}", rows["extprod_partials_grouped"], macs,
               dig.numel() + ext.numel() + parts.numel() * 4,
               time_ms(lambda: kx.extprod_partials_grouped(dig_8, ext_8, js)),
               time_ms(lambda: kx.extprod_partials_grouped_plain(
                   dig_8, ext_8, js), reps=2), max_abs_err(parts, ref8))

    def nd_of(base_log):
        return torus.limbs_for_bound(decomposition.digit_bound(base_log))
    # (name, what, n_d, K, N, js, B): B as the 2-byte tree SBOX's first
    # level and a 16-byte bootstrap of the 8-bit model give them
    shapes = [
        (TREE, "packing KS", nd_of(P_TREE.ks_base_log),
         P_TREE.lwe_dimension * P_TREE.ks_level,
         (P_TREE.glwe_dimension + 1) * P_TREE.polynomial_size, 0, 1024),
        (TREE, "keyswitch") + k4_shapes(P_TREE)[0][1:] + (2048,),
        (f"{WIDE} 8-bit", "keyswitch") + k4_shapes(P8)[0][1:] + (16,),
        (f"{WIDE} 8-bit", "pfKS") + k4_shapes(P8)[1][1:] + (128,)]
    for name, what, nd_m, kk, nn, js_m, b in shapes:
        m = kmm.kmajor_key_planes(rand_i8(gen, (8 - js_m, kk, nn)))
        d = rand_i8(gen, (nd_m, b, kk))
        got = kmm.fused_limb_matmul(d, m, js_m)
        ref = kmm.fused_limb_matmul_plain(d, m, js_m)
        sync()
        record(f"fused_limb_matmul {name} {what} n_d={nd_m} B={b} (split "
               f"{kmm._splits(b, kk, nn)})", rows["fused_limb_matmul"],
               b * kk * nn * pairs(nd_m, js_m),
               d.numel() + m.numel() + got.numel() * 8,
               time_ms(lambda: kmm.fused_limb_matmul(d, m, js_m)),
               time_ms(lambda: kmm.fused_limb_matmul_plain(d, m, js_m),
                       reps=2), max_abs_err(got, ref))
        del m


def cards_against_the_cpu() -> None:
    """On keys made once from a seed on the CPU and carried onto both
    devices: one tree SBOX output bit at PARAMS_TEST_S1 (255 bootstraps),
    and one byte's bootstrap_from_bits through the SBOX LUT followed by
    extract_bits_from_ciphertext at PARAMS_TEST_8BIT, on the card and with
    the plain versions on the CPU: bit-equal, and decrypting right."""
    byte = 0x3A
    bits = np.unpackbits(np.array([byte], np.uint8)[:, None], axis=-1)[0]
    sbox_msb = lambda v: (int(SBOX[v]) >> 7) & 1            # noqa: E731
    for pset, mod in ((tm1b.PARAMS_TEST_S1, tm1b),
                      (params_mod.PARAMS_TEST_8BIT, tm8)):
        client, raw = keys_mod.generate_keys(pset, seed=11, device="cpu")
        raw_card = keys_mod.ServerKeySet(*(x.to(DEV) for x in raw))
        if mod is tm1b:
            ct = client.encrypt_encodings_small(
                bits.astype(np.uint64) << np.uint64(62))
        else:
            ct = client.encrypt_bits_small(bits)
        outs = {}
        for dev, sks in (("cpu", raw), (DEV, raw_card)):
            ctx = mod.context_from_keys(pset, sks, lowering=Lowering())
            arr = torus.to_tensor(ct, dev)
            t0 = time.time()
            if mod is tm1b:
                out = tm1b.calculate_multivariate_function(
                    ctx, tm1b.Bit1Ct(arr, ctx),
                    tm1b.generate_multivariate_test_vector(ctx, 8,
                                                           sbox_msb)).array
                what = "tree SBOX output bit (255 bootstraps)"
            else:
                fw = ctx.bootstrap_from_bits(
                    tm8.fresh_linear_bitct(arr, ctx),
                    ctx.generate_lookup_table(lambda v: int(SBOX[v])))
                out = torch.cat([fw.array.reshape(-1), ctx
                                 .extract_bits_from_ciphertext(fw).array
                                 .reshape(-1)])
                what = ("bootstrap_from_bits + extract_bits_from_ciphertext "
                        "of one byte")
            if dev == DEV:
                sync()
            outs[dev] = out.cpu()
            name = "PARAMS_TEST_S1" if mod is tm1b else "PARAMS_TEST_8BIT"
            log(f"  {what} at {name} on {dev}: {time.time() - t0:.2f} s")
        if not torch.equal(outs["cpu"], outs[DEV]):
            raise AssertionError(f"{mod.__name__}: the card differs from the "
                                 "CPU's plain versions")
        arr = torus.to_numpy(outs[DEV])
        if mod is tm1b:
            got = int(fhe.Shortint1BitSboxPbsAesEncrypt.decrypt_bits(client,
                                                                     arr))
            want = sbox_msb(byte)
        else:
            small = arr[-8 * (pset.lwe_dimension + 1):].reshape(1, 8, -1)
            got = fhe.ShortintWoppbs8BitSboxPbsAesEncrypt.decrypt_client(
                client, small)[0][0]
            want = int(SBOX[byte])
        if got != want:
            raise AssertionError(f"{mod.__name__}: decrypts to {got}, not "
                                 f"{want}")
    log("card == CPU (plain versions), bit for bit, on the same keys: the "
        "tree SBOX bit at PARAMS_TEST_S1 and the 8-bit byte op at "
        "PARAMS_TEST_8BIT; both decrypt right")


@contextlib.contextmanager
def environment(**values):
    """os.environ with `values` set (None: removed) inside the block."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_models(rows, gen):
    """The other two models at full width: the card against the CPU on the
    same keys at the test sets; the tree model's SBOX on 2 bytes at
    PARAMS_SHORTINT_1BIT; the 8-bit model through cli.main at
    PARAMS_WOPPBS_8BIT, 2 rounds, under the default lowering, and its rounds
    again under (gridg, partials), (longk, fused) and (merged, fused),
    bit-equal, the longk and merged rounds' step kernels held against their
    plain versions at the batches they ran (rows, gen: check_path_steps').
    Returns the launch counts of the tree run, the CLI run, the partials,
    the longk and the merged rounds."""
    log("== phase 8: the other two models at full width")
    t0 = time.time()
    cards_against_the_cpu()
    log(f"step 1 (card against the CPU): {time.time() - t0:.1f} s")
    t0 = time.time()
    tree = tree_sbox()
    log(f"step 2 (tree SBOX, keygen included): {time.time() - t0:.1f} s")
    t0 = time.time()
    runs = woppbs_8bit_cli(rows, gen)
    log(f"step 3 (8-bit model, the CLI run and its rounds under partials, "
        f"longk and merged): {time.time() - t0:.1f} s")
    return [tree] + runs


def tree_sbox() -> dict:
    """The tree model's SBOX on 2 bytes at PARAMS_SHORTINT_1BIT (8 output
    bits x 255 bootstraps a byte, each tree level one batch), decrypted
    against SBOX[x]; returns its launch counts."""
    t0 = time.time()
    client, ctx = tm1b.generate_keys(P_TREE, seed=0, device=DEV,
                                     lowering=Lowering())
    ops = tm1b.Shortint1BitByteOps(ctx)
    ops._sbox_tvs()
    sync()
    log(f"PARAMS_SHORTINT_1BIT keygen (seeded) + key preparation + the SBOX "
        f"leaf tables: {time.time() - t0:.1f} s")
    byts = np.array([0x53, 0xC5], np.uint8)
    bits = np.unpackbits(byts[:, None], axis=-1)
    state = tm1b.fresh_lane_bit1ct(torus.to_tensor(
        client.encrypt_encodings_small(bits.astype(np.uint64)
                                       << np.uint64(62)), DEV), ctx)
    pk = P_TREE.lwe_dimension * P_TREE.ks_level
    labels = {(pk, (P_TREE.glwe_dimension + 1) * P_TREE.polynomial_size):
              "packing KS"}
    reset_counters()
    t0 = time.time()
    with launch_shapes(labels) as shapes:
        out = ops.sub_bytes(state)
    sync()
    tree_s = time.time() - t0
    tree = read_counters()
    dec = b"".join(fhe.Shortint1BitSboxPbsAesEncrypt.decrypt_client(
        client, torus.to_numpy(out.array)))
    if dec != bytes(int(SBOX[x]) for x in byts):
        raise AssertionError(f"tree SBOX decrypts to {dec.hex()}")
    log("tree SBOX, 2 bytes: K3 and K4 launches by shape: " + ", ".join(
        f"{key}: {count}" for key, count in sorted(shapes.items())))
    require_launches("tree SBOX at PARAMS_SHORTINT_1BIT, 2 bytes", tree,
                     MAIN_PATH)
    log(f"tree SBOX at PARAMS_SHORTINT_1BIT, 2 bytes x 8 output bits "
        f"(4,080 blind rotations of {P_TREE.lwe_dimension} steps): "
        f"{tree_s:.2f} s; both bytes decrypt to SBOX[x]")
    return tree


def woppbs_8bit_cli(rows, gen) -> list:
    """The 8-bit model through cli.main on the card at PARAMS_WOPPBS_8BIT,
    1 block, 2 rounds, under the default lowering, verified by the CLI
    against the plain 2-round oracle; then the same 2 rounds again on the
    same prepared keys, expanded key and encrypted block under (gridg,
    partials) — the lowering TFHE_VP_FUSED=0 selects — which must launch K8
    and no K3 and give the fused run's output ciphertexts bit for bit.
    Then the same 2 rounds under (longk, fused), K10a + K10b and no K1, and
    under (merged, fused), K9 and no K1 or K2, each bit-equal too and
    decrypted against the plain 2-round oracle, and K6, K9, K10a, K10b and
    K11 held against their plain versions at each (B, js) those rounds ran
    their CMux steps at. Returns the four runs' launch counts."""
    argv = ["--implementation", "shortint-woppbs-8bit", "--key", KEY.hex(),
            "--iv", IV.hex(), "--number-of-outputs", "1", "--rounds", "2"]
    seen = {}
    real_serve, real_schedule = scenario.serve_request, fhe.key_schedule_staged
    real_read = scenario.read_response

    def read(client, *args, **kwargs):
        seen["client"] = client
        return real_read(client, *args, **kwargs)

    def serve(ctx, strategy, key_ct, block_cts, rounds=10, **kwargs):
        out, timings = real_serve(ctx, strategy, key_ct, block_cts, rounds,
                                  **kwargs)
        seen.update(ctx=ctx, strategy=strategy, blocks=block_cts,
                    rounds=rounds, out=out.array)
        return out, timings

    def schedule(*args, **kwargs):
        seen["eks"] = real_schedule(*args, **kwargs)
        return seen["eks"]
    scenario.serve_request, fhe.key_schedule_staged = serve, schedule
    scenario.read_response = read
    try:
        with environment(TFHE_BR_KERNEL=None, TFHE_BR_GLUE=None,
                         TFHE_VP_FUSED=None):
            fused, _, secs = run_cli(argv, "8-bit model, default lowering",
                                     MAIN_PATH)
    finally:
        scenario.serve_request, fhe.key_schedule_staged = (real_serve,
                                                           real_schedule)
        scenario.read_response = real_read
    log(f"8-bit model through cli.main, 1 block, 2 rounds, (gridg, fused): "
        f"{secs:.2f} s of wall time, keygen included; verified against the "
        f"plain 2-round oracle")
    ctx = dataclasses.replace(seen["ctx"], lowering=Lowering("gridg",
                                                             "partials"))
    eks = dataclasses.replace(seen["eks"], context=ctx)
    reset_counters()
    t0 = time.time()
    out = fhe.encrypt_blocks_staged(seen["strategy"], ctx, eks,
                                    seen["blocks"], seen["rounds"]).array
    sync()
    secs = time.time() - t0
    partials = read_counters()
    require_launches("8-bit model, (gridg, partials)", partials,
                     ("extprod_step2g", "rot_diff_digits",
                      "extprod_partials_grouped", "fused_limb_matmul"))
    if partials["extprod_grouped_fused"] != 0:
        raise AssertionError("the (gridg, partials) rounds launched K3")
    if not torch.equal(out, seen["out"]):
        raise AssertionError("8-bit model: the partials rounds' ciphertext "
                             "differs from the fused run's")
    log(f"8-bit model, the same 2 rounds under (gridg, partials) on the same "
        f"keys and expanded key: {secs:.2f} s; output ciphertexts bit-equal "
        f"to the fused run's (K8 {partials['extprod_partials_grouped']} "
        f"launches, no K3)")
    # the same rounds under (longk, fused): K10a + K10b a CMux step at
    # N = 1024, their rows split to fill the card at 4-32 lanes
    ctx = dataclasses.replace(seen["ctx"], lowering=Lowering("longk"))
    eks = dataclasses.replace(seen["eks"], context=ctx)
    reset_counters()
    t0 = time.time()
    with launch_shapes() as shapes:
        out = fhe.encrypt_blocks_staged(seen["strategy"], ctx, eks,
                                        seen["blocks"], seen["rounds"]).array
    sync()
    longk_s = time.time() - t0
    longk = read_counters()
    require_launches("8-bit model, (longk, fused)", longk,
                     ("rot_diff_digits_flat", "extprod_step_longk",
                      "extprod_grouped_fused", "fused_limb_matmul"))
    if longk["extprod_step2g"] != 0:
        raise AssertionError("the (longk, fused) rounds launched K1")
    if not torch.equal(out, seen["out"]):
        raise AssertionError("8-bit model: the longk rounds' ciphertext "
                             "differs from the fused run's")
    log(f"8-bit model, the same 2 rounds under (longk, fused) on the same "
        f"keys and expanded key: {longk_s:.2f} s against {secs:.2f} s under "
        f"(gridg, partials); output ciphertexts bit-equal to the fused run's "
        f"(K10a {longk['rot_diff_digits_flat']}, K10b "
        f"{longk['extprod_step_longk']} launches, no K1)")
    # and under (merged, fused): K9 a CMux step at N = 1024, a lane tile's
    # 2·O blocks one cluster
    ctx = dataclasses.replace(seen["ctx"], lowering=Lowering("merged"))
    eks = dataclasses.replace(seen["eks"], context=ctx)
    reset_counters()
    t0 = time.time()
    with launch_shapes() as shapes9:
        out = fhe.encrypt_blocks_staged(seen["strategy"], ctx, eks,
                                        seen["blocks"], seen["rounds"]).array
    sync()
    merged_s = time.time() - t0
    merged = read_counters()
    require_launches("8-bit model, (merged, fused)", merged, MERGED)
    if merged["extprod_step2g"] or merged["rot_diff_digits"]:
        raise AssertionError("the (merged, fused) rounds launched K1 or K2")
    if not torch.equal(out, seen["out"]):
        raise AssertionError("8-bit model: the merged rounds' ciphertext "
                             "differs from the fused run's")
    got = seen["strategy"].decrypt_client(seen["client"],
                                          torus.to_numpy(out))
    if got != plain.expand_key_and_encrypt_blocks(
            KEY, scenario.ctr_blocks(IV, 1), seen["rounds"]):
        raise AssertionError("8-bit model: the merged rounds decrypt wrong")
    log(f"8-bit model, the same 2 rounds under (merged, fused) on the same "
        f"keys and expanded key: {merged_s:.2f} s; output ciphertexts "
        f"bit-equal to the fused run's and decrypted to the plain 2-round "
        f"oracle (K9 {merged['cmux_step_merged']} launches, no K1 or K2)")
    check_path_steps(rows, gen, "8-bit", P8, {**shapes, **shapes9},
                     ("longk", "merged"))
    return [fused, partials, longk, merged]


# ------------------- phase 9: the noise check and the scale-out layer

SCALE_OUT_LAYOUTS = (("dp", 1), ("lane", 1), ("lanehost", 2))


def noise_floors(keep: dict) -> list:
    """noise.measure_sbox_floor at the four reference sets, lvl64 and
    lvl256 on phase 4's and phase 7's keys, lvl1 and lvl4 on new seeded
    ones, each within its bars (js and log2 std); then noise.measure at
    lvl64, 8 blocks x 10 rounds, verified, log2_std <= 59. Returns each
    run's launch counts."""
    runs = []
    for name, (p, _, dual_bar, out_bar) in noise.SBOX_FLOOR_SETS.items():
        if name in keep:
            client, ctx = keep[name]
        else:
            client, ctx = model.generate_keys(p, seed=0, device=DEV,
                                              lowering=Lowering())
        reset_counters()
        js, dual, out = noise.measure_sbox_floor(p, client, ctx, name)
        sync()
        counts = read_counters()
        require_launches(f"{name} SBOX floor", counts, MAIN_PATH)
        runs.append(counts)
        log(f"noise floor {name}: js (bsk, ksk, pfpksk, vp) = {js}, SBOX+"
            f"GalMul of 4 bytes decoded exactly, log2 std: dual {dual:.3f} "
            f"(bar {dual_bar}), out {out:.3f} (bar {out_bar})")
    with environment(TFHE_BR_KERNEL=None, TFHE_BR_GLUE=None,
                     TFHE_VP_FUSED=None):
        reset_counters()
        res = noise.measure(8, 10, device=DEV)
        counts = read_counters()
    require_launches("noise.measure, lvl64, 8 blocks x 10 rounds", counts,
                     MAIN_PATH)
    runs.append(counts)
    log("noise.measure: " + json.dumps(res))
    noise.check(res)
    log(f"lvl64 end to end, 8 blocks x 10 rounds: verified, log2_std "
        f"{res['log2_std']} <= {noise.LOG2_STD_MAX}, "
        f"{res['decode_margin_stds']} stds of margin to 2^62")
    return runs


def scale_out_jobs(tmp: str, want: torch.Tensor, params: str = "lvl64"
                   ) -> None:
    """The three layouts of parallel/distributed.py as 2-process gloo jobs
    sharing the card, and the gate at --processes 2, all at once (fresh
    interpreters; the kernels phase 1 built load from its build
    directory). Every child must exit 0 with its "ok" line; each worker's
    shards must equal `want`, the unsharded output of the same keys and
    inputs."""
    cmds, what = [], []
    for layout, bpd in SCALE_OUT_LAYOUTS:
        os.makedirs(f"{tmp}/{layout}")
        for rank in (0, 1):
            cmds.append([
                sys.executable, "-m",
                "tfhe_aes2_tpu_torch.parallel.distributed", "--backend",
                "gloo", "--init-method", f"file://{tmp}/{layout}/rendezvous",
                "--num-processes", "2", "--process-id", str(rank),
                "--device", DEV, "--params", params, "--rounds", "1",
                "--layout", layout, "--blocks-per-device", str(bpd),
                "--out-dir", f"{tmp}/{layout}"])
            what.append((f"{layout}, process {rank}",
                         f"ok: process {rank} verified"))
    cmds.append([sys.executable, "-m", "tfhe_aes2_tpu_torch.parallel.gate",
                 "--processes", "2", "--backend", "gloo", "--device", DEV,
                 "--params", params, "--out", f"{tmp}/gate.json"])
    what.append(("the gate", "ok: gate verified 2 processes"))
    t0 = time.time()
    rcs, outs, timed_out = gate.run_processes(cmds, 300, cwd=ROOT)
    secs = time.time() - t0
    for (name, ok_line), rc, out in zip(what, rcs, outs):
        lines = [ln for ln in out.splitlines() if ln.startswith("ok:")]
        if timed_out or rc != 0 or not any(ln.startswith(ok_line)
                                           for ln in lines):
            raise AssertionError(f"{name}: rc {rc}, timed out {timed_out}:"
                                 f"\n{out[-3000:]}")
        log(f"  {name}: {lines[-1]}")
    want = torus.to_numpy(want)
    for layout, _ in SCALE_OUT_LAYOUTS:
        seen = np.zeros(want.shape[:2], np.int64)
        for b0, c0, shard in distributed.load_shards(f"{tmp}/{layout}"):
            bs, nb = shard.shape[:2]
            if not np.array_equal(shard, want[b0: b0 + bs, c0: c0 + nb]):
                raise AssertionError(f"{layout}: shard ({b0}, {c0}) differs "
                                     "from the unsharded output")
            seen[b0: b0 + bs, c0: c0 + nb] += 1
        if not (seen == 1).all():
            raise AssertionError(f"{layout}: shards cover {seen.tolist()}")
    record = json.loads(Path(f"{tmp}/gate.json").read_text())
    log(f"2-process gloo jobs sharing the card (dp, lane, lanehost; lvl64, "
        f"2 blocks, 1 round) and the gate (2 processes, lanehost, lvl64) "
        f"ran together in {secs:.1f} s; each worker decrypt-verified, every "
        f"shard bit-equal to the one-device run; gate "
        f"{record['wall_s']} s, decrypt_verified {record['decrypt_verified']}")


def phase_scale_out(keep: dict) -> list:
    """Phase 9: the noise checks (noise_floors), then a one-device mesh
    (make_mesh(1), dp) at lvl64 on distributed.demo_inputs' keys and
    ciphertexts, 2 blocks x 1 round, bit-equal to encrypt_blocks_staged on
    the same context and inputs, then scale_out_jobs held against it.
    Returns the in-process runs' launch counts."""
    log("== phase 9: noise floors of the four sets, lvl64 end-to-end noise, "
        "a one-device mesh, 2-process gloo jobs and the gate")
    t0 = time.time()
    runs = noise_floors(keep)

    t1 = time.time()
    client, keys, ks_ct, block_cts, blocks = distributed.demo_inputs(
        P, 2, 3, DEV, exact=False)
    ks, cts = torus.to_tensor(ks_ct, DEV), torus.to_tensor(block_cts, DEV)
    fn = mesh.make_sharded_encrypt_blocks_fn(STRATEGY, P, 1,
                                             mesh.make_mesh(1, device=DEV),
                                             Lowering())
    reset_counters()
    out = fn(keys, ks, cts)
    sync()
    counts = read_counters()
    require_launches("one-device mesh, lvl64, 2 blocks x 1 round", counts,
                     MAIN_PATH)
    runs.append(counts)
    ctx = model.FheContext(params=P, sks=keys, lowering=Lowering())
    want = fhe.encrypt_blocks_staged(
        STRATEGY, ctx, STRATEGY.fresh(ks, ctx, lane_ndim=3), cts, 1).array
    if not torch.equal(out, want):
        raise AssertionError("the one-device mesh differs from "
                             "encrypt_blocks_staged")
    if (STRATEGY.decrypt_client(client, torus.to_numpy(out))
            != plain.expand_key_and_encrypt_blocks(distributed.KEY, blocks,
                                                   1)):
        raise AssertionError("the one-device mesh decrypts wrong")
    log(f"one-device mesh (dp), lvl64, 2 blocks x 1 round: bit-equal to "
        f"encrypt_blocks_staged and verified ({time.time() - t1:.1f} s "
        "with keygen)")
    del keys, ctx
    with tempfile.TemporaryDirectory() as tmp:
        scale_out_jobs(tmp, want)
    log(f"phase 9: {time.time() - t0:.1f} s")
    return runs


# ------------------- phase 10: the last modules: native keygen, the CRT-NTT
# vertical packing, the warm-up

VP_SHAPES = ((4, 8), (16, 8), (16, 24), (128, 1), (32, 24))   # phase 2's


def keygen_streams(raw64) -> None:
    """lvl64 keygen through _KeygenRng as the CLI takes it (native=None:
    the ChaCha20 core where cmake builds it, else numpy, as the JAX package
    does) and with the numpy stream, each timed; the first's keys must be
    phase 4's (the same seed and stream)."""
    for native in (None, False):
        sync()
        t0 = time.time()
        client, raw = keys_mod.generate_keys_numpy(P, seed=0, device=DEV,
                                                   native=native)
        sync()
        log(f"lvl64 keygen (native={native}): the {client.keygen_stream} "
            f"stream, {time.time() - t0:.2f} s")
        if native is None:
            for name in ("bsk", "ksk", "pfpksk", "pksk"):
                if not np.array_equal(raw[name],
                                      torus.to_numpy(getattr(raw64, name))):
                    raise AssertionError(f"lvl64 keygen: {name} differs "
                                         "from phase 4's")
    log("lvl64 keygen through _KeygenRng: the keys of phase 4 again")


def ntt_against_k3() -> list:
    """The CRT-NTT product at phase 2's vertical-packing shapes (lvl64:
    R = O = 5, js = 4, digits up to 2^12): on pre-truncated selectors,
    whose extension's dropped planes negate, bit-equal to K3 on the same
    operands; on random ones bit-equal to the NTT on the CPU. Each timed
    beside K3 and the float64 bound. Returns the rows."""
    gen = torch.Generator().manual_seed(2468)
    k1, n = P.glwe_dimension + 1, P.polynomial_size
    r = k1 * P.cbs_level
    js = truncation.vp_ggsw_j_start(P)
    d_bound = decomposition.digit_bound(P.cbs_base_log)
    nd = torus.limbs_for_bound(d_bound)
    rows = []
    for lanes, g in VP_SHAPES:
        digits = torch.randint(-d_bound, d_bound + 1, (lanes, g, r, n),
                               generator=gen, dtype=torch.int32).to(DEV)
        polys = torch.randint(-2**62, 2**62, (lanes, r, k1, n),
                              generator=gen, dtype=torch.int64).to(DEV) * 2
        planes = kx.split_polys_ext(truncation.truncate_u64_values(
            polys, js))[js:].contiguous()                 # [8-js, B, R, O, 2N]
        got = ntt.polymul_digits_ntt_grouped(digits, planes, d_bound, js)
        dig3 = torus.split_int32_signed(digits, nd).permute(
            1, 3, 0, 2, 4).reshape(lanes, r, nd * g, n).contiguous()
        ext3 = planes.permute(1, 3, 2, 0, 4).contiguous()  # [B, O, R, 8-js, 2N]
        k3 = kx.extprod_grouped_fused(dig3, ext3, nd, js)  # [B, O, G, N]
        raw_planes = kx.split_polys_ext(polys)[js:].contiguous()
        on_card = ntt.polymul_digits_ntt_grouped(digits, raw_planes, d_bound,
                                                 js)
        on_cpu = ntt.polymul_digits_ntt_grouped(digits.cpu(),
                                                raw_planes.cpu(), d_bound, js)
        sync()
        err = max(max_abs_err(got, k3.permute(0, 2, 1, 3)),
                  max_abs_err(on_card.cpu(), on_cpu))
        ms = time_ms(lambda: ntt.polymul_digits_ntt_grouped(
            digits, planes, d_bound, js))
        k3_ms = time_ms(lambda: kx.extprod_grouped_fused(dig3, ext3, nd, js))
        flops = (2 * n * 4 * n * (lanes * g * r + lanes * k1 * r * (8 - js))
                 + 2 * 4 * lanes * g * k1 * n * n)
        nbytes = digits.numel() * 4 + planes.numel() + got.numel() * 8
        t_ops = flops / PEAK_FP64_OPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        row = dict(name=f"ntt lanes={lanes} G={g}", ms=ms, k3_ms=k3_ms,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   gflop=flops / 1e9, max_abs_err=err)
        rows.append(row)
        log(f"  CRT-NTT lanes={lanes} G={g}: {ms:.4f} ms against K3's "
            f"{k3_ms:.4f} ms ({ms / k3_ms:.1f}x; float64 bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']}, "
            f"{row['gflop']:.2f} GFLOP), max_abs_err {err}")
        if err:
            raise AssertionError(f"the CRT-NTT at lanes={lanes} G={g} "
                                 "differs from K3 or from the CPU")
    return rows


def ntt_latency_lvl64(client, ctx, request, out_default) -> list:
    """The lvl64 latency path on phase 4's keys and request under
    Lowering(ntt=True): 4 kept planes, so every vertical-packing stage is
    the CRT-NTT and no K3 runs. AES-verified; timed in turns with the
    default (ntt, default, ntt); then once more with each distinct
    (lanes, G) NTT call held against the same call on the CPU, bit-equal
    to the first. Its ciphertext differs from phase 4's where a selector's
    dropped planes of -x are not those of x negated: the NTT reads only
    the first N columns, as the JAX package's does. Returns the counts."""
    expect = aes_lib.encrypt_blocks(KEY, scenario.ctr_blocks(IV, 1))
    nctx = dataclasses.replace(ctx, lowering=Lowering(ntt=True))
    times, runs, outs = {}, [], []
    for what, c in (("ntt", nctx), ("default", ctx), ("ntt", nctx)):
        reset_counters()
        out, t = scenario.serve_request(c, STRATEGY, *request, rounds=10)
        sync()
        counts = read_counters()
        times.setdefault(what, []).append(t["fused_latency_s"])
        if scenario.read_response(client, ctx, STRATEGY, out) != expect:
            raise AssertionError(f"lvl64 latency path ({what}) decrypts "
                                 "wrong")
        if what == "ntt":
            require_launches("lvl64 latency path under the CRT-NTT", counts,
                             ("extprod_step2g", "rot_diff_digits",
                              "fused_limb_matmul"))
            if (counts["extprod_grouped_fused"]
                    or counts["extprod_partials_grouped"]):
                raise AssertionError("lvl64 under the CRT-NTT launched K3 "
                                     "or K8")
            runs.append(counts)
            outs.append(out.array)
        elif not torch.equal(out.array, out_default):
            raise AssertionError("lvl64 default latency path differs from "
                                 "phase 4's")
    checked = {}
    plain = ntt.polymul_digits_ntt_grouped

    def held(digits, planes, d_bound, j_start=0):
        got = plain(digits, planes, d_bound, j_start)
        key = (digits.shape[0], digits.shape[1])
        if key not in checked:
            checked[key] = max_abs_err(got.cpu(), plain(
                digits.cpu(), planes.cpu(), d_bound, j_start))
        return got
    ntt.polymul_digits_ntt_grouped = held
    try:
        out, _ = scenario.serve_request(nctx, STRATEGY, *request, rounds=10)
        sync()
    finally:
        ntt.polymul_digits_ntt_grouped = plain
    if not all(torch.equal(x, out.array) for x in outs) or any(
            checked.values()):
        raise AssertionError(f"lvl64 under the CRT-NTT: runs differ or a "
                             f"call differs from the CPU: {checked}")
    differ = int((outs[0] != out_default).sum())
    log(f"lvl64 latency path under the CRT-NTT: {times['ntt']} s against "
        f"the default's {times['default']} s; 0 K3 launches, verified, "
        f"bit-equal across its 3 runs; the NTT calls at (lanes, G) "
        f"{sorted(checked)} bit-equal to the CPU's; {differ} of "
        f"{out_default.numel()} words differ from phase 4's ciphertext "
        "(the NTT reads the selectors' first N columns, as the JAX "
        "package's does)")
    return runs


def ntt_latency_lvl256(client, ctx, request, out_default) -> dict:
    """The lvl256 latency path under Lowering(ntt=True): 5 kept planes,
    so the vertical packing falls back to K3 (the JAX package's own
    semantics), and the ciphertext is phase 7's. Returns the counts."""
    reset_counters()
    out, t = scenario.serve_request(
        dataclasses.replace(ctx, lowering=Lowering(ntt=True)), STRATEGY,
        *request, rounds=10)
    sync()
    counts = read_counters()
    require_launches("lvl256 latency path under the CRT-NTT (K3 fallback)",
                     counts, MAIN_PATH)
    if not torch.equal(out.array, out_default):
        raise AssertionError("lvl256 under the CRT-NTT differs from phase 7")
    if (scenario.read_response(client, ctx, STRATEGY, out)
            != aes_lib.encrypt_blocks(KEY, scenario.ctr_blocks(IV, 1))):
        raise AssertionError("lvl256 under the CRT-NTT decrypts wrong")
    log(f"lvl256 latency path under the CRT-NTT: {t['fused_latency_s']:.2f} "
        f"s, K3 {counts['extprod_grouped_fused']} launches (the fallback at "
        "5 planes), bit-equal to phase 7's, verified")
    return counts


def warmup_cli() -> dict:
    """cli.main at lvl64, one output, as a subprocess: with the warm-up
    (TFHE_AOT unset: on for the card) and under TFHE_AOT=0; both must
    verify. Returns the walls and the warm-up's line."""
    argv = [sys.executable, "-m", "tfhe_aes2_tpu_torch.cli", "--key",
            KEY.hex(), "--iv", IV.hex(), "--number-of-outputs", "1",
            "--params", "lvl64"]
    found = {}
    for setting in (None, "0"):
        env = {k: v for k, v in os.environ.items() if k != "TFHE_AOT"}
        if setting is not None:
            env["TFHE_AOT"] = setting
        t0 = time.time()
        proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        wall = time.time() - t0
        lines = proc.stdout.splitlines()
        warm = [ln for ln in lines if ln.startswith("warm-up:")]
        if (proc.returncode != 0 or not any(
                ln.startswith("ok: FHE keystream verified") for ln in lines)
                or bool(warm) != (setting is None)):
            raise AssertionError(f"cli (TFHE_AOT={setting}) failed:\n"
                                 f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        keys = [ln for ln in lines if ln.startswith("keys generated")]
        log(f"cli lvl64, 1 block, TFHE_AOT={setting}: {wall:.2f} s wall, "
            f"verified; {keys[0] if keys else ''}"
            + (f"; {warm[0]}" if warm else ""))
        found[setting] = dict(wall=wall, warm=warm[0] if warm else None)
    return found


def phase_last_modules(raw64, client64, ctx64, request64, out64,
                       keep: dict, smi: str) -> list:
    """Phase 10: keygen_streams, ntt_against_k3, ntt_latency_lvl64,
    ntt_latency_lvl256, warmup_cli, every timing on the card `smi` names.
    Returns the in-process runs' launch counts."""
    log("== phase 10: the last modules: native keygen, the CRT-NTT vertical "
        f"packing, the warm-up (card: {smi})")
    t0 = time.time()
    keygen_streams(raw64)
    rows = ntt_against_k3()
    runs = ntt_latency_lvl64(client64, ctx64, request64, out64)
    client, ctx = keep["lvl256"]
    runs.append(ntt_latency_lvl256(client, ctx, *keep["lvl256_request"]))
    cli_runs = warmup_cli()
    log(json.dumps({"card": smi, "ntt": rows, "warmup_cli": cli_runs}))
    log(f"phase 10: {time.time() - t0:.1f} s (card: {smi})")
    return runs


# ------------------- phase 11: the bench entry at 16 blocks, and lvl64mxu

BENCH_BLOCKS = 16
P_MXU = params_mod.PARAMS_SQRD_LVL_64_MXU
MXU = "lvl64mxu"      # the name prefix of the rows measured at P_MXU
BENCH = "bench"       # the label of the rows at the bench's batch shapes
BENCH_ENV = dict(BENCH_PARAMS="lvl64", BENCH_BLOCKS=str(BENCH_BLOCKS),
                 BENCH_ROUNDS="10", BENCH_REPS="3", BENCH_COMPRESS="16",
                 BENCH_LATENCY="1", BENCH_STAGES="1", BENCH_AOT="1")
BENCH_LATENCY_KEYS = ("reused_key_latency_s", "latency_1block_s",
                      "latency_1block_fused_s", "scenario_10_outputs_s")


def check_bench_shapes(rows, gen) -> None:
    """The kernels at the shapes the bench's batches give them, never run
    before this phase: K1 and K2 at B = 1280 (the 10-block scenario) and
    2048 (16 blocks x 128 bits), K3 at the 16-block SubBytes' 256 lanes x
    G = 8 (the last round) and 24 (the other rounds), K4's keyswitch and
    pfKS at B = 2048 with the torch._int_mm yardstick beside each; each
    against its plain version, timed. Their rows carry the BENCH label: the
    kernels JSON lists them under `shapes`, its main-path rows stay phase
    2's."""
    for b in (10 * 128, BENCH_BLOCKS * 128):
        check_step_at(rows, gen, P, b, f"{BENCH} ")
    for g in (8, 24):
        check_vp_at(rows, gen, P, BENCH_BLOCKS * 16, g, f"{BENCH} ")
    for shape in k4_shapes():
        _, _, kk, nn, js_m = shape
        m = kmm.kmajor_key_planes(rand_i8(gen, (8 - js_m, kk, nn)))
        check_k4_at(rows, gen, shape, m, BENCH_BLOCKS * 128, f"{BENCH} ",
                    yard=True)
        del m


def mxu_run(rows, gen) -> dict:
    """lvl64mxu (k = 8, N = 256: O = 9, R = 27) through the CTR scenario,
    2 blocks x 10 rounds under the default lowering, decrypted against the
    AES authority, launch counters reset just before and read just after;
    then K1 and K2 at every batch its blind rotations took (timed at the
    widest) and K3 at every (lanes, G) it launched, against their plain
    versions. Returns the run's counts."""
    t0 = time.time()
    client, raw = keys_mod.generate_keys(P_MXU, seed=0, device=DEV)
    ctx = model.context_from_keys(P_MXU, raw, lowering=Lowering())
    del raw
    sync()
    log(f"lvl64mxu keygen + key preparation: {time.time() - t0:.1f} s")
    reset_counters()
    with launch_shapes() as shapes:
        _, timings = scenario.run_client_server_aes_scenario(
            client, ctx, KEY, IV, 2, rounds=10)
    counts = read_counters()
    require_launches("lvl64mxu, 2 blocks x 10 rounds", counts, MAIN_PATH)
    log("lvl64mxu launches by shape: " + ", ".join(
        f"{key}: {count}" for key, count in sorted(shapes.items())))
    log(f"lvl64mxu 2 blocks x 10 rounds, verified: key expansion "
        f"{timings['key_expansion_s']:.3f} s, 10 rounds "
        f"{timings['blocks_s']:.3f} s")
    del client, ctx
    batches = sorted({b for _, b, _, _ in step_batches(shapes, "gridg")})
    for b in batches:
        check_step_at(rows, gen, P_MXU, b, f"{MXU} ", timed=b == batches[-1])
    vp = sorted({(int(k.split("lanes=")[1].split()[0]),
                  int(k.split("G=")[1])) for k in shapes
                 if k.startswith("K3 ")})
    for lanes, g in vp:
        check_vp_at(rows, gen, P_MXU, lanes, g, f"{MXU} ",
                    timed=(lanes, g) == max(vp, key=lambda x: x[0] * x[1]))
    log(f"  lvl64mxu: K1 and K2 bit-equal to plain at the rotations' B "
        f"{batches}, K3 at (lanes, G) {vp}")
    return counts


def bench_subprocess() -> tuple[dict, dict, float]:
    """python -m tfhe_aes2_tpu_torch.bench at BENCH_ENV (lvl64, 16 blocks,
    10 rounds, 3 reps, compressed, latency and stages on, its warm-up on)
    as a subprocess. Fails unless it exits 0 with a verified result of
    bench.py's keys. Returns (its JSON line, its launches over one steady
    rep, wall seconds)."""
    env = {k: v for k, v in os.environ.items() if k != "TFHE_AOT"}
    env.update(BENCH_ENV)
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "tfhe_aes2_tpu_torch.bench"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.time() - t0
    for ln in proc.stderr.splitlines():
        log("  " + ln)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"bench rc {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    res = json.loads(lines[-1])
    sec = res.get("secondary") or {}
    if ("error" in res or not res["value"] > 0
            or sec.get("params") != BENCH_ENV["BENCH_PARAMS"]
            or any(not sec.get(k, 0) > 0 for k in BENCH_LATENCY_KEYS)
            or set(sec.get("stage_ms_per_round") or ())
            != {"ks", "pbs", "pfks", "vp"}):
        raise AssertionError(f"bench result: {lines[-1]}")
    marker = "[bench] launches over one steady rep: "
    launches = json.loads(next(ln for ln in proc.stderr.splitlines()
                               if ln.startswith(marker))[len(marker):])
    require_launches("bench, 16 blocks x 10 rounds, one steady rep",
                     {**dict.fromkeys(KERNELS, 0), **launches}, MAIN_PATH)
    return res, launches, wall


def phase_bench(rows, gen, smi: str) -> tuple[list, dict]:
    """Phase 11: check_bench_shapes, mxu_run, bench_subprocess. Returns the
    mxu run's and the bench's launch counts, and the bench's JSON line."""
    log("== phase 11: the bench entry at 16 blocks (2,048 lanes) and "
        f"lvl64mxu (card: {smi})")
    t0 = time.time()
    check_bench_shapes(rows, gen)
    counts = mxu_run(rows, gen)
    torch.cuda.empty_cache()
    res, launches, wall = bench_subprocess()
    log(json.dumps({"card": smi, "bench": res, "bench_wall_s": wall,
                    "bench_launches_one_rep": launches}))
    log(f"phase 11: {time.time() - t0:.1f} s (bench subprocess {wall:.1f} s)")
    return [counts, {**dict.fromkeys(KERNELS, 0), **launches}], res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the in-process runs take no warm-up (aot.py), as before it existed:
    # their launch counts are then their paths' alone; phase 10 runs the
    # CLI with it in a subprocess
    os.environ["TFHE_AOT"] = "0"
    smi = phase_device()
    rows, floor = phase_kernels()
    if sys.argv[1:] == ["--kernels-only"]:
        log(f"card: {smi}")
        print(json.dumps({"kernels_only": {
            name: [{k: v for k, v in x.items() if k not in ("macs", "nbytes")}
                   for x in rows[name]] for name in KERNELS},
            "launch_floor_ms": floor}))
        return 0
    phase_test_params()
    client, raw, ctx, request, out1, batch, latency = phase_full_width()
    k1_ms_160 = next(x["ms"] for x in rows["extprod_step2g"]
                     if x["name"].endswith("B=160"))
    grid, glue = phase_second_path(client, ctx, request, out1, latency,
                                   k1_ms_160)
    third = phase_server(client, raw, ctx, request, out1)
    keep = {"lvl64": (client, ctx)}            # phase 9's noise floor
    wide = phase_wide(rows, torch.Generator().manual_seed(4321), keep)
    models = phase_models(rows, torch.Generator().manual_seed(8765))
    scale_out = phase_scale_out(keep)
    last = phase_last_modules(raw, client, ctx, request, out1, keep, smi)
    del keep, client, raw, ctx
    bench_runs, _ = phase_bench(rows, torch.Generator().manual_seed(2468),
                                smi)
    # each kernel's launches on the main paths: the default lowering's two
    # runs (phase 4), the (grid, partials) run and the glue_out rotation
    # (phase 5), the two served requests and the three derivations (phase
    # 6), the N = 1024 runs (phase 7), the other two models' runs (phase
    # 8), the noise checks and the one-device mesh (phase 9), the CRT-NTT
    # latency paths (phase 10), lvl64mxu's run and one steady rep of the
    # bench's 16-block batch (phase 11)
    launches = {name: sum(c[name] for c in [batch, latency, grid, glue]
                          + third + wide + models + scale_out + last
                          + bench_runs)
                for name in KERNELS}
    missing = [name for name, count in launches.items() if count <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on a path: {missing}")
    kernels = []
    for name, spec in KERNELS.items():
        # the main path's row: the last of phase 2 at PARAMS_SQRD_LVL_64's
        # shapes (phase 11's 16-block rows stand under `shapes`)
        last = [x for x in rows[name]
                if not any(tag in x["name"] for tag in (WIDE, TREE, MXU,
                                                        BENCH))
                and x["ms"] is not None][-1]
        kernels.append(dict(
            name=name, route="cuda", source=spec["source"],
            replaces=spec["replaces"], launches=launches[name],
            max_abs_err=max(x["max_abs_err"] for x in rows[name]),
            ms=last["ms"], plain_ms=last["plain_ms"],
            bound_ms=last["bound_ms"], bound_by=last["bound_by"],
            library_ms=last.get("int_mm_yardstick_ms"),
            library=LIBRARY.get(name), launch_floor_ms=floor,
            int8_products=spec["int8_products"],
            **{k: v for k, v in spec.items() if k.startswith("source_")},
            shape=last["name"],
            shapes=[{k: v for k, v in x.items()
                     if k not in ("macs", "nbytes")} for x in rows[name]]))
    log(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
