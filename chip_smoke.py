"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. device and build: the card's name and power limit, the nvcc build of
     every kernel from tfhe_aes2_tpu_torch/csrc/;
  2. kernel checks: K1-K4 at their PARAMS_SQRD_LVL_64 main-path shapes,
     each held bit-for-bit against its plain PyTorch version on the card,
     with median times over a few launches and each kernel's bound;
  3. a fast end-to-end run at PARAMS_TEST (2 rounds), decrypt-verified;
  4. the full-width run at PARAMS_SQRD_LVL_64: seeded keygen, 2 CTR blocks
     through key_schedule_staged + encrypt_blocks_staged (10 rounds), then
     1 block through encrypt_block_latency, each decrypted and checked
     against the AES authority, with every kernel's launch counter reset
     just before and read just after.
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or tfhe_aes2_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from tfhe_aes2_tpu_torch.aes_128 import aes_lib, plain, scenario
from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as model
from tfhe_aes2_tpu_torch.ops import decomposition, torus
from tfhe_aes2_tpu_torch.ops import params as params_mod
from tfhe_aes2_tpu_torch.ops import truncation
from tfhe_aes2_tpu_torch.ops.kernels import build
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx
from tfhe_aes2_tpu_torch.ops.kernels import matmul as kmm

P = params_mod.PARAMS_SQRD_LVL_64
DEV = "cuda"
PEAK_INT8_OPS = 1979e12      # H100 SXM dense int8 tensor-core rate, ops/s
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 bytes/s
KEY = bytes.fromhex("76b8e0ada0f13d90405d6ae55386bd28")
IV = bytes.fromhex("bdd219b8a08ded1a")

KERNELS = {
    "extprod_step2g": dict(
        fn=kx.extprod_step2g, source="tfhe_aes2_tpu_torch/csrc/cmux.cu",
        replaces="tfhe_aes2_tpu/ops/pallas/extprod.py:542"),
    "rot_diff_digits": dict(
        fn=kx.rot_diff_digits, source="tfhe_aes2_tpu_torch/csrc/cmux.cu",
        replaces="tfhe_aes2_tpu/ops/pallas/extprod.py:386"),
    "extprod_grouped_fused": dict(
        fn=kx.extprod_grouped_fused, source="tfhe_aes2_tpu_torch/csrc/vp.cu",
        replaces="tfhe_aes2_tpu/ops/pallas/extprod.py:1154"),
    "fused_limb_matmul": dict(
        fn=kmm.fused_limb_matmul, source="tfhe_aes2_tpu_torch/csrc/matmul.cu",
        replaces="tfhe_aes2_tpu/ops/pallas/matmul.py:82"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, reps: int = 5) -> float:
    """Median device time of fn() over `reps` runs after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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


def record(name: str, rows: list, macs: int, nbytes: int, ms: float,
           plain_ms: float, err: int) -> None:
    b_ms, b_by = bound(macs, nbytes)
    rows.append(dict(name=name, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, max_abs_err=err, macs=macs,
                     nbytes=nbytes))
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
    spills = [ln for ln in build.ptxas_report().splitlines()
              if "spill" in ln and " 0 bytes spill" not in ln]
    log(f"ptxas: {len(spills)} kernel instantiations report spills")
    return smi


def phase_kernels() -> dict:
    """K1-K4 at main-path shapes vs their plain versions; returns the last
    (largest) measurement of each kernel for the JSON line."""
    log("== phase 2: kernel checks at PARAMS_SQRD_LVL_64 shapes")
    gen = torch.Generator().manual_seed(1234)
    k1, n, lv = P.glwe_dimension + 1, P.polynomial_size, P.pbs_level
    r = k1 * lv
    nd = torus.limbs_for_bound(decomposition.digit_bound(P.pbs_base_log))
    js = truncation.bsk_j_start(P)
    rows: dict[str, list] = {k: [] for k in KERNELS}

    for b in (128, 160, 256, 288):
        acc = torch.randint(-2**62, 2**62, (k1, b, n), generator=gen,
                            dtype=torch.int64).to(DEV)
        t = torch.randint(0, 2 * n, (b,), generator=gen,
                          dtype=torch.int32).to(DEV)
        # K2
        got = kx.rot_diff_digits(acc, t, P.pbs_base_log, lv, nd)
        ref = kx.rot_diff_digits_plain(acc, t, P.pbs_base_log, lv, nd)
        sync()
        err = max_abs_err(got, ref)
        ms = time_ms(lambda: kx.rot_diff_digits(acc, t, P.pbs_base_log, lv,
                                                nd))
        pms = time_ms(lambda: kx.rot_diff_digits_plain(
            acc, t, P.pbs_base_log, lv, nd), reps=2)
        record(f"rot_diff_digits B={b}", rows["rot_diff_digits"], 0,
               acc.numel() * 8 + got.numel() + b * 4, ms, pms, err)
        # K1
        dig = rand_i8(gen, (k1, lv, nd, b, n))
        ext = rand_i8(gen, (k1, r, 8 - js, 2 * n))
        acc_k, dig_k = kx.extprod_step2g(dig, ext, acc.clone(), t,
                                         P.pbs_base_log, lv, js)
        acc_p, dig_p = kx.extprod_step2g_plain(dig, ext, acc.clone(), t,
                                               P.pbs_base_log, lv, js)
        sync()
        err = max(max_abs_err(acc_k, acc_p), max_abs_err(dig_k, dig_p))
        scratch = acc.clone()
        ms = time_ms(lambda: kx.extprod_step2g(dig, ext, scratch, t,
                                               P.pbs_base_log, lv, js))
        pms = time_ms(lambda: kx.extprod_step2g_plain(
            dig, ext, scratch, t, P.pbs_base_log, lv, js), reps=2)
        macs = b * k1 * r * n * n * pairs(nd, js)
        nbytes = dig.numel() * 2 + ext.numel() + acc.numel() * 16 + b * 4
        record(f"extprod_step2g B={b}", rows["extprod_step2g"], macs,
               nbytes, ms, pms, err)

    # K3: the three vertical-packing shapes of the main path (lanes, G)
    js_vp = truncation.vp_ggsw_j_start(P)
    nd_vp = torus.limbs_for_bound(decomposition.digit_bound(P.cbs_base_log))
    r_vp = k1 * P.cbs_level
    for lanes, g in ((4, 8), (128, 1), (32, 24)):
        dig = rand_i8(gen, (lanes, r_vp, nd_vp * g, n))
        ext = rand_i8(gen, (lanes, k1, r_vp, 8 - js_vp, 2 * n))
        got = kx.extprod_grouped_fused(dig, ext, nd_vp, js_vp)
        ref = kx.extprod_grouped_fused_plain(dig, ext, nd_vp, js_vp)
        sync()
        err = max_abs_err(got, ref)
        ms = time_ms(lambda: kx.extprod_grouped_fused(dig, ext, nd_vp,
                                                      js_vp))
        pms = time_ms(lambda: kx.extprod_grouped_fused_plain(
            dig, ext, nd_vp, js_vp), reps=2)
        macs = lanes * g * k1 * r_vp * n * n * pairs(nd_vp, js_vp)
        record(f"extprod_grouped_fused lanes={lanes} G={g}",
               rows["extprod_grouped_fused"], macs,
               dig.numel() + ext.numel() + got.numel() * 8, ms, pms, err)

    # K4: keyswitch then pfKS at 256 lanes
    kn = P.glwe_dimension * P.polynomial_size
    shapes = [
        ("keyswitch", torus.limbs_for_bound(
            decomposition.digit_bound(P.ks_base_log)),
         kn * P.ks_level, P.lwe_dimension + 1, truncation.ksk_j_start(P)),
        ("pfKS", torus.limbs_for_bound(
            decomposition.digit_bound(P.pfks_base_log)),
         (kn + 1) * P.pfks_level, k1 * k1 * n, truncation.pfpksk_j_start(P)),
    ]
    for what, nd_m, kk, nn, js_m in shapes:
        b = 256
        d = rand_i8(gen, (nd_m, b, kk))
        m = rand_i8(gen, (8 - js_m, kk, nn))
        got = kmm.fused_limb_matmul(d, m, js_m)
        ref = kmm.fused_limb_matmul_plain(d, m, js_m)
        sync()
        err = max_abs_err(got, ref)
        ms = time_ms(lambda: kmm.fused_limb_matmul(d, m, js_m))
        pms = time_ms(lambda: kmm.fused_limb_matmul_plain(d, m, js_m),
                      reps=2)
        record(f"fused_limb_matmul {what} B={b}", rows["fused_limb_matmul"],
               b * kk * nn * pairs(nd_m, js_m),
               d.numel() + m.numel() + got.numel() * 8, ms, pms, err)
    sync()
    return rows


def reset_counters() -> None:
    for spec in KERNELS.values():
        spec["fn"].launches = 0


def read_counters() -> dict:
    return {name: spec["fn"].launches for name, spec in KERNELS.items()}


def phase_test_params() -> None:
    log("== phase 3: end to end at PARAMS_TEST, 2 rounds")
    t0 = time.time()
    client, ctx = model.generate_keys(params_mod.PARAMS_TEST, seed=3,
                                      device=DEV)
    out, _ = scenario.run_client_server_aes_scenario(
        client, ctx, KEY, IV, 2, rounds=2)
    expect = plain.expand_key_and_encrypt_blocks(
        KEY, scenario.ctr_blocks(IV, 2), 2)
    assert out == expect, "PARAMS_TEST output mismatch"
    log(f"PARAMS_TEST 2-round CTR x2 verified in {time.time() - t0:.1f} s")


def phase_full_width() -> dict:
    """The user's entry points at full width: the CTR scenario with 2 blocks
    (key_schedule_staged + encrypt_blocks_staged, 10 rounds) and with 1
    block (encrypt_block_latency), each decrypted and checked against the
    AES authority inside the scenario."""
    log("== phase 4: full width, PARAMS_SQRD_LVL_64, 10 rounds")
    t0 = time.time()
    client, ctx = model.generate_keys(P, seed=0, device=DEV)
    sync()
    log(f"keygen (seeded) + key preparation: {time.time() - t0:.1f} s")

    reset_counters()
    out2, t2 = scenario.run_client_server_aes_scenario(client, ctx, KEY, IV,
                                                       2, rounds=10)
    out1, t1 = scenario.run_client_server_aes_scenario(client, ctx, KEY, IV,
                                                       1, rounds=10)
    launches = read_counters()
    expect = aes_lib.encrypt_blocks(KEY, scenario.ctr_blocks(IV, 2))
    assert out2 == expect and out1 == expect[:1], "keystream mismatch"
    log(f"key expansion: {t2['key_expansion_s']:.2f} s; 10 rounds x 2 "
        f"blocks: {t2['blocks_s']:.2f} s; latency path (1 block, expansion "
        f"included): {t1['fused_latency_s']:.2f} s")
    log(f"launches on the main path: {launches}")
    log("2-block batch path and 1-block latency path decrypt to the AES "
        "authority's keystream")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = phase_device()
    rows = phase_kernels()
    phase_test_params()
    launches = phase_full_width()
    kernels = []
    for name, spec in KERNELS.items():
        last = rows[name][-1]
        kernels.append(dict(
            name=name, route="cuda", source=spec["source"],
            replaces=spec["replaces"], launches=launches[name],
            max_abs_err=max(x["max_abs_err"] for x in rows[name]),
            ms=last["ms"], plain_ms=last["plain_ms"],
            bound_ms=last["bound_ms"], bound_by=last["bound_by"],
            library_ms=None, shape=last["name"]))
    log(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
