"""Time the CMux-step kernels of a checkout at their main-path shapes, on the
card, so that two versions of the shared tensor-core contraction
(csrc/nc_mma.cuh) can be compared in one call: K1 and K5 (cmux.cu), K3 and
K8 (vp.cu), K6 and K7 (step.cu), K9 (merged.cu), K10b (longk.cu) and K11
(bucket.cu), which share it, and the glue K2 (cmux.cu) and K10a (longk.cu)
beside them. K1 is also timed on its own from 1 lane through the latency
path's batches to the 16-block batch's 2,048 lanes, at lvl64's step
(N = 512) and lvl256's (N = 1024), and at the 8-bit model's scans
(N = 1024), as the wrapper launches it ("K1") and, where the checkout
has K1 on wgmma (cmux_wg.cu) at that N, that kernel through its C entry
("K1 wgmma") beside a second reference: K1 on mma.sync (cmux.cu, "K1
mma.sync") where N <= 512, K5 then K2 ("K5+K2") at N = 1024. Where both
K1 kernels are timed it prints the crossover, the fewest lanes from
which wgmma is the faster at every batch timed (below one lane:
extprod.k1_path reads N alone).

    python3 tfhe_aes2_tpu_torch/csrc/probes/mma_regress.py [ROOT]

ROOT is the root of the checkout whose tfhe_aes2_tpu_torch is imported and
built (default: this one). Run it in turns on two checkouts (a, b, b, a) in
one call. Each kernel is checked bit for bit against its plain version,
then timed as the median device time of 50 launches enqueued behind a spin
of the device, so that the events time the device, not the host's enqueue.
Prints one line per shape and a JSON line of all times last.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(sys.argv[1] if len(sys.argv) > 1
            else Path(__file__).resolve().parents[3]).resolve()
sys.path.insert(0, str(ROOT))
from tfhe_aes2_tpu_torch.ops import polynomial  # noqa: E402
from tfhe_aes2_tpu_torch.ops.kernels import build  # noqa: E402
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx  # noqa: E402


def device_ms(fn, reps=50):
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e6 * 20))              # ~20 ms at ~2 GHz
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def k1_alone(times, r8, gen):
    """K1 alone at lvl64's, lvl256's and the 8-bit model's steps, as the
    wrapper launches it and, where the checkout has K1 on wgmma at the
    step's N, that kernel and the second reference (K1 on mma.sync where
    N <= 512, else K5 then K2), each bit-equal to plain; times into
    `times`, and the crossover printed where both K1 kernels ran."""
    wg_n = getattr(kx, "WG_N", ())
    wg_n = wg_n if isinstance(wg_n, frozenset) else {wg_n}
    for label, (o, lv, n, nd, js, bl), batches in (
            ("", (5, 3, 512, 2, 2, 12),
             (1, 9, 16, 32, 64, 96, 128, 160, 192, 256, 288, 2048)),
            ("N=1024 lvl256 ", (3, 4, 1024, 2, 2, 9),
             (1, 9, 16, 32, 128, 160, 288, 2048)),
            ("N=1024 8-bit ", (3, 6, 1024, 1, 1, 7), (1, 16, 32, 128))):
        ext = r8(o, o * lv, 8 - js, 2 * n)
        entries = ([("K1 mma.sync", "cmux", "tfhe_extprod_step2g")]
                   if n in wg_n and n <= 512 else [])
        entries += ([("K1 wgmma", "cmux_wg", "tfhe_extprod_step2g_wg")]
                    if n in wg_n else [])
        for b in batches:
            dig = r8(o, lv, nd, b, n)
            acc = torch.randint(-2 ** 62, 2 ** 62, (o, b, n), generator=gen,
                                dtype=torch.int64).cuda()
            t = torch.randint(0, 2 * n, (b,), generator=gen,
                              dtype=torch.int32).cuda()
            want = kx.extprod_step2g_plain(dig, ext, acc.clone(), t, bl, lv,
                                           js)
            step = {"K1": lambda: kx.extprod_step2g(dig, ext, acc, t, bl, lv,
                                                    js)}
            for name, stem, entry in entries:
                f = kx._fn(stem, entry, [kx._P] * 5 + [kx._I] * 8 + [kx._P])

                def launch(f=f, a=acc, out=torch.empty_like(dig)):
                    build.check(f(dig.data_ptr(), ext.data_ptr(),
                                  a.data_ptr(), t.data_ptr(), out.data_ptr(),
                                  b, n, o, o * lv, lv, nd, js, bl,
                                  build.stream_ptr(a.device)), entry)
                    return a, out
                got = launch(a=acc.clone())
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"{name} differs from plain at "
                                         f"{label}B={b}")
                step[name] = launch
            if n in wg_n and n > 512:
                def k5_k2(a=acc.clone()):
                    a = kx.extprod_step2(dig, ext, a, js)
                    return a, kx.rot_diff_digits(a, t, bl, lv, nd)
                got = k5_k2()
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"K5+K2 differs from plain at "
                                         f"{label}B={b}")
                step["K5+K2"] = k5_k2
            del want
            before = getattr(kx.extprod_step2g, "launches_wg", 0)
            step["K1"]()
            took = ("wgmma" if getattr(kx.extprod_step2g, "launches_wg", 0)
                    > before else "mma.sync")
            for name, fn in step.items():
                times[f"{name} {label}B={b}"] = device_ms(fn)
            print(f"K1 {label}B={b}: " + ", ".join(
                f"{name} {times[f'{name} {label}B={b}']:.4f} ms"
                for name in step) + f" (the wrapper takes {took})",
                flush=True)
        if len(entries) == 2:
            wins = [times[f"K1 wgmma {label}B={b}"]
                    <= times[f"K1 mma.sync {label}B={b}"] for b in batches]
            start = next((batches[i] for i in range(len(batches))
                          if all(wins[i:])), None)
            verdict = (f"faster from B={start} at every batch timed"
                       if start is not None
                       else "slower at the largest batch")
            print(f"K1 {label or 'N=512 lvl64 '}crossover: wgmma is the "
                  f"{verdict}", flush=True)


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"{card}; checkout {ROOT}", flush=True)
    gen = torch.Generator().manual_seed(21)

    def r8(*shape):
        return torch.randint(-128, 128, shape, generator=gen,
                             dtype=torch.int8).cuda()
    times = {}
    o, lv, n, nd, js, bl = 5, 3, 512, 2, 2, 12       # PARAMS_SQRD_LVL_64
    ext = r8(o, o * lv, 8 - js, 2 * n)
    for b in (9, 160, 288):
        dig = r8(o, lv, nd, b, n)
        acc = torch.randint(-2 ** 62, 2 ** 62, (o, b, n), generator=gen,
                            dtype=torch.int64).cuda()
        t = torch.randint(0, 2 * n, (b,), generator=gen,
                          dtype=torch.int32).cuda()
        got = kx.extprod_step2g(dig, ext, acc.clone(), t, bl, lv, js)
        want = kx.extprod_step2g_plain(dig, ext, acc.clone(), t, bl, lv, js)
        got9 = kx.cmux_step_merged(t, ext, acc, bl, lv, js)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and torch.equal(got9, kx.cmux_step_merged_plain(
                    t, ext, acc, bl, lv, js))):
            raise AssertionError(f"K1 or K9 differs from plain at B={b}")
        # K5, K10b, K6 and K11: the same update on their own layouts
        flat = dig.permute(2, 3, 0, 1, 4).reshape(nd, b, o * lv * n)
        dig_bm = dig.reshape(o * lv, nd, b, n).permute(1, 2, 0,
                                                       3).contiguous()
        acc_bm = acc.permute(1, 0, 2).contiguous()
        upd = want[0]
        if not (torch.equal(kx.extprod_step2(dig, ext, acc.clone(), js), upd)
                and torch.equal(kx.extprod_step_longk(flat, ext, acc.clone(),
                                                      js), upd)
                and torch.equal(kx.extprod_step(dig_bm, ext, acc_bm, js),
                                upd.permute(1, 0, 2))
                and torch.equal(kx.extprod_step3(dig, ext, acc.clone(), js),
                                upd)):
            raise AssertionError(f"K5, K10b, K6 or K11 differs from K1's "
                                 f"update at B={b}")
        scratch = acc.clone()
        step = {
            "K1": lambda: kx.extprod_step2g(dig, ext, scratch, t, bl, lv, js),
            "K9": lambda: kx.cmux_step_merged(t, ext, acc, bl, lv, js),
            "K5": lambda: kx.extprod_step2(dig, ext, scratch, js),
            "K10b": lambda: kx.extprod_step_longk(flat, ext, scratch, js),
            "K6": lambda: kx.extprod_step(dig_bm, ext, acc_bm, js),
            "K11": lambda: kx.extprod_step3(dig, ext, scratch, js)}
        for name, fn in step.items():
            times[f"{name} B={b}"] = device_ms(fn)
        print(f"B={b}: " + ", ".join(f"{name} {times[f'{name} B={b}']:.4f} "
                                     "ms" for name in step), flush=True)
    k1_alone(times, r8, gen)
    # K2 and K10a, the glue alone in two layouts, at the batches the paths
    # run them at
    for b in (9, 128, 160, 256, 288):
        acc = torch.randint(-2 ** 63, 2 ** 63 - 1, (o, b, n), generator=gen,
                            dtype=torch.int64).cuda()
        t = torch.randint(0, 2 * n, (b,), generator=gen,
                          dtype=torch.int32).cuda()
        if not (torch.equal(kx.rot_diff_digits(acc, t, bl, lv, nd),
                            kx.rot_diff_digits_plain(acc, t, bl, lv, nd))
                and torch.equal(kx.rot_diff_digits_flat(acc, t, bl, lv, nd),
                                kx.rot_diff_digits_flat_plain(acc, t, bl, lv,
                                                              nd))):
            raise AssertionError(f"K2 or K10a differs from plain at B={b}")
        for name, fn in (
                ("K2", lambda: kx.rot_diff_digits(acc, t, bl, lv, nd)),
                ("K10a", lambda: kx.rot_diff_digits_flat(acc, t, bl, lv,
                                                         nd))):
            key = f"{name} B={b}"
            times[key] = device_ms(fn)
            print(f"{key}: {times[key]:.4f} ms", flush=True)
    # K7, all 8 key planes of the batch-major product
    for b in (9, 160, 288):
        dig_bm = r8(nd, b, o * lv, n)
        ext8 = r8(8, o * lv, o, 2 * n)
        if not torch.equal(kx.extprod_partials(dig_bm, ext8),
                           kx.extprod_partials_plain(dig_bm, ext8)):
            raise AssertionError(f"K7 differs from plain at B={b}")
        key = f"K7 B={b}"
        times[key] = device_ms(lambda: kx.extprod_partials(dig_bm, ext8))
        print(f"{key}: {times[key]:.4f} ms", flush=True)
    nd_vp, js_vp, r_vp = 2, 4, o                    # CBS 1 level, k+1 = 5
    for lanes, g in ((4, 8), (16, 8), (16, 24), (128, 1), (32, 24)):
        dig = r8(lanes, r_vp, nd_vp * g, n)
        ext3 = r8(lanes, o, r_vp, 8 - js_vp, 2 * n)
        fused = kx.extprod_grouped_fused(dig, ext3, nd_vp, js_vp)
        if not torch.equal(fused, kx.extprod_grouped_fused_plain(
                dig, ext3, nd_vp, js_vp)):
            raise AssertionError(f"K3 differs from plain at {lanes} x {g}")
        # K8 on the same operands in its own layouts; recombined it is K3
        dig8 = dig.reshape(lanes, r_vp, nd_vp, g, n).permute(
            2, 0, 3, 1, 4).contiguous()
        ext8 = ext3.permute(3, 0, 2, 1, 4).contiguous()
        parts = kx.extprod_partials_grouped(dig8, ext8, js_vp)
        if not (torch.equal(parts, kx.extprod_partials_grouped_plain(
                dig8, ext8, js_vp)) and torch.equal(
                polynomial.recombine_partials(parts, js_vp),
                fused.permute(0, 2, 1, 3))):
            raise AssertionError(f"K8 differs from plain or K3 at {lanes} "
                                 f"x {g}")
        for name, fn in (
                ("K3", lambda: kx.extprod_grouped_fused(dig, ext3, nd_vp,
                                                        js_vp)),
                ("K8", lambda: kx.extprod_partials_grouped(dig8, ext8,
                                                           js_vp))):
            key = f"{name} lanes={lanes} G={g}"
            times[key] = device_ms(fn)
            print(f"{key}: {times[key]:.4f} ms", flush=True)
    print(json.dumps({"card": card, "root": str(ROOT), "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
