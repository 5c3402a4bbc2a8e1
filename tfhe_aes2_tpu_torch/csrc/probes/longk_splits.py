"""Time K10b (csrc/longk.cu) at every split count of its R contraction rows,
on the card, and hold the wrapper's choice (extprod._longk_splits) against
the measured curve:

    python3 tfhe_aes2_tpu_torch/csrc/probes/longk_splits.py

At the step shapes of STEPS — PARAMS_SQRD_LVL_64's (O=5, R=15, N=512,
n_d=2, js=2), lvl256's (O=3, R=12, N=1024, n_d=2, js=2) and the 8-bit
model's (O=3, R=18, N=1024, n_d=1, js=1), where two blocks share each row
tile's columns — and B in {1, 9, 13, 32, 64, 128, 160, 200, 256, 288}, it
calls the kernel's C entry with each split count 1..R, checks the result
bit for bit against the plain version, and prints the median device time
of 50 launches enqueued behind a spin of the device (so that the events
time the device, not the host's enqueue), the wrapper's choice marked with
'*'. Then the host's time to enqueue one launch through the wrapper and
through the bare ctypes call. Arguments name a subset of STEPS.
"""

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))
from tfhe_aes2_tpu_torch.ops.kernels import build  # noqa: E402
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
# name: (O, L, N, n_d, js) of a blind rotation's step
STEPS = {"lvl64": (5, 3, 512, 2, 2), "lvl256": (3, 4, 1024, 2, 2),
         "8-bit": (3, 6, 1024, 1, 1)}
BATCHES = (1, 9, 13, 32, 64, 128, 160, 200, 256, 288)


def device_ms(fn, reps=50):
    """Median device time of fn(), each launch between its own events, all
    enqueued while the device spins."""
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


def host_us(fn, reps=200):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / reps


def main() -> int:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    for name in sys.argv[1:] or STEPS:
        print(f"{name}: O, L, N, n_d, js = {STEPS[name]}", flush=True)
        probe(*STEPS[name])
    return 0


def probe(o, lv, n, nd, js) -> None:
    f = kx._fn("longk", "tfhe_extprod_step_longk", [_P] * 3 + [_I] * 7 + [_P])
    gen = torch.Generator().manual_seed(11)
    r = o * lv
    ext = torch.randint(-128, 128, (o, r, 8 - js, 2 * n), generator=gen,
                        dtype=torch.int8).cuda()
    for b in BATCHES:
        flat = torch.randint(-128, 128, (nd, b, r * n), generator=gen,
                             dtype=torch.int8).cuda()
        acc = torch.randint(-2 ** 62, 2 ** 62, (o, b, n), generator=gen,
                            dtype=torch.int64).cuda()
        want = kx.extprod_step_longk_plain(flat, ext, acc.clone(), js)
        stream = build.stream_ptr(acc.device)

        def call(splits, out):
            build.check(f(flat.data_ptr(), ext.data_ptr(), out.data_ptr(), b,
                          n, o, r, nd, js, splits, stream), "K10b")
        chosen = kx._longk_splits(b, o, r, n)
        times = {}
        for splits in range(1, r + 1):
            got = acc.clone()
            call(splits, got)
            if not torch.equal(got, want):
                raise AssertionError(f"K10b differs from plain at B={b} "
                                     f"splits={splits}")
            scratch = acc.clone()
            times[splits] = device_ms(lambda: call(splits, scratch))
        best = min(times, key=times.get)
        print(f"B={b} ({-(-b // 8) * o * kx._column_blocks(n)} tiles), ms "
              f"by split count: " + " | ".join(
                  f"{s}{'*' if s == chosen else ''} {ms:.4f}"
                  for s, ms in times.items())
              + f"; chosen {chosen} is {times[chosen] / times[best] - 1:+.1%}"
              f" of the best, {best}", flush=True)
    scratch = acc.clone()
    print(f"host enqueue of one K10b launch at B={b}: wrapper "
          f"{host_us(lambda: kx.extprod_step_longk(flat, ext, scratch, js)):.1f}"
          f" us, bare ctypes call "
          f"{host_us(lambda: call(1, scratch)):.1f} us")


if __name__ == "__main__":
    sys.exit(main())
