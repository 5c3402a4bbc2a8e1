"""Time K11 (csrc/bucket.cu) at every split count of its R contraction rows,
on the card, hold the wrapper's choice (extprod._bucket_splits) against the
measured curve, and split a launch's time into its phases:

    python3 tfhe_aes2_tpu_torch/csrc/probes/bucket_splits.py

At the step shapes of longk_splits.STEPS — PARAMS_SQRD_LVL_64's (O=5,
R=15, N=512, n_d=2, js=2), lvl256's (O=3, R=12, N=1024, n_d=2, js=2) and the
8-bit model's (O=3, R=18, N=1024, n_d=1, js=1), where two blocks share each
row tile's columns — it prints the kernel's residency (blocks an SM, from
cudaOccupancyMaxActiveBlocksPerMultiprocessor). Then for B in {1, 9, 13,
32, 64, 128, 160, 200, 256, 288} it calls the kernel's C entry with each
split count 1..R, checks the result bit for bit against the plain version,
and prints the median device time of 50 launches enqueued behind a spin of
the device (so that the events time the device, not the host's enqueue),
the wrapper's choice marked with '*' and its distance from the best,
beside K10b's time at its own split (`longk`, the other schedule that
splits these rows). Last, at lvl64's shape, copies of bucket.cu with one
phase of the row loop removed — the S-table builds of the next row, or the
mma — built and timed at B = 9 and 288 at the wrapper's split: those
compute wrong sums and exist only to split the shipped kernel's time (each
plane's table is built by two buckets at n_d = 2, 11 builds a row where K5
makes 6). Arguments name a subset of the shapes; the variants run with
lvl64's.
"""

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))
from tfhe_aes2_tpu_torch.ops.kernels import build  # noqa: E402
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx  # noqa: E402
from longk_splits import BATCHES, STEPS  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
ARGS = [_P] * 3 + [_I] * 7 + [_P]
NO_BUILD = ("    if (r + 1 < R)\n      nc::build_tables<LIMBS>(",
            "    if (false)\n      nc::build_tables<LIMBS>(")
NO_MMA = ("      nc::mma_row<1, 7>(acc,",
          "      if (false) nc::mma_row<1, 7>(acc,")
VARIANTS = {"no table builds in the row loop": NO_BUILD, "no mma": NO_MMA}


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


def build_variants(out_dir: Path) -> dict:
    """bucket.cu with each phase of VARIANTS removed, one nvcc each."""
    procs = {}
    for v, (name, (old, new)) in enumerate(VARIANTS.items()):
        src = (build.CSRC / "bucket.cu").read_text()
        assert src.count(old) == 1, old
        path = out_dir / f"bucket_{v}.cu"
        path.write_text(src.replace(old, new))
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.FLAGS, "-I", str(build.CSRC), "-o",
             str(out_dir / f"bucket_{v}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), v)
    libs = {}
    for name, (proc, v) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(out[-4000:])
        f = ctypes.CDLL(str(out_dir / f"bucket_{v}.so")).tfhe_extprod_step3
        f.argtypes, f.restype = ARGS, ctypes.c_int
        libs[name] = f
    return libs


def main() -> int:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    cases = {}
    for name in sys.argv[1:] or STEPS:
        print(f"{name}: O, L, N, n_d, js = {STEPS[name]}", flush=True)
        cases[name] = probe(*STEPS[name])
    if "lvl64" in cases:
        phases(cases["lvl64"], *STEPS["lvl64"])
    return 0


def probe(o, lv, n, nd, js) -> dict:
    """K11 at every split count for each batch; returns {B: (dig, ext,
    acc, plain result)}."""
    f = kx._fn("bucket", "tfhe_extprod_step3", ARGS)
    gen = torch.Generator().manual_seed(13)
    r, nj = o * lv, 8 - js
    resident = kx._bucket_residency(n, nd)
    print(f"K11 residency at N={n}, n_d={nd}: {resident} blocks an SM",
          flush=True)
    ext = torch.randint(-128, 128, (o, r, nj, 2 * n), generator=gen,
                        dtype=torch.int8).cuda()
    stream = build.stream_ptr(ext.device)
    cases = {}
    for b in BATCHES:
        dig = torch.randint(-128, 128, (o, lv, nd, b, n), generator=gen,
                            dtype=torch.int8).cuda()
        acc = torch.randint(-2 ** 62, 2 ** 62, (o, b, n), generator=gen,
                            dtype=torch.int64).cuda()
        want = kx.extprod_step3_plain(dig, ext, acc.clone(), js)
        cases[b] = (dig, ext, acc, want)

        def call(fn, splits, out):
            build.check(fn(dig.data_ptr(), ext.data_ptr(), out.data_ptr(), b,
                           n, o, r, nd, js, splits, stream), "K11")
        chosen = kx._bucket_splits(b, o, r, nj, resident, n)
        times = {}
        for splits in range(1, r + 1):
            got = acc.clone()
            call(f, splits, got)
            if not torch.equal(got, want):
                raise AssertionError(f"K11 differs from plain at B={b} "
                                     f"splits={splits}")
            scratch = acc.clone()
            times[splits] = device_ms(lambda: call(f, splits, scratch))
        best = min(times, key=times.get)
        flat = dig.permute(2, 3, 0, 1, 4).reshape(nd, b, r * n)
        scratch = acc.clone()
        longk = device_ms(lambda: kx.extprod_step_longk(flat, ext, scratch,
                                                        js))
        print(f"B={b} ({-(-b // 8) * o * nj * kx._column_blocks(n)} blocks "
              f"unsplit), ms by split count: " + " | ".join(
                  f"{s}{'*' if s == chosen else ''} {ms:.4f}"
                  for s, ms in times.items())
              + f"; chosen {chosen} is {times[chosen] / times[best] - 1:+.1%}"
              f" of the best, {best}; K10b at its split "
              f"{kx._longk_splits(b, o, r, n)}: {longk:.4f}", flush=True)
    return cases


def phases(cases, o, lv, n, nd, js) -> None:
    """The shipped K11 beside its copies with one phase of the row loop
    removed, at B = 9 and 288, the wrapper's split."""
    f = kx._fn("bucket", "tfhe_extprod_step3", ARGS)
    r, nj = o * lv, 8 - js
    resident = kx._bucket_residency(n, nd)
    with tempfile.TemporaryDirectory() as tmp:
        variants = build_variants(Path(tmp))
        for b in (9, 288):
            dig, ext, acc, _ = cases[b]
            stream = build.stream_ptr(ext.device)
            splits = kx._bucket_splits(b, o, r, nj, resident, n)
            scratch = acc.clone()
            times = {"shipped": device_ms(lambda: build.check(f(
                dig.data_ptr(), ext.data_ptr(), scratch.data_ptr(), b, n, o,
                r, nd, js, splits, stream), "K11"))}
            for name, fn in variants.items():
                times[name] = device_ms(lambda: build.check(fn(
                    dig.data_ptr(), ext.data_ptr(), scratch.data_ptr(), b, n,
                    o, r, nd, js, splits, stream), name))
            print(f"B={b}, split {splits}: " + ", ".join(
                f"{name} {ms:.4f} ms" for name, ms in times.items()),
                flush=True)


if __name__ == "__main__":
    sys.exit(main())
