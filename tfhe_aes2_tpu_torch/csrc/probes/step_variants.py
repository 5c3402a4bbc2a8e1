"""Build K1 (cmux.cu) and K9 (merged.cu) with other tuning constants and time
them against the shipped ones, on the card:

    python3 tfhe_aes2_tpu_torch/csrc/probes/step_variants.py

Each variant is a set of -D flags (NC_KT_UNROLL: k-steps unrolled in
nc::mma_row; NC_K1_MIN_BLOCKS: blocks an SM that K1's registers are held to).
For each it prints ptxas's registers and spills of the blind rotation's
instantiation (ND=2, JS=2), checks both kernels bit for bit against their
plain versions, and prints median times at PARAMS_SQRD_LVL_64's step shape
for B in {9, 160, 288} and R in {5, 10, 15} contraction rows (the slope over
R is a row's cost, the intercept the launch, prologue, epilogue and glue).
More variants: name="-DFLAG=1 -DOTHER=2" arguments.
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

VARIANTS = {
    "shipped": [],
    "unroll 1": ["-DNC_KT_UNROLL=1"],
    "unroll 8": ["-DNC_KT_UNROLL=8"],
    "two blocks an SM": ["-DNC_K1_MIN_BLOCKS=2"],
    "two blocks, unroll 1": ["-DNC_K1_MIN_BLOCKS=2", "-DNC_KT_UNROLL=1"],
}
_P, _I = ctypes.c_void_p, ctypes.c_int


def build_variants(out_dir: Path) -> dict:
    procs = {}
    for name, flags in VARIANTS.items():
        for stem in ("cmux", "merged"):
            tag = f"{stem}_{len(procs)}"
            log = open(out_dir / f"{tag}.log", "w")
            procs[name, stem] = (subprocess.Popen(
                [build._nvcc(), *build.FLAGS, *flags, "-o",
                 str(out_dir / f"{tag}.so"), str(build.CSRC / f"{stem}.cu")],
                stdout=log, stderr=subprocess.STDOUT), tag, log)
    libs = {}
    for (name, stem), (proc, tag, log) in procs.items():
        rc = proc.wait()
        log.close()
        lines = (out_dir / f"{tag}.log").read_text().splitlines()
        if rc:
            raise RuntimeError("\n".join(lines[-40:]))
        libs[name, stem] = ctypes.CDLL(str(out_dir / f"{tag}.so"))
        for i, ln in enumerate(lines):
            if "Compiling" in ln and ("step2g_kernelILi2ELi2ELb1E" in ln
                                      or "merged_kernelILi2ELi2E" in ln):
                print(f"{name}, {stem}.cu: {lines[i + 2].strip()}; "
                      f"{lines[i + 3].split(':', 1)[1].strip()}")
    return libs


def k1(lib, dig, ext, acc, t, out, lv, nd, js, bl):
    f = lib.tfhe_extprod_step2g
    f.argtypes, f.restype = [_P] * 5 + [_I] * 8 + [_P], _I
    o, _, _, b, n = dig.shape
    build.check(f(dig.data_ptr(), ext.data_ptr(), acc.data_ptr(),
                  t.data_ptr(), out.data_ptr(), b, n, o, ext.shape[1], lv, nd,
                  js, bl, build.stream_ptr(acc.device)), "K1")


def k9(lib, t, ext, acc, out, lv, nd, js, bl):
    f = lib.tfhe_cmux_step_merged
    f.argtypes, f.restype = [_P] * 4 + [_I] * 7 + [_P], _I
    o, b, n = acc.shape
    build.check(f(t.data_ptr(), ext.data_ptr(), acc.data_ptr(),
                  out.data_ptr(), b, n, o, lv, nd, js, bl,
                  build.stream_ptr(acc.device)), "K9")


def median_ms(fn, reps=30):
    fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def main() -> int:
    for a in sys.argv[1:]:
        name, flags = a.split("=", 1)
        VARIANTS[name] = flags.split()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        gen = torch.Generator().manual_seed(3)
        o, n, nd, js, bl = 5, 512, 2, 2, 12
        for lv in (3, 2, 1):
            r = o * lv
            for b in (9, 160, 288):
                dig = torch.randint(-128, 128, (o, lv, nd, b, n),
                                    generator=gen, dtype=torch.int8).cuda()
                ext = torch.randint(-128, 128, (o, r, 8 - js, 2 * n),
                                    generator=gen, dtype=torch.int8).cuda()
                acc = torch.randint(-2 ** 62, 2 ** 62, (o, b, n),
                                    generator=gen, dtype=torch.int64).cuda()
                t = torch.randint(0, 2 * n, (b,), generator=gen,
                                  dtype=torch.int32).cuda()
                want1 = kx.extprod_step2g_plain(dig, ext, acc.clone(), t, bl,
                                                lv, js)
                want9 = kx.cmux_step_merged_plain(t, ext, acc, bl, lv, js)
                cells = []
                for name in VARIANTS:
                    l1, l9 = libs[name, "cmux"], libs[name, "merged"]
                    got, out = acc.clone(), torch.empty_like(dig)
                    k1(l1, dig, ext, got, t, out, lv, nd, js, bl)
                    out9 = torch.empty_like(acc)
                    k9(l9, t, ext, acc, out9, lv, nd, js, bl)
                    if not (torch.equal(got, want1[0])
                            and torch.equal(out, want1[1])
                            and torch.equal(out9, want9)):
                        raise AssertionError(f"{name} differs from plain at "
                                             f"R={r} B={b}")
                    scratch = acc.clone()
                    ms1 = median_ms(lambda: k1(l1, dig, ext, scratch, t, out,
                                               lv, nd, js, bl))
                    ms9 = median_ms(lambda: k9(l9, t, ext, acc, out9, lv, nd,
                                               js, bl))
                    cells.append(f"{name}: K1 {ms1:.4f} K9 {ms9:.4f}")
                print(f"R={r} B={b} (ms): " + " | ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
