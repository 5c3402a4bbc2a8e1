"""Build K4 (matmul.cu) with other tuning constants, or with one of its
phases removed, and time each against the shipped kernel on the card:

    python3 tfhe_aes2_tpu_torch/csrc/probes/limb_variants.py

A variant is a set of -D flags (K4_MW: warps along a block's rows;
K4_STAGES: slices in flight) and/or text replacements in a copy of the
source that drop a phase of the slice loop (the mma, or the cp.async copies
after the first STAGES - 1 slices): those variants
compute wrong sums and exist only to split the shipped kernel's time into
its phases. For each variant it prints ptxas's registers and spills of the
pfKS (ND=3, JS=1) and keyswitch (ND=1, JS=5) instantiations, whether the
result is bit-equal to the plain version, and median times at
PARAMS_SQRD_LVL_64's pfKS shape (B = 9, 288) and keyswitch shape (B = 288,
split as the wrapper splits it).
"""

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))
from tfhe_aes2_tpu_torch.ops.kernels import build  # noqa: E402
from tfhe_aes2_tpu_torch.ops.kernels import matmul as kmm  # noqa: E402

NO_MMA = ("    if (busy) mma_slice", "    if (false) mma_slice")
NO_COPY = ("    if (next < cnt)\n      copy_slice",
           "    if (false)\n      copy_slice")
VARIANTS = {
    "shipped": ([], []),
    "2 stages": (["-DK4_STAGES=2"], []),
    "3 stages": (["-DK4_STAGES=3"], []),
    "MW=2 (64 x 64 tiles, 8 warps)": (["-DK4_MW=2"], []),
    "no mma": ([], [NO_MMA]),
    "no copies in the loop": ([], [NO_COPY]),
}
_P, _I = ctypes.c_void_p, ctypes.c_int


def build_variants(out_dir: Path) -> dict:
    procs = {}
    for v, (name, (flags, edits)) in enumerate(VARIANTS.items()):
        src = (build.CSRC / "matmul.cu").read_text()
        for old, new in edits:
            assert old in src, old
            src = src.replace(old, new)
        path = out_dir / f"matmul_{v}.cu"
        path.write_text(src)
        log = open(out_dir / f"matmul_{v}.log", "w")
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.FLAGS, *flags, "-I", str(build.CSRC), "-o",
             str(out_dir / f"matmul_{v}.so"), str(path)],
            stdout=log, stderr=subprocess.STDOUT), v, log)
    libs = {}
    for name, (proc, v, log) in procs.items():
        rc = proc.wait()
        log.close()
        lines = (out_dir / f"matmul_{v}.log").read_text().splitlines()
        if rc:
            raise RuntimeError("\n".join(lines[-40:]))
        libs[name] = ctypes.CDLL(str(out_dir / f"matmul_{v}.so"))
        for i, ln in enumerate(lines):
            for key in ("kernelILi3ELi1E", "kernelILi1ELi5E"):
                if key in ln and "Compiling" in ln:
                    after = lines[i + 1:i + 5]
                    spill = next(x for x in after if "spill" in x).strip()
                    regs = next(x for x in after if "registers" in x)
                    print(f"{name}, {key[6:]}: {spill}; "
                          f"{regs.split(':', 1)[1].strip()}")
    return libs


def run(lib, d, m, js, splits):
    """One launch on K-major key planes (kmajor_key_planes), K a multiple
    of 16 so that the digits need no padding."""
    f = lib.tfhe_fused_limb_matmul
    f.argtypes, f.restype = [_P] * 3 + [_I] * 8 + [_P], _I
    n_d, b, k = d.shape
    n = m.shape[2]
    out = torch.zeros((b, n), dtype=torch.int64, device="cuda")
    build.check(f(d.data_ptr(), m.data_ptr(), out.data_ptr(), b, k, n, k,
                  m.stride(2), splits, n_d, js, build.stream_ptr(d.device)),
                "K4")
    return out


def median_ms(fn, reps=20):
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


def main():
    out_dir = Path(tempfile.mkdtemp())
    try:
        libs = build_variants(out_dir)
        gen = torch.Generator().manual_seed(3)
        shapes = [("pfKS", 3, 4096, 12800, 1, (9, 288)),
                  ("keyswitch", 1, 8192, 678, 5, (288,))]
        for what, n_d, k, n, js, batches in shapes:
            # K rounded to 16 so the probe passes the digits unpadded
            m = kmm.kmajor_key_planes(torch.randint(
                -128, 128, (8 - js, k, n), generator=gen,
                dtype=torch.int8).cuda())
            for b in batches:
                d = torch.randint(-128, 128, (n_d, b, k), generator=gen,
                                  dtype=torch.int8).cuda()
                ref = kmm.fused_limb_matmul_plain(d, m, js)
                for name, lib in libs.items():
                    mw = 2 if "MW=2" in name else 3
                    tiles = -(-b // (32 * mw)) * -(-n // 64)
                    splits = max(1, min(132 // tiles, -(-k // 64) // 8))
                    same = torch.equal(run(lib, d, m, js, splits), ref)
                    ms = median_ms(lambda: run(lib, d, m, js, splits))
                    print(f"{what} B={b} split {splits}: {name}: {ms:.4f} ms"
                          f" ({'bit-equal' if same else 'WRONG'})",
                          flush=True)
            del m
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
