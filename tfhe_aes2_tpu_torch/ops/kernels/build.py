"""Build the CUDA sources with nvcc into shared libraries and load them.

Route: `nvcc -gencode arch=compute_90a,code=sm_90a -shared` per source into
a plain C-interface library, loaded with ctypes. All sources compile at the
first use of any kernel, one nvcc process each, started together. Outputs go
to tfhe_aes2_tpu_torch/_build/ (listed in .gitignore), named by a hash of the
sources and flags, so an edited source never loads a stale library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("cmux.cu", "step.cu", "vp.cu", "matmul.cu", "merged.cu",
           "merged_wide.cu", "longk.cu", "bucket.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; returns them by
    source stem. Raises RuntimeError with nvcc's output on any failure."""
    global build_seconds
    with _lock:
        if _libs:
            return _libs
        t0 = time.time()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = _digest()
        targets = {Path(s).stem: BUILD_DIR / f"lib{Path(s).stem}-{tag}.so"
                   for s in SOURCES}
        procs = {}
        for src in SOURCES:
            stem = Path(src).stem
            out = targets[stem]
            if out.exists():
                continue
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            log = open(BUILD_DIR / f"{stem}-{tag}.log", "w")
            procs[stem] = (subprocess.Popen(
                [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / src)],
                stdout=log, stderr=subprocess.STDOUT), tmp, log)
        failed = []
        for stem, (proc, tmp, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(stem)
            else:
                os.replace(tmp, targets[stem])
        if failed:
            msgs = "\n".join(
                (BUILD_DIR / f"{s}-{tag}.log").read_text()[-4000:]
                for s in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
        for stem, path in targets.items():
            _libs[stem] = ctypes.CDLL(str(path))
        build_seconds = time.time() - t0
        return _libs


def ptxas_report() -> str:
    """nvcc's -Xptxas -v lines of the last build — per kernel its entry
    function's name, then its spills, then its registers and shared memory
    — empty when the libraries came from an earlier build."""
    tag = _digest()
    lines = []
    for src in SOURCES:
        log = BUILD_DIR / f"{Path(src).stem}-{tag}.log"
        if log.exists():
            lines += [ln for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln
                      or "Compiling entry function" in ln]
    return "\n".join(lines)


def library(stem: str) -> ctypes.CDLL:
    return build_all()[stem]


def stream_ptr(device) -> int:
    """The current stream of `device`, which must be the current CUDA
    device: the C side launches, and sets kernel attributes, on the
    current device, so a tensor on another one would be read from the
    wrong card. A thread working for cuda:i calls torch.cuda.set_device(i)
    first (parallel/mesh.py)."""
    import torch
    device = torch.device(device)
    current = torch.cuda.current_device()
    if device.type != "cuda" or device.index not in (None, current):
        raise RuntimeError(f"kernel launch for {device} while cuda:{current} "
                           "is the current device: call "
                           "torch.cuda.set_device first")
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {rc})")
