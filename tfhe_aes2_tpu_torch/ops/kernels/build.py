"""Build the CUDA sources with nvcc into shared libraries and load them.

Route: `nvcc -gencode arch=compute_90a,code=sm_90a -shared` per source into
a plain C-interface library, loaded with ctypes. All sources compile at the
first use of any kernel (or on the warm-up's thread, aot.py), one nvcc
process each, started together. Outputs go to the store, by default
tfhe_aes2_tpu_torch/_build/ (listed in .gitignore; use_store picks another),
named by a hash of the sources and flags, so an edited source never loads a
stale library. Beside them the store keeps a manifest of what built them
(nvcc's version, the device's name and compute capability, torch's
version): where it is missing or differs from this process's, every
library is built again and the changed fields are logged.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("cmux.cu", "cmux_wg.cu", "step.cu", "vp.cu", "matmul.cu",
           "merged.cu", "merged_wide.cu", "longk.cu", "bucket.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_log = logging.getLogger(__name__)
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


def use_store(path) -> None:
    """Build into and load from `path` instead of the default store; only
    before any library is loaded."""
    global BUILD_DIR
    with _lock:
        if _libs and Path(path) != BUILD_DIR:
            raise RuntimeError(f"kernels already loaded from {BUILD_DIR}")
        BUILD_DIR = Path(path)


def fingerprint() -> dict:
    """What the libraries' machine code depends on beyond the sources and
    flags: nvcc's version, the device's name and compute capability, and
    torch's version (the build store's manifest)."""
    import torch
    out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    dev = torch.cuda.current_device() if torch.cuda.is_available() else None
    return {"nvcc": out[-1] if out else "",
            "device": None if dev is None else torch.cuda.get_device_name(dev),
            "capability": None if dev is None else "%d.%d" % (
                torch.cuda.get_device_capability(dev)),
            "torch": torch.__version__}


def stale_fields(store: Path, want: dict) -> list[str]:
    """The manifest fields of `store` that differ from `want` (all of them,
    where the store has no manifest)."""
    try:
        have = json.loads((store / "manifest.json").read_text())
    except (OSError, ValueError):
        return sorted(want)
    return sorted(k for k in want if have.get(k) != want[k])


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; returns them by
    source stem. Raises RuntimeError with nvcc's output on any failure.
    A caller that comes while another thread builds waits for it."""
    global build_seconds
    with _lock:
        if _libs:
            return _libs
        t0 = time.time()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = _digest()
        want = fingerprint()
        stale = stale_fields(BUILD_DIR, want)
        if stale:
            _log.info("kernel store %s: %s changed; building every source",
                      BUILD_DIR, ", ".join(stale))
        targets = {Path(s).stem: BUILD_DIR / f"lib{Path(s).stem}-{tag}.so"
                   for s in SOURCES}
        procs = {}
        for src in SOURCES:
            stem = Path(src).stem
            out = targets[stem]
            if out.exists() and not stale:
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
        if stale:
            tmp = BUILD_DIR / f"manifest.json.tmp{os.getpid()}"
            tmp.write_text(json.dumps(want, indent=1, sort_keys=True))
            os.replace(tmp, BUILD_DIR / "manifest.json")
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
