"""ctypes binding of the repository's native C++ client core
(native/tfhe_core.cpp): a deterministic ChaCha20 CSPRNG with threaded
counter-mode fills, LWE encrypt / decrypt, exact negacyclic multiplication
and gadget decomposition over Z_2^64.

The library is built by the route the JAX package takes
(tfhe_aes2_tpu/native.py): `cmake -G Ninja` on native/CMakeLists.txt, with
its flags (C++17, -O3 -march=native, Threads). Keygen draws its evaluation
keys from this core exactly where the JAX package does, so both packages
make the same keys from one seed: wherever cmake and ninja are present,
and, through the Gaussian fills' std::log / std::cos, only with the same
compiler and flags. The build goes into the port's own directory,
tfhe_aes2_tpu_torch/_build/ (git-ignored), named by a digest of the two
sources, and never into native/build/. Each build runs in a directory of
its own process and renames the library into place, so processes that
build at once do not clash.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _digest(source_dir: Path) -> str:
    h = hashlib.sha256()
    for name in ("CMakeLists.txt", "tfhe_core.cpp"):
        h.update(name.encode())
        h.update((source_dir / name).read_bytes())
    return h.hexdigest()[:16]


def build(source_dir: Path | None = None) -> Path:
    """The built library's path, building it with cmake + ninja if it is
    not there yet. Raises OSError where the sources or the tools are
    missing and subprocess.CalledProcessError where a step fails."""
    source_dir = SOURCE_DIR if source_dir is None else Path(source_dir)
    tag = _digest(source_dir)
    lib = BUILD_DIR / f"libtfhe_core-{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = BUILD_DIR / f"native-{tag}.tmp{os.getpid()}"
    try:
        subprocess.run(["cmake", "-G", "Ninja", "-S", str(source_dir),
                        "-B", str(work)], check=True, capture_output=True)
        subprocess.run(["ninja", "-C", str(work)], check=True,
                       capture_output=True)
        os.replace(work / "libtfhe_core.so", lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded library with its C signatures declared (built on first
    use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build())))
        return _lib


def _declare(l: ctypes.CDLL) -> ctypes.CDLL:
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64, dbl, ptr = ctypes.c_int64, ctypes.c_double, ctypes.c_void_p
    l.tfhe_rng_new.restype = ptr
    l.tfhe_rng_new.argtypes = [ctypes.c_uint64]
    l.tfhe_rng_free.restype = None
    l.tfhe_rng_free.argtypes = [ptr]
    for name in ("tfhe_rng_fill_u64", "tfhe_rng_fill_u64_par"):
        getattr(l, name).restype = None
        getattr(l, name).argtypes = [ptr, u64p, i64]
    for name in ("tfhe_rng_fill_gaussian", "tfhe_rng_fill_gaussian_par"):
        getattr(l, name).restype = None
        getattr(l, name).argtypes = [ptr, u64p, i64, dbl]
    l.tfhe_lwe_encrypt.restype = None
    l.tfhe_lwe_encrypt.argtypes = [ptr, u64p, i64, u64p, i64, dbl, u64p]
    l.tfhe_lwe_decrypt_phase.restype = None
    l.tfhe_lwe_decrypt_phase.argtypes = [u64p, i64, u64p, i64, u64p]
    l.tfhe_negacyclic_mul.restype = None
    l.tfhe_negacyclic_mul.argtypes = [u64p, u64p, i64, u64p]
    l.tfhe_decompose.restype = None
    l.tfhe_decompose.argtypes = [u64p, i64, ctypes.c_int, ctypes.c_int, i32p]
    return l


class NativeRng:
    """Deterministic ChaCha20 CSPRNG (the reference's DeterministicSeeder +
    EncryptionRandomGenerator analogue, engine.rs:138-184)."""

    def __init__(self, seed: int):
        self._l = lib()
        self._h = self._l.tfhe_rng_new(seed)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._l.tfhe_rng_free(h)

    def uniform_u64(self, count: int) -> np.ndarray:
        out = np.empty(count, np.uint64)
        self._l.tfhe_rng_fill_u64(self._h, out, count)
        return out

    def gaussian_u64(self, count: int, std_torus: float) -> np.ndarray:
        out = np.empty(count, np.uint64)
        self._l.tfhe_rng_fill_gaussian(self._h, out, count, std_torus)
        return out

    def uniform_u64_par(self, count: int) -> np.ndarray:
        """Threaded fill: deterministic (counter-indexed ChaCha20 blocks,
        independent of the thread count) but a different stream than the
        sequential uniform_u64."""
        out = np.empty(count, np.uint64)
        self._l.tfhe_rng_fill_u64_par(self._h, out, count)
        return out

    def gaussian_u64_par(self, count: int, std_torus: float) -> np.ndarray:
        out = np.empty(count, np.uint64)
        self._l.tfhe_rng_fill_gaussian_par(self._h, out, count, std_torus)
        return out

    def lwe_encrypt(self, sk: np.ndarray, msgs: np.ndarray,
                    std_torus: float) -> np.ndarray:
        """msgs [M] torus encodings -> LWE cts [M, n+1] under sk [n]."""
        sk = np.ascontiguousarray(sk, np.uint64)
        msgs = np.ascontiguousarray(msgs, np.uint64)
        out = np.empty((msgs.shape[0], sk.shape[0] + 1), np.uint64)
        self._l.tfhe_lwe_encrypt(self._h, sk, sk.shape[0], msgs,
                                 msgs.shape[0], std_torus, out)
        return out


def lwe_decrypt_phase(sk: np.ndarray, cts: np.ndarray) -> np.ndarray:
    """LWE cts [M, n+1] -> phases [M] under sk [n]."""
    sk = np.ascontiguousarray(sk, np.uint64)
    cts = np.ascontiguousarray(cts, np.uint64)
    if cts.ndim != 2 or cts.shape[1] != sk.shape[0] + 1:
        raise ValueError(f"cts {cts.shape} do not fit a key of {sk.shape[0]}")
    out = np.empty(cts.shape[0], np.uint64)
    lib().tfhe_lwe_decrypt_phase(sk, sk.shape[0], cts, cts.shape[0], out)
    return out


def negacyclic_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact a·b mod (X^N + 1, 2^64) of two [N] polynomials."""
    a = np.ascontiguousarray(a, np.uint64)
    b = np.ascontiguousarray(b, np.uint64)
    if a.ndim != 1 or a.shape != b.shape:
        raise ValueError(f"shapes {a.shape} and {b.shape} are not one [N]")
    out = np.empty_like(a)
    lib().tfhe_negacyclic_mul(a, b, a.shape[0], out)
    return out


def decompose(xs: np.ndarray, base_log: int, levels: int) -> np.ndarray:
    """Balanced gadget digits [M, levels] int32 of xs [M]."""
    xs = np.ascontiguousarray(xs, np.uint64)
    out = np.empty((xs.shape[0], levels), np.int32)
    lib().tfhe_decompose(xs, xs.shape[0], base_log, levels, out)
    return out
