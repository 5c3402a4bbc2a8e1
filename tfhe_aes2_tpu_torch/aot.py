"""Warm-up of the port's startup costs, before the first request.

The JAX package's aot.py removes three startup costs of its staged
programs; the port has PyTorch counterparts of each:

1. **Context absorber** (the JAX channel absorber). A background thread
   initialises the CUDA context, the caching allocator and cuBLAS (a
   float64 product: keygen's limb GEMMs and the CRT-NTT run on cuBLAS)
   while the host does other work, and reports the seconds as
   `WarmupHandle.context_ready_s` (the JAX CHANNEL_READY_S).
2. **Parallel compile.** A background thread runs ops/kernels/build.py's
   build_all (one nvcc a source, all at once) while keygen runs (cli.py)
   or the keys move to the device (serve.py); a launch that comes first
   blocks on the build's lock, as a JAX program blocks on its own
   compile, and `wait()` times how long the run waited. `attach(ctx)`
   then loads,
   on the same thread, every kernel function the context's lowering
   launches at its parameter set and its keys' kept planes, and only
   those (Lowering.kernels() and K4, which every lowering runs): one
   launch each on zero operands of one lane. So CUDA's lazy loading of
   each function and its first cudaFuncSetAttribute are paid before the
   first request. These launches are counted by the wrappers like any.
3. **Artifact store.** The build store is content-addressed by the
   sources and flags (build._digest) and keeps a manifest of nvcc's
   version, the device's name and compute capability and torch's
   version; on a mismatch build_all rebuilds and logs which field changed.
   TFHE_AOT_DIR picks the store ("0": a fresh temporary one).

TFHE_AOT reads as in the JAX package: "1" forces the warm-up, "0"
disables it, and by default it runs where the device is CUDA.

One deliberate difference: the JAX package's pending programs fall back
to plain jit when their artifact or compile fails (aot.py:124-134). Here
nothing falls back: a failed build or load raises from `wait()`, and the
first launch of a kernel raises too (build_all builds again, and fails
again), never a silent run on the CPU.

    handle = aot.warmup_staged("cuda")      # returns at once
    ... keygen / bundle load ...
    handle.attach(ctx)                      # load the run's kernels
    handle.wait()                           # raises what failed
"""

from __future__ import annotations

import logging
import os
import tempfile
import time
from concurrent.futures import Future, ThreadPoolExecutor

import torch

from tfhe_aes2_tpu_torch.ops import blind_rotate as br
from tfhe_aes2_tpu_torch.ops import circuit_bootstrap as cbs
from tfhe_aes2_tpu_torch.ops import decomposition
from tfhe_aes2_tpu_torch.ops.kernels import build
from tfhe_aes2_tpu_torch.ops.torus import exact_matmul

log = logging.getLogger(__name__)


def enabled(device) -> bool:
    """TFHE_AOT: "1" forces the warm-up, "0" disables it, unset (or any
    other value) runs it where `device` is CUDA and a CUDA device is
    present (the JAX package: where its backend is not the CPU)."""
    env = os.environ.get("TFHE_AOT", "")
    return env == "1" or (env != "0" and torch.device(device).type == "cuda"
                          and torch.cuda.is_available())


def store_dir() -> str | None:
    """The build store TFHE_AOT_DIR names: None for build's default, a new
    temporary directory for "0"."""
    env = os.environ.get("TFHE_AOT_DIR")
    if env == "0":
        return tempfile.mkdtemp(prefix="tfhe-kernels-")
    return env or None


class WarmupHandle:
    """The warm-up's futures and timings (seconds; None until measured)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.context_ready_s: float | None = None
        self.build_s: float | None = None
        self.load_s: float | None = None
        self.wait_s: float | None = None
        self.loaded: tuple[str, ...] = ()
        self._pool = ThreadPoolExecutor(2, thread_name_prefix="tfhe-aot")
        self._futures: list[Future] = []
        self._build: Future | None = None

    def attach(self, ctx) -> None:
        """Load, after the build, the kernels `ctx` launches (warm_kernels)."""
        def load():
            self._build.result()
            if ctx.device.type == "cuda" and ctx.device.index is not None:
                torch.cuda.set_device(ctx.device)
            t0 = time.time()
            self.loaded = warm_kernels(ctx)
            if ctx.device.type == "cuda":
                torch.cuda.synchronize(ctx.device)
            self.load_s = time.time() - t0
            log.info("warm-up: %s loaded in %.3f s", ", ".join(self.loaded),
                     self.load_s)

        self._futures.append(self._pool.submit(load))

    def wait(self, timeout: float | None = None) -> None:
        """Block until every step is done; raise the first that failed."""
        t0 = time.time()
        try:
            for fut in self._futures:
                fut.result(timeout)
        finally:
            self.wait_s = time.time() - t0
            self._pool.shutdown(wait=False)


def _absorb_context(handle: WarmupHandle) -> None:
    t0 = time.time()
    x = torch.ones((8, 8), dtype=torch.float64, device=handle.device)
    (x @ x).sum().item()
    handle.context_ready_s = time.time() - t0
    log.info("warm-up: device context ready in %.3f s", handle.context_ready_s)


def _build(handle: WarmupHandle, store: str | None) -> None:
    t0 = time.time()
    if store is not None:
        build.use_store(store)
    build.build_all()
    handle.build_s = time.time() - t0
    log.info("warm-up: kernels built or loaded from %s in %.3f s",
             build.BUILD_DIR, handle.build_s)


def warmup_staged(device="cuda", store: str | None = None) -> WarmupHandle:
    """Start the context absorber and the kernel build on background
    threads and return at once; `store` (default store_dir()) picks the
    build store."""
    handle = WarmupHandle(device)
    if store is None:
        store = store_dir()
    if handle.device.type == "cuda":
        handle._futures.append(handle._pool.submit(_absorb_context, handle))
    handle._build = handle._pool.submit(_build, handle, store)
    handle._futures.append(handle._build)
    return handle


def warm_kernels(ctx) -> tuple[str, ...]:
    """One launch of each kernel `ctx` (a model's FheContext over prepared
    keys) launches: its lowering's blind rotation (one step of one lane,
    zero key) and vertical packing (one lane's CMux stages, zero
    selectors; none under the CRT-NTT where it applies, whose float64
    products run instead), and K4 at the keyswitch's and the pfKS's digit
    limbs and kept planes. Returns the kernels' names:
    ctx.lowering.kernels(vp_js) and fused_limb_matmul."""
    p, sks, low, dev = ctx.params, ctx.sks, ctx.lowering, ctx.device
    k1, n = p.glwe_dimension + 1, p.polynomial_size
    zeros = dict(dtype=torch.int64, device=dev)
    bsk = torch.zeros((1,) + tuple(sks.bsk.shape[1:]), dtype=torch.int8,
                      device=dev)
    br.blind_rotate_glwe(torch.zeros((1, 2), **zeros), bsk,
                         torch.zeros((k1, n), **zeros), p, low)
    ggsw = torch.zeros((1, p.log2_poly_size, p.cbs_level, k1, k1, n), **zeros)
    cbs.vertical_packing(ggsw, torch.zeros((1, 1, n), **zeros), p,
                         sks.vp_js, low)
    for key, base_log in ((sks.ksk, p.ks_base_log),
                          (sks.pfpksk, p.pfks_base_log)):
        nj, k_len, _ = key.shape
        planes = torch.zeros((nj, k_len, 8), dtype=torch.int8, device=dev)
        exact_matmul(torch.zeros((1, k_len), dtype=torch.int32, device=dev),
                     planes, decomposition.digit_bound(base_log),
                     max_k=k_len, m_j_start=8 - nj)
    return low.kernels(sks.vp_js) + ("fused_limb_matmul",)

