"""Logging and tracing setup (reference src/logger.rs).

Env-filterable level (the reference's EnvFilter: TFHE_AES_LOG overrides the
default, logger.rs:7-25), idempotent test init (logger.rs:28-35), a coarse
wall-clock span, and a torch.profiler trace of a region on the CPU and, where
there is one, the CUDA device — where the JAX package's profile() takes a
jax.profiler trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

_INITIALIZED = False


def init(level: str = "INFO") -> None:
    global _INITIALIZED
    if _INITIALIZED:
        return
    level = os.environ.get("TFHE_AES_LOG", level)
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)-5s %(name)s: %(message)s")
    _INITIALIZED = True


def test_init(level: str = "DEBUG") -> None:
    init(level)


@contextlib.contextmanager
def timed(label: str, logger: logging.Logger | None = None):
    """Coarse wall-clock span (the reference's debug! timing around every
    expensive primitive, e.g. shortint_woppbs_1bit.rs:295-333)."""
    log = logger or logging.getLogger("tfhe_aes2_tpu_torch")
    t0 = time.time()
    try:
        yield
    finally:
        log.debug("%s %.3fs", label, time.time() - t0)


@contextlib.contextmanager
def profile(logdir: str):
    """torch.profiler trace of the region, CPU and (where available) CUDA
    activities, written to `logdir` as a Chrome trace; yields the
    profiler, whose key_averages() sums the time by operator and kernel."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
