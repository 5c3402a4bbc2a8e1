"""Logging and tracing setup (reference src/logger.rs).

Env-filterable level (the reference's EnvFilter: TFHE_AES_LOG overrides the
default, logger.rs:7-25), idempotent test init (logger.rs:28-35), the
program's named spans, and a torch.profiler trace of a region on the CPU and,
where there is one, the CUDA device — where the JAX package's profile() takes
a jax.profiler trace.

A span is a torch.profiler host range (a kineto event), so it lies on the
clock of the device's kernels in the same trace. It is opened only while a
profiler records: otherwise `span` hands back one shared null context, for
one check of the profiler's state (a bare record_function costs some twenty
times that). No span sits inside a per-step loop.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os

import torch

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


# Every span the program opens, by layer: the AES circuit and the FHE
# model's metadata work, the wop-pbs primitives, the blind rotation's step
# loop (one span a call, around the whole loop).
SPANS = (
    "tfhe.aes.key_schedule",      # aes_128/fhe.py key_schedule_staged (and
                                  # the eager schedule it falls back to)
    "tfhe.aes.encrypt_blocks",    # fhe.encrypt_blocks_staged / _eager
    "tfhe.aes.encrypt_latency",   # fhe.encrypt_block_latency
    "tfhe.aes.round",             # a round; a fused latency-path step
    "tfhe.model.meta",            # BitCt noise/component checks, fresh ids
    "tfhe.wop.keyswitch",         # ops/keyswitch.keyswitch
    "tfhe.wop.pbs",               # ops/blind_rotate.pbs_bit_to_level
    "tfhe.br.steps",              # blind_rotate_glwe's step loop
    "tfhe.wop.pfks",              # ops/keyswitch.pfks_all
    "tfhe.wop.vp",                # ops/circuit_bootstrap.vertical_packing
    "tfhe.wop.compress",          # ops/compression.compress_bits
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A torch.profiler range named `name` (one of SPANS) while a profiler
    records, else a shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def profile(logdir: str):
    """torch.profiler trace of the region, CPU and (where available) CUDA
    activities, the program's spans among them, written to `logdir` as a
    Chrome trace; yields the profiler, whose key_averages() sums the time
    by span, operator and kernel."""
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
