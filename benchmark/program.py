"""The system under test, as the benchmark drives it: the port's keygen,
key preparation and warm-up (set-up), and the two ends of a request that
every traffic kind shares: ciphertexts from the host to the device, and the
answer compressed to q' = 2^log2q and read back as wire words (the calls
serve.py's request handler makes). Each call runs inside a named
`record_function` range, which the traced run reads as what the host was
doing."""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function


def log(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Session:
    """One process's program state: the client (host), the server context
    over prepared keys (device), the AES strategy and the answer's q'."""

    client: object
    ctx: object
    strategy: object
    params: object
    log2q: int

    @property
    def device(self) -> torch.device:
        return self.ctx.device

    def upload(self, arr: np.ndarray) -> torch.Tensor:
        from tfhe_aes2_tpu_torch.ops.torus import to_tensor
        with record_function("bench.upload"):
            return to_tensor(arr, self.device)

    def answer(self, out) -> np.ndarray:
        """The output bits (a BitCt) -> wire words on the host."""
        from tfhe_aes2_tpu_torch.ops import compression
        with record_function("bench.compress"):
            comp = compression.compress_bits(out.array, self.ctx.sks,
                                             self.params, self.log2q)
        with record_function("bench.readback"):
            return compression.wire_array(comp, self.log2q)

    def close(self) -> None:
        self.ctx = self.client = None


def param_set(cfg: dict):
    """The port's parameter set the configuration names, held to the
    numbers the configuration file states."""
    from tfhe_aes2_tpu_torch.ops import params as params_mod
    p = getattr(params_mod, cfg["params"])
    got = {k: getattr(p, k) for k in cfg["param_values"]}
    if got != cfg["param_values"]:
        raise ValueError(f"{cfg['params']} is {got}, the configuration "
                         f"states {cfg['param_values']}")
    return p


def open_session(cfg: dict, seed: int, device: torch.device,
                 params=None) -> Session:
    """Keygen from `seed`, key preparation under the default lowering and
    the port's warm-up (kernel build or load, one launch of each kernel the
    context runs). `params` replaces the configuration's set (CPU tests)."""
    from tfhe_aes2_tpu_torch import aot
    from tfhe_aes2_tpu_torch.aes_128 import fhe
    from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as model
    from tfhe_aes2_tpu_torch.ops import keys

    p = params if params is not None else param_set(cfg)
    strategy = getattr(fhe, cfg["strategy"])
    handle = aot.warmup_staged(device) if aot.enabled(device) else None
    t0 = time.time()
    client, raw = keys.generate_keys(p, seed=seed, device=device)
    log(f"keygen {time.time() - t0:.3f} s ({client.keygen_stream} stream)")
    t0 = time.time()
    ctx = model.context_from_keys(p, raw)
    del raw
    sync(device)
    log(f"key preparation {time.time() - t0:.3f} s, lowering "
        f"({ctx.lowering.br}, {ctx.lowering.vp}, ntt={ctx.lowering.ntt})")
    if handle is not None:
        handle.attach(ctx)
        handle.wait()
        log(f"warm-up: context_ready_s {handle.context_ready_s}, build_s "
            f"{handle.build_s}, load_s {handle.load_s}, wait_s "
            f"{handle.wait_s} ({len(handle.loaded)} kernels)")
    return Session(client=client, ctx=ctx, strategy=strategy, params=p,
                   log2q=cfg["compress_log2q"])
