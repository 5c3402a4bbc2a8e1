"""The system under test, as the benchmark drives it: the port's keygen,
key preparation and warm-up (set-up), and the two ends of a request that
every traffic kind shares: ciphertexts from the host to the device, and the
answer compressed to q' = 2^log2q and read back as wire words (the calls
serve.py's request handler makes). The configuration names its FHE model
(`model`, a module of tfhe_aes2_tpu_torch.models; shortint_woppbs_1bit
where it names none). Each call runs inside a named
`record_function` range, which the traced run reads as what the host was
doing."""

from __future__ import annotations

import dataclasses
import importlib
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
        """The output bits (a BitCt) -> wire words on the host: bits under
        the big key (last axis kN+1) keyswitched to the small key and
        switched to q', bits already under the small key (n+1: the 8-bit
        model's) switched to q' alone."""
        from tfhe_aes2_tpu_torch.ops import compression
        p = self.params
        with record_function("bench.compress"):
            if out.array.shape[-1] == p.big_lwe_dimension + 1:
                comp = compression.compress_bits(out.array, self.ctx.sks, p,
                                                 self.log2q)
            else:
                comp = compression.mod_switch_q(out.array, self.log2q)
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


DEFAULT_MODEL = "shortint_woppbs_1bit"


def model_module(cfg: dict):
    """The port's FHE model module the configuration names."""
    return importlib.import_module("tfhe_aes2_tpu_torch.models."
                                   + cfg.get("model", DEFAULT_MODEL))


def open_session(cfg: dict, seed: int, device: torch.device,
                 params=None) -> Session:
    """Keygen from `seed`, key preparation under the default lowering and
    the port's warm-up (kernel build or load, one launch of each kernel the
    context runs), the context built by the configuration's model.
    `params` replaces the configuration's set (CPU tests)."""
    from tfhe_aes2_tpu_torch import aot
    from tfhe_aes2_tpu_torch.aes_128 import fhe
    from tfhe_aes2_tpu_torch.ops import keys

    p = params if params is not None else param_set(cfg)
    strategy = getattr(fhe, cfg["strategy"])
    handle = aot.warmup_staged(device) if aot.enabled(device) else None
    t0 = time.time()
    client, raw = keys.generate_keys(p, seed=seed, device=device)
    log(f"keygen {time.time() - t0:.3f} s ({client.keygen_stream} stream)")
    t0 = time.time()
    ctx = model_module(cfg).context_from_keys(p, raw)
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
