"""Shared helpers of the tests/test_torch_*.py parity tests: move the JAX
package's numpy key material into the PyTorch port (CPU), and convert
between the two packages' array types. Inputs are made by numpy."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as tm1
from tfhe_aes2_tpu_torch.ops import keys as tkeys
from tfhe_aes2_tpu_torch.ops import params as tparams
from tfhe_aes2_tpu_torch.ops.torus import to_numpy, to_tensor

CPU = "cpu"

# The suite runs several pytest workers side by side, each with JAX's own
# thread pools; torch's intra-op threads on top oversubscribe the cores
# (measured: a 3 s CPU test took 215 s in the full parallel run). The
# port's CPU work here is small, so one thread per worker is fastest.
torch.set_num_threads(1)


def port_params(jax_params):
    """The port's copy of a JAX parameter set (same field values), from
    ops/params.py or the tree-PBS model's module."""
    from tfhe_aes2_tpu_torch.models import shortint_1bit as tm1b

    for module in (tparams, tm1b):
        for name in dir(module):
            cand = getattr(module, name)
            if isinstance(cand, tparams.WopbsParams) and \
                    cand.__dict__ == jax_params.__dict__:
                return cand
    raise KeyError(jax_params)


def private_keys(jax_keys):
    """(a copy of the JAX client drawing from a copy of its rng, the server
    keys): encryptions with it leave the session-cached client's rng, which
    the JAX package's tests draw from too (tests/conftest.py), where it was.
    tests/test_torch_rng_isolation.py holds every port test file to it."""
    client, sks = jax_keys
    client = copy.copy(client)
    client.rng = copy.deepcopy(client.rng)
    return client, sks


def port_keys(jax_keys):
    """(ClientKey, raw ServerKeySet) of the port on the CPU, built from the
    JAX package's keys with keys_from_numpy."""
    client, sks = jax_keys
    return tkeys.keys_from_numpy(
        port_params(client.params), client.lwe_sk, client.glwe_sk,
        np.asarray(sks.bsk), np.asarray(sks.ksk), np.asarray(sks.pfpksk),
        np.asarray(sks.pksk), device=CPU)


def port_context(jax_keys, truncate: bool, lowering=None):
    client, sks = port_keys(jax_keys)
    return client, tm1.context_from_keys(client.params, sks, truncate,
                                         lowering)


def jax_server_keys(jax_keys, truncate: bool):
    """The JAX key set to hold the port against: raw u64 keys, or the
    prepared int8 planes with the package's truncation (what its Pallas
    path, interpret mode on the CPU, computes on)."""
    import jax
    import jax.numpy as jnp
    from tfhe_aes2_tpu.ops import blind_rotate as jbr
    from tfhe_aes2_tpu.ops import keys as jkeys
    from tfhe_aes2_tpu.ops import truncation as jtrunc
    from tfhe_aes2_tpu.ops.torus import split_u64_signed

    client, sks = jax_keys
    p = client.params
    raw = jax.tree_util.tree_map(jnp.asarray, sks)
    if not truncate:
        return raw
    return jkeys.ServerKeySet(
        bsk=jbr.prepare_bsk(raw.bsk, p),
        ksk=split_u64_signed(raw.ksk)[jtrunc.ksk_j_start(p):],
        pfpksk=split_u64_signed(raw.pfpksk)[jtrunc.pfpksk_j_start(p):],
        pksk=raw.pksk)


def t64(x) -> torch.Tensor:
    """numpy uint64 (or a jax array) -> int64 CPU tensor, same bits."""
    return to_tensor(np.asarray(x), CPU)


def u64(t: torch.Tensor) -> np.ndarray:
    return to_numpy(t)


def t8(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.int8)))


def require_cuda():
    """Skip (with the reason) unless an NVIDIA GPU is present; decided at
    test time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
