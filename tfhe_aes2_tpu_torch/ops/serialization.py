"""Key serialization: save and load client keys and evaluation-key bundles.

A deployed service ships the evaluation keys from the client to the server
host once; they must be reloadable there. The format is the JAX package's
(tfhe_aes2_tpu/ops/serialization.py): one npz per bundle with the raw keys as
uint64 arrays under the names `bsk`, `ksk`, `pfpksk`, `pksk` and the
parameter set as JSON bytes under `params`, so a bundle written by either
package loads in the other. A server bundle holds no secret key. Client keys
embed the RNG state, so encryption stays reproducible after a round trip.
The server bundle is stored uncompressed: evaluation keys are uniform random
words, which deflate cannot shrink, and `np.load` reads either form.

Raw keys load as numpy arrays; `keys.keys_from_numpy` and
`keys.prepare_server_keys` (or `server_context`) take them to the device and
into the kernels' layouts.
"""

from __future__ import annotations

import json

import numpy as np

from tfhe_aes2_tpu_torch.ops import keys as keys_mod
from tfhe_aes2_tpu_torch.ops.params import WopbsParams
from tfhe_aes2_tpu_torch.ops.torus import to_numpy, to_tensor

_KEY_NAMES = ("bsk", "ksk", "pfpksk", "pksk")


def _params_bytes(params: WopbsParams) -> np.ndarray:
    return np.frombuffer(json.dumps(params.__dict__).encode(), dtype=np.uint8)


def _params_from(entry) -> WopbsParams:
    return WopbsParams(**json.loads(bytes(entry).decode()))


def _as_u64(x) -> np.ndarray:
    """A raw key as numpy uint64: an int64 tensor's bits, or an array."""
    return to_numpy(x) if hasattr(x, "detach") else np.asarray(x, np.uint64)


def save_server_keys(path: str, sks, params: WopbsParams) -> None:
    """Write the evaluation-key bundle. `sks`: a raw `keys.ServerKeySet`
    (int64 tensors on any device) or the same four arrays as numpy uint64."""
    np.savez(path, params=_params_bytes(params),
             **{name: _as_u64(getattr(sks, name)) for name in _KEY_NAMES})


def load_server_keys(path: str) -> tuple[dict, WopbsParams]:
    """-> ({bsk, ksk, pfpksk, pksk: numpy uint64}, params)."""
    with np.load(path) as z:
        return {name: z[name] for name in _KEY_NAMES}, _params_from(z["params"])


def server_keys_on(raw: dict, device) -> keys_mod.ServerKeySet:
    """The loaded bundle's arrays as a raw ServerKeySet on `device`."""
    return keys_mod.ServerKeySet(
        **{name: to_tensor(raw[name], device) for name in _KEY_NAMES})


def save_client_key(path: str, client: keys_mod.ClientKey) -> None:
    state = client.rng.bit_generator.state
    np.savez_compressed(
        path, lwe_sk=client.lwe_sk, glwe_sk=client.glwe_sk,
        params=_params_bytes(client.params),
        rng_state=np.frombuffer(json.dumps(state).encode(), dtype=np.uint8))


def load_client_key(path: str) -> keys_mod.ClientKey:
    with np.load(path) as z:
        rng = np.random.default_rng()
        rng.bit_generator.state = json.loads(bytes(z["rng_state"]).decode())
        return keys_mod.ClientKey(params=_params_from(z["params"]),
                                  lwe_sk=z["lwe_sk"], glwe_sk=z["glwe_sk"],
                                  rng=rng)
