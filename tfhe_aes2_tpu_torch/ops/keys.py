"""Client keys, evaluation keys, and their preparation for the kernels.

  - small LWE secret key  s  ∈ {0,1}^n
  - GLWE secret key       S  ∈ ({0,1}^N)^k; flattened = the "big" LWE key s'
  - BSK     GGSW_S(s_i) per small-key bit, gadget (pbs_level, pbs_base_log)
  - KSK     big->small LWE keyswitch key, gadget (ks_level, ks_base_log)
  - PFPKSK  private functional packing keyswitch keys for the circuit
            bootstrap functions f_u(x) = -x·S_u (u < k) and f_k(x) = x
  - PKSK    LWE->GLWE packing keyswitch key (the tree-PBS model's,
            ops/packing_keyswitch.py)

Randomness follows the JAX package's keygen (tfhe_aes2_tpu/ops/keys.py,
_KeygenRng): the secret keys and client encryption draw from
np.random.default_rng(seed); the evaluation keys' masks and noise from the
native core's threaded ChaCha20 fills (native.py) where cmake and ninja
build it, else from np.random.default_rng(seed ^ 0x6B657967), which is the
JAX package's fallback too. Both packages draw in the same order, so one
seed gives byte-identical keys wherever both take the same stream; keygen
logs which it took (ClientKey.keygen_stream). The exact GLWE bodies
Σ_u A_u ⊛ S_u run as float64 limb GEMMs on the target device.

The client (ClientKey) stays on the host in numpy uint64; the evaluation
keys are int64 tensors on the device.
"""

from __future__ import annotations

import logging
import subprocess
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from tfhe_aes2_tpu_torch import native as native_mod
from tfhe_aes2_tpu_torch.ops import truncation
from tfhe_aes2_tpu_torch.ops.kernels.matmul import kmajor_key_planes
from tfhe_aes2_tpu_torch.ops.lowering import Lowering
from tfhe_aes2_tpu_torch.ops.params import WopbsParams
from tfhe_aes2_tpu_torch.ops.torus import split_u64_signed, to_tensor

_KEYGEN_SALT = 0x6B65_7967
log = logging.getLogger(__name__)


class ServerKeySet(NamedTuple):
    """Raw evaluation keys, int64 tensors on one device.

    bsk:    [n, pbs_level, k+1(row u), k+1(component), N]
    ksk:    [kN, ks_level, n+1]
    pfpksk: [kN+1(pos), pfks_level, k+1(fn u), k+1(component), N]
    pksk:   [n, ks_level, k+1, N]
    """

    bsk: torch.Tensor
    ksk: torch.Tensor
    pfpksk: torch.Tensor
    pksk: torch.Tensor


class PreparedServerKeys(NamedTuple):
    """Evaluation keys in the kernels' int8 limb-plane layouts, each keeping
    only its planes j >= js (the consumers read js back as 8 - plane count).

    bsk:    [n, k+1(o), R = (k+1)·L (r = u·L + l), 8-js, 2N]  K1's ext_or
    ksk:    [8-js, kN·L, n+1]                                 K4's m planes
    pfpksk: [8-js, (kN+1)·L, (k+1)·(k+1)·N]                   K4's m planes
    vp_js:  planes the vertical packing drops from its runtime GGSWs (K3)
    pksk:   [8, n·L, (k+1)·N] (L = ks_level)                  K4's m planes

    ksk, pfpksk and pksk are views of K-major storage, the layout K4 reads
    (kernels.matmul.kmajor_key_planes). pksk keeps all 8 planes (j_start
    0), as the JAX package keeps it u64 (tfhe_aes2_tpu/ops/keys.py,
    prepare_server_keys).
    """

    bsk: torch.Tensor
    ksk: torch.Tensor
    pfpksk: torch.Tensor
    vp_js: int
    pksk: torch.Tensor

    def to(self, device) -> "PreparedServerKeys":
        """The same keys on `device` (a copy, or self where they already
        lie there; any CPU device index means the one host memory). K4's
        keys are laid out K-major again there: a copy of the padded view
        would lose its row stride."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        here = self.bsk.device
        if device.type == here.type == "cpu" or device == here:
            return self
        return PreparedServerKeys(
            bsk=self.bsk.to(device),
            ksk=kmajor_key_planes(self.ksk.to(device)),
            pfpksk=kmajor_key_planes(self.pfpksk.to(device)),
            vp_js=self.vp_js,
            pksk=kmajor_key_planes(self.pksk.to(device)))


@dataclass
class ClientKey:
    params: WopbsParams
    lwe_sk: np.ndarray    # [n] uint64 in {0,1}
    glwe_sk: np.ndarray   # [k, N] uint64 in {0,1}
    rng: np.random.Generator
    # the evaluation keys' stream ("chacha20" or "numpy"); None where the
    # keys came from elsewhere (keys_from_numpy)
    keygen_stream: str | None = None

    @property
    def big_sk(self) -> np.ndarray:
        """Flattened GLWE key: s'_{u·N + i} = S_u[i]."""
        return self.glwe_sk.reshape(-1)

    def encrypt_bits(self, bits) -> np.ndarray:
        """bits [...] in {0,1} -> LWE cts [..., kN+1] uint64 under the big
        key, bit at 2^63, lwe noise."""
        bits = np.asarray(bits, dtype=np.uint64)
        n = self.params.big_lwe_dimension
        a = _uniform_u64(self.rng, bits.shape + (n,))
        e = _gaussian_u64(self.rng, self.params.lwe_noise_std, bits.shape)
        b = _wrap_dot(a, self.big_sk) + (bits << np.uint64(63)) + e
        return np.concatenate([a, b[..., None]], axis=-1)

    def decrypt_phase(self, cts) -> np.ndarray:
        """Raw phase (message + noise) of big-key LWE cts [..., kN+1]."""
        cts = np.asarray(cts, dtype=np.uint64)
        return cts[..., -1] - _wrap_dot(cts[..., :-1], self.big_sk)

    def decrypt_bits(self, cts) -> np.ndarray:
        """LWE cts [..., kN+1] -> bits [...] via threshold decode."""
        phase = self.decrypt_phase(cts)
        return ((phase + np.uint64(1 << 62)) >> np.uint64(63)) & np.uint64(1)

    # -- small-key codecs: the 8-bit model encrypts its bits under the small
    #    LWE key at 2^63, the tree-PBS model at 2^62 (encodings) --

    def encrypt_bits_small(self, bits) -> np.ndarray:
        """bits [...] -> LWE cts [..., n+1] uint64 under the small key, bit
        at 2^63, lwe noise."""
        bits = np.asarray(bits, dtype=np.uint64)
        return self.encrypt_encodings_small(bits << np.uint64(63))

    def decrypt_bits_small(self, cts) -> np.ndarray:
        """Small-key LWE cts [..., n+1] -> bits [...] (bit at 2^63)."""
        phase = self.decrypt_phase_small(cts)
        return ((phase + np.uint64(1 << 62)) >> np.uint64(63)) & np.uint64(1)

    def encrypt_encodings_small(self, encodings) -> np.ndarray:
        """Raw torus encodings [...] -> LWE cts [..., n+1] uint64 under the
        small key, lwe noise."""
        encodings = np.asarray(encodings, dtype=np.uint64)
        n = self.params.lwe_dimension
        a = _uniform_u64(self.rng, encodings.shape + (n,))
        e = _gaussian_u64(self.rng, self.params.lwe_noise_std,
                          encodings.shape)
        b = _wrap_dot(a, self.lwe_sk) + encodings + e
        return np.concatenate([a, b[..., None]], axis=-1)

    def decrypt_phase_small(self, cts) -> np.ndarray:
        """Raw phase of small-key LWE cts [..., n+1]."""
        cts = np.asarray(cts, dtype=np.uint64)
        return cts[..., -1] - _wrap_dot(cts[..., :-1], self.lwe_sk)


# ---------------------------------------------------------------- helpers

def _uniform_u64(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.integers(0, np.iinfo(np.uint64).max, size=shape,
                        dtype=np.uint64, endpoint=True)


def _gaussian_u64(rng: np.random.Generator, std_torus: float,
                  shape) -> np.ndarray:
    """Gaussian noise with std = std_torus·2^64, rounded half to even,
    wrapped to uint64."""
    e = rng.normal(0.0, std_torus * 2.0 ** 64, size=shape)
    return np.rint(e).astype(np.int64).astype(np.uint64)


def _wrap_dot(a: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Wrapping uint64 dot product over the last axis."""
    with np.errstate(over="ignore"):
        return (a * s).sum(axis=-1, dtype=np.uint64)


class _KeygenRng:
    """Fill source of the evaluation keys' masks and noise, as the JAX
    package's: the native core's threaded ChaCha20 fills (deterministic,
    independent of the thread count) when it builds, numpy otherwise.

    native: None takes the core where it builds and falls back to numpy,
    logged, where it does not (the JAX package's behaviour); False takes
    numpy; True takes the core or raises."""

    def __init__(self, seed: int, native: bool | None = None):
        self._np = np.random.default_rng(seed ^ _KEYGEN_SALT)
        self._native = None
        if native is not False:
            try:
                self._native = native_mod.NativeRng(seed)
            except (OSError, subprocess.SubprocessError) as ex:
                if native:
                    raise
                log.warning("native ChaCha20 core unavailable (%s: %s); "
                            "evaluation keys from the numpy stream",
                            type(ex).__name__, ex)
        self.stream = "numpy" if self._native is None else "chacha20"

    def uniform(self, shape) -> np.ndarray:
        if self._native is None:
            return _uniform_u64(self._np, shape)
        count = int(np.prod(shape, dtype=np.int64))
        return self._native.uniform_u64_par(count).reshape(shape)

    def gaussian(self, std_torus: float, shape) -> np.ndarray:
        if self._native is None:
            return _gaussian_u64(self._np, std_torus, shape)
        count = int(np.prod(shape, dtype=np.int64))
        return self._native.gaussian_u64_par(count, std_torus).reshape(shape)


def _signed_nc_stack(glwe_sk: np.ndarray, device) -> torch.Tensor:
    """[kN, N] float64 negacirculants of the binary S_u, entries in {-1,0,1}:
    (Σ_u A_u ⊛ S_u) = A_flat @ this."""
    k, n = glwe_sk.shape
    j = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    idx = (m - j) % (2 * n)
    blocks = []
    for u in range(k):
        s = glwe_sk[u].astype(np.int64)
        blocks.append(np.concatenate([s, -s])[idx].astype(np.float64))
    return torch.from_numpy(np.concatenate(blocks, axis=0)).to(device)


def _glwe_bodies(a: np.ndarray, nc_signed: torch.Tensor) -> np.ndarray:
    """Exact wrapping A [rows, kN] @ NC(S) mod 2^64 as four float64 GEMMs of
    16-bit unsigned limbs: each sum is below 2^16·kN << 2^53."""
    device = nc_signed.device
    chunk = 8192
    parts = []
    for lo in range(0, a.shape[0], chunk):
        a_t = to_tensor(a[lo: lo + chunk], device)
        acc = None
        for limb in range(4):
            pl = ((a_t >> (16 * limb)) & 0xFFFF).to(torch.float64)
            term = (pl @ nc_signed).round().to(torch.int64) << (16 * limb)
            acc = term if acc is None else acc + term
        parts.append(acc.cpu().numpy().view(np.uint64))
    return np.concatenate(parts, axis=0)


def _encrypt_zero(params: WopbsParams, krng: _KeygenRng,
                  nc_signed: torch.Tensor, rows: int, noise_std: float):
    """-> (A [rows, k, N], B [rows, N]) uint64: GLWE encryptions of zero."""
    k, n = params.glwe_dimension, params.polynomial_size
    a = krng.uniform((rows, k, n))
    e = krng.gaussian(noise_std, (rows, n))
    with np.errstate(over="ignore"):
        b = e + _glwe_bodies(a.reshape(rows, k * n), nc_signed)
    return a, b


def generate_keys_numpy(params: WopbsParams, seed: int = 0,
                        device="cuda", native: bool | None = None):
    """(ClientKey, dict of raw uint64 numpy evaluation keys); `native` picks
    the evaluation keys' stream as _KeygenRng says."""
    rng = np.random.default_rng(seed)
    p = params
    n, k, big_n = p.lwe_dimension, p.glwe_dimension, p.polynomial_size
    k1 = k + 1
    kn = k * big_n

    lwe_sk = rng.integers(0, 2, size=(n,), dtype=np.uint64)
    glwe_sk = rng.integers(0, 2, size=(k, big_n), dtype=np.uint64)
    krng = _KeygenRng(seed, native)
    log.info("evaluation keys from the %s stream (seed %d)", krng.stream,
             seed)
    client = ClientKey(params=p, lwe_sk=lwe_sk, glwe_sk=glwe_sk, rng=rng,
                       keygen_stream=krng.stream)
    big_sk = client.big_sk

    nc_signed = _signed_nc_stack(glwe_sk, device)

    # BSK: GGSW_S(s_i), rows (l, u) = enc(0) + s_i·g_l at component u
    lv = p.pbs_level
    a, b = _encrypt_zero(p, krng, nc_signed, n * lv * k1, p.glwe_noise_std)
    bsk = np.concatenate([a, b[:, None, :]], axis=1).reshape(
        n, lv, k1, k1, big_n)
    with np.errstate(over="ignore"):
        for l in range(lv):
            g = np.uint64(1 << (64 - p.pbs_base_log * (l + 1)))
            for u in range(k1):
                bsk[:, l, u, u, 0] += lwe_sk * g

    # KSK: LWE_s(s'_i · g_l)
    lk = p.ks_level
    a = krng.uniform((kn, lk, n))
    e = krng.gaussian(p.lwe_noise_std, (kn, lk))
    with np.errstate(over="ignore"):
        body = _wrap_dot(a, lwe_sk) + e
        for l in range(lk):
            g = np.uint64(1 << (64 - p.ks_base_log * (l + 1)))
            body[:, l] += big_sk * g
    ksk = np.concatenate([a, body[..., None]], axis=-1)

    # PFPKSK: GLWE_S(s'_i·f_u(g_l)), extra position kN for the body
    lp = p.pfks_level
    a, b = _encrypt_zero(p, krng, nc_signed, (kn + 1) * lp * k1,
                         p.pfks_noise_std)
    pfpksk = np.concatenate([a, b[:, None, :]], axis=1).reshape(
        kn + 1, lp, k1, k1, big_n)
    with np.errstate(over="ignore"):
        s_ext = np.concatenate([big_sk, np.uint64([1])])
        for u in range(k1):
            for l in range(lp):
                g = np.uint64(1 << (64 - p.pfks_base_log * (l + 1)))
                if u < k:
                    msg = (np.uint64(0) - (s_ext * g))[:, None] \
                        * glwe_sk[u][None, :]
                    pfpksk[:, l, u, k, :] += msg
                else:
                    pfpksk[:, l, u, k, 0] += s_ext * g

    # PKSK: GLWE_S(s_i · g_l)
    a, b = _encrypt_zero(p, krng, nc_signed, n * lk, p.lwe_noise_std)
    pksk = np.concatenate([a, b[:, None, :]], axis=1).reshape(n, lk, k1,
                                                              big_n)
    with np.errstate(over="ignore"):
        for l in range(lk):
            g = np.uint64(1 << (64 - p.ks_base_log * (l + 1)))
            pksk[:, l, k, 0] += lwe_sk * g

    return client, dict(bsk=bsk, ksk=ksk, pfpksk=pfpksk, pksk=pksk)


def keys_from_numpy(params: WopbsParams, lwe_sk, glwe_sk, bsk, ksk, pfpksk,
                    pksk, device="cuda", rng: np.random.Generator = None):
    """Build the port's (ClientKey, ServerKeySet) from numpy key arrays,
    e.g. those of the JAX package's generate_keys, so both packages compute
    on identical keys. `rng` drives client encryption (default: seed 0)."""
    client = ClientKey(params=params,
                       lwe_sk=np.asarray(lwe_sk, np.uint64),
                       glwe_sk=np.asarray(glwe_sk, np.uint64),
                       rng=rng if rng is not None else np.random.default_rng(0))
    sks = ServerKeySet(bsk=to_tensor(bsk, device), ksk=to_tensor(ksk, device),
                       pfpksk=to_tensor(pfpksk, device),
                       pksk=to_tensor(pksk, device))
    return client, sks


def generate_keys(params: WopbsParams, seed: int = 0, device="cuda",
                  native: bool | None = None):
    """(ClientKey, raw ServerKeySet on `device`); `native` as in
    generate_keys_numpy."""
    client, raw = generate_keys_numpy(params, seed, device, native)
    out, sks = keys_from_numpy(params, client.lwe_sk, client.glwe_sk,
                               rng=client.rng, device=device, **raw)
    out.keygen_stream = client.keygen_stream
    return out, sks


def prepare_bsk(bsk: torch.Tensor, js: int) -> torch.Tensor:
    """int64 BSK [n, L, k+1(u), k+1(o), N] -> int8 [n, k+1(o), R, 8-js, 2N]
    with row r = u·L + l (the digit order of blind_rotate.decompose)."""
    n_lwe, lv, k1, _, big_n = bsk.shape
    rows = bsk.permute(0, 2, 1, 3, 4).reshape(n_lwe, k1 * lv, k1, big_n)
    ext = torch.cat([rows, -rows], dim=-1)                 # [n, R, O, 2N]
    planes = split_u64_signed(ext)[js:]                    # [8-js, n, R, O, 2N]
    return planes.permute(1, 3, 2, 0, 4).contiguous()


def prepare_server_keys(sks: ServerKeySet, params: WopbsParams,
                        truncate: bool = True) -> PreparedServerKeys:
    """Split the raw keys into the kernels' int8 limb-plane layouts.

    truncate=True drops each key's planes below its noise floor
    (ops/truncation.py: bsk/ksk/pfpksk, and the runtime VP GGSW js);
    truncate=False keeps all 8 planes everywhere, making every contraction
    exact mod 2^64 (the JAX package's CPU arithmetic, bit for bit). No
    padding: kernel K4 takes every shape."""
    p = params
    js_bsk = truncation.bsk_j_start(p) if truncate else 0
    js_ksk = truncation.ksk_j_start(p) if truncate else 0
    js_pf = truncation.pfpksk_j_start(p) if truncate else 0
    kn, lk, n1 = sks.ksk.shape
    kn1, lp, u_cnt, k1, big_n = sks.pfpksk.shape
    n_in = sks.pksk.shape[0]
    ksk = kmajor_key_planes(
        split_u64_signed(sks.ksk.reshape(kn * lk, n1))[js_ksk:])
    pfpksk = kmajor_key_planes(split_u64_signed(
        sks.pfpksk.reshape(kn1 * lp, u_cnt * k1 * big_n))[js_pf:])
    pksk = kmajor_key_planes(split_u64_signed(
        sks.pksk.reshape(n_in * lk, k1 * big_n)))
    return PreparedServerKeys(
        bsk=prepare_bsk(sks.bsk, js_bsk), ksk=ksk, pfpksk=pfpksk,
        vp_js=truncation.vp_ggsw_j_start(p) if truncate else 0, pksk=pksk)


def context_from_keys(ctx_cls, params: WopbsParams, sks: ServerKeySet,
                      truncate: bool = True, lowering: Lowering | None = None):
    """A model's FheContext class `ctx_cls` over raw keys (generate_keys /
    keys_from_numpy), prepared for the kernels; `lowering` None means
    Lowering.from_env()."""
    return ctx_cls(params=params,
                   sks=prepare_server_keys(sks, params, truncate),
                   lowering=(Lowering.from_env() if lowering is None
                             else lowering))


def generate_context(ctx_cls, params: WopbsParams, seed: int = 0,
                     device="cuda", truncate: bool = True,
                     lowering: Lowering | None = None):
    """(ClientKey, ctx_cls over prepared keys on `device`)."""
    client, sks = generate_keys(params, seed=seed, device=device)
    return client, context_from_keys(ctx_cls, params, sks, truncate,
                                     lowering)
