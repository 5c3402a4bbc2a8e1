"""Model `shortint_woppbs_8bit` — 8-bit ciphertexts with WoP-PBS.

Ported from tfhe_aes2_tpu/models/shortint_woppbs_8bit.py (reference
src/tfhe/shortint_woppbs_8bit.rs): the SBOX is evaluated on one 8-bit
`FullWidthCt` (message modulus 256 at delta 2^56) by one WoP-PBS — the
byte's 8 bits under the *small* key circuit-bootstrapped into GGSWs
(ops/circuit_bootstrap.circuit_bootstrap_bits_small) and a vertical-packing
lookup — then its 8 one-bit "dual" ciphertexts are extracted again for the
XOR layer (ops/bit_extract.py). Noise tracking is the linear shortint
`NoiseLevel` (stddev-additive, max 11, shortint_woppbs_8bit.rs:79,154-160);
no independence sets.

On the card a bootstrap runs K2 + K1 (the scaling PBS of each circuit
bootstrap level and of each extracted bit, under the default lowering), K4
(keyswitch and pfKS) and K3 (the vertical packing; K8 under
Lowering.vp == "partials"), at PARAMS_WOPPBS_8BIT's N = 1024.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tfhe_aes2_tpu_torch.models.shortint_woppbs_1bit import (
    BitCt, NoiseError, _empty_ids)
from tfhe_aes2_tpu_torch.ops import bit_extract as be
from tfhe_aes2_tpu_torch.ops import circuit_bootstrap as cbs_ops
from tfhe_aes2_tpu_torch.ops import keys as keys_mod
from tfhe_aes2_tpu_torch.ops import lwe as lwe_ops
from tfhe_aes2_tpu_torch.ops.lowering import Lowering
from tfhe_aes2_tpu_torch.ops.params import PARAMS_WOPPBS_8BIT, WopbsParams
from tfhe_aes2_tpu_torch.ops.torus import to_tensor


@dataclass
class FheContext:
    """8-bit model server context (shortint_woppbs_8bit.rs:184-196):
    parameters, prepared keys on a device, and the lowering its bootstraps
    run. Its bit tensors live under the SMALL key."""

    params: WopbsParams
    sks: keys_mod.PreparedServerKeys
    lowering: Lowering = Lowering()

    @property
    def device(self) -> torch.device:
        return self.sks.bsk.device

    def trivial_bits(self, bits) -> "LinearBitCt":
        bits = np.asarray(bits)
        arr = lwe_ops.trivial_bits(torch.as_tensor(bits, device=self.device),
                                   self.params.lwe_dimension)
        return LinearBitCt(arr, np.zeros(bits.shape, np.int64),
                           _empty_ids(bits.shape), self)

    def generate_lookup_table(self, f) -> np.ndarray:
        """Full-width LUT (generate_lut_without_padding,
        shortint_woppbs_8bit.rs:262-265): entries f(v)·2^(64-8) at index v
        -> uint64 [1, P, N]."""
        p = self.params
        n, logn = p.polynomial_size, p.log2_poly_size
        bits = p.message_bits
        tree_bits = max(0, bits - logn)
        lut = np.zeros((1, (1 << tree_bits) * n), dtype=np.uint64)
        vals = np.array([int(f(v)) % (1 << bits) for v in range(1 << bits)],
                        dtype=np.uint64)
        lut[0, : 1 << bits] = vals << np.uint64(64 - bits)
        return lut.reshape(1, 1 << tree_bits, n)

    def bootstrap_from_bits(self, byte: "LinearBitCt",
                            lut: np.ndarray) -> "FullWidthCt":
        """8 dual bits [..., 8, n+1] (MSB first) -> FullWidthCt [..., kN+1]
        encoding f(byte)·2^56 (shortint_woppbs_8bit.rs:299-335)."""
        p = self.params
        ggsw = cbs_ops.circuit_bootstrap_bits_small(byte.array, self.sks, p,
                                                    self.lowering)
        out = cbs_ops.vertical_packing(ggsw, to_tensor(lut, self.device), p,
                                       self.sks.vp_js, self.lowering)
        return FullWidthCt(out[..., 0, :], self)

    def extract_bits_from_ciphertext(self, fw: "FullWidthCt") -> "LinearBitCt":
        """FullWidthCt -> 8 dual bit cts [..., 8 lanes], fresh NOMINAL noise
        (shortint_woppbs_8bit.rs:268-296)."""
        p = self.params
        out = be.extract_bits(fw.array, self.sks, p, 64 - p.message_bits,
                              p.message_bits, self.lowering)
        lanes = tuple(out.shape[:-1])
        return LinearBitCt(out, np.ones(lanes, np.int64), _empty_ids(lanes),
                           self)


class LinearBitCt(BitCt):
    """1-bit dual ciphertext tensor under the small key with linear
    (stddev-additive) noise tracking — the shortint NoiseLevel semantics
    (shortint_woppbs_8bit.rs:154-160). Component sets are unused (always
    empty), matching the reference's lack of an independence check here.
    Every axis of the array but the last is a lane."""

    def __xor__(self, rhs: "LinearBitCt") -> "LinearBitCt":
        noise = self.noise_sq + rhs.noise_sq        # linear NoiseLevel sum
        max_lin = self.context.params.max_noise_level_linear
        if noise.max(initial=0) > max_lin:
            raise NoiseError(f"NoiseTooBig: noise_level {noise.max()} "
                             f"exceeds max {max_lin}")
        return LinearBitCt(lwe_ops.add(self.array, rhs.array), noise,
                           _empty_ids(noise.shape), self.context)


@dataclass
class FullWidthCt:
    """8-bit message ciphertext under the big key (FullWidthCiphertext,
    shortint_woppbs_8bit.rs:171-182)."""

    array: torch.Tensor  # int64 [..., kN+1]
    context: FheContext


def fresh_linear_bitct(arrays: torch.Tensor, context: FheContext,
                       lane_ndim: int | None = None) -> LinearBitCt:
    """Wrap freshly encrypted small-key bit cts [..., n+1] with nominal
    noise; every leading axis is a lane (`lane_ndim` is taken for the
    strategies' common signature and not used, as in the JAX package)."""
    lanes = tuple(arrays.shape[:-1])
    return LinearBitCt(arrays, np.ones(lanes, np.int64), _empty_ids(lanes),
                       context)


class Woppbs8BitByteOps:
    """AES byte ops for this model (fhe_impls/shortint_woppbs_8bit.rs:22-42):
    bootstrap the byte into a FullWidthCt through the LUT, then extract the
    8 dual bits again."""

    _LUTS: dict = {}

    def __init__(self, ctx: FheContext):
        self.ctx = ctx

    def _lut(self, name: str, f) -> np.ndarray:
        key = (name, self.ctx.params)
        if key not in self._LUTS:
            self._LUTS[key] = self.ctx.generate_lookup_table(f)
        return self._LUTS[key]

    def _through_lut(self, state: LinearBitCt, lut) -> LinearBitCt:
        fw = self.ctx.bootstrap_from_bits(state, lut)
        return self.ctx.extract_bits_from_ciphertext(fw)

    def sub_bytes(self, state: LinearBitCt) -> LinearBitCt:
        from tfhe_aes2_tpu_torch.aes_128 import SBOX
        return self._through_lut(state,
                                 self._lut("sbox", lambda v: int(SBOX[v])))

    def boot(self, word: LinearBitCt) -> LinearBitCt:
        return self._through_lut(word, self._lut("identity", lambda v: v))


def generate_keys(params: WopbsParams = PARAMS_WOPPBS_8BIT, seed: int = 0,
                  device="cuda", truncate: bool = True,
                  lowering: Lowering | None = None):
    """(ClientKey, FheContext) with prepared keys on `device`; `lowering`
    None means Lowering.from_env()."""
    return keys_mod.generate_context(FheContext, params, seed, device,
                                     truncate, lowering)


def context_from_keys(params: WopbsParams, sks: keys_mod.ServerKeySet,
                      truncate: bool = True,
                      lowering: Lowering | None = None) -> FheContext:
    """FheContext over raw keys (keys.generate_keys / keys_from_numpy);
    `lowering` None means Lowering.from_env()."""
    return keys_mod.context_from_keys(FheContext, params, sks, truncate,
                                      lowering)
