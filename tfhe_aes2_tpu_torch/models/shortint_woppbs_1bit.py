"""Model `shortint_woppbs_1bit` — 1-bit ciphertexts with WoP-PBS (production).

  * `BitCt` is a tensor of bit ciphertexts: an int64 array [..., kN+1] (one
    LWE ct per lane, leading axes are batch) plus per-lane metadata.
  * XOR = wrapping LWE add, with variance-based noise tracking under the
    independence heuristic: `noise_sq` adds on XOR and is checked against
    `max_noise_level_squared`, and the component sets of the two operands
    must be disjoint. PyTorch runs eagerly, so the metadata is tracked
    directly on every operation and the checks are always on (the JAX
    package shadow-traces them with jax.eval_shape across its compiled
    programs).
  * `circuit_bootstrap` = bit extract (keyswitch) -> scaling PBS -> pfKS ->
    vertical-packing lookup; output noise = NOMINAL x input bit count.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from tfhe_aes2_tpu_torch.ops import circuit_bootstrap as cbs_ops
from tfhe_aes2_tpu_torch.ops import keys as keys_mod
from tfhe_aes2_tpu_torch.ops import lwe as lwe_ops
from tfhe_aes2_tpu_torch.ops.lowering import Lowering
from tfhe_aes2_tpu_torch.ops.params import PARAMS_SQRD_LVL_64, WopbsParams
from tfhe_aes2_tpu_torch.ops.torus import device_const
from tfhe_aes2_tpu_torch.utils.logger import span, spanned


class NoiseError(Exception):
    """Raised when noise accounting overflows (the reference's NoiseTooBig /
    'noise components not independent' panics)."""


_ID_COUNTER = itertools.count(1)


@spanned("tfhe.model.meta")
def _fresh_ids(shape) -> np.ndarray:
    """Array of singleton component sets with globally unique ids."""
    out = np.empty(shape, dtype=object)
    flat = out.reshape(-1)
    for i in range(flat.size):
        flat[i] = frozenset((next(_ID_COUNTER),))
    return out


def _empty_ids(shape) -> np.ndarray:
    out = np.empty(shape, dtype=object)
    out.reshape(-1)[:] = [frozenset()] * out.size
    return out


@dataclass
class FheContext:
    """Server-side evaluation context: parameters + prepared keys on a
    device, and the lowering (ops/lowering.py) its bootstraps run."""

    params: WopbsParams
    sks: keys_mod.PreparedServerKeys
    lowering: Lowering = Lowering()

    @property
    def device(self) -> torch.device:
        return self.sks.bsk.device

    def trivial_bits(self, bits) -> "BitCt":
        """Trivial (noiseless) ciphertexts of clear `bits`; degree = bit."""
        bits = np.asarray(bits)
        arr = lwe_ops.trivial_bits(device_const(bits, self.device),
                                   self.params.big_lwe_dimension)
        return BitCt(arr, np.zeros(bits.shape, np.int64),
                     _empty_ids(bits.shape), self, bits.astype(np.int64))

    def generate_lookup_table(self, input_bits: int, output_bits: int,
                              f: Callable[[int], int]) -> np.ndarray:
        return cbs_ops.generate_lut(input_bits, output_bits, f, self.params)

    def _luts(self, lut: np.ndarray) -> torch.Tensor:
        return device_const(lut, self.device, torch.int64)

    def circuit_bootstrap(self, bits: "BitCt", lut: np.ndarray) -> "BitCt":
        """Multivariate multivalued bootstrap.

        bits: BitCt whose last lane axis is the T input bits, MSB first;
        lut:  [O, P, N] from generate_lookup_table.
        Returns BitCt [..., O lanes] with noise_sq = T and fresh components.
        """
        t = bits.array.shape[-2]
        o = lut.shape[0]
        out = self.bootstrap_arrays(bits.array, lut)
        lane_shape = bits.lane_shape[:-1] + (o,)
        return BitCt(out, np.full(lane_shape, t, np.int64),
                     _fresh_ids(lane_shape), self)

    def circuit_bootstrap_mixed(self, parts) -> list["BitCt"]:
        """Several bootstrap requests through ONE shared circuit-bootstrap
        front end (keyswitch, blind rotation, pfKS), split per request only
        for the vertical-packing lookups. parts: [(batchless BitCt, lut)]."""
        for bits, _ in parts:
            if bits.array.ndim != len(bits.lane_shape) + 1:
                raise ValueError("circuit_bootstrap_mixed takes batchless "
                                 "BitCts")
        outs = self.bootstrap_mixed_arrays([(bits.array, lut)
                                            for bits, lut in parts])
        metas = [(bits.lane_shape[:-1] + (lut.shape[0],), bits.array.shape[-2])
                 for bits, lut in parts]
        return [BitCt(out, np.full(shape, t, np.int64), _fresh_ids(shape),
                      self) for out, (shape, t) in zip(outs, metas)]

    # -- the ciphertext work of the two bootstraps, without the metadata;
    #    parallel/mesh.py's LaneShardedContext splits it across devices --

    def bootstrap_arrays(self, bits: torch.Tensor,
                         lut: np.ndarray) -> torch.Tensor:
        """[..., T, kN+1] -> [..., O, kN+1]: circuit_bootstrap's arrays."""
        return cbs_ops.circuit_bootstrap_vertical_packing(
            bits, self._luts(lut), self.sks, self.params, self.lowering)

    def bootstrap_mixed_arrays(self, parts) -> list[torch.Tensor]:
        """[(array [*lanes, T, kN+1], lut)] -> [array [*lanes, O, kN+1]]:
        circuit_bootstrap_mixed's arrays, one shared front end."""
        n1 = self.params.big_lwe_dimension + 1
        flats = [bits.reshape(-1, n1) for bits, _ in parts]
        ggsw = cbs_ops.circuit_bootstrap_bits(torch.cat(flats), self.sks,
                                              self.params, self.lowering)
        outs, off = [], 0
        for (bits, lut), flat in zip(parts, flats):
            nl, t = flat.shape[0], bits.shape[-2]
            g = ggsw[off: off + nl].reshape((nl // t, t) + ggsw.shape[1:])
            out = cbs_ops.vertical_packing(g, self._luts(lut), self.params,
                                           self.sks.vp_js, self.lowering)
            outs.append(out.reshape(bits.shape[:-2] + (lut.shape[0], n1)))
            off += nl
        return outs


@dataclass
class BitCt:
    """Tensor of 1-bit LWE ciphertexts under the big (GLWE-as-LWE) key.

    array: int64 [..., *lane_shape, kN+1] (leading axes are batch);
    noise_sq, comps, degree: per-lane metadata of shape lane_shape —
    squared noise level, set of independent noise components, and the
    message-degree bound (1 for encrypted bits, the bit for trivials,
    saturating under XOR).
    """

    array: torch.Tensor
    noise_sq: np.ndarray
    comps: np.ndarray
    context: FheContext
    degree: np.ndarray = None

    def __post_init__(self):
        if self.degree is None:
            self.degree = np.ones(self.noise_sq.shape, np.int64)

    @property
    def lane_shape(self):
        return self.noise_sq.shape

    def __xor__(self, rhs: "BitCt") -> "BitCt":
        with span("tfhe.model.meta"):
            noise_sq = self.noise_sq + rhs.noise_sq
            max_sq = self.context.params.max_noise_level_squared
            if noise_sq.max(initial=0) > max_sq:
                raise NoiseError(
                    f"NoiseTooBig: noise_level_squared {noise_sq.max()} "
                    f"exceeds max {max_sq}")
            inter = np.frompyfunc(lambda a, b: a & b, 2, 1)(self.comps,
                                                            rhs.comps)
            if any(len(s) > 0 for s in inter.reshape(-1)):
                raise NoiseError("noise components not independent")
            comps = np.frompyfunc(lambda a, b: a | b, 2, 1)(self.comps,
                                                            rhs.comps)
            degree = np.minimum(self.degree + rhs.degree, 1)
        return BitCt(lwe_ops.add(self.array, rhs.array), noise_sq, comps,
                     self.context, degree)

    def _arr_axis(self, axis: int) -> int:
        n_lane = len(self.lane_shape)
        return self.array.ndim - 1 - n_lane + axis % n_lane

    def take_lanes(self, idx, axis: int) -> "BitCt":
        """Gather lanes along lane axis `axis` (0 = outermost lane axis)."""
        idx = np.asarray(idx)
        axis = axis % len(self.lane_shape)
        arr = torch.index_select(
            self.array, self._arr_axis(axis),
            device_const(idx, self.array.device, torch.int64))
        return type(self)(arr, np.take(self.noise_sq, idx, axis=axis),
                          np.take(self.comps, idx, axis=axis), self.context,
                          np.take(self.degree, idx, axis=axis))

    def reshape_lanes(self, *lane_shape) -> "BitCt":
        batch = tuple(self.array.shape[: self.array.ndim - 1
                                       - len(self.lane_shape)])
        arr = self.array.reshape(batch + tuple(lane_shape)
                                 + self.array.shape[-1:])
        return type(self)(arr, self.noise_sq.reshape(lane_shape),
                          self.comps.reshape(lane_shape), self.context,
                          self.degree.reshape(lane_shape))

    def slice_lanes(self, sl: slice, axis: int = 0) -> "BitCt":
        """Slice one lane axis with python slice `sl`."""
        axis = axis % len(self.lane_shape)
        arr = self.array.narrow(self._arr_axis(axis), *_start_len(
            sl, self.lane_shape[axis]))
        meta_idx = [slice(None)] * len(self.lane_shape)
        meta_idx[axis] = sl
        meta_idx = tuple(meta_idx)
        return type(self)(arr, self.noise_sq[meta_idx],
                          self.comps[meta_idx], self.context,
                          self.degree[meta_idx])

    @classmethod
    def concat_lanes(cls, parts: list["BitCt"], axis: int = 0) -> "BitCt":
        n_lane = len(parts[0].lane_shape)
        axis = axis % n_lane
        # broadcast leading batch axes so batchless parts join batched ones
        max_ndim = max(p.array.ndim for p in parts)
        batch = next(tuple(q.array.shape[: max_ndim - n_lane - 1])
                     for q in parts if q.array.ndim == max_ndim)
        arrays = [p.array.expand(batch + tuple(p.array.shape))
                  if p.array.ndim < max_ndim else p.array for p in parts]
        return cls(torch.cat(arrays, dim=max_ndim - 1 - n_lane + axis),
                   np.concatenate([p.noise_sq for p in parts], axis=axis),
                   np.concatenate([p.comps for p in parts], axis=axis),
                   parts[0].context,
                   np.concatenate([p.degree for p in parts], axis=axis))


def _start_len(sl: slice, size: int) -> tuple[int, int]:
    start, stop, step = sl.indices(size)
    if step != 1:
        raise ValueError("slice_lanes takes unit-step slices")
    return start, max(0, stop - start)


def fresh_bitct(arrays: torch.Tensor, context: FheContext,
                lane_ndim: int | None = None) -> BitCt:
    """Wrap freshly encrypted ct arrays ([..., kN+1]) as a BitCt with nominal
    noise (1) and fresh component ids; `lane_ndim` trailing axes (before the
    ct axis) are lanes, default all."""
    if lane_ndim is None:
        lane_ndim = arrays.ndim - 1
    lane_shape = tuple(arrays.shape[arrays.ndim - 1 - lane_ndim: -1])
    return BitCt(arrays, np.ones(lane_shape, np.int64),
                 _fresh_ids(lane_shape), context)


def generate_keys(params: WopbsParams = PARAMS_SQRD_LVL_64, seed: int = 0,
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
