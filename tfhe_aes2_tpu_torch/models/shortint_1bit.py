"""Model `shortint_1bit` — plain-PBS 1-bit ciphertexts with tree-based
multivariate bootstrapping (TCHES 8793).

Ported from tfhe_aes2_tpu/models/shortint_1bit.py (reference
src/tfhe/shortint_1bit.rs): bits encode at 2^62 under the *small* LWE key
(shortint message 2 / carry 1); XOR is an unchecked add whose carry
overflows into the padding bit (valid because every functional bootstrap is
effectively negacyclic, shortint_1bit.rs:103-115). The multivariate
bootstrap evaluates an n-bit function as a binary tree: leaf test vectors
select on the LSB, each level bootstraps the remaining test vectors by one
selector bit and packs result pairs into new (encrypted) test vectors
through the LWE->GLWE packing keyswitch (shortint_1bit.rs:392-576).

On the card a bootstrap is one blind rotation (K2, then K1 per step under
the default lowering) with a per-lane accumulator, a sample extract and a
keyswitch (K4); a tree level's packing keyswitch is K4 and its selection
product mask0·p0 + mask1·p1 one launch of K3 (polynomial
.polymul_shared_digits) — the JAX package materialises each lane's
negacirculant there, which at PARAMS_SHORTINT_1BIT would take ~86 GB for
one AES state.

The reference flags its parameter set `!Testing parameters!`
(shortint_1bit.rs:62) and #[ignore]s its AES tests for noise accumulation;
the model tracks no noise metadata, as there.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tfhe_aes2_tpu_torch.ops import blind_rotate as br
from tfhe_aes2_tpu_torch.ops import keys as keys_mod
from tfhe_aes2_tpu_torch.ops import keyswitch as ksw
from tfhe_aes2_tpu_torch.ops import packing_keyswitch as pks
from tfhe_aes2_tpu_torch.ops import polynomial
from tfhe_aes2_tpu_torch.ops.lowering import Lowering
from tfhe_aes2_tpu_torch.ops.params import WopbsParams

# reference shortint_1bit.rs:63-83 — flagged `todo !Testing parameters!`
PARAMS_SHORTINT_1BIT = WopbsParams(
    lwe_dimension=640,
    glwe_dimension=4,
    polynomial_size=512,
    lwe_noise_std=4.728000245054929e-7,
    glwe_noise_std=2.845267479601915e-15,
    pbs_level=7, pbs_base_log=6,
    ks_level=2, ks_base_log=6,
    cbs_level=1, cbs_base_log=10,       # unused by this model
    pfks_level=1, pfks_base_log=24,     # unused by this model
    pfks_noise_std=2.845267479601915e-15,
    max_noise_level_squared=0,
    max_noise_level_linear=11,
)

# small insecure set for CPU tests
PARAMS_TEST_S1 = WopbsParams(
    lwe_dimension=32,
    glwe_dimension=1,
    polynomial_size=128,
    lwe_noise_std=2.0 ** -35,
    glwe_noise_std=2.0 ** -45,
    pbs_level=3, pbs_base_log=12,
    ks_level=3, ks_base_log=6,
    cbs_level=1, cbs_base_log=10,
    pfks_level=1, pfks_base_log=24,
    pfks_noise_std=2.0 ** -45,
    max_noise_level_squared=0,
    max_noise_level_linear=11,
)


@dataclass
class FheContext:
    """shortint_1bit server context (shortint_1bit.rs:132-144): parameters,
    prepared keys on a device, and the lowering its blind rotations run."""

    params: WopbsParams
    sks: keys_mod.PreparedServerKeys
    lowering: Lowering = Lowering()
    cache: dict = field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.sks.bsk.device

    def trivial(self, bits) -> "Bit1Ct":
        bits = np.asarray(bits)
        mask = np.zeros(bits.shape + (self.params.lwe_dimension,), np.uint64)
        body = (bits.astype(np.uint64) << np.uint64(62))[..., None]
        arr = np.concatenate([mask, body], axis=-1).view(np.int64)
        return Bit1Ct(torch.from_numpy(arr).to(self.device), self)

    def trivial_bits(self, bits) -> "LaneBit1Ct":
        """Lane-tensor trivial ciphertexts (the AES data model's entry
        point, ContextT::trivial for this model)."""
        bits = np.asarray(bits)
        return LaneBit1Ct(self.trivial(bits).array, bits.shape, self)

    # -- test vectors --

    def test_vector_from_cleartext_fn(self, f) -> torch.Tensor:
        """Clear GLWE accumulator for f: {0,1}->{0,1}
        (shortint_1bit.rs:365-390) -> int64 [k+1, N] (trivial)."""
        p = self.params
        n = p.polynomial_size
        box = n // 2
        body = np.empty(n, np.uint64)
        body[:box] = np.uint64(int(f(0)) << 62)
        body[box:] = np.uint64(int(f(1)) << 62)
        body = np.roll(body, -(box // 2))
        glwe = np.zeros((p.glwe_dimension + 1, n), np.uint64)
        glwe[-1] = body
        return torch.from_numpy(glwe.view(np.int64)).to(self.device)

    def test_vector_from_ciphertexts(self, ct0: "Bit1Ct", ct1: "Bit1Ct"):
        """Encrypted accumulator selecting ct0/ct1 with the box layout of
        test_vector_from_cleartext_fn (shortint_1bit.rs:392-492)."""
        return _tv_from_ct_arrays(ct0.array, ct1.array, self.sks.pksk,
                                  self.params)

    def packing_keyswitch(self, cts: "Bit1Ct") -> torch.Tensor:
        """Pack bit cts [..., M, n+1] at successive monomials
        (shortint_1bit.rs:239-254)."""
        return pks.pack_lwe_list(cts.array, self.sks.pksk, self.params)

    # -- bootstrap --

    def bootstrap(self, ct: "Bit1Ct", test_vector: torch.Tensor) -> "Bit1Ct":
        """Blind rotate + sample extract + keyswitch
        (shortint_1bit.rs:264-289). test_vector: [..., k+1, N], a clear or
        an encrypted GLWE accumulator, broadcastable against the ct batch."""
        p = self.params
        acc = br.blind_rotate_glwe(ct.array, self.sks.bsk, test_vector, p,
                                   self.lowering)
        big = br.sample_extract0(acc)
        return Bit1Ct(ksw.keyswitch(big, self.sks.ksk, p), self)


def selection_masks(n: int, device) -> torch.Tensor:
    """The tree's selection digits int8 [2, N]: mask0 is 1 on the first and
    last N/4 coefficients (the box of input 0, rotated), mask1 on the middle
    N/2."""
    hb = n // 4
    masks = torch.zeros((2, n), dtype=torch.int8, device=device)
    masks[0, :hb] = 1
    masks[0, n - hb:] = 1
    masks[1, hb:n - hb] = 1
    return masks


def _tv_from_ct_arrays(ct0: torch.Tensor, ct1: torch.Tensor,
                       pksk: torch.Tensor,
                       params: WopbsParams) -> torch.Tensor:
    """mask0 ⊛ pack(ct0) + mask1 ⊛ pack(ct1): ct0, ct1 [..., n+1] ->
    GLWE [..., k+1, N], one launch of K3 for all the pairs."""
    p = params
    k1, n = p.glwe_dimension + 1, p.polynomial_size
    polys = torch.stack([pks.pack_lwe(ct0, pksk, p),
                         pks.pack_lwe(ct1, pksk, p)], dim=-3)  # [.., 2, O, N]
    batch = polys.shape[:-3]
    out = polynomial.polymul_shared_digits(
        selection_masks(n, polys.device), polys.reshape(-1, 2, k1, n))
    return out.reshape(batch + (k1, n))


@dataclass
class Bit1Ct:
    """1-bit shortint ciphertext tensor under the small key, bit at 2^62."""

    array: torch.Tensor  # int64 [..., n+1]
    context: FheContext

    def __xor__(self, rhs: "Bit1Ct") -> "Bit1Ct":
        # unchecked add; carry overflows into the padding bit
        # (shortint_1bit.rs:103-115)
        return Bit1Ct(self.array + rhs.array, self.context)


@dataclass
class LaneBit1Ct:
    """Lane-tensor of shortint_1bit ciphertexts — the AES data model's bit
    type for this model (array [..., *lane_shape, n+1], bit at 2^62 under
    the small key). XOR is the unchecked add whose carry overflows into the
    padding bit; the model tracks no noise metadata, matching the reference
    (whose AES tests are #[ignore]d for exactly that uncontrolled
    accumulation, fhe_impls/shortint_1bit.rs:81-83)."""

    array: torch.Tensor
    lane_shape: tuple
    context: FheContext

    def __xor__(self, rhs: "LaneBit1Ct") -> "LaneBit1Ct":
        return LaneBit1Ct(self.array + rhs.array, self.lane_shape,
                          self.context)

    def _arr_axis(self, axis: int) -> tuple[int, int]:
        n_lane = len(self.lane_shape)
        axis = axis % n_lane
        return self.array.ndim - 1 - n_lane + axis, axis

    def take_lanes(self, idx, axis: int) -> "LaneBit1Ct":
        arr_axis, axis = self._arr_axis(axis)
        idx = np.asarray(idx)
        shape = (self.lane_shape[:axis] + idx.shape
                 + self.lane_shape[axis + 1:])
        arr = torch.index_select(
            self.array, arr_axis,
            torch.as_tensor(idx.reshape(-1), dtype=torch.int64,
                            device=self.array.device))
        arr = arr.reshape(arr.shape[:arr_axis] + idx.shape
                          + arr.shape[arr_axis + 1:])
        return LaneBit1Ct(arr, shape, self.context)

    def slice_lanes(self, sl: slice, axis: int = 0) -> "LaneBit1Ct":
        arr_axis, axis = self._arr_axis(axis)
        start, stop, step = sl.indices(self.lane_shape[axis])
        if step != 1:
            raise ValueError("slice_lanes takes unit-step slices")
        arr = self.array.narrow(arr_axis, start, max(0, stop - start))
        n_lane = len(self.lane_shape)
        return LaneBit1Ct(arr, tuple(arr.shape[arr.ndim - 1 - n_lane: -1]),
                          self.context)

    def reshape_lanes(self, *lane_shape) -> "LaneBit1Ct":
        batch = tuple(self.array.shape[: self.array.ndim - 1
                                       - len(self.lane_shape)])
        arr = self.array.reshape(batch + tuple(lane_shape)
                                 + self.array.shape[-1:])
        return LaneBit1Ct(arr, tuple(lane_shape), self.context)

    @classmethod
    def concat_lanes(cls, parts: list["LaneBit1Ct"],
                     axis: int = 0) -> "LaneBit1Ct":
        n_lane = len(parts[0].lane_shape)
        axis = axis % n_lane
        # broadcast leading batch axes so batchless parts join batched ones
        max_ndim = max(p.array.ndim for p in parts)
        batch = next(tuple(q.array.shape[: max_ndim - n_lane - 1])
                     for q in parts if q.array.ndim == max_ndim)
        arrays = [p.array.expand(batch + tuple(p.array.shape))
                  if p.array.ndim < max_ndim else p.array for p in parts]
        shape = list(parts[0].lane_shape)
        shape[axis] = sum(p.lane_shape[axis] for p in parts)
        return cls(torch.cat(arrays, dim=max_ndim - 1 - n_lane + axis),
                   tuple(shape), parts[0].context)


def fresh_lane_bit1ct(arrays: torch.Tensor, context: FheContext,
                      lane_ndim: int | None = None) -> LaneBit1Ct:
    """Wrap ct arrays [..., n+1]; `lane_ndim` trailing axes (before the ct
    axis) are lanes, default all."""
    if lane_ndim is None:
        lane_ndim = arrays.ndim - 1
    shape = tuple(arrays.shape[arrays.ndim - 1 - lane_ndim: -1])
    return LaneBit1Ct(arrays, shape, context)


class Shortint1BitByteOps:
    """Byte ops for the AES pipeline aes_128/sbox_pbs.py on this model: the
    SBOX as 8 per-output-bit multivariate tree bootstraps, the boot an
    identity bootstrap (fhe_impls/shortint_1bit.rs:30-47). All bytes x 8
    output bits x tree test vectors advance through each blind rotation as
    one batch."""

    def __init__(self, ctx: FheContext):
        self.ctx = ctx

    def _sbox_tvs(self) -> torch.Tensor:
        cache = self.ctx.cache
        if "sbox_tvs" not in cache:
            from tfhe_aes2_tpu_torch.aes_128 import SBOX
            tvs = [generate_multivariate_test_vector(
                self.ctx, 8, lambda v, o=o: (int(SBOX[v]) >> (7 - o)) & 1)
                for o in range(8)]
            cache["sbox_tvs"] = torch.stack(tvs)       # [8, 128, k+1, N]
        return cache["sbox_tvs"]

    def sub_bytes(self, state: LaneBit1Ct) -> LaneBit1Ct:
        arr = state.array                               # [..., 8(bit), n+1]
        bit_arr = arr[..., None, :, :].expand(
            arr.shape[:-2] + (8, 8, arr.shape[-1]))
        out = _tree_pbs_batched(self.ctx, bit_arr, self._sbox_tvs())
        return type(state)(out, state.lane_shape, self.ctx)

    def boot(self, word: LaneBit1Ct) -> LaneBit1Ct:
        tv = self.ctx.test_vector_from_cleartext_fn(lambda b: b)
        out = self.ctx.bootstrap(Bit1Ct(word.array, self.ctx), tv)
        return type(word)(out.array, word.lane_shape, self.ctx)


def generate_multivariate_test_vector(ctx: FheContext, bits: int,
                                      f) -> torch.Tensor:
    """Leaf test vectors, one per even input value, selecting on the LSB
    (shortint_1bit.rs:520-536) -> int64 [2^(bits-1), k+1, N] (clear)."""
    if not 0 < bits <= 8:
        raise ValueError(f"{bits} input bits: the tree takes 1 to 8")
    return torch.stack([ctx.test_vector_from_cleartext_fn(
        lambda b, v=val: f(v + int(b))) for val in range(0, 1 << bits, 2)])


def _tree_pbs_batched(ctx: FheContext, bit_arr: torch.Tensor,
                      test_vectors: torch.Tensor) -> torch.Tensor:
    """The batched tree-based multivariate bootstrap.

    bit_arr: int64 [..., T, n+1], MSB first (the LSB selects at the leaves);
    test_vectors: [..., 2^(T-1), k+1, N], broadcastable against the [...]
    batch (per-lane leaf tables, e.g. one per SBOX output bit).
    Returns int64 [..., n+1]. Every tree level bootstraps all remaining test
    vectors of all batch lanes through one blind rotation.
    """
    t = bit_arr.shape[-2]
    batch = bit_arr.shape[:-2]
    tvs = test_vectors.expand(batch + test_vectors.shape[-3:])
    for level in range(t - 1, 0, -1):
        n_tv = tvs.shape[-3]
        sel = bit_arr[..., level, None, :].expand(batch + (n_tv,
                                                           bit_arr.shape[-1]))
        outs = ctx.bootstrap(Bit1Ct(sel, ctx), tvs).array  # [..., n_tv, n+1]
        tvs = _tv_from_ct_arrays(outs[..., 0::2, :], outs[..., 1::2, :],
                                 ctx.sks.pksk, ctx.params)
    return ctx.bootstrap(Bit1Ct(bit_arr[..., 0, :], ctx),
                         tvs[..., 0, :, :]).array


def calculate_multivariate_function(ctx: FheContext, bit_cts: Bit1Ct,
                                    test_vectors: torch.Tensor) -> Bit1Ct:
    """Tree-based multivariate bootstrap (shortint_1bit.rs:539-576).

    bit_cts: Bit1Ct [T, n+1], MSB first (the LSB selects at the leaves);
    test_vectors: [2^(T-1), k+1, N].
    """
    return Bit1Ct(_tree_pbs_batched(ctx, bit_cts.array, test_vectors), ctx)


def generate_keys(params: WopbsParams = PARAMS_SHORTINT_1BIT, seed: int = 0,
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
