"""AES pipeline A: the circuit bootstrap computes the SBOX only; the Galois
multiplication of MixColumns is leveled, shift-and-XOR (reference
fhe_sbox_pbs.rs). XOR depth 11, so it pairs with the sqrd_lvl_256 parameter
set (ShortintWoppbs1BitSboxPbsAesEncrypt, aes_128/fhe.py). Ported from
tfhe_aes2_tpu/aes_128/sbox_pbs.py; the reference's own tests of this
pipeline are #[ignore]d ("noise is not independent in calculations",
fhe_impls/shortint_woppbs_1bit.rs:160-174).
"""

from __future__ import annotations

import numpy as np

from tfhe_aes2_tpu_torch.aes_128 import RC
from tfhe_aes2_tpu_torch.aes_128 import data_model as dm
from tfhe_aes2_tpu_torch.aes_128.sbox_gal_mul_pbs import boot_word, sbox_lut
from tfhe_aes2_tpu_torch.models.shortint_woppbs_1bit import BitCt, FheContext
from tfhe_aes2_tpu_torch.utils.logger import span


class Woppbs1BitByteOps:
    """The byte operations of the 1-bit model: the multivariate circuit
    bootstrap (fhe_impls/shortint_woppbs_1bit.rs:47-57)."""

    def __init__(self, ctx: FheContext):
        self.ctx = ctx

    def sub_bytes(self, state: BitCt) -> BitCt:
        return self.ctx.circuit_bootstrap(state, sbox_lut(self.ctx))

    def boot(self, word: BitCt) -> BitCt:
        return boot_word(self.ctx, word)


def _ops(ctx: FheContext, ops):
    return ops if ops is not None else Woppbs1BitByteOps(ctx)


def _shl1(ctx: FheContext, byte_lanes: BitCt):
    """Byte::shl_assign_1 (data_model.rs:45-49) on lane shape [..., 8]:
    returns (the shifted byte with a trailing trivial 0, the shifted-out
    MSB)."""
    out_bit = byte_lanes.slice_lanes(slice(0, 1), axis=-1)
    rest = byte_lanes.slice_lanes(slice(1, 8), axis=-1)
    zero = ctx.trivial_bits(np.zeros(byte_lanes.lane_shape[:-1] + (1,),
                                     np.uint8))
    return type(byte_lanes).concat_lanes([rest, zero], axis=-1), out_bit


def gf_256_mul(ctx: FheContext, state: BitCt, b: int) -> BitCt:
    """Leveled multiply by the constant b in GF(256) (fhe_sbox_pbs.rs:33-54):
    shift and XOR, the 0x1b reduction folded into bit lanes 3, 4, 6, 7."""
    a = state
    res = None
    for _ in range(8):
        if b & 1:
            res = a if res is None else (res ^ a)
        if b >> 1 == 0:
            break
        a, reduce_bit = _shl1(ctx, a)
        for j in (3, 4, 6, 7):
            lane_j = a.slice_lanes(slice(j, j + 1), axis=-1) ^ reduce_bit
            parts = []
            if j > 0:
                parts.append(a.slice_lanes(slice(0, j), axis=-1))
            parts.append(lane_j)
            if j < 7:
                parts.append(a.slice_lanes(slice(j + 1, 8), axis=-1))
            a = type(a).concat_lanes(parts, axis=-1)
        b >>= 1
    if res is None:
        res = ctx.trivial_bits(np.zeros(state.lane_shape, np.uint8))
    return res


def mix_columns(ctx: FheContext, state: BitCt) -> BitCt:
    """Leveled MixColumns (fhe_sbox_pbs.rs:57-73):
    new[i] = 2·a[i] ^ a[i+3] ^ a[i+2] ^ 3·a[i+1] per column."""
    return ((gf_256_mul(ctx, state, 2)
             ^ dm.rot_rows(gf_256_mul(ctx, state, 1), 3))
            ^ (dm.rot_rows(gf_256_mul(ctx, state, 1), 2)
               ^ dm.rot_rows(gf_256_mul(ctx, state, 3), 1)))


def middle_round(ctx: FheContext, state: BitCt, key_group: BitCt,
                 ops=None) -> BitCt:
    state = dm.shift_rows(_ops(ctx, ops).sub_bytes(state))
    return mix_columns(ctx, state) ^ key_group


def final_round(ctx: FheContext, state: BitCt, key_group: BitCt,
                ops=None) -> BitCt:
    return dm.shift_rows(_ops(ctx, ops).sub_bytes(state)) ^ key_group


def encrypt_block_for_rounds(ctx: FheContext, expanded_key: BitCt,
                             blocks: BitCt, rounds: int, ops=None) -> BitCt:
    """fhe_sbox_pbs.rs:75-121."""
    ops = _ops(ctx, ops)
    state = blocks ^ dm.key_word_group(expanded_key, 0)
    for i in range(1, rounds):
        with span("tfhe.aes.round"):
            state = middle_round(ctx, state,
                                 dm.key_word_group(expanded_key, i), ops)
    with span("tfhe.aes.round"):
        return final_round(ctx, state, dm.key_word_group(expanded_key, 10),
                           ops)


def key_schedule(ctx: FheContext, key: BitCt, ops=None) -> BitCt:
    """fhe_sbox_pbs.rs:123-158: key lanes [16, 8] -> expanded key lanes
    [44, 4, 8]; the words are booted in batches of four (i % 4 == 3)."""
    ops = _ops(ctx, ops)
    words = [key.slice_lanes(slice(4 * i, 4 * i + 4), axis=0)
             for i in range(4)]
    for i in range(4, 44):
        if i % 4 == 0:
            rot = words[i - 1].take_lanes(np.array([1, 2, 3, 0]), axis=0)
            w = words[i - 4] ^ ops.sub_bytes(rot)
            rc = dm.trivial_byte(ctx, int(RC[i // 4]))
            w0 = w.slice_lanes(slice(0, 1), axis=0) ^ rc.reshape_lanes(1, 8)
            w = type(w).concat_lanes(
                [w0, w.slice_lanes(slice(1, 4), axis=0)], axis=0)
        else:
            w = words[i - 4] ^ words[i - 1]
        words.append(w)
        if i % 4 == 3:
            for j in range(i - 3, i + 1):
                words[j] = ops.boot(words[j])
    return type(words[0]).concat_lanes(
        [w.reshape_lanes(1, 4, 8) for w in words], axis=0)
