"""AES pipeline B (production): SBOX + Galois multiplication fused into one
multivalued circuit bootstrap (reference fhe_sbox_gal_mul_pbs.rs). Ported
from tfhe_aes2_tpu/aes_128/sbox_gal_mul_pbs.py.

Per round, the 16 bytes (x batch) run ONE batched 8->24-bit circuit bootstrap
producing [S(x)·1, S(x)·2, S(x)·3]; MixColumns is then a pure XOR combine of
the three states (leveled depth 5, README.md:32-35). The reference's stated
headroom — the 8 per-SBOX GGSW bootstraps running serially in tfhe-rs
(README.md:70-71) — is structural here: all 128·batch GGSW bootstraps of a
round advance through one batched blind rotation.
"""

from __future__ import annotations

import numpy as np

from tfhe_aes2_tpu_torch.aes_128 import RC, SBOX, gf_256_mul
from tfhe_aes2_tpu_torch.aes_128 import data_model as dm
from tfhe_aes2_tpu_torch.models.shortint_woppbs_1bit import BitCt, FheContext
from tfhe_aes2_tpu_torch.utils.logger import span, spanned

_LUT_CACHE: dict = {}


def sbox_gal_mul_lut(ctx: FheContext) -> np.ndarray:
    """8->24 LUT: [S(x)·1 ‖ S(x)·2 ‖ S(x)·3] (fhe_impls/shortint_woppbs_1bit.rs:94-111)."""
    key = ("gal_mul", ctx.params)
    if key not in _LUT_CACHE:
        _LUT_CACHE[key] = ctx.generate_lookup_table(
            8, 24,
            lambda b: (gf_256_mul(int(SBOX[b]), 1) << 16)
                      | (gf_256_mul(int(SBOX[b]), 2) << 8)
                      | gf_256_mul(int(SBOX[b]), 3))
    return _LUT_CACHE[key]


def sbox_lut(ctx: FheContext) -> np.ndarray:
    """8->8 SBOX LUT (fhe_impls/shortint_woppbs_1bit.rs:32-44)."""
    key = ("sbox", ctx.params)
    if key not in _LUT_CACHE:
        _LUT_CACHE[key] = ctx.generate_lookup_table(8, 8, lambda b: int(SBOX[b]))
    return _LUT_CACHE[key]


def identity_lut(ctx: FheContext) -> np.ndarray:
    """1->1 identity LUT for noise-reset bootstraps."""
    key = ("identity", ctx.params)
    if key not in _LUT_CACHE:
        _LUT_CACHE[key] = ctx.generate_lookup_table(1, 1, lambda b: b)
    return _LUT_CACHE[key]


def sub_bytes_with_gal_mul(ctx: FheContext, state: BitCt):
    """[..., 16, 8] -> three states (S·1, S·2, S·3) (fhe_sbox_gal_mul_pbs.rs:27-48)."""
    out = ctx.circuit_bootstrap(state, sbox_gal_mul_lut(ctx))  # [..., 16, 24]
    mul1 = out.slice_lanes(slice(0, 8), axis=-1)
    mul2 = out.slice_lanes(slice(8, 16), axis=-1)
    mul3 = out.slice_lanes(slice(16, 24), axis=-1)
    return mul1, mul2, mul3


def sub_bytes(ctx: FheContext, state: BitCt) -> BitCt:
    return ctx.circuit_bootstrap(state, sbox_lut(ctx))


def mix_columns(muls) -> BitCt:
    """new[i] = 2·a[i] ^ 3·a[i+1] ^ a[i+2] ^ a[i+3] per column, combined from
    the three bootstrapped states (fhe_sbox_gal_mul_pbs.rs:61-82)."""
    mul1, mul2, mul3 = muls
    return (mul2 ^ dm.rot_rows(mul3, 1)) ^ (dm.rot_rows(mul1, 2) ^ dm.rot_rows(mul1, 3))


def boot_word(ctx: FheContext, word: BitCt) -> BitCt:
    """Identity bootstrap per bit to reset noise (fhe_sbox_gal_mul_pbs.rs:166-180)."""
    flat = word.reshape_lanes(int(np.prod(word.lane_shape)), 1)
    booted = ctx.circuit_bootstrap(flat, identity_lut(ctx))
    return booted.reshape_lanes(*word.lane_shape)


def middle_round(ctx: FheContext, state: BitCt, key_group: BitCt,
                 ops=None) -> BitCt:
    """One full round: SubBytes+GalMul bootstrap, ShiftRows x3, MixColumns
    (pure XOR), AddRoundKey (fhe_sbox_gal_mul_pbs.rs:101-118)."""
    muls = sub_bytes_with_gal_mul(ctx, state)
    muls = tuple(dm.shift_rows(m) for m in muls)
    return mix_columns(muls) ^ key_group


def final_round(ctx: FheContext, state: BitCt, key_group: BitCt,
                ops=None) -> BitCt:
    """SubBytes, ShiftRows, AddRoundKey (fhe_sbox_gal_mul_pbs.rs:120-129)."""
    return dm.shift_rows(sub_bytes(ctx, state)) ^ key_group


def encrypt_block_for_rounds(ctx: FheContext, expanded_key: BitCt,
                             blocks: BitCt, rounds: int) -> BitCt:
    """FHE AES rounds on a batch of blocks (fhe_sbox_gal_mul_pbs.rs:84-132).

    expanded_key: BitCt lanes [44, 4, 8]; blocks: BitCt lanes [16, 8] with
    leading batch axes.
    """
    state = blocks ^ dm.key_word_group(expanded_key, 0)
    for i in range(1, rounds):
        with span("tfhe.aes.round"):
            state = middle_round(ctx, state,
                                 dm.key_word_group(expanded_key, i))
    # final-round key is always words 40..44 (fhe_sbox_gal_mul_pbs.rs:126-129)
    with span("tfhe.aes.round"):
        return final_round(ctx, state, dm.key_word_group(expanded_key, 10))


def key_schedule_group_preboot(ctx: FheContext, base: BitCt, prev: BitCt,
                               rc_val_or_byte, sub: BitCt | None = None) -> BitCt:
    """One group of four key-schedule words from the previous group, BEFORE
    the noise-reset boot: RotWord + SubWord (one 32-lane SBOX cbs) + the XOR
    chain (noise peaks at 12 « 64).

    sub: optionally the precomputed SubWord bootstrap output (the fused
    staged path batches it with the PREVIOUS group's boot,
    key_schedule_fused_boot_sub); prev is then unused."""
    if sub is None:
        rot = prev.take_lanes(np.array([1, 2, 3, 0]), axis=0)
        sub = ctx.circuit_bootstrap(rot, sbox_lut(ctx))
    w0 = base.slice_lanes(slice(0, 1), axis=0).reshape_lanes(4, 8) ^ sub
    if isinstance(rc_val_or_byte, BitCt):
        rc = rc_val_or_byte
    else:
        rc = dm.trivial_byte(ctx, int(rc_val_or_byte))
    w0b0 = w0.slice_lanes(slice(0, 1), axis=0) ^ rc.reshape_lanes(1, 8)
    w0 = type(w0).concat_lanes([w0b0, w0.slice_lanes(slice(1, 4), axis=0)], axis=0)
    ws = [w0]
    for j in range(1, 4):
        ws.append(base.slice_lanes(slice(j, j + 1), axis=0).reshape_lanes(4, 8)
                  ^ ws[-1])
    return BitCt.concat_lanes([w.reshape_lanes(1, 4, 8) for w in ws], axis=0)


def key_schedule_fused_boot_sub(ctx: FheContext, preboot: BitCt):
    """Fused staged step: the identity noise-reset boot of a PREBOOT group
    (128 one-bit lanes) and the NEXT group's RotWord/SubWord SBOX bootstrap
    (32 lanes in 4 byte-groups) through ONE shared circuit-bootstrap front
    end (one 677-step blind rotation instead of two sequential ones).

    Feeding SubWord the group's last word BEFORE its boot is value-exact —
    the boot is an identity LUT, so both ciphertexts encrypt the same word —
    and noise-sound: the preboot word carries variance <= 12 of the 64
    budget, far below what round inputs already present to the bootstrap
    (depth-5 MixColumns outputs at ~33). Returns (booted group, sub)."""
    flat = preboot.reshape_lanes(int(np.prod(preboot.lane_shape)), 1)
    prev = preboot.slice_lanes(slice(3, 4), axis=0).reshape_lanes(4, 8)
    rot = prev.take_lanes(np.array([1, 2, 3, 0]), axis=0)
    booted_flat, sub = ctx.circuit_bootstrap_mixed(
        [(flat, identity_lut(ctx)), (rot, sbox_lut(ctx))])
    return booted_flat.reshape_lanes(*preboot.lane_shape), sub


@spanned("tfhe.aes.round")
def latency_fused_middle(ctx: FheContext, preboot: BitCt, state: BitCt,
                         rc_val_or_byte):
    """Latency-mode step g (single block): ONE shared cbs front end covers
    [boot of key-schedule group g (128 lanes) ‖ SubWord of group g+1 (32)
    ‖ round g's SubBytes+GalMul of the state (128 lanes, 8->24 LUT)], then
    the cheap epilogues — the group-g+1 XOR chain and round g's ShiftRows/
    MixColumns/AddRoundKey with the JUST-booted group as the round key.

    Serial structure of the reference collapses to 11 scans for key
    expansion + all rounds: device-serial latency ~= 11 x one 288-lane scan
    instead of (11 + 10) scans (VERDICT r4 #6). state lanes [16, 8]
    (batchless); returns (preboot_{g+1}, state_g, booted_g) — the booted
    group so the caller can assemble the full expanded key for reuse."""
    flat = preboot.reshape_lanes(int(np.prod(preboot.lane_shape)), 1)
    prev = preboot.slice_lanes(slice(3, 4), axis=0).reshape_lanes(4, 8)
    rot = prev.take_lanes(np.array([1, 2, 3, 0]), axis=0)
    booted_flat, sub, out24 = ctx.circuit_bootstrap_mixed(
        [(flat, identity_lut(ctx)), (rot, sbox_lut(ctx)),
         (state, sbox_gal_mul_lut(ctx))])
    booted = booted_flat.reshape_lanes(*preboot.lane_shape)
    nxt = key_schedule_group_preboot(ctx, booted, None, rc_val_or_byte,
                                     sub=sub)
    muls = tuple(dm.shift_rows(out24.slice_lanes(slice(8 * i, 8 * i + 8),
                                                 axis=-1))
                 for i in range(3))
    rk = booted.reshape_lanes(16, 8)
    return nxt, mix_columns(muls) ^ rk, booted


@spanned("tfhe.aes.round")
def latency_fused_final(ctx: FheContext, preboot: BitCt, state: BitCt):
    """Latency-mode last step: [boot of group 10 ‖ final-round SubBytes]
    through one cbs front end, then ShiftRows + the last AddRoundKey.
    Returns (output state [16, 8], booted group 10)."""
    flat = preboot.reshape_lanes(int(np.prod(preboot.lane_shape)), 1)
    booted_flat, subbed = ctx.circuit_bootstrap_mixed(
        [(flat, identity_lut(ctx)), (state, sbox_lut(ctx))])
    rk = booted_flat.reshape_lanes(16, 8)
    return dm.shift_rows(subbed) ^ rk, booted_flat.reshape_lanes(4, 4, 8)


def key_schedule_group(ctx: FheContext, base: BitCt, prev: BitCt,
                       rc_val_or_byte) -> BitCt:
    """One group of four key-schedule words from the previous group.

    base: words i-4..i (lanes [4, 4, 8], booted); prev = base's last word
    (lanes [4, 8]); returns the next four words, identity-bootstrapped
    together (one 128-lane batch instead of four sequential 32-lane boots —
    noise stays <= 12 « 64, the grouping fhe_sbox_pbs.rs:150-154 uses).
    """
    group = key_schedule_group_preboot(ctx, base, prev, rc_val_or_byte)
    return boot_word(ctx, group)  # lanes [4, 4, 8] -> 128-lane identity cbs


def key_schedule(ctx: FheContext, key: BitCt) -> BitCt:
    """FHE key expansion (fhe_sbox_gal_mul_pbs.rs:134-164), group-batched.

    key: BitCt lanes [16, 8] -> expanded key BitCt lanes [44, 4, 8].
    """
    groups = [key.reshape_lanes(4, 4, 8)]
    for g in range(1, 11):
        base = groups[-1]
        prev = base.slice_lanes(slice(3, 4), axis=0).reshape_lanes(4, 8)
        groups.append(key_schedule_group(ctx, base, prev, int(RC[g])))
    return BitCt.concat_lanes(groups, axis=0)
