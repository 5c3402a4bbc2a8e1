"""FHE AES-128 strategies and server entry points.

The production strategy binds the 1-bit WoP-PBS model to the
SBOX+GalMul round pipeline (the reference's submitted solution); the second
binds it to the depth-11 SBOX-only pipeline (aes_128/sbox_pbs.py), the
reference's pairing for the sqrd_lvl_256 set; the other two bind the
8-bit WoP-PBS model and the tree-PBS model (shortint_1bit) to that same
pipeline, each with its own byte operations and small-key codecs. A
strategy's `fresh` wraps fresh ciphertext arrays as its model's bit type.
The entry
points keep the JAX package's names and schedules: the fused key schedule
(11 circuit-bootstrap calls), the round loop, and the single-block latency
path (11 fused circuit bootstraps for key expansion AND all rounds). PyTorch
runs eagerly, so each is a plain Python loop over the pipeline functions,
with the noise metadata tracked on every operation — no compiled programs,
no shadow tracing.
"""

from __future__ import annotations

import numpy as np
import torch

from tfhe_aes2_tpu_torch.aes_128 import (RC, fhe_encryption, sbox_gal_mul_pbs,
                                         sbox_pbs)
from tfhe_aes2_tpu_torch.models.shortint_woppbs_1bit import (
    BitCt, FheContext, fresh_bitct)


class ShortintWoppbs1BitSboxGalMulPbsAesEncrypt:
    """Production strategy: model shortint_woppbs_1bit + pipeline
    fhe_sbox_gal_mul_pbs."""

    pipeline = sbox_gal_mul_pbs

    @staticmethod
    def encrypt_client(client, data_bytes_list) -> np.ndarray:
        return fhe_encryption.encrypt_blocks(client, data_bytes_list)

    @staticmethod
    def encrypt_key_client(client, key) -> np.ndarray:
        return fhe_encryption.encrypt_byte_array(client, key)

    @staticmethod
    def decrypt_client(client, arrays) -> list[bytes]:
        return fhe_encryption.decrypt_blocks(client, arrays)

    @staticmethod
    def make_ops(ctx):
        return None          # the pipeline runs its own bootstraps

    fresh = staticmethod(fresh_bitct)


class ShortintWoppbs1BitSboxPbsAesEncrypt(
        ShortintWoppbs1BitSboxGalMulPbsAesEncrypt):
    """Model shortint_woppbs_1bit + pipeline fhe_sbox_pbs (leveled Galois
    multiplication, XOR depth 11; pairs with PARAMS_SQRD_LVL_256). It has no
    fused key-schedule groups, so key_schedule_staged runs the eager
    schedule for it, and no latency path (aes_128/scenario.py)."""

    pipeline = sbox_pbs

    @staticmethod
    def make_ops(ctx):
        return sbox_pbs.Woppbs1BitByteOps(ctx)


def _small_key_bits(data) -> np.ndarray:
    """Bytes (or a list of them) -> bits [..., 8] uint8, MSB first."""
    if isinstance(data, (list, tuple)):
        arr = np.stack([np.frombuffer(bytes(b), np.uint8) for b in data])
    else:
        arr = np.frombuffer(bytes(data), np.uint8)
    return np.unpackbits(arr[..., None], axis=-1)


class ShortintWoppbs8BitSboxPbsAesEncrypt:
    """Model shortint_woppbs_8bit + pipeline fhe_sbox_pbs: the SBOX on one
    8-bit ciphertext a byte, the XORs on its extracted 1-bit duals under the
    small key (fhe_impls/shortint_woppbs_8bit.rs:44-94)."""

    pipeline = sbox_pbs

    @staticmethod
    def encrypt_client(client, data_bytes_list) -> np.ndarray:
        return client.encrypt_bits_small(_small_key_bits(data_bytes_list))

    @staticmethod
    def encrypt_key_client(client, key) -> np.ndarray:
        return client.encrypt_bits_small(_small_key_bits(key))

    @staticmethod
    def decrypt_client(client, arrays) -> list[bytes]:
        bits = client.decrypt_bits_small(np.asarray(arrays)).astype(np.uint8)
        return [row.tobytes() for row in np.packbits(bits, axis=-1)[..., 0]]

    @staticmethod
    def make_ops(ctx):
        from tfhe_aes2_tpu_torch.models.shortint_woppbs_8bit import (
            Woppbs8BitByteOps)
        return Woppbs8BitByteOps(ctx)

    @staticmethod
    def fresh(arrays, ctx, lane_ndim=None):
        from tfhe_aes2_tpu_torch.models.shortint_woppbs_8bit import (
            fresh_linear_bitct)
        return fresh_linear_bitct(arrays, ctx, lane_ndim)


class Shortint1BitSboxPbsAesEncrypt:
    """Model shortint_1bit + pipeline fhe_sbox_pbs: the SBOX as 8
    per-output-bit tree bootstraps (255 blind rotations each, batched
    across bytes and bits).

    Ships for parity with the reference, which dispatches it from its
    binary (fhe_impls/shortint_1bit.rs:52, main.rs:60-92) while #[ignore]-ing
    its AES tests ("too big noise accumulation",
    fhe_impls/shortint_1bit.rs:81-83)."""

    pipeline = sbox_pbs

    @staticmethod
    def _encode(bits) -> np.ndarray:
        """Bits at 2^62 under the small key (shortint_1bit.rs:352-356)."""
        return np.asarray(bits, np.uint64) << np.uint64(62)

    @classmethod
    def encrypt_client(cls, client, data_bytes_list) -> np.ndarray:
        return client.encrypt_encodings_small(
            cls._encode(_small_key_bits(data_bytes_list)))

    @classmethod
    def encrypt_key_client(cls, client, key) -> np.ndarray:
        return client.encrypt_encodings_small(
            cls._encode(_small_key_bits(key)))

    @staticmethod
    def decrypt_bits(client, arrays) -> np.ndarray:
        """Small-key ciphertexts [..., n+1] -> their bits uint8 [...]."""
        phase = client.decrypt_phase_small(np.asarray(arrays))
        return (((phase + np.uint64(1 << 61)) >> np.uint64(62))
                & np.uint64(1)).astype(np.uint8)

    @classmethod
    def decrypt_client(cls, client, arrays) -> list[bytes]:
        bits = cls.decrypt_bits(client, arrays)
        return [row.tobytes() for row in np.packbits(bits, axis=-1)[..., 0]]

    @staticmethod
    def make_ops(ctx):
        from tfhe_aes2_tpu_torch.models.shortint_1bit import (
            Shortint1BitByteOps)
        return Shortint1BitByteOps(ctx)

    @staticmethod
    def fresh(arrays, ctx, lane_ndim=None):
        from tfhe_aes2_tpu_torch.models.shortint_1bit import fresh_lane_bit1ct
        return fresh_lane_bit1ct(arrays, ctx, lane_ndim)


def _pipeline_kwargs(strategy, ctx) -> dict:
    ops = strategy.make_ops(ctx)
    return {} if ops is None else {"ops": ops}


def key_schedule_eager(strategy, ctx: FheContext,
                       key_arr: torch.Tensor) -> BitCt:
    """FHE key expansion word by word, the pipeline's own key_schedule:
    key_arr [16, 8, dim+1] -> the strategy's bit type, lanes [44, 4, 8]."""
    key = strategy.fresh(key_arr, ctx, lane_ndim=2)
    return strategy.pipeline.key_schedule(ctx, key,
                                          **_pipeline_kwargs(strategy, ctx))


def encrypt_blocks_eager(strategy, ctx: FheContext, eks: BitCt,
                         blocks_arr: torch.Tensor, rounds: int) -> BitCt:
    """AES rounds on blocks [B, 16, 8, dim+1] under `eks` (from
    key_schedule_eager, or a clear schedule wrapped fresh)."""
    blocks = strategy.fresh(blocks_arr, ctx, lane_ndim=2)
    return strategy.pipeline.encrypt_block_for_rounds(
        ctx, eks, blocks, rounds, **_pipeline_kwargs(strategy, ctx))


def _rc(ctx: FheContext, g: int) -> BitCt:
    """Round constant g as 8 trivial bits, MSB first."""
    return ctx.trivial_bits(np.unpackbits(np.array([RC[g]], np.uint8)))


def key_schedule_staged(strategy, ctx: FheContext,
                        key_arr: torch.Tensor) -> BitCt:
    """FHE key expansion, fused form: the SubWord half of group 1, then 9
    steps each running [boot of group g ‖ SubWord of group g+1] through ONE
    shared circuit-bootstrap front end, then the final boot — 11 blind
    rotations. key_arr [16, 8, kN+1] -> BitCt lanes [44, 4, 8]. A pipeline
    without the fused groups (sbox_pbs) runs key_schedule_eager."""
    pipe = strategy.pipeline
    if not hasattr(pipe, "key_schedule_group_preboot"):
        return key_schedule_eager(strategy, ctx, key_arr)
    group0 = fresh_bitct(key_arr.reshape((4, 4) + key_arr.shape[1:]), ctx,
                         lane_ndim=3)
    prev = group0.slice_lanes(slice(3, 4), axis=0).reshape_lanes(4, 8)
    pre = pipe.key_schedule_group_preboot(ctx, group0, prev, _rc(ctx, 1))
    groups = [group0]
    for g in range(1, 10):
        booted, sub = pipe.key_schedule_fused_boot_sub(ctx, pre)
        pre = pipe.key_schedule_group_preboot(ctx, booted, None,
                                              _rc(ctx, g + 1), sub=sub)
        groups.append(booted)
    groups.append(pipe.boot_word(ctx, pre))
    return BitCt.concat_lanes(groups, axis=0)


def encrypt_blocks_staged(strategy, ctx: FheContext, eks: BitCt,
                          blocks_arr: torch.Tensor, rounds: int,
                          blocks_meta=None) -> BitCt:
    """AES rounds on a batch of blocks [B, 16, 8, kN+1] under the expanded
    key from key_schedule_staged -> BitCt [B | 16, 8].

    blocks_meta: optional (noise_sq, comps), each of lane shape [16, 8], for
    input blocks that are not fresh encryptions (the homomorphically derived
    CTR batch, aes_128/ctr_fhe.derive_ctr_batch)."""
    if blocks_meta is None:
        blocks = strategy.fresh(blocks_arr, ctx, lane_ndim=2)
    else:
        blocks = BitCt(blocks_arr, blocks_meta[0], blocks_meta[1], ctx)
    return strategy.pipeline.encrypt_block_for_rounds(
        ctx, eks, blocks, rounds, **_pipeline_kwargs(strategy, ctx))


def encrypt_block_latency(strategy, ctx: FheContext, key_arr: torch.Tensor,
                          block_arr: torch.Tensor, return_eks: bool = False):
    """Single-block minimum-latency path: key expansion AND all ten rounds
    in 11 fused circuit bootstraps. Round g's SubBytes lanes ride the same
    blind rotation as key-schedule group g's boot and group g+1's SubWord
    (288 lanes), because round g's AddRoundKey key is exactly the group
    booted in that bootstrap.

    key_arr [16, 8, kN+1]; block_arr [16, 8, kN+1] or [1, 16, 8, kN+1].
    Returns a BitCt with lanes [16, 8] (and the input's batch axis).
    return_eks=True returns (that BitCt, the expanded key BitCt [44, 4, 8])
    instead: the fresh key group and the ten groups booted along the way,
    which is key_schedule_staged's result on the same key — a server caches
    it so that later requests under this key skip the expansion."""
    pipe = strategy.pipeline
    batched = block_arr.ndim == 4
    if batched:
        if block_arr.shape[0] != 1:
            raise ValueError("the latency path takes a single block")
        block_arr = block_arr[0]
    key_ct = fresh_bitct(key_arr.reshape((4, 4) + key_arr.shape[1:]), ctx,
                         lane_ndim=3)
    state = fresh_bitct(block_arr, ctx, lane_ndim=2) \
        ^ key_ct.reshape_lanes(16, 8)
    prev = key_ct.slice_lanes(slice(3, 4), axis=0).reshape_lanes(4, 8)
    pre = pipe.key_schedule_group_preboot(ctx, key_ct, prev, _rc(ctx, 1))
    groups = [key_ct]
    for g in range(1, 10):
        pre, state, booted = pipe.latency_fused_middle(ctx, pre, state,
                                                       _rc(ctx, g + 1))
        groups.append(booted)
    out, booted = pipe.latency_fused_final(ctx, pre, state)
    groups.append(booted)
    if batched:
        out = BitCt(out.array[None], out.noise_sq, out.comps, ctx,
                    out.degree)
    if return_eks:
        return out, BitCt.concat_lanes(groups, axis=0)
    return out
