"""Output ciphertext compression for transport (server -> client).

A big-key AES block is 16·8 LWE cts of kN+1 = 2049 64-bit words ≈ 2.1 MB at
PARAMS_SQRD_LVL_64. Before transport the server

  1. keyswitches big -> small (ops/keyswitch.py, kernel K4: kN+1 -> n+1);
  2. switches the modulus q = 2^64 -> q' = 2^log2q (16- or 32-bit words).

Counterpart of tfhe_aes2_tpu/ops/compression.py, byte-identical on the wire.
torch has no unsigned 16/32-bit arithmetic to rely on, so the device side
stays in int64 (values in [0, q')) and the wire width is taken in numpy at
the host boundary (`pack_bytes`). The client side (`unpack_bytes`,
`decrypt_*_compressed`) is numpy, like ClientKey.
"""

from __future__ import annotations

import numpy as np
import torch

from tfhe_aes2_tpu_torch.ops import keyswitch as ksw
from tfhe_aes2_tpu_torch.ops.keys import ClientKey, PreparedServerKeys
from tfhe_aes2_tpu_torch.ops.params import WopbsParams
from tfhe_aes2_tpu_torch.ops.torus import srl
from tfhe_aes2_tpu_torch.utils.logger import spanned


def _wire_dtype(log2q: int) -> str:
    return "<u2" if log2q <= 16 else "<u4"


def mod_switch_q(x: torch.Tensor, log2q: int) -> torch.Tensor:
    """int64 torus -> Z_{2^log2q}: round(x · q'/2^64), int64 in [0, q')."""
    shift = 64 - log2q
    return srl(x + (1 << (shift - 1)), shift)


@spanned("tfhe.wop.compress")
def compress_bits(cts_big: torch.Tensor, sks: PreparedServerKeys,
                  params: WopbsParams, log2q: int = 32) -> torch.Tensor:
    """Big-key LWE bits [..., kN+1] -> compressed small-key cts [..., n+1],
    int64 with coefficients in Z_{2^log2q}."""
    if not 8 <= log2q <= 32:
        raise ValueError(f"log2q={log2q} outside [8, 32]")
    return mod_switch_q(ksw.keyswitch(cts_big, sks.ksk, params), log2q)


def wire_array(comp, log2q: int) -> np.ndarray:
    """A compressed tensor (or array) as the numpy words that travel:
    little-endian, 16 bits when log2q <= 16, else 32."""
    if isinstance(comp, torch.Tensor):
        comp = comp.detach().to("cpu").numpy()
    return np.asarray(comp).astype(_wire_dtype(log2q))


def pack_bytes(comp, log2q: int) -> bytes:
    """Serialize a compressed tensor (or array) to its wire words."""
    return wire_array(comp, log2q).tobytes()


def unpack_bytes(data: bytes, shape, log2q: int) -> np.ndarray:
    return np.frombuffer(data, dtype=_wire_dtype(log2q)).reshape(
        shape).astype(np.uint32)


def decrypt_bits_compressed(client: ClientKey, comp,
                            log2q: int = 32) -> np.ndarray:
    """Compressed cts uint32 [..., n+1] -> bits [...] (threshold decode in
    Z_{2^log2q}: bit encoded at q'/2, threshold q'/4)."""
    comp = np.asarray(comp, dtype=np.uint64)
    mask_q = np.uint64((1 << log2q) - 1)
    a, b = comp[..., :-1], comp[..., -1]
    phase = (b - (a * client.lwe_sk.astype(np.uint64)).sum(axis=-1)) & mask_q
    return ((phase + np.uint64(1 << (log2q - 2)))
            >> np.uint64(log2q - 1)) & np.uint64(1)


def decrypt_blocks_compressed(client: ClientKey, comp,
                              log2q: int = 32) -> list[bytes]:
    """Compressed blocks [B, 16, 8, n+1] -> list of 16-byte plaintexts."""
    bits = decrypt_bits_compressed(client, comp, log2q)
    return [np.packbits(row.astype(np.uint8), axis=-1)[..., 0].tobytes()
            for row in bits]
