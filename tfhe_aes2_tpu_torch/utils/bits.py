"""Bit twiddling helpers, MSB-first everywhere (numpy, host side).

The port's own copy of tfhe_aes2_tpu/utils/bits.py: capability parity with
the reference's src/util.rs:33-70 (u8/u16/u64 <-> bit arrays, MSB first).
Shape checks raise ValueError where the JAX package asserts.
"""

from __future__ import annotations

import numpy as np


def u8_to_bits(val: int) -> np.ndarray:
    """8 bits, MSB first (reference util.rs `u8_to_bits`)."""
    return np.unpackbits(np.array([val], dtype=np.uint8))


def u16_to_bits(val: int) -> np.ndarray:
    """16 bits, MSB first (reference util.rs `u16_to_bits`)."""
    return np.unpackbits(np.array([val], dtype=np.uint16).view(np.uint8)[::-1])


def u64_to_bits(val: int) -> np.ndarray:
    """64 bits, MSB first (reference util.rs `u64_to_bits`)."""
    return np.unpackbits(np.array([val], dtype=np.uint64).view(np.uint8)[::-1])


def _bits(bits, count: int | None) -> np.ndarray:
    bits = np.asarray(bits, dtype=np.uint8)
    if count is not None and bits.shape != (count,):
        raise ValueError(f"expected {count} bits, got shape {bits.shape}")
    if count is None and bits.size % 8:
        raise ValueError(f"{bits.size} bits are not whole bytes")
    return bits


def bits_to_u8(bits) -> int:
    """MSB-first bits -> u8 (reference util.rs `bits_to_u8`)."""
    return int(np.packbits(_bits(bits, 8))[0])


def bits_to_u64(bits) -> int:
    """MSB-first 64 bits -> u64 (reference util.rs `bits_to_u64`)."""
    return int(np.packbits(_bits(bits, 64)).view(">u8")[0])


def bytes_to_bits(data) -> np.ndarray:
    """Byte array -> flat bit array, each byte MSB first
    (fhe_encryption.rs:9-35 order)."""
    return np.unpackbits(np.asarray(bytearray(data), dtype=np.uint8))


def bits_to_bytes(bits) -> bytes:
    """Flat MSB-first bit array -> bytes."""
    return np.packbits(_bits(bits, None)).tobytes()
