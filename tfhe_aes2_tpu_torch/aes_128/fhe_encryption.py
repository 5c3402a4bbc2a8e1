"""Client-side clear <-> FHE conversions (reference fhe_encryption.rs:9-65).

Bytes map to 8 LWE bit ciphertexts MSB-first; blocks to lane shape [16, 8];
the expanded key to [44, 4, 8]. Returns raw numpy ct arrays — the server
wraps them in BitCt metadata.
"""

from __future__ import annotations

import numpy as np

from tfhe_aes2_tpu_torch.ops.keys import ClientKey


def _bytes_to_bit_lanes(data: np.ndarray) -> np.ndarray:
    """uint8 [...] -> bits [..., 8] MSB first."""
    data = np.asarray(data, dtype=np.uint8)
    return np.unpackbits(data[..., None], axis=-1)


def encrypt_byte_array(client: ClientKey, data: bytes) -> np.ndarray:
    """16 bytes -> ct array [16, 8, kN+1]."""
    bits = _bytes_to_bit_lanes(np.frombuffer(bytes(data), dtype=np.uint8))
    return client.encrypt_bits(bits)


def encrypt_blocks(client: ClientKey, blocks) -> np.ndarray:
    """list of 16-byte blocks -> [B, 16, 8, kN+1]."""
    arr = np.stack([np.frombuffer(bytes(b), dtype=np.uint8) for b in blocks])
    return client.encrypt_bits(_bytes_to_bit_lanes(arr))


def encrypt_word_array(client: ClientKey, words) -> np.ndarray:
    """Clear key schedule [44, 4] uint8 -> [44, 4, 8, kN+1], the expanded
    key supplied encrypted (the sharded entry points' input)."""
    return client.encrypt_bits(_bytes_to_bit_lanes(np.asarray(words,
                                                              np.uint8)))


def decrypt_blocks(client: ClientKey, cts: np.ndarray) -> list[bytes]:
    """[B, 16, 8, kN+1] -> list of 16-byte blocks."""
    bits = np.asarray(client.decrypt_bits(np.asarray(cts)), dtype=np.uint8)
    data = np.packbits(bits, axis=-1)[..., 0]
    return [row.tobytes() for row in data]
