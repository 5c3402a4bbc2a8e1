"""Clear AES-128 oracle with partial-round support.

Mirrors reference src/aes_128/plain.rs:75-147: byte-level AES whose structure
(state layout, round steps, partial rounds) matches the FHE implementation so
intermediate states can be compared step by step. Used as the `test_light`
oracle. `encrypt_blocks_lib`-equivalent authority is provided by the full
10-round path validated against FIPS-197 C.1 (tests/test_aes_plain.py).
"""

from __future__ import annotations

import numpy as np

from tfhe_aes2_tpu_torch.aes_128 import RC, ROUNDS, SBOX, gf_256_mul

# Precomputed GF(256) x2 / x3 tables (standard reduction).
GF_MUL2 = np.array([gf_256_mul(x, 2) for x in range(256)], dtype=np.uint8)
GF_MUL3 = np.array([gf_256_mul(x, 3) for x in range(256)], dtype=np.uint8)


def key_schedule(key: bytes) -> np.ndarray:
    """Expand a 16-byte key into 44 words of 4 bytes (plain.rs:106-132)."""
    assert len(key) == 16
    w = [np.frombuffer(bytes(key[4 * i: 4 * i + 4]), dtype=np.uint8).copy() for i in range(4)]
    for i in range(4, 44):
        if i % 4 == 0:
            t = SBOX[np.roll(w[i - 1], -1)]
            t = t.copy()
            t[0] ^= RC[i // 4]
            w.append(w[i - 4] ^ t)
        else:
            w.append(w[i - 4] ^ w[i - 1])
    return np.stack(w)  # [44, 4] uint8


def encrypt_block(expanded_key: np.ndarray, block: bytes, rounds: int = ROUNDS) -> bytes:
    """Encrypt one block for a given number of rounds (plain.rs:75-103).

    State layout: state[row, col] = block[4*col + row] (column-major words),
    matching reference plain/data_model.rs.
    """
    assert expanded_key.shape == (44, 4)
    state = np.frombuffer(bytes(block), dtype=np.uint8).reshape(4, 4).T.copy()

    def xor_key(s, i):
        # key word j is column j; word bytes map to rows
        s ^= expanded_key[4 * i: 4 * i + 4].T

    xor_key(state, 0)
    for rnd in range(1, rounds):
        state = SBOX[state]
        for r in range(4):
            state[r] = np.roll(state[r], -r)
        col = state.copy()
        state[0] = GF_MUL2[col[0]] ^ GF_MUL3[col[1]] ^ col[2] ^ col[3]
        state[1] = GF_MUL2[col[1]] ^ GF_MUL3[col[2]] ^ col[3] ^ col[0]
        state[2] = GF_MUL2[col[2]] ^ GF_MUL3[col[3]] ^ col[0] ^ col[1]
        state[3] = GF_MUL2[col[3]] ^ GF_MUL3[col[0]] ^ col[1] ^ col[2]
        xor_key(state, rnd)

    state = SBOX[state]
    for r in range(4):
        state[r] = np.roll(state[r], -r)
    # The final-round key is always words 40..44, matching the reference even
    # for partial rounds (plain.rs:95-99, fhe_sbox_gal_mul_pbs.rs:126-129).
    xor_key(state, 10)

    return state.T.tobytes()


def expand_key_and_encrypt_blocks(key: bytes, blocks, rounds: int = ROUNDS):
    """plain.rs:141-147."""
    ks = key_schedule(key)
    return [encrypt_block(ks, b, rounds) for b in blocks]
