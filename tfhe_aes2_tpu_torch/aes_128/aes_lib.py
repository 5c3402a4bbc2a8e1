"""Independent AES-128 authority (T-table implementation).

Role of the reference's `aes` crate wrapper (src/aes_128/aes_lib.rs:4-14): an
implementation structurally unrelated to `plain.py`, used as the final oracle
for full-round tests and the CTR scenario assert (main.rs:125-127).
"""

from __future__ import annotations

import numpy as np

from tfhe_aes2_tpu_torch.aes_128 import RC, SBOX, gf_256_mul

# T-tables: Te0[x] = [2·S(x), S(x), S(x), 3·S(x)] packed big-endian
_T0 = np.array(
    [(gf_256_mul(int(SBOX[x]), 2) << 24) | (int(SBOX[x]) << 16) | (int(SBOX[x]) << 8)
     | gf_256_mul(int(SBOX[x]), 3) for x in range(256)], dtype=np.uint32)
_T1 = np.array([((int(_T0[x]) >> 8) | ((int(_T0[x]) & 0xFF) << 24)) for x in range(256)],
               dtype=np.uint32)
_T2 = np.array([((int(_T1[x]) >> 8) | ((int(_T1[x]) & 0xFF) << 24)) for x in range(256)],
               dtype=np.uint32)
_T3 = np.array([((int(_T2[x]) >> 8) | ((int(_T2[x]) & 0xFF) << 24)) for x in range(256)],
               dtype=np.uint32)


def _expand(key: bytes) -> list[int]:
    w = [int.from_bytes(key[4 * i: 4 * i + 4], "big") for i in range(4)]
    for i in range(4, 44):
        t = w[i - 1]
        if i % 4 == 0:
            t = ((t << 8) | (t >> 24)) & 0xFFFFFFFF
            t = (int(SBOX[(t >> 24) & 0xFF]) << 24 | int(SBOX[(t >> 16) & 0xFF]) << 16
                 | int(SBOX[(t >> 8) & 0xFF]) << 8 | int(SBOX[t & 0xFF]))
            t ^= int(RC[i // 4]) << 24
        w.append(w[i - 4] ^ t)
    return w


def encrypt_block(key: bytes, block: bytes) -> bytes:
    w = _expand(key)
    s = [int.from_bytes(block[4 * i: 4 * i + 4], "big") ^ w[i] for i in range(4)]
    for rnd in range(1, 10):
        t = [
            int(_T0[(s[i] >> 24) & 0xFF]) ^ int(_T1[(s[(i + 1) % 4] >> 16) & 0xFF])
            ^ int(_T2[(s[(i + 2) % 4] >> 8) & 0xFF]) ^ int(_T3[s[(i + 3) % 4] & 0xFF])
            ^ w[4 * rnd + i]
            for i in range(4)
        ]
        s = t
    out = bytearray()
    for i in range(4):
        v = (int(SBOX[(s[i] >> 24) & 0xFF]) << 24
             | int(SBOX[(s[(i + 1) % 4] >> 16) & 0xFF]) << 16
             | int(SBOX[(s[(i + 2) % 4] >> 8) & 0xFF]) << 8
             | int(SBOX[s[(i + 3) % 4] & 0xFF]))
        v ^= w[40 + i]
        out += v.to_bytes(4, "big")
    return bytes(out)


def encrypt_blocks(key: bytes, blocks) -> list[bytes]:
    return [encrypt_block(key, b) for b in blocks]
