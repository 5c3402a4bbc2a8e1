"""AES-128 (FIPS-197), plain Python: the keystream the answers must equal."""

from __future__ import annotations


def _xtime(b: int) -> int:
    b <<= 1
    return (b ^ 0x11B) if b & 0x100 else b


def _gmul(a: int, b: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        a = _xtime(a)
        b >>= 1
    return out


def _sbox() -> list[int]:
    """The S-box from its definition (FIPS-197 5.1.1): the inverse in
    GF(2^8), then the affine map with 0x63."""
    inv = [0] * 256
    for a in range(1, 256):
        for b in range(1, 256):
            if _gmul(a, b) == 1:
                inv[a] = b
                break
    box = []
    for a in range(256):
        x, s = inv[a], inv[a]
        for _ in range(4):
            x = ((x << 1) | (x >> 7)) & 0xFF
            s ^= x
        box.append(s ^ 0x63)
    return box


SBOX = _sbox()
RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]


def expand_key(key: bytes) -> list[list[int]]:
    """The 44 words of the key schedule, each 4 bytes (FIPS-197 5.2)."""
    if len(key) != 16:
        raise ValueError("AES-128 takes a 16-byte key")
    w = [list(key[4 * i: 4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = [SBOX[b] for b in t[1:] + t[:1]]
            t[0] ^= RCON[i // 4 - 1]
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return w


def _add_round_key(s: list[int], w: list[list[int]], r: int) -> list[int]:
    return [s[i] ^ w[4 * r + i // 4][i % 4] for i in range(16)]


def _shift_rows(s: list[int]) -> list[int]:
    # state byte i is row i % 4, column i // 4; row r rotates left by r
    return [s[(i + 4 * (i % 4)) % 16] for i in range(16)]


def _mix_columns(s: list[int]) -> list[int]:
    out = []
    for c in range(4):
        a = s[4 * c: 4 * c + 4]
        out += [_gmul(a[0], 2) ^ _gmul(a[1], 3) ^ a[2] ^ a[3],
                a[0] ^ _gmul(a[1], 2) ^ _gmul(a[2], 3) ^ a[3],
                a[0] ^ a[1] ^ _gmul(a[2], 2) ^ _gmul(a[3], 3),
                _gmul(a[0], 3) ^ a[1] ^ a[2] ^ _gmul(a[3], 2)]
    return out


def encrypt_block(w: list[list[int]], block: bytes, rounds: int = 10) -> bytes:
    """One 16-byte block under the expanded key `w` (FIPS-197 5.1). With
    `rounds` under 10, the reference crate's partial AES (a CPU test's
    shorter run): rounds 1 .. rounds-1 in full, then the final round,
    without MixColumns, under round key 10."""
    if not 1 <= rounds <= 10:
        raise ValueError(f"{rounds} rounds: AES-128 has 1 to 10")
    s = _add_round_key(list(block), w, 0)
    for r in range(1, rounds):
        s = _add_round_key(_mix_columns(_shift_rows([SBOX[b] for b in s])),
                           w, r)
    return bytes(_add_round_key(_shift_rows([SBOX[b] for b in s]), w, 10))


def encrypt_blocks(key: bytes, blocks: list[bytes],
                   rounds: int = 10) -> list[bytes]:
    w = expand_key(key)
    return [encrypt_block(w, b, rounds) for b in blocks]
