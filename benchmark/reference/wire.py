"""Decode of the compressed answer, from its documented wire format: each
output bit is a small-key LWE ciphertext (a_1..a_n, b) whose n+1 words are
taken mod q' = 2^log2q; the bit sits at q'/2, so the phase
b - <a, s> mod q' is bit * q'/2 plus noise, and decodes by the nearest of
the two (the decision threshold q'/4 from each)."""

from __future__ import annotations

import numpy as np


def phases(words: np.ndarray, sk: np.ndarray, log2q: int) -> np.ndarray:
    """Phases [...] in [0, q') of wire words [..., n+1] under key sk [n]."""
    w = np.asarray(words).astype(np.int64)
    if w.shape[-1] != sk.shape[0] + 1:
        raise ValueError(f"ciphertexts of {w.shape[-1]} words under a key "
                         f"of {sk.shape[0]} bits")
    q = 1 << log2q
    return (w[..., -1] - w[..., :-1] @ sk) % q


def decode(words: np.ndarray, sk: np.ndarray, log2q: int) -> np.ndarray:
    """The decoded bits [...] uint8: the nearest of 0 and q'/2."""
    q = 1 << log2q
    return (((phases(words, sk, log2q) + q // 4) >> (log2q - 1))
            & 1).astype(np.uint8)


def phase_error(words: np.ndarray, sk: np.ndarray, log2q: int,
                bits: np.ndarray) -> np.ndarray:
    """Each phase's distance from bits * q'/2, the expected bit's encoding,
    as a share of q'/4: under 1 the bit decodes right, over 1 wrong (up to
    2 for a phase at the other bit's encoding)."""
    q = 1 << log2q
    err = ((phases(words, sk, log2q) - bits.astype(np.int64) * (q // 2)
            + q // 2) % q) - q // 2
    return np.abs(err) / (q // 4)
