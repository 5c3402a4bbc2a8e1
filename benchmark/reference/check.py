"""The comparison that decides `correct`: every answer of the window,
decoded with the reference's own key, against the reference's AES
keystream of the same request."""

from __future__ import annotations

import numpy as np

from benchmark.reference import aes, wire


def keystream_bits(key: bytes, blocks: list[bytes],
                   rounds: int = 10) -> np.ndarray:
    """AES_key(block) for each block -> bits [B, 16, 8], MSB first (the
    wire's lane order); `rounds` under 10 the partial AES."""
    ks = np.frombuffer(b"".join(aes.encrypt_blocks(key, blocks, rounds)),
                       np.uint8)
    return np.unpackbits(ks.reshape(len(blocks), 16, 1), axis=-1)


def compare(answers, sk: np.ndarray, log2q: int, rounds: int = 10) -> dict:
    """answers: (key, blocks, wire words [B, 16, 8, n+1]) for each answered
    request, each AES of `rounds` rounds -> {"wrong_bits",
    "phase_err_max", "failed_requests", "answers"}: the keystream bits
    that differ from AES, the widest distance of a phase from its AES
    bit's encoding over all bits (a share of q'/4), and the requests with
    any bit wrong."""
    wrong = failed = 0
    worst = 0.0
    cache: dict = {}
    for key, blocks, words in answers:
        words = np.asarray(words)
        want_key = (key, tuple(blocks))
        if want_key not in cache:
            cache[want_key] = keystream_bits(key, blocks, rounds)
        want = cache[want_key]
        words = words.reshape(want.shape + words.shape[-1:])
        bad = int(np.count_nonzero(wire.decode(words, sk, log2q) != want))
        wrong += bad
        failed += bad > 0
        worst = max(worst, float(wire.phase_error(words, sk, log2q,
                                                  want).max()))
    return {"wrong_bits": wrong, "phase_err_max": worst,
            "failed_requests": failed, "answers": len(answers)}
