"""What every traffic kind shares: a request's clear inputs and their
client encryptions, drawn from the run's seed."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Request:
    """One request: the AES key and the IV || counter blocks in the clear
    (for the reference), and the client's ciphertexts of them (host numpy,
    uploaded in the window)."""

    key: bytes
    blocks: list
    key_ct: np.ndarray | None
    block_cts: np.ndarray


def ctr_blocks(iv: bytes, first: int, count: int) -> list[bytes]:
    """IV || big-endian 64-bit counter, counters first .. first+count-1."""
    return [iv + ((first + i) % (1 << 64)).to_bytes(8, "big")
            for i in range(count)]


def draw_session(rng: np.random.Generator) -> tuple[bytes, bytes, int]:
    """(AES key, IV, first counter) of one client session."""
    return (rng.bytes(16), rng.bytes(8),
            int(rng.integers(0, 1 << 62, dtype=np.int64)))
