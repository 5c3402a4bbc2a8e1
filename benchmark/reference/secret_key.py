"""The client's small LWE secret key, worked out again from the keygen
seed: the port's keygen (like the JAX package's and the reference's
DeterministicSeeder order) draws it first from numpy's default generator,
n uniform bits, then the GLWE key. The benchmark hands the same seed to
both sides; nothing of the port's ClientKey is read here."""

from __future__ import annotations

import numpy as np


def small_lwe_key(seed: int, lwe_dimension: int) -> np.ndarray:
    """The n-bit small LWE key, int64 in {0, 1}."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=(lwe_dimension,),
                        dtype=np.uint64).astype(np.int64)
