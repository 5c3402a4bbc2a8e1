"""Bit-sliced FHE AES data model (re-design of the reference data_model.rs).

A `State` is a single BitCt with lane shape [16, 8]: byte index i = 4·col +
row (standard AES block order, matching the reference's column-major
State/Word layout), bit index MSB-first within the byte. All AES linear steps
are lane gathers + batched LWE adds — no per-object graph.

  xor_state   (AddRoundKey)  — data_model.rs:270-274
  shift_rows                 — data_model.rs:277-281
  byte/bit trivial constants — data_model.rs:35-43
"""

from __future__ import annotations

import numpy as np

from tfhe_aes2_tpu_torch.models.shortint_woppbs_1bit import BitCt, FheContext

# shift_rows: new[4c+r] = old[4·((c+r)%4) + r]
SHIFT_ROWS_IDX = np.array(
    [4 * ((c + r) % 4) + r for c in range(4) for r in range(4)], dtype=np.int32)

# rotate rows within each column by k: rot_k[4c+i] = X[4c + (i+k)%4]
ROW_ROT_IDX = {
    k: np.array([4 * c + ((i + k) % 4) for c in range(4) for i in range(4)],
                dtype=np.int32)
    for k in (1, 2, 3)
}


def shift_rows(state: BitCt) -> BitCt:
    """ShiftRows on lane shape [..., 16, 8]."""
    return state.take_lanes(SHIFT_ROWS_IDX, axis=-2)


def rot_rows(state: BitCt, k: int) -> BitCt:
    """Per-column row rotation used by MixColumns recombination."""
    return state.take_lanes(ROW_ROT_IDX[k], axis=-2)


def trivial_byte(ctx: FheContext, val: int) -> BitCt:
    """Byte::trivial (data_model.rs:35-43): 8 trivial bit cts, MSB first."""
    bits = [(int(val) >> (7 - i)) & 1 for i in range(8)]
    return ctx.trivial_bits(np.array(bits))


def key_word_group(expanded_key: BitCt, i: int) -> BitCt:
    """Words 4i..4i+4 of the key schedule (lane shape [44, 4, 8]) reshaped to
    state layout [16, 8]: state byte 4c+r pairs with word 4i+c, byte r."""
    return expanded_key.slice_lanes(slice(4 * i, 4 * i + 4), axis=0).reshape_lanes(16, 8)