"""Multi-bit extraction from a wide LWE ciphertext (tfhe-rs `extract_bits`).

The 8-bit model's way back from a full-width ciphertext to its 8 bits
(reference shortint_woppbs_8bit.rs:268-296, DeltaLog(56) x 8 bits): an
iterated LSB peel — shift the target bit to 2^63, keyswitch to the small key
(K4), and for all but the last bit remove its contribution with a scaling
PBS (K2 + K1 under the default lowering) before going on. The bits come
back MSB first, the reference's Byte order.

With one bit at DeltaLog(63) this is one keyswitch: the 1-bit model's
`extract_dual_bit_from_bit`.
"""

from __future__ import annotations

import torch

from tfhe_aes2_tpu_torch.ops import blind_rotate as br
from tfhe_aes2_tpu_torch.ops import keyswitch as ks
from tfhe_aes2_tpu_torch.ops.keys import PreparedServerKeys
from tfhe_aes2_tpu_torch.ops.lowering import Lowering
from tfhe_aes2_tpu_torch.ops.params import WopbsParams


def extract_bits(ct_big: torch.Tensor, sks: PreparedServerKeys,
                 params: WopbsParams, delta_log: int, count: int,
                 lowering: Lowering = Lowering()) -> torch.Tensor:
    """ct_big [..., kN+1] with message bits at [delta_log, delta_log+count)
    -> small-key bit cts [..., count, n+1], MSB first, each bit at 2^63."""
    if delta_log + count > 64:
        raise ValueError(f"bits [{delta_log}, {delta_log + count}) leave the "
                         "64-bit torus")
    ct = ct_big
    out = []
    for j in range(count):                               # LSB first
        pos = delta_log + j
        shift = 63 - pos
        shifted = ct << shift                            # · 2^shift mod 2^64
        small = ks.keyswitch(shifted, sks.ksk, params)
        out.append(small)
        if j < count - 1:
            ct = ct - br.pbs_bit_to_level(small, sks.bsk, 64 - pos, params,
                                          lowering)
    out.reverse()                                        # MSB first
    return torch.stack(out, dim=-2)
