"""Server-side LWE tensor ops on int64 torus values.

LWE ciphertext layout: [..., dim+1] = mask ‖ body. XOR in the 1-bit model is
the wrapping add; trivial encryptions carry constants with a zero mask.
"""

from __future__ import annotations

import torch

from tfhe_aes2_tpu_torch.ops.torus import encode_bit


def trivial(encodings: torch.Tensor, dim: int) -> torch.Tensor:
    """encodings int64 [...] -> trivial LWE [..., dim+1] (zero mask)."""
    mask = torch.zeros(encodings.shape + (dim,), dtype=torch.int64,
                       device=encodings.device)
    return torch.cat([mask, encodings.to(torch.int64)[..., None]], dim=-1)


def trivial_bits(bits: torch.Tensor, dim: int) -> torch.Tensor:
    """bits [...] -> trivial LWE of bit<<63."""
    return trivial(encode_bit(bits), dim)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Wrapping LWE addition (the XOR of the 1-bit model)."""
    return a + b
