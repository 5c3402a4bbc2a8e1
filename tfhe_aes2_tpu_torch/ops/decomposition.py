"""Signed gadget decomposition (balanced base-2^B digits) on int64 torus values.

Digit d[l] (l = 0 most significant) has weight g_l = 2^(64 - B·(l+1)) and
value in [-2^(B-1), 2^(B-1)); Σ_l d[l]·g_l ≡ round(x) (mod 2^64) with
|round(x) - x| <= 2^(64 - B·L - 1). Branch-free: round to the grid with a
logical shift, then extract balanced digits with the offset trick.
"""

from __future__ import annotations

import torch

from tfhe_aes2_tpu_torch.ops.torus import srl, wrap


def decompose(x: torch.Tensor, base_log: int, levels: int) -> torch.Tensor:
    """int64 torus [...] -> digits int32 [..., levels], most significant first."""
    b = base_log
    total = b * levels
    if total > 64:
        raise ValueError(f"base_log·levels = {total} exceeds 64")
    shift = 64 - total
    r = srl(x + (1 << (shift - 1)), shift) if shift > 0 else x
    # add 2^(B-1) at every digit position, take plain digits, subtract it
    y = r + wrap(sum(1 << (b - 1 + b * l) for l in range(levels)))
    half = 1 << (b - 1)
    mask = (1 << b) - 1
    digits = [((y >> (b * (levels - 1 - l))) & mask).to(torch.int32) - half
              for l in range(levels)]
    return torch.stack(digits, dim=-1)


def digit_bound(base_log: int) -> int:
    """Inclusive bound on |digit|."""
    return 1 << (base_log - 1)
