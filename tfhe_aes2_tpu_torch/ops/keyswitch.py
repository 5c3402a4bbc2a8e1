"""LWE keyswitching: big->small (KS) and private functional packing (pfKS).

Both are exact limb-plane contractions of gadget digits against the prepared
key planes, evaluated by kernel K4 (torus.exact_matmul). `keyswitch` is the
whole of the reference's `extract_dual_bit_from_bit`: with one extracted bit
at DeltaLog(63), bit extraction degenerates to one big->small keyswitch.
"""

from __future__ import annotations

import torch

from tfhe_aes2_tpu_torch.ops import decomposition
from tfhe_aes2_tpu_torch.ops.params import WopbsParams
from tfhe_aes2_tpu_torch.ops.torus import exact_matmul


def keyswitch(lwe_big: torch.Tensor, ksk: torch.Tensor,
              params: WopbsParams) -> torch.Tensor:
    """[..., kN+1] under the big key -> [..., n+1] under the small key:
    out = (0, b) - Σ_{i,l} dec(a_i)_l · KSK[i, l].

    ksk: prepared int8 planes [8-js, kN·L, n+1] (keys.prepare_server_keys).
    """
    p = params
    nj, k_len, n1 = ksk.shape
    a, b = lwe_big[..., :-1], lwe_big[..., -1]
    digits = decomposition.decompose(a, p.ks_base_log, p.ks_level)  # [..., kN, L]
    batch = digits.shape[:-2]
    acc = exact_matmul(digits.reshape(-1, k_len), ksk,
                       decomposition.digit_bound(p.ks_base_log),
                       max_k=k_len, m_j_start=8 - nj).reshape(batch + (n1,))
    out = -acc
    out[..., -1] += b
    return out


def pfks_all(lwe_big: torch.Tensor, pfpksk: torch.Tensor,
             params: WopbsParams) -> torch.Tensor:
    """Apply all k+1 circuit-bootstrap functions in one contraction:
    LWE [..., kN+1] -> GLWEs [..., U=k+1, k+1, N].

    pfpksk: prepared int8 planes [8-js, (kN+1)·L, U·(k+1)·N].
    out = Σ_l dec(b)_l·K[kN, l] - Σ_{i,l} dec(a_i)_l·K[i, l].
    """
    p = params
    nj, k_len, width = pfpksk.shape
    k1, big_n = p.glwe_dimension + 1, p.polynomial_size
    digits = decomposition.decompose(lwe_big, p.pfks_base_log, p.pfks_level)
    digits = digits.clone()
    digits[..., :-1, :] *= -1          # negate the mask digits, keep the body
    batch = digits.shape[:-2]
    out = exact_matmul(digits.reshape(-1, k_len), pfpksk,
                       decomposition.digit_bound(p.pfks_base_log),
                       max_k=k_len, m_j_start=8 - nj)
    return out.reshape(batch + (width // (k1 * big_n), k1, big_n))
