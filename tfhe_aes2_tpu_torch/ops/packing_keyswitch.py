"""LWE -> GLWE packing keyswitch (tfhe-rs `lwe_packing_keyswitch`).

The tree-PBS model's (models/shortint_1bit.py) way from an LWE ciphertext
under the small key to a GLWE ciphertext under S with the message at
coefficient 0, or to one GLWE holding a list at successive monomials:

    out = (0, b·X^0) - Σ_{i,l} dec(a_i)_l · PKSK[i, l],
    PKSK[i, l] = GLWE_S(s_i · g_l), gadget (ks_level, ks_base_log).

The contraction is exact mod 2^64 on the prepared key's 8 limb planes, by
kernel K4 (torus.exact_matmul), as the keyswitches of ops/keyswitch.py.
"""

from __future__ import annotations

import torch

from tfhe_aes2_tpu_torch.ops import decomposition, polynomial
from tfhe_aes2_tpu_torch.ops.params import WopbsParams
from tfhe_aes2_tpu_torch.ops.torus import exact_matmul


def pack_lwe(lwe_small: torch.Tensor, pksk: torch.Tensor,
             params: WopbsParams) -> torch.Tensor:
    """[..., n+1] (small key) -> GLWE [..., k+1, N], message at coeff 0.

    pksk: prepared int8 planes [8, n·L, (k+1)·N] (keys.prepare_server_keys).
    """
    p = params
    nj, k_len, width = pksk.shape
    k1, n = p.glwe_dimension + 1, p.polynomial_size
    a, b = lwe_small[..., :-1], lwe_small[..., -1]
    digits = decomposition.decompose(a, p.ks_base_log, p.ks_level)  # [..., n, L]
    batch = digits.shape[:-2]
    acc = exact_matmul(digits.reshape(-1, k_len), pksk,
                       decomposition.digit_bound(p.ks_base_log),
                       max_k=k_len, m_j_start=8 - nj)
    out = (-acc).reshape(batch + (k1, n))
    out[..., -1, 0] += b
    return out


def pack_lwe_list(lwe_list: torch.Tensor, pksk: torch.Tensor,
                  params: WopbsParams) -> torch.Tensor:
    """[..., M, n+1] -> GLWE [..., k+1, N] with message m_j at coefficient j
    (tfhe-rs keyswitch_lwe_ciphertext_list_and_pack_in_glwe_ciphertext)."""
    glwes = pack_lwe(lwe_list, pksk, params)           # [..., M, k+1, N]
    out = glwes[..., 0, :, :]
    for j in range(1, lwe_list.shape[-2]):
        out = out + polynomial.monomial_mul_static(glwes[..., j, :, :], j)
    return out
