"""Blind rotation + programmable bootstrap (the hot loop).

The CMux chain of the blind rotation runs one of six schedules of the
JAX package (tfhe_aes2_tpu/ops/blind_rotate.py:229-364), chosen by
`Lowering.br`; all give the same bits:

  "gridg" (default): kernel K2 decomposes X^{a_0}·acc - acc once, then
      kernel K1 runs each of the n steps — the external product with BSK
      entry i added into the accumulator, fused with the decomposition of
      the NEXT step's rotation difference; the last step's glue is fed t = 0
      and its digits are discarded.
  "grid": two launches a step, K2 (the glue) then K5 (dots + recombine).
  "merged": one launch a step, K9 (glue, dots and recombine; no digits
      between the steps).
  "longk": K10a (the glue, row-flattened) then K10b (one long contraction
      a lane, its rows split across blocks to fill the card) per step, on
      the prepared BSK entry as it lies.
  "bucket": K2 then K11 (one weight bucket per block) per step.
  "glue_out": the glue in plain torch on the batch-major accumulator
      (rotate, subtract, decompose, split: a few dozen small launches),
      then K6.

All concurrent bootstraps of the batch advance through step i together.
"""

from __future__ import annotations

import torch

from tfhe_aes2_tpu_torch.ops import decomposition, polynomial, torus
from tfhe_aes2_tpu_torch.ops.kernels import extprod
from tfhe_aes2_tpu_torch.ops.lowering import Lowering
from tfhe_aes2_tpu_torch.ops.params import WopbsParams
from tfhe_aes2_tpu_torch.ops.torus import srl, wrap


def mod_switch(x: torch.Tensor, log2n: int) -> torch.Tensor:
    """int64 torus -> Z_{2N}: round(x · 2N / 2^64), int32 in [0, 2N)."""
    shift = 64 - (log2n + 1)
    return srl(x + (1 << (shift - 1)), shift).to(torch.int32)


def decompose_glwe(glwe: torch.Tensor, base_log: int,
                   levels: int) -> torch.Tensor:
    """GLWE [..., k+1, N] -> digits int32 [..., (k+1)·levels, N], row
    r = u·levels + l."""
    d = decomposition.decompose(glwe, base_log, levels)    # [..., k+1, N, L]
    d = d.movedim(-1, -2)                                  # [..., k+1, L, N]
    return d.reshape(d.shape[:-3] + (d.shape[-3] * d.shape[-2], d.shape[-1]))


def blind_rotate_glwe(lwe: torch.Tensor, bsk: torch.Tensor,
                      acc_glwe: torch.Tensor, params: WopbsParams,
                      lowering: Lowering = Lowering()) -> torch.Tensor:
    """Blind-rotate a GLWE accumulator by the phase of `lwe`.

    lwe:      [..., n+1] int64 (under the small key)
    bsk:      prepared int8 [n, k+1, R, 8-js, 2N] (keys.prepare_bsk)
    acc_glwe: [..., k+1, N] int64, broadcastable over the batch
    lowering: its `br` picks the schedule of the CMux chain
    returns   [..., k+1, N]
    """
    p = params
    n, logn = p.polynomial_size, p.log2_poly_size
    k1 = p.glwe_dimension + 1
    js = 8 - bsk.shape[3]
    batch = lwe.shape[:-1]
    lwe = lwe.reshape(-1, lwe.shape[-1])
    b_flat = lwe.shape[0]
    n_d = torus.limbs_for_bound(decomposition.digit_bound(p.pbs_base_log))

    a_steps = mod_switch(lwe[:, :-1], logn).t().contiguous()   # [n_lwe, B]
    b_tilde = mod_switch(lwe[:, -1], logn)
    acc = acc_glwe.expand(batch + (k1, n)).reshape(b_flat, k1, n)
    acc = polynomial.monomial_mul(acc, ((2 * n - b_tilde) % (2 * n))[:, None])
    n_lwe = a_steps.shape[0]

    if lowering.br == "glue_out":
        acc = acc.contiguous()                                 # [B, O, N]
        for i in range(n_lwe):
            rot = polynomial.monomial_mul(acc, a_steps[i][:, None])
            digits = decompose_glwe(rot - acc, p.pbs_base_log, p.pbs_level)
            planes = torus.split_int32_signed(digits, n_d)     # [n_d, B, R, N]
            acc = extprod.extprod_step(planes, bsk[i], acc, js)
        return acc.reshape(batch + (k1, n))

    acc_of = acc.permute(1, 0, 2).contiguous()                 # [O, B, N]
    base_log, levels = p.pbs_base_log, p.pbs_level
    if lowering.br == "gridg":
        dig = extprod.rot_diff_digits(acc_of, a_steps[0], base_log, levels,
                                      n_d)
        zero = torch.zeros_like(a_steps[0])
        for i in range(n_lwe):
            t_next = a_steps[i + 1] if i + 1 < n_lwe else zero
            acc_of, dig = extprod.extprod_step2g(
                dig, bsk[i], acc_of, t_next, base_log, levels, js)
    elif lowering.br == "merged":
        for i in range(n_lwe):
            acc_of = extprod.cmux_step_merged(a_steps[i], bsk[i], acc_of,
                                              base_log, levels, js)
    elif lowering.br == "longk":
        for i in range(n_lwe):
            dig = extprod.rot_diff_digits_flat(acc_of, a_steps[i], base_log,
                                               levels, n_d)
            acc_of = extprod.extprod_step_longk(dig, bsk[i], acc_of, js)
    else:                                          # "grid" | "bucket"
        dots = (extprod.extprod_step3 if lowering.br == "bucket"
                else extprod.extprod_step2)
        for i in range(n_lwe):
            dig = extprod.rot_diff_digits(acc_of, a_steps[i], base_log,
                                          levels, n_d)
            acc_of = dots(dig, bsk[i], acc_of, js)
    return acc_of.permute(1, 0, 2).reshape(batch + (k1, n))


def sample_extract0(glwe: torch.Tensor) -> torch.Tensor:
    """Extract coefficient 0 as an LWE ct under the flattened GLWE key:
    glwe [..., k+1, N] -> [..., kN+1] with a[u·N] = A_u[0],
    a[u·N + i] = -A_u[N - i] (i >= 1), b = B[0]."""
    a, b = glwe[..., :-1, :], glwe[..., -1, :]
    mask = torch.cat([a[..., :1], -a[..., 1:].flip(-1)], dim=-1)
    mask = mask.reshape(mask.shape[:-2] + (-1,))
    return torch.cat([mask, b[..., :1]], dim=-1)


def pbs_bit_to_level(lwe_small: torch.Tensor, bsk: torch.Tensor,
                     target_log: int, params: WopbsParams,
                     lowering: Lowering = Lowering()) -> torch.Tensor:
    """Bootstrap a 1-bit LWE (bit at 2^63) to LWE_bigkey(bit·2^(64-target_log)).

    The gadget-scaling PBS inside circuit bootstrapping: shift the input by
    q/4, blind-rotate the constant test vector c = -2^(64-target_log-1),
    extract, and re-centre by adding -c."""
    p = params
    half = 1 << (64 - target_log - 1)
    shifted = lwe_small.clone()
    shifted[..., -1] += 1 << 62
    acc = torch.zeros((p.glwe_dimension + 1, p.polynomial_size),
                      dtype=torch.int64, device=lwe_small.device)
    acc[-1] = wrap(-half)
    out = sample_extract0(blind_rotate_glwe(shifted, bsk, acc, p, lowering))
    out[..., -1] += half
    return out
