"""Circuit bootstrapping + vertical-packing CMux-tree lookup (WoP-PBS core).

Each input bit becomes a GGSW via `cbs_level` scaling bootstraps and k+1
private functional keyswitches (all bits of the batch through one batched
blind rotation); the multivalued LUT is then evaluated with a CMux tree over
packed LUT polynomials and a CMux-rotation stage, one polynomial per output
bit. Every vertical-packing CMux is one launch of kernel K3, with the lane's
selector GGSW shared by its accumulators (the JAX package's pair-mode stage
loop, tfhe_aes2_tpu/ops/circuit_bootstrap.py:154-198, on int64) — or, under
`Lowering.vp == "partials"`, one launch of kernel K8 and the recombination
of its int32 partial sums in torch (the JAX package's TFHE_VP_FUSED=0 stage,
circuit_bootstrap.py:200-253) — or, under `Lowering.ntt` where the
selectors keep at most 4 limb planes, the CRT-NTT product of ops/ntt.py on
K8's operand layout (the JAX package's TFHE_VP_NTT=1 stage,
circuit_bootstrap.py:221-228).
"""

from __future__ import annotations

import numpy as np
import torch

from tfhe_aes2_tpu_torch.ops import blind_rotate as br
from tfhe_aes2_tpu_torch.ops import decomposition
from tfhe_aes2_tpu_torch.ops import keyswitch as ks
from tfhe_aes2_tpu_torch.ops import ntt, polynomial, torus
from tfhe_aes2_tpu_torch.ops.keys import PreparedServerKeys
from tfhe_aes2_tpu_torch.ops.kernels import extprod
from tfhe_aes2_tpu_torch.ops.lowering import Lowering
from tfhe_aes2_tpu_torch.ops.params import WopbsParams


def circuit_bootstrap_bits(bits_big: torch.Tensor, sks: PreparedServerKeys,
                           params: WopbsParams,
                           lowering: Lowering = Lowering()) -> torch.Tensor:
    """LWE bits [..., kN+1] (bit at 2^63, big key) -> GGSW
    [..., L, k+1, k+1, N]: big->small keyswitch, then
    circuit_bootstrap_bits_small."""
    dual = ks.keyswitch(bits_big, sks.ksk, params)
    return circuit_bootstrap_bits_small(dual, sks, params, lowering)


def circuit_bootstrap_bits_small(dual: torch.Tensor, sks: PreparedServerKeys,
                                 params: WopbsParams,
                                 lowering: Lowering = Lowering()
                                 ) -> torch.Tensor:
    """LWE bits [..., n+1] already under the small key (bit at 2^63; the
    8-bit model's extracted bits) -> GGSW [..., L, k+1, k+1, N]: per cbs
    level a scaling PBS and the k+1 pfKS that assemble the GGSW rows."""
    p = params
    rows = []
    for j in range(p.cbs_level):
        lwe_j = br.pbs_bit_to_level(dual, sks.bsk, p.cbs_base_log * (j + 1), p,
                                    lowering)
        rows.append(ks.pfks_all(lwe_j, sks.pfpksk, p))     # [..., k+1, k+1, N]
    return torch.stack(rows, dim=-4)


def ggsw_to_rows(ggsw: torch.Tensor) -> torch.Tensor:
    """[..., L, k+1(row u), k+1, N] -> [..., (k+1)·L (r = u·L + l), k+1, N]."""
    *batch, lv, k1, _, n = ggsw.shape
    return ggsw.movedim(-4, -3).reshape(tuple(batch) + (k1 * lv, k1, n))


def generate_lut(input_bits: int, output_bits: int, f,
                 params: WopbsParams) -> np.ndarray:
    """Multivariate multivalued LUT [output_bits, P, N] uint64, one packed
    polynomial stack per output bit: the entry for input v sits at flat
    index v; output bit o is the o-th most significant of f(v);
    P = 2^max(0, input_bits - log2 N)."""
    if not (0 < input_bits <= 16 and 0 < output_bits <= 64):
        raise ValueError(f"unsupported LUT geometry {input_bits}->"
                         f"{output_bits} bits")
    n = params.polynomial_size
    p_count = 1 << max(0, input_bits - params.log2_poly_size)
    vals = np.array([int(f(v)) for v in range(1 << input_bits)],
                    dtype=np.uint64)
    lut = np.zeros((output_bits, p_count * n), dtype=np.uint64)
    for o in range(output_bits):
        bits = (vals >> np.uint64(output_bits - 1 - o)) & np.uint64(1)
        lut[o, : 1 << input_bits] = bits << np.uint64(63)
    return lut.reshape(output_bits, p_count, n)


def vertical_packing(ggsw: torch.Tensor, luts: torch.Tensor,
                     params: WopbsParams, vp_js: int,
                     lowering: Lowering = Lowering()) -> torch.Tensor:
    """Evaluate the packed LUTs under the GGSW-encrypted selector bits.

    ggsw:  [..., T, L, k+1, k+1, N] int64, T selector bits, MSB first;
    luts:  [O, P, N] int64 clear LUT polynomials (shared by the batch);
    vp_js: GGSW limb planes dropped by K3/K8 (keys.PreparedServerKeys.vp_js);
    lowering: its `vp` picks K3 or K8 + recombination for the CMux stages,
    its `ntt` the CRT-NTT where lowering.vp_ntt(vp_js) (ValueError at
    N = 1024, as in the JAX package).
    returns LWE [..., O, kN+1], one ct per output bit.
    """
    p = params
    o_bits, p_count, n = luts.shape
    t = ggsw.shape[-5]
    tree_bits = p_count.bit_length() - 1
    low_bits = t - tree_bits
    if low_bits != min(t, p.log2_poly_size):
        raise ValueError(f"{t} selector bits do not match LUTs of {p_count} "
                         f"polynomials at N={n}")
    batch = ggsw.shape[:-5]
    b_flat = int(np.prod(batch, dtype=np.int64))
    k1 = p.glwe_dimension + 1
    n_d = torus.limbs_for_bound(decomposition.digit_bound(p.cbs_base_log))

    use_ntt = lowering.vp_ntt(vp_js)
    partials = lowering.vp == "partials"
    rows = ggsw_to_rows(ggsw.reshape((b_flat, t) + ggsw.shape[-4:]))
    planes = extprod.split_polys_ext(rows)[vp_js:]         # [8-js, B, T, R, O, 2N]
    if partials or use_ntt:           # per bit, K8's [8-js, B, R, O, 2N]
        planes = planes.permute(2, 0, 1, 3, 4, 5).contiguous()
    else:                             # per bit, K3's [B, O, R, 8-js, 2N]
        planes = planes.permute(2, 1, 4, 3, 0, 5).contiguous()

    def cmux(bit_idx: int, ct0: torch.Tensor, ct1: torch.Tensor):
        diff = ct1 - ct0                                   # [B, G..., k+1, N]
        digits = br.decompose_glwe(diff, p.cbs_base_log, p.cbs_level)
        d4 = digits.reshape((b_flat, -1) + digits.shape[-2:])  # [B, G, R, N]
        if use_ntt:
            out = ntt.polymul_digits_ntt_grouped(
                d4, planes[bit_idx], decomposition.digit_bound(p.cbs_base_log),
                vp_js)                                     # [B, G, O, N]
            return ct0 + out.reshape(diff.shape)
        dig = torus.split_int32_signed(d4, n_d)            # [n_d, B, G, R, N]
        if partials:
            parts = extprod.extprod_partials_grouped(dig, planes[bit_idx],
                                                     vp_js)  # [8, B, G, O, N]
            out = polynomial.recombine_partials(parts, vp_js)
            return ct0 + out.reshape(diff.shape)
        g = dig.shape[2]
        dig = dig.permute(1, 3, 0, 2, 4).reshape(b_flat, -1, n_d * g, n)
        out = extprod.extprod_grouped_fused(dig.contiguous(), planes[bit_idx],
                                            n_d, vp_js)    # [B, O, G, N]
        return ct0 + out.permute(0, 2, 1, 3).reshape(diff.shape)

    # trivial GLWE accumulators [B, O, P, k+1, N]
    acc = torch.zeros((b_flat, o_bits, p_count, k1, n), dtype=torch.int64,
                      device=ggsw.device)
    acc[..., -1, :] = luts
    for level in range(tree_bits):
        acc = cmux(tree_bits - 1 - level, acc[:, :, 0::2], acc[:, :, 1::2])
    acc = acc[:, :, 0]                                     # [B, O, k+1, N]
    for j in range(low_bits):
        step = 1 << (low_bits - 1 - j)
        acc = cmux(tree_bits + j, acc,
                   polynomial.monomial_mul_static(acc, 2 * n - step))
    return br.sample_extract0(acc).reshape(batch + (o_bits, -1))


def circuit_bootstrap_vertical_packing(bits_big: torch.Tensor,
                                       luts: torch.Tensor,
                                       sks: PreparedServerKeys,
                                       params: WopbsParams,
                                       lowering: Lowering = Lowering()
                                       ) -> torch.Tensor:
    """Full WoP-PBS: input bits [..., T, kN+1] (MSB first) + LUTs [O, P, N]
    -> output bits [..., O, kN+1]."""
    ggsw = circuit_bootstrap_bits(bits_big, sks, params, lowering)
    return vertical_packing(ggsw, luts, params, sks.vp_js, lowering)
