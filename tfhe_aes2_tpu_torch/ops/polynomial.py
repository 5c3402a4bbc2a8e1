"""Negacyclic polynomial arithmetic in Z_{2^64}[X]/(X^N + 1) on int64.

A product a ⊛ b is a matrix product of a's coefficients with the
negacirculant of b: NC(b)[j, m] = ext[(m - j) mod 2N] with ext = [b, -b], so
(a ⊛ b)[m] = Σ_j a[j]·NC(b)[j, m]. The kernels (ops/kernels/extprod.py)
never materialise NC: they index the 2N-entry ext row on chip.
`nc_limb_product` here is the plain truth for K1, K3, K5 and K6: the same
function in float64 matrix products, used by the kernels' plain versions;
`nc_limb_partials` is the same contraction left as one int32 sum per weight
2^(8s), the plain truth for K7 and K8.

Monomial multiplications (the rotations of blind rotation and vertical
packing) are index gathers on ext.

`polymul_shared_digits` is the tree-PBS model's selection product (the JAX
package's `polymul_digits_grouped` there, which materialises each lane's
negacirculant): small digit polynomials shared by every lane against each
lane's own u64 polynomials, through kernel K3.
"""

from __future__ import annotations

import torch


def negacyclic_extend(polys: torch.Tensor) -> torch.Tensor:
    """[..., N] -> [..., 2N]: concat(p, -p); ext[m mod 2N] realises X^m signs."""
    return torch.cat([polys, -polys], dim=-1)


def nc_index(n: int, device) -> torch.Tensor:
    """idx[j, m] = (m - j) mod 2N, so NC[j, m] = ext[idx[j, m]]."""
    j = torch.arange(n, device=device)[:, None]
    m = torch.arange(n, device=device)[None, :]
    return (m - j) % (2 * n)


def monomial_mul_static(polys: torch.Tensor, t: int) -> torch.Tensor:
    """X^t · polys for a static t: slice + concat + negate."""
    n = polys.shape[-1]
    t %= 2 * n
    if t == 0:
        return polys
    if t >= n:
        return -monomial_mul_static(polys, t - n)
    return torch.cat([-polys[..., n - t:], polys[..., : n - t]], dim=-1)


def monomial_mul(polys: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """X^t · polys (negacyclic). polys [..., N]; t integer tensor
    broadcastable to polys.shape[:-1], values in [0, 2N):
    (X^t p)[m] = ext[(m - t) mod 2N]."""
    n = polys.shape[-1]
    ext = negacyclic_extend(polys)
    m = torch.arange(n, device=polys.device)
    idx = (m - t.to(torch.int64)[..., None]) % (2 * n)
    idx = idx.expand(polys.shape[:-1] + (n,))
    return torch.gather(ext, -1, idx)


def nc_limb_partials(dig_planes: torch.Tensor, ext_planes: torch.Tensor,
                     j_start: int) -> torch.Tensor:
    """Plain truth of the negacirculant limb-plane contraction, as the raw
    partial sums of K7/K8.

    dig_planes: int8 [n_d, S, G, R, N], the balanced limb planes of gadget
                digits (plane i weighs 2^(8i)) for G accumulators in each
                of S groups;
    ext_planes: int8 [S, R, O, 8 - j_start, 2N], limb planes j_start..7 of
                ext = [p, -p] for each row r and output component o, shared
                by the G accumulators of a group;
    -> int32 [8, S, G, O, N], row s = Σ_{i + j = s} Σ_r dig_i[r] ⊛ plane_j[r, o];
       pairs with i + j >= 8 vanish mod 2^64 and are not formed, and rows
       s < j_start are zero.

    Float64 products of int8 entries are exact, and each sum must fit the
    kernels' int32 buckets: at most n_d pairs (i, j) share a weight, each
    of R·N products of at most 2^14; the check below refuses anything
    longer.
    """
    n_d, s_cnt, g, r, n = dig_planes.shape
    if ext_planes.shape[:2] != (s_cnt, r) or ext_planes.shape[-1] != 2 * n:
        raise ValueError(f"shape mismatch {tuple(dig_planes.shape)} vs "
                         f"{tuple(ext_planes.shape)}")
    o_cnt, n_j = ext_planes.shape[2:4]
    if n_d * r * n * (1 << 14) >= 1 << 31:
        raise ValueError("contraction too long for int32 partial sums")
    digits = dig_planes.to(torch.float64).reshape(n_d, s_cnt, g, r * n)
    idx = nc_index(n, dig_planes.device)
    parts = torch.zeros((8, s_cnt, g, o_cnt, n), dtype=torch.int32,
                        device=dig_planes.device)
    for o in range(o_cnt):
        for jj in range(n_j):
            ext = ext_planes[:, :, o, jj].to(torch.float64)  # [S, R, 2N]
            nc = ext[..., idx].reshape(s_cnt, r * n, n)      # [S, R·N, N]
            for i in range(min(n_d, 8 - j_start - jj)):
                prod = torch.bmm(digits[i], nc).to(torch.int32)  # [S, G, N]
                parts[i + j_start + jj, :, :, o] += prod
    return parts


def recombine_partials(parts: torch.Tensor, j_start: int = 0) -> torch.Tensor:
    """int32 [8, ...] partial sums by weight 2^(8s) -> int64 [...]:
    Σ_{s >= j_start} sext(parts[s]) << 8s, wrapping mod 2^64."""
    out = parts[j_start].to(torch.int64) << (8 * j_start)
    for s in range(j_start + 1, 8):
        out += parts[s].to(torch.int64) << (8 * s)
    return out


def nc_limb_product(dig_planes: torch.Tensor, ext_planes: torch.Tensor,
                    j_start: int) -> torch.Tensor:
    """Plain truth of the contraction of K1, K3, K5 and K6: operands as for
    `nc_limb_partials` -> int64 [S, G, O, N] =
    Σ_{i,j} 2^(8(i+j)) Σ_r dig_i[r] ⊛ plane_j[r, o] mod 2^64, equal to those
    partial sums folded by `recombine_partials`.

    Float64 limb products are exact below 2^53: the recombined digit is
    below 2^(8·n_d - 1) in magnitude, a key plane entry at most 2^7, and
    the contraction has R·N terms; the check below refuses anything
    longer. Products with i + j >= 8 vanish mod 2^64, so contracting the
    recombined digit against each key plane gives the kernels' bits.
    """
    n_d, s, g, r, n = dig_planes.shape
    if ext_planes.shape[:2] != (s, r) or ext_planes.shape[-1] != 2 * n:
        raise ValueError(f"shape mismatch {tuple(dig_planes.shape)} vs "
                         f"{tuple(ext_planes.shape)}")
    o_cnt, n_j = ext_planes.shape[2:4]
    if (8 * n_d - 1) + 7 + (r * n).bit_length() >= 53:
        raise ValueError("contraction too long for exact float64")
    digits = sum(dig_planes[i].to(torch.float64) * float(1 << (8 * i))
                 for i in range(n_d))                       # [S, G, R, N]
    digits = digits.reshape(s, g, r * n)
    idx = nc_index(n, dig_planes.device)
    out = torch.zeros((s, g, o_cnt, n), dtype=torch.int64,
                      device=dig_planes.device)
    for o in range(o_cnt):
        for jj in range(n_j):
            ext = ext_planes[:, :, o, jj].to(torch.float64)  # [S, R, 2N]
            nc = ext[..., idx].reshape(s, r * n, n)          # [S, R·N, N]
            prod = torch.bmm(digits, nc).to(torch.int64)     # [S, G, N]
            out[:, :, o] += prod << (8 * (j_start + jj))
    return out


# K3's limits (csrc/vp.cu): its int8 operands are read through 32-bit byte
# strides, and its lanes lie on the grid's z axis
_K3_OPERAND_BYTES = 1 << 31
_K3_LANES = 65535


def polymul_shared_digits(digits: torch.Tensor,
                          polys: torch.Tensor) -> torch.Tensor:
    """Σ_r digits[r] ⊛ polys[b, r, o] mod 2^64 for every lane b.

    digits: int8 [R, N], shared by the lanes (one limb a digit);
    polys:  int64 [B, R, O, N], each lane's own polynomials;
    returns int64 [B, O, N].

    Kernel K3 (extprod_grouped_fused, its plain version on the CPU) with
    G = 1 and n_d = 1, the polys as its per-lane GGSW rows over all 8 limb
    planes: exact, and no negacirculant is formed. One launch for as many
    lanes as K3's limits take (at O·R·8·2N operand bytes a lane).
    """
    from tfhe_aes2_tpu_torch.ops.kernels import extprod

    b, r, o, n = polys.shape
    if digits.shape != (r, n):
        raise ValueError(f"digits {tuple(digits.shape)} do not match polys "
                         f"{tuple(polys.shape)}")
    if digits.dtype != torch.int8:
        raise ValueError(f"digits must be int8, got {digits.dtype}")
    step = min(_K3_LANES, (_K3_OPERAND_BYTES - 1) // (o * r * 8 * 2 * n))
    outs = []
    for s in range(0, max(b, 1), step):
        part = polys[s:s + step]
        ext = extprod.split_polys_ext(part)               # [8, b, R, O, 2N]
        ext = ext.permute(1, 3, 2, 0, 4).contiguous()     # [b, O, R, 8, 2N]
        dig = digits[None, :, None, :].expand(part.shape[0], r, 1, n)
        outs.append(extprod.extprod_grouped_fused(dig.contiguous(), ext, 1,
                                                  0)[:, :, 0])
    return outs[0] if len(outs) == 1 else torch.cat(outs)
