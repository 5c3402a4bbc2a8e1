"""Exact negacyclic CRT-NTT external product of the vertical packing.

The port of tfhe_aes2_tpu/ops/ntt.py, with its contract: the CMux stages'
product of gadget digits against a lane's GGSW selector rows, computed
through transforms against SHARED constant matrices over four 14-bit
primes instead of per-lane negacirculants (K3):

    forward   X_p = x @ W_p (mod p)      W_p[j, m] = psi^j omega^{jm}
              (the negacyclic twist psi folds into the constant matrix)
    weights   E_p = Σ_j (2^{8j} mod p) · E_{j,p}  — the selector's limb
              planes combine in frequency, once per prime
    pointwise P_p[b,g,o,m] = Σ_r D_p[b,g,r,m] · E_p[b,o,r,m]  (mod p)
    inverse   out_p = P_p @ Winv_p (mod p); CRT-4 (Garner) -> the signed
              integer -> wrapped mod 2^64 -> shifted by 2^{8 js}.

The prime product 12289·13313·15361·18433 ≈ 2^54.6 covers the signed
value, bounded by R·N·2^12·2^7·(1+2^8+2^16+2^24) < 2^53 for R <= 5, N <=
512, |digit| <= 2^12 and at most 4 kept planes: the guards below raise
ValueError outside them (the JAX package asserts). At N = 1024 only 12289
has a 2048-th root of unity, and _find_psi raises its ValueError as there.

The transforms are float64 matrix products (torch.matmul: one DGEMM for
the four primes' forward transforms, one batched for the inverse), where
the JAX package takes four int8 dots a transform. They are exact: every
partial sum is an integer below 2^53, whatever the order of summation —
the forward transform sums N <= 512 products of |x| < 2^13 and W < 2^15,
below 2^37; the inverse N products of |P| <= p/2 < 2^14 and Winv < 2^15,
below 2^38. The reductions are exact int64 remainders (balanced, as the
JAX package's Barrett step gives them), Garner's reconstruction int64
below 2^63. No hand-written kernel: the JAX package computes this outside
any Pallas kernel too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PRIMES = (12289, 13313, 15361, 18433)   # p = 1 (mod 2N) for N <= 512
MAX_DIGIT = 1 << 12                      # the prime product's guards
MAX_PLANES = 4
MAX_ROWS = 5


def _find_psi(p: int, two_n: int) -> int:
    for g in range(2, p):
        if pow(g, (p - 1) // 2, p) != 1:
            psi = pow(g, (p - 1) // two_n, p)
            if pow(psi, two_n // 2, p) == p - 1:
                return psi
    raise ValueError(f"no primitive {two_n}-th root mod {p}")


def refusal(n: int) -> str | None:
    """Why the NTT cannot run at polynomial size n (the _find_psi error
    of the first prime without a 2n-th root), or None."""
    try:
        for p in PRIMES:
            _find_psi(p, 2 * n)
    except ValueError as ex:
        return f"the CRT-NTT at N={n}: {ex}"
    return None


@functools.lru_cache(maxsize=None)
def _mats_np(n: int, p: int):
    """(W, Winv) [N, N] int64 in [0, p): twisted negacyclic DFT matrices."""
    psi = _find_psi(p, 2 * n)
    omega = psi * psi % p
    om = np.array([pow(omega, x, p) for x in range(n)], np.int64)
    j = np.arange(n)
    jm = (j[:, None] * j[None, :]) % n
    tw = np.array([pow(psi, int(x), p) for x in j], np.int64)
    w = om[jm] * tw[:, None] % p
    ninv = pow(n, p - 2, p)
    psi_inv = pow(psi, p - 2, p)
    omi = np.array([pow(pow(omega, p - 2, p), x, p) for x in range(n)],
                   np.int64)
    tw_inv = np.array([pow(psi_inv, int(x), p) for x in j], np.int64)
    winv = omi[jm] * tw_inv[None, :] % p * ninv % p
    return w, winv


@functools.lru_cache(maxsize=None)
def _mats(n: int, device: torch.device):
    """float64 on `device`: the four forward matrices side by side [N, 4N]
    and the inverse ones stacked [4, N, N]."""
    mats = [_mats_np(n, p) for p in PRIMES]
    fwd = np.concatenate([w for w, _ in mats], axis=1)
    inv = np.stack([winv for _, winv in mats])
    return (torch.from_numpy(fwd.astype(np.float64)).to(device),
            torch.from_numpy(inv.astype(np.float64)).to(device))


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    """int64 on `device`: the primes [4] and the plane weights
    2^(8j) mod p [4, 8] (made once, so no call copies from the host)."""
    weights = [[(1 << (8 * j)) % p for j in range(8)] for p in PRIMES]
    return (torch.tensor(PRIMES, dtype=torch.int64, device=device),
            torch.tensor(weights, dtype=torch.int64, device=device))


def _primes(ndim: int, device) -> torch.Tensor:
    """The primes as an int64 [4, 1, ..., 1] of `ndim` dimensions."""
    return _consts(torch.device(device))[0].reshape((4,) + (1,) * (ndim - 1))


def _reduce(x: torch.Tensor, p) -> torch.Tensor:
    """Exact x mod p into the balanced (-p/2, p/2] of int64 x (p an int
    or a tensor broadcast against x)."""
    r = torch.remainder(x, p)
    return torch.where(r > p // 2, r - p, r)


def _forward(x: torch.Tensor) -> torch.Tensor:
    """x [..., N] integers, |x| < 2^13 -> [4, ..., N] balanced residues of
    the four primes' forward transforms."""
    n = x.shape[-1]
    fwd, _ = _mats(n, x.device)
    y = torch.matmul(x.to(torch.float64), fwd).to(torch.int64)
    y = y.reshape(x.shape[:-1] + (4, n)).movedim(-2, 0)
    return _reduce(y, _primes(y.ndim, y.device))


def _inverse(x: torch.Tensor) -> torch.Tensor:
    """[4, ..., N] balanced residues -> the inverse transforms, balanced."""
    n = x.shape[-1]
    _, inv = _mats(n, x.device)
    flat = x.reshape(4, -1, n).to(torch.float64)
    y = torch.bmm(flat, inv).to(torch.int64).reshape(x.shape)
    return _reduce(y, _primes(y.ndim, y.device))


def _garner(residues: torch.Tensor) -> torch.Tensor:
    """CRT residues [4, ...] (balanced, one row a prime) -> the signed
    value as int64 torus bits (wrapped mod 2^64), |v| < P/2.

    Garner's mixed-radix reconstruction, every term below 2^63."""
    p1, p2, p3, p4 = PRIMES
    r = torch.where(residues < 0, residues + _primes(residues.ndim,
                                                     residues.device),
                    residues)
    inv12 = pow(p1, p2 - 2, p2)
    inv13 = pow(p1 * p2 % p3, p3 - 2, p3)
    inv14 = pow(p1 * p2 * p3 % p4, p4 - 2, p4)
    c2 = (r[1] - r[0]) % p2 * inv12 % p2
    x12 = r[0] + c2 * p1                          # < p1·p2 ~ 2^27.3
    c3 = (r[2] - x12 % p3) % p3 * inv13 % p3
    x123 = x12 + c3 * (p1 * p2)                   # < 2^41
    c4 = (r[3] - x123 % p4) % p4 * inv14 % p4
    x = x123 + c4 * (p1 * p2 * p3)                # < P ~ 2^54.6
    big = p1 * p2 * p3 * p4
    return torch.where(x > big // 2, x - big, x)


def polymul_digits_ntt_grouped(digits: torch.Tensor, ext_planes: torch.Tensor,
                               d_bound: int, j_start: int = 0) -> torch.Tensor:
    """NTT lowering of the vertical packing's grouped product (the
    contract of tfhe_aes2_tpu/ops/ntt.py and of K8's operands).

    digits:     [B, G, R, N] integer gadget digits, |d| <= d_bound <= 2^12
    ext_planes: [8-j_start, B, R, O, 2N] int8 limb planes of the negacyclic
                extensions, the lowest j_start dropped; only the first N
                columns (the polynomials themselves) are read
    -> [B, G, O, N] int64 torus, exact mod 2^64 over the kept planes.
    """
    n_j, b, r, o, two_n = ext_planes.shape
    n = two_n // 2
    if d_bound > MAX_DIGIT or n_j > MAX_PLANES or r > MAX_ROWS:
        raise ValueError(
            f"the CRT-NTT covers |digit| <= {MAX_DIGIT}, at most "
            f"{MAX_PLANES} planes and {MAX_ROWS} rows: got d_bound "
            f"{d_bound}, {n_j} planes, {r} rows")
    if digits.shape[0] != b or digits.shape[2:] != (r, n):
        raise ValueError(f"digits {tuple(digits.shape)} do not fit planes "
                         f"{tuple(ext_planes.shape)}")
    for p in PRIMES:
        _mats_np(n, p)                   # raises at N = 1024, as there
    ext = ext_planes[..., :n].permute(1, 3, 2, 0, 4)     # [B, O, R, n_j, N]
    primes = _primes(5, digits.device)
    dp = _forward(digits)                                # [4, B, G, R, N]
    ep = _forward(ext)                                   # [4, B, O, R, n_j, N]
    wts = _consts(digits.device)[1][:, :n_j]
    ew = _reduce((ep * wts[:, None, None, None, :, None]).sum(-2),
                 primes)                                 # [4, B, O, R, N]
    pw = None
    for ri in range(r):                                  # [4, B, G, O, N]
        term = dp[:, :, :, None, ri] * ew[:, :, None, :, ri]
        pw = term if pw is None else pw + term
    val = _garner(_inverse(_reduce(pw, primes)))         # [B, G, O, N]
    return val << (8 * j_start)
