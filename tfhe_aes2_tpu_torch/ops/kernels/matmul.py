"""K4: the exact limb-plane contraction (keyswitch, pfKS) and its plain version.

`fused_limb_matmul` replaces the Pallas kernel
tfhe_aes2_tpu/ops/pallas/matmul.py::fused_limb_matmul (source csrc/matmul.cu)
and takes every shape. At PARAMS_SQRD_LVL_64 it is bound by int8
operations for the pfKS (~2.4e11 multiply-adds at 256 lanes) and by the key
planes' bytes for the keyswitch and at small batches. The kernel runs its products on the int8
tensor cores (mma.sync.m16n8k32, 96 x 64 output tiles, int32 weight
buckets folded into uint64 at the end) from K-major operands copied by a
4-stage cp.async ring, and splits K across blocks when the output has too
few tiles to fill the card; the TPU's MXU tile-eligibility rules and K
tiling for Mosaic's compile time have no counterpart. The key planes are
read K-major (`kmajor_key_planes`), the layout of the prepared keys. Digits
take one to four int8 limbs (four: lvl1's pfKS gadget (1, 24)).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. `launches` counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch

from tfhe_aes2_tpu_torch.ops.kernels import build


def fused_limb_matmul_plain(d_planes: torch.Tensor, m_planes: torch.Tensor,
                            j_start: int) -> torch.Tensor:
    """int64 [B, N] = Σ_{i,j} 2^(8(i+j)) d_planes[i] @ m_planes[j] mod 2^64.

    Float64 is exact below 2^53: the recombined digit is below 2^(8·n_d - 1)
    in magnitude, a key-plane entry at most 2^7, and K terms add log2(K) bits
    (2^23 · 2^7 · 2^13 = 2^43 for the pfKS at PARAMS_SQRD_LVL_64)."""
    n_d, b, k = d_planes.shape
    if (8 * n_d - 1) + 7 + k.bit_length() >= 53:
        raise ValueError("contraction too long for exact float64")
    d = sum(d_planes[i].to(torch.float64) * float(1 << (8 * i))
            for i in range(n_d))
    out = torch.zeros((b, m_planes.shape[2]), dtype=torch.int64,
                      device=d_planes.device)
    for jj in range(m_planes.shape[0]):
        prod = (d @ m_planes[jj].to(torch.float64)).to(torch.int64)
        out += prod << (8 * (j_start + jj))
    return out


TILE_B, TILE_N, SLICE_K = 96, 64, 64     # csrc/matmul.cu: BM, BN, KT
SMS = 132                                 # SMs of an H100 SXM


def _round16(k: int) -> int:
    return -(-k // 16) * 16


def kmajor_key_planes(m_planes: torch.Tensor) -> torch.Tensor:
    """int8 [nj, K, N] -> the same values as a [nj, K, N] view of K-major
    storage [nj, N, ldm], ldm = K rounded up to 16 with a zero tail: the
    layout csrc/matmul.cu reads (16-byte copies of consecutive k). The
    prepared keys are kept so (ops/keys.py); any other key is laid out so
    on each call."""
    nj, k, n = m_planes.shape
    store = m_planes.new_zeros((nj, n, _round16(k)))
    store[:, :, :k] = m_planes.transpose(1, 2)
    return store[:, :, :k].transpose(1, 2)


def _kmajor_ld(m: torch.Tensor):
    """The row stride ldm of a kmajor_key_planes view, or None for any
    other layout."""
    nj, k, n = m.shape
    s0, s1, s2 = m.stride()
    if (s1 == 1 and s2 % 16 == 0 and s2 >= k and s0 == n * s2
            and m.data_ptr() % 16 == 0):
        return s2
    return None


def _splits(b: int, k: int, n: int) -> int:
    """Blocks that share one output tile's contraction (csrc/matmul.cu):
    enough to give each of the card's SMs a block when the output has fewer
    tiles than SMs (the keyswitch: 3 x 11 tiles at 288 lanes), each block
    keeping at least 8 slices of K."""
    tiles = -(-b // TILE_B) * -(-n // TILE_N)
    return max(1, min(SMS // tiles, -(-k // SLICE_K) // 8))


def fused_limb_matmul(d_planes: torch.Tensor, m_planes: torch.Tensor,
                      j_start: int = 0) -> torch.Tensor:
    """K4. d_planes int8 [n_d, B, K] (limb planes of gadget digits);
    m_planes int8 [8 - j_start, K, N] (limb planes of the key, planes below
    j_start dropped; fastest as a kmajor_key_planes view) -> int64 [B, N]."""
    n_d, b, k = d_planes.shape
    nj, k2, n = m_planes.shape
    if k2 != k or nj != 8 - j_start:
        raise ValueError(f"fused_limb_matmul: shapes {tuple(d_planes.shape)} "
                         f"x {tuple(m_planes.shape)}, j_start={j_start}")
    if d_planes.device.type == "cpu" and m_planes.device.type == "cpu":
        return fused_limb_matmul_plain(d_planes, m_planes, j_start)
    if not 1 <= n_d <= 4 or not 0 <= j_start <= 7:
        raise ValueError(f"fused_limb_matmul: n_d={n_d}, j_start={j_start} "
                         "unsupported")
    # int32 weight buckets: at most n_d products of K terms of 2^7·2^7
    if n_d * k * (1 << 14) >= 1 << 31:
        raise ValueError("fused_limb_matmul: contraction too long for int32")
    for t in (d_planes, m_planes):
        if (t.device.type != "cuda" or t.device != d_planes.device
                or t.dtype != torch.int8):
            raise ValueError("fused_limb_matmul: operands must be int8 "
                             "tensors on one CUDA device")
    ldm = _kmajor_ld(m_planes)
    if ldm is None:
        m_planes = kmajor_key_planes(m_planes)
        ldm = m_planes.stride(2)
    # the kernel copies digit rows 16 bytes at a time: pad K to 16 with zeros
    ldd = _round16(k)
    if ldd != k or not d_planes.is_contiguous() or d_planes.data_ptr() % 16:
        d_pad = d_planes.new_zeros((n_d, b, ldd))
        d_pad[..., :k] = d_planes
        d_planes = d_pad
    splits = _splits(b, k, n)
    out = (torch.zeros if splits > 1 else torch.empty)(
        (b, n), dtype=torch.int64, device=d_planes.device)
    f = build.library("matmul").tfhe_fused_limb_matmul
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    rc = f(d_planes.data_ptr(), m_planes.data_ptr(), out.data_ptr(), b, k, n,
           ldd, ldm, splits, n_d, j_start, build.stream_ptr(d_planes.device))
    build.check(rc, "fused_limb_matmul")
    fused_limb_matmul.launches += 1
    return out


fused_limb_matmul.launches = 0
