"""K4: the exact limb-plane contraction (keyswitch, pfKS) and its plain version.

`fused_limb_matmul` replaces the Pallas kernel
tfhe_aes2_tpu/ops/pallas/matmul.py::fused_limb_matmul (source csrc/matmul.cu)
and takes every shape, so the prepared keys carry no padding. At
PARAMS_SQRD_LVL_64 it is bound by int8 operations for the pfKS
(~2.4e11 multiply-adds at 256 lanes) and by the key planes' bytes for the
keyswitch at small batches. The kernel is a plain shared-memory tiled GEMM
with one __dp4a per inner step and int32 weight buckets folded into uint64
at the end; the TPU's MXU tile-eligibility rules and K tiling for Mosaic's
compile time have no counterpart.

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


def fused_limb_matmul(d_planes: torch.Tensor, m_planes: torch.Tensor,
                      j_start: int = 0) -> torch.Tensor:
    """K4. d_planes int8 [n_d, B, K] (limb planes of gadget digits);
    m_planes int8 [8 - j_start, K, N] (limb planes of the key, planes below
    j_start dropped) -> int64 [B, N]."""
    n_d, b, k = d_planes.shape
    nj, k2, n = m_planes.shape
    if k2 != k or nj != 8 - j_start:
        raise ValueError(f"fused_limb_matmul: shapes {tuple(d_planes.shape)} "
                         f"x {tuple(m_planes.shape)}, j_start={j_start}")
    if d_planes.device.type == "cpu" and m_planes.device.type == "cpu":
        return fused_limb_matmul_plain(d_planes, m_planes, j_start)
    if not 1 <= n_d <= 3 or not 0 <= j_start <= 7:
        raise ValueError(f"fused_limb_matmul: n_d={n_d}, j_start={j_start} "
                         "unsupported")
    # int32 weight buckets: at most n_d products of K terms of 2^7·2^7
    if n_d * k * (1 << 14) >= 1 << 31:
        raise ValueError("fused_limb_matmul: contraction too long for int32")
    for t in (d_planes, m_planes):
        if (t.device.type != "cuda" or t.device != d_planes.device
                or t.dtype != torch.int8 or not t.is_contiguous()):
            raise ValueError("fused_limb_matmul: operands must be contiguous "
                             "int8 tensors on one CUDA device")
    out = torch.empty((b, n), dtype=torch.int64, device=d_planes.device)
    f = build.library("matmul").tfhe_fused_limb_matmul
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    rc = f(d_planes.data_ptr(), m_planes.data_ptr(), out.data_ptr(), b, k, n,
           n_d, j_start, build.stream_ptr(d_planes.device))
    build.check(rc, "fused_limb_matmul")
    fused_limb_matmul.launches += 1
    return out


fused_limb_matmul.launches = 0
