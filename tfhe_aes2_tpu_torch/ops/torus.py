"""Exact 2^64-torus arithmetic on torch.int64.

Torus elements are int64 tensors: two's-complement add, sub and multiply wrap
mod 2^64, and the bits view unchanged to and from numpy uint64
(`to_tensor` / `to_numpy`). One thing differs from uint64 and is handled
where it matters: `>>` is arithmetic, so a logical shift masks the sign
fill (`srl`). No unsigned compare is needed: carries and borrows never
appear outside the CUDA kernels, which work on uint64.

Every large contraction is evaluated exactly with balanced signed base-256
limb planes (int8): x ≡ Σ_i l_i·256^i (mod 2^64), l_i ∈ [-128, 128), computed
branch-free by adding 0x8080..80 and taking bytes. `exact_matmul` routes the
digit × key-plane contraction to the hand-written kernel K4
(ops/kernels/matmul.py).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

_U64_MASK = (1 << 64) - 1

# device_const's cache, least recently used first: (device, dtype, numpy
# dtype, shape, bytes) -> the tensor on that device. Bounded in entries and
# in bytes an entry; shared by every context of the process, which is safe
# because a key holds the whole content.
CONST_MAX_ENTRIES = 256
CONST_MAX_BYTES = 1 << 18
_CONSTS: OrderedDict = OrderedDict()
_CONSTS_LOCK = threading.Lock()


def wrap(v: int) -> int:
    """Python int -> the int64 value with the same low 64 bits."""
    v &= _U64_MASK
    return v - (1 << 64) if v >= 1 << 63 else v


def to_tensor(x, device) -> torch.Tensor:
    """numpy uint64 (or any integer array) -> a new int64 tensor, same bits
    (never sharing memory with x)."""
    arr = np.ascontiguousarray(np.asarray(x, dtype=np.uint64))
    return torch.from_numpy(arr.view(np.int64)).to(device, copy=True)


def device_const(x, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A small constant host array (LUTs, lane indices, clear bits) on
    `device`, copied there once.

    Returns the values of torch.as_tensor(x, dtype=dtype, device=device),
    uint64 taken as int64 with the same bits (to_tensor). A host-to-device
    copy waits for the stream to drain, so the host loses its lead on the
    device; here each (device, dtype, shape, content) is copied on its first
    call only, and later calls return the cached tensor. The key is the
    array's bytes, so a hit always holds the values asked for. At most
    CONST_MAX_ENTRIES tensors are kept, least recently used out first; an
    array over CONST_MAX_BYTES is copied and not kept. The tensor is shared:
    callers only read it. `device_const.uploads` counts the copies,
    `device_const.hits` the cached returns.
    """
    arr = np.ascontiguousarray(x)
    if arr.dtype == np.uint64:
        arr = arr.view(np.int64)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device, dtype, arr.dtype.str, arr.shape, arr.tobytes())
    with _CONSTS_LOCK:
        hit = _CONSTS.get(key)
        if hit is not None:
            _CONSTS.move_to_end(key)
            device_const.hits += 1
            return hit
        device_const.uploads += 1
    t = torch.from_numpy(arr.copy()).to(device=device, dtype=dtype)
    if arr.nbytes <= CONST_MAX_BYTES:
        with _CONSTS_LOCK:
            _CONSTS[key] = t
            while len(_CONSTS) > CONST_MAX_ENTRIES:
                _CONSTS.popitem(last=False)
    return t


device_const.uploads = 0
device_const.hits = 0


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64, same bits."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint64)


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 torus values by a static k in [0, 64)."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def encode_bit(bits: torch.Tensor) -> torch.Tensor:
    """bit -> torus encoding at 2^63."""
    return bits.to(torch.int64) << 63


def split_u64_signed(x: torch.Tensor) -> torch.Tensor:
    """int64 torus tensor [...] -> balanced int8 limb planes [8, ...] with
    Σ_i planes[i]·2^(8i) ≡ x (mod 2^64), planes[i] ∈ [-128, 128)."""
    y = x + wrap(sum(1 << (7 + 8 * i) for i in range(8)))
    return torch.stack([(((y >> (8 * i)) & 0xFF) - 128).to(torch.int8)
                        for i in range(8)])


def split_int32_signed(d: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """int32 tensor [...] with |d| < 2^(8·n_limbs - 1) -> int8 planes
    [n_limbs, ...], balanced base-256; the top limb absorbs the sign."""
    y = d.to(torch.int32) + sum(128 << (8 * i) for i in range(n_limbs - 1))
    planes = []
    for i in range(n_limbs):
        if i < n_limbs - 1:
            p = ((y >> (8 * i)) & 0xFF) - 128
        else:
            p = y >> (8 * i)          # arithmetic shift keeps the sign
        planes.append(p.to(torch.int8))
    return torch.stack(planes)


def limbs_for_bound(bound: int) -> int:
    """Number of balanced base-256 limbs for |d| <= bound (bound < 2^(8L-1))."""
    n = 1
    while bound >= (1 << (8 * n - 1)):
        n += 1
    return n


def exact_matmul(d: torch.Tensor, m_planes: torch.Tensor, d_bound: int,
                 max_k: int, m_j_start: int = 0) -> torch.Tensor:
    """Exact wrapping contraction out[b, o] = Σ_k d[b, k]·m[k, o] mod 2^64.

    d: integer digits [B, K] with |d| <= d_bound; m_planes: the int8 limb
    planes [8 - m_j_start, K, O] of the int64 operand, planes below
    m_j_start dropped (noise-floor truncation, ops/truncation.py).
    Returns int64 [B, O] from kernel K4 (its plain version on the CPU).
    """
    from tfhe_aes2_tpu_torch.ops.kernels import matmul as kmm

    n_d = limbs_for_bound(d_bound)
    if m_planes.shape[0] != 8 - m_j_start:
        raise ValueError(f"m planes {m_planes.shape[0]} != 8 - j_start "
                         f"{m_j_start}")
    # int32 overflow guard of the kernel's per-bucket sums:
    # n_terms * K * 127 * 127 < 2^31 (at most min(n_d, 8) digit planes
    # land in one weight bucket)
    if min(n_d, 8) * max_k * 127 * 127 >= 2 ** 31:
        raise ValueError("contraction too long for int32 accumulation")
    d_planes = split_int32_signed(d, n_d).contiguous()
    return kmm.fused_limb_matmul(d_planes, m_planes, m_j_start)
