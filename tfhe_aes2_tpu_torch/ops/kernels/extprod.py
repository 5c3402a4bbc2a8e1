"""K1-K3, K5-K11: the negacirculant external-product kernels and their plain
versions.

K1 `extprod_step2g` — one whole blind-rotate CMux step (dots + recombine +
   the next step's glue). Replaces the Pallas kernel
   tfhe_aes2_tpu/ops/pallas/extprod.py::extprod_step2g; source csrc/cmux.cu,
   and at N = 512 and 1024 csrc/cmux_wg.cu (the same step on `wgmma` over
   32-lane tiles, `k1_path`).
K2 `rot_diff_digits` — the glue alone, for step 0. Replaces
   extprod.py::rot_diff_digits; source csrc/cmux.cu (nc::glue_wide of
   csrc/nc_common.cuh: a thread owns 8 consecutive columns of one row).
K3 `extprod_grouped_fused` — the vertical-packing external product (one
   selector GGSW per lane, shared by its G accumulators). Replaces
   extprod.py::extprod_grouped_fused; source csrc/vp.cu.
K5 `extprod_step2` — K1 without the glue: dots + recombine into the
   accumulator in place, so that K2 + K5 is K1 taken apart (K1's kernel
   built without its glue). Replaces extprod.py::extprod_step2; source
   csrc/cmux.cu.
K6 `extprod_step` — the same update on batch-major layouts (glue done
   outside the kernel), into a new tensor. Replaces extprod.py::extprod_step;
   source csrc/step.cu.
K7 `extprod_partials` — the shared-key product over all 8 key planes as raw
   int32 sums per weight 2^(8s). Replaces extprod.py::extprod_partials;
   source csrc/step.cu (K6's kernel, built to store its buckets).
K8 `extprod_partials_grouped` — the per-lane product of the vertical packing
   as raw int32 sums. Replaces extprod.py::extprod_partials_grouped; source
   csrc/vp.cu (K3's kernel, built to store its buckets).
K9 `cmux_step_merged` — one whole CMux step in one launch (glue of all
   components, digits kept in shared memory, dots + recombine), into a new
   accumulator; at N = 1024 the 2·O blocks of a lane tile are one cluster
   that shares the glue out and copies each row's digits between its
   blocks' shared memory. Replaces extprod.py::cmux_step_merged; sources
   csrc/merged.cu (N <= 512) and csrc/merged_wide.cu (N = 1024).
K10a `rot_diff_digits_flat` — K2's glue in the row-flattened layout
   [n_d, B, R·N]. Replaces extprod.py::rot_diff_digits_flat; source
   csrc/longk.cu (K2's nc::glue_wide with K10a's output strides).
K10b `extprod_step_longk` — the CMux update on K10a's flat digits, one
   length-R·N contraction per lane, in place; its R rows split across
   blocks where that fills the card's waves better (`_longk_splits`). Replaces
   extprod.py::extprod_step_longk; source csrc/longk.cu.
K11 `extprod_step3` — the CMux update one weight bucket at a time, the
   buckets added into the accumulator in place. Replaces
   extprod.py::extprod_step3; source csrc/bucket.cu.

What bounds them on the H100 is int8 operations (K1 at 256 lanes: ~5.5e10
multiply-adds a step on ~15 MB of operands). Every kernel reads the
negacirculant from shared-memory S-tables that index the 2N-byte ext row,
so it (146 GB for the expanded BSK) never exists; the TPU's packed ladders,
weight buckets in VMEM and sequential (n_bt, o, r) grid have no counterpart
— a block owns ROWS lanes × all N columns of one component (at N = 1024
512 of them, two blocks a row tile; K9's 2·O blocks of a lane tile one
cluster for their glue) and loops over r itself. Every kernel takes
N <= N_MAX on the card. Every kernel with products (K1, K3, K5-K9, K10b,
K11) puts them on the tensor cores: `mma.sync.m16n8k32` int8 whose operand
fragments are S-table and digit-tile words, the operands staged by
`cp.async` one contraction row ahead (csrc/nc_mma.cuh); what is left above
their bound is the instruction rate of `mma.sync` at N = 8 and, in K9, the
glue. K1 at N = 512 and 1024 runs `wgmma.m64n32k32` instead, its A
fragments S-table words and its B a 32-lane digit tile in shared memory
(csrc/nc_wgmma.cuh).
(K3's and K8's 8 instruction columns are 8 of a lane's G accumulators;
K11's blocks each keep one weight bucket.) K2 and K10a are bound by bytes:
one wide pass, a thread for every 8 columns of an accumulator row
(csrc/nc_common.cuh).

Layouts (int64 torus values; the TPU's (lo, hi) u32 pairs do not exist):
  dig    int8  [k+1, L, n_d, B, N]   digit limb planes, row r = u·L + l
  ext_or int8  [O, R, 8-js, 2N]      one BSK entry's limb planes of [p, -p]
  acc    int64 [O, B, N]             the component-major accumulator
K6-K8 keep the TPU kernels' batch-major operand layouts (each wrapper's
docstring), read by the kernels through their own strides; only the key
operands of K6 and K10b differ: each is ext_or, the prepared BSK entry, not
a transposed key.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. `launches` counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch

from tfhe_aes2_tpu_torch.ops import decomposition, ntt, polynomial, torus
from tfhe_aes2_tpu_torch.ops.kernels import build
from tfhe_aes2_tpu_torch.ops.kernels.matmul import SMS
from tfhe_aes2_tpu_torch.ops.lowering import Lowering

_P = ctypes.c_void_p
_I = ctypes.c_int


_fns: dict = {}


def _fn(stem: str, name: str, argtypes):
    """The C entry point `name` of library `stem`, prepared once."""
    f = _fns.get((stem, name))
    if f is None:
        f = getattr(build.library(stem), name)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _fns[stem, name] = f
    return f


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _require_cuda(name: str, spec) -> None:
    """spec: [(tensor, dtype)]. All on one CUDA device, contiguous."""
    dev = spec[0][0].device
    for t, dtype in spec:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must all lie on one CUDA "
                             f"device (got {t.device} and {dev})")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


# The largest polynomial size N every kernel takes on a CUDA device: 1024,
# where a block owns at most 512 output columns and two blocks share a row
# tile (K3, K5-K9, K10b, K11: csrc/nc_mma.cuh's column offset; K9's glue
# across a cluster of a lane tile's 2·O blocks), K1 on wgmma's 8 blocks of
# 128 columns are one cluster (csrc/cmux_wg.cu), or a block owns a row (K2,
# K10a). device_refusal reads it, so a set above it is refused before keygen.
N_MAX = 1024

# The kernel wrappers of this module, whose launch counters the tests and
# csrc/probes/model_scale.py read.
WRAPPERS = ("extprod_step2g", "rot_diff_digits", "extprod_grouped_fused",
            "extprod_step2", "extprod_partials_grouped", "extprod_step",
            "extprod_partials", "cmux_step_merged", "rot_diff_digits_flat",
            "extprod_step_longk", "extprod_step3")


def _column_blocks(n: int) -> int:
    """Blocks that share one row tile's output columns in the tensor-core
    kernels: a block owns at most 512 (csrc/nc_mma.cuh's SPLIT_COLS)."""
    return max(1, n // 512)


# The n_d values K3 and K8 are built for at N = 1024 (VP_SPLIT_DISPATCH,
# csrc/vp.cu): the circuit bootstrap's digit limbs in PARAMS_WOPPBS_8BIT
# (1) and in lvl1, lvl4 and lvl256 (2). The split builds are what
# WIDE_ND_KERNELS launch there; any other n_d is refused.
WIDE_ND = frozenset({1, 2})
WIDE_ND_KERNELS = ("extprod_grouped_fused", "extprod_partials_grouped")


def device_refusal(n: int, device, lowering: Lowering,
                   vp_js: int | None = None) -> str | None:
    """Why a parameter set of polynomial size n whose vertical packing drops
    vp_js selector planes cannot run on `device` under `lowering`, or None.
    Under lowering.ntt, where the set takes the CRT-NTT (lowering.vp_ntt)
    the NTT must have its roots of unity at N = n, on any device: at
    N = 1024 with 4 planes (lvl1, lvl4) it has not, and the JAX package
    raises. On a CUDA device n must be at most N_MAX, which every kernel
    takes; on the CPU the plain versions take any N. Every set of
    ops/params.py (N <= 1024) runs on the card under every lowering without
    ntt."""
    if vp_js is not None and lowering.vp_ntt(vp_js):
        why = ntt.refusal(n)
        if why:
            return (f"{why} (TFHE_VP_NTT=1 takes the NTT where the "
                    f"selectors keep {8 - vp_js} <= {ntt.MAX_PLANES} limb "
                    "planes, as in the JAX package)")
    if torch.device(device).type != "cuda" or n <= N_MAX:
        return None
    return (f"polynomial_size {n} is above what lowering (br="
            f"{lowering.br}, vp={lowering.vp}) takes on the card: its "
            f"kernels {', '.join(lowering.kernels(vp_js))} take N <= "
            f"{N_MAX} (on device 'cpu' the plain versions run it)")


def _check_geometry(name: str, n: int, n_d: int, r: int, j_start: int,
                    n_min: int = 8):
    """N a power of two from n_min up to N_MAX. n_min: 8 for
    the glue (K2, K10a), whose threads each own 8 consecutive columns of a
    row; 64 for the tensor-core kernels (K1, K3, K5-K9, K10b, K11), whose
    warps own 64 columns each and index their S-tables unmasked."""
    if n & (n - 1) or not n_min <= n <= N_MAX:
        raise ValueError(f"{name}: N={n} must be a power of two in "
                         f"[{n_min}, {N_MAX}]")
    if not 1 <= n_d <= 3 or not 0 <= j_start <= 7:
        raise ValueError(f"{name}: n_d={n_d}, j_start={j_start} unsupported")
    if n > 512 and name in WIDE_ND_KERNELS and n_d not in WIDE_ND:
        raise ValueError(f"{name}: at N={n} built for n_d in "
                         f"{sorted(WIDE_ND)} only, got n_d={n_d}")
    # int32 weight buckets: at most n_d (i, j) pairs of R·N products of
    # at most 2^7·2^7 each (csrc/nc_common.cuh)
    if n_d * r * n * (1 << 14) >= 1 << 31:
        raise ValueError(f"{name}: contraction too long for int32 buckets")


SMEM_LIMIT = 232448      # bytes of shared memory a block may take on sm_90


def _check_smem(name: str, nbytes: int) -> None:
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"{name}: a block would need {nbytes} bytes of "
                         f"shared memory (limit {SMEM_LIMIT})")


def _mma_stage_bytes(n: int, nj: int) -> int:
    """Two stages of S-tables and raw key rows (csrc/nc_mma.cuh)."""
    return 2 * (nj * 2 * n * 4 + nj * 2 * n)


def _mma_dig_tile_bytes(n: int, n_d: int) -> int:
    """One contraction row's digit tile, each row padded by 16 bytes."""
    return n_d * 8 * (n + 16)


def _k1_smem(n: int, nj: int, n_d: int) -> int:
    """K1 on mma.sync's block (csrc/cmux.cu, N <= 512): the two stages of
    the contraction (the whole 2N-word S-tables and 2N-byte digit rows), or
    the [8][N] int64 tile of the new accumulator its glue reads after them,
    whichever is larger."""
    return max(_mma_stage_bytes(n, nj) + 2 * _mma_dig_tile_bytes(n, n_d),
               8 * n * 8)


def _check_staged(name: str, *tensors) -> None:
    """Operands that csrc/nc_mma.cuh stages by cp.async: 16 bytes at a time,
    through 32-bit byte strides."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
        if t.numel() >= 1 << 31:
            raise ValueError(f"{name}: an int8 operand of {t.numel()} bytes "
                             f"is past the kernel's 32-bit strides")


# ----------------------------------------------------------------- K2 glue

def rot_diff_digits_plain(acc: torch.Tensor, t: torch.Tensor, base_log: int,
                          levels: int, n_d: int) -> torch.Tensor:
    """Digit limb planes of X^t·acc - acc: acc int64 [O, B, N], t [B] in
    [0, 2N) -> int8 [O, L, n_d, B, N]."""
    rot = polynomial.monomial_mul(acc, t[None, :])
    digits = decomposition.decompose(rot - acc, base_log, levels)  # [O,B,N,L]
    planes = torus.split_int32_signed(digits, n_d)           # [n_d,O,B,N,L]
    return planes.permute(1, 4, 0, 2, 3).contiguous()


# The (levels, base_log) gadgets the glue kernels K2 and K10a are built for
# (NC_GLUE_GADGETS, csrc/nc_common.cuh): the blind rotation's of every set
# in ops/params.py and models/shortint_1bit.py, and (2, 12).
GLUE_GADGETS = frozenset({(2, 12), (2, 15), (3, 12), (4, 9), (6, 7),
                          (7, 6)})


def _check_glue(name: str, acc, t, n: int, n_d: int, levels: int,
                base_log: int) -> None:
    """The glue kernels' (K2, K10a) checks before a launch: geometry (a
    block of K2 holds 1024/N whole rows, one at N = 1024), a gadget they are
    built for, CUDA operands, acc 16-byte aligned (its words are read 16
    bytes at a time)."""
    _check_geometry(name, n, n_d, 1, 0)
    if (levels, base_log) not in GLUE_GADGETS:
        raise ValueError(f"{name}: the kernel is not built for "
                         f"levels={levels}, base_log={base_log} (built: "
                         f"{sorted(GLUE_GADGETS)})")
    _require_cuda(name, [(acc, torch.int64), (t, torch.int32)])
    if acc.data_ptr() % 16:
        raise ValueError(f"{name}: acc must be 16-byte aligned")


def rot_diff_digits(acc: torch.Tensor, t: torch.Tensor, base_log: int,
                    levels: int, n_d: int) -> torch.Tensor:
    """K2. acc int64 [O, B, N]; t int32 [B] -> int8 [O, L, n_d, B, N]. On a
    CUDA device the gadget (levels, base_log) must be one of GLUE_GADGETS:
    the kernel unrolls its level loop."""
    o, b, n = acc.shape
    if t.shape != (b,):
        raise ValueError(f"rot_diff_digits: t shape {tuple(t.shape)} != ({b},)")
    if _on_cpu(acc, t):
        return rot_diff_digits_plain(acc, t, base_log, levels, n_d)
    _check_glue("rot_diff_digits", acc, t, n, n_d, levels, base_log)
    out = torch.empty((o, levels, n_d, b, n), dtype=torch.int8,
                      device=acc.device)
    f = _fn("cmux", "tfhe_rot_diff_digits", [_P, _P, _P] + [_I] * 6 + [_P])
    rc = f(acc.data_ptr(), t.data_ptr(), out.data_ptr(), b, n, o, levels,
           n_d, base_log, build.stream_ptr(acc.device))
    build.check(rc, "rot_diff_digits")
    rot_diff_digits.launches += 1
    return out


rot_diff_digits.launches = 0


# ------------------------------------------------------- K1 the CMux step

def extprod_step2g_plain(dig, ext_or, acc, t_next, base_log: int,
                         levels: int, j_start: int):
    """acc += Σ_r dig[r] ⊛ BSK rows (limb planes j >= j_start), in place;
    returns (acc, digits of X^t_next·acc - acc)."""
    n_d = dig.shape[2]
    acc = extprod_step2_plain(dig, ext_or, acc, j_start)
    return acc, rot_diff_digits_plain(acc, t_next, base_log, levels, n_d)


# K1 on `wgmma` (csrc/cmux_wg.cu, nc_wgmma.cuh): a block owns 32 lanes x
# WG_COLS of the N columns, its N / WG_COLS blocks one cluster (4 at
# N = 512, 8 at 1024), at each N in WG_N. A block contracts unit by unit,
# a unit WG_KC digit columns of one row, so its stage is the same at both
# sizes. It takes over from cmux.cu's mma.sync blocks of 8 lanes at every
# batch, so that those serve N <= 256 only: the crossover lies below one
# lane at both sizes on the H100 (PERF.md; csrc/probes/mma_regress.py times
# it at N = 512), wgmma taking 0.080 ms at B = 1 against mma.sync's 0.130
# at N = 512, 0.126 against 0.197 at N = 1024.
# WG_LANES, WG_COLS and WG_KC are nc_wgmma.cuh's LANES, COLS and KC.
WG_N = frozenset({512, 1024})
WG_LANES = 32
WG_COLS = 128
WG_KC = 512


def k1_path(n: int) -> str:
    """Which kernel K1 launches on the card for polynomial size n, at any
    batch: "wgmma" (cmux_wg.cu) at each N in WG_N, else "mma.sync"
    (cmux.cu)."""
    return "wgmma" if n in WG_N else "mma.sync"


def _k1_wg_smem(n: int, nj: int, n_d: int) -> int:
    """K1 on wgmma's block at N = n (one of WG_N): two stages of a unit's
    nj table windows of WG_KC + WG_COLS words, nj x 2·WG_KC raw key bytes
    and n_d 32-lane digit tiles of WG_KC columns, or the [32][WG_COLS]
    int64 tile of the new accumulator, whichever is larger. The stage is
    the same at every N."""
    if n not in WG_N:
        raise ValueError(f"K1 on wgmma is not built for N={n}")
    stage = (nj * (WG_KC + WG_COLS) * 4 + nj * 2 * WG_KC
             + n_d * WG_LANES * WG_KC)
    return max(2 * stage, WG_LANES * WG_COLS * 8)


def extprod_step2g(dig: torch.Tensor, ext_or: torch.Tensor, acc: torch.Tensor,
                   t_next: torch.Tensor, base_log: int, levels: int,
                   j_start: int):
    """K1. dig int8 [k+1, L, n_d, B, N]; ext_or int8 [O, R, 8-js, 2N];
    acc int64 [O, B, N] (updated in place, as the TPU kernel aliases it);
    t_next int32 [B] -> (acc, next digits int8 [k+1, L, n_d, B, N]). On the
    card it launches the kernel k1_path(N) names; `launches` counts
    both, `launches_wg` the wgmma one."""
    k1, lv, n_d, b, n = dig.shape
    o, r, nj, two_n = ext_or.shape
    if (lv != levels or o != k1 or r != k1 * levels or nj != 8 - j_start
            or two_n != 2 * n or acc.shape != (o, b, n)
            or t_next.shape != (b,)):
        raise ValueError(
            f"extprod_step2g: shapes dig {tuple(dig.shape)}, ext_or "
            f"{tuple(ext_or.shape)}, acc {tuple(acc.shape)}, t_next "
            f"{tuple(t_next.shape)} (levels={levels}, j_start={j_start})")
    if _on_cpu(dig, ext_or, acc, t_next):
        return extprod_step2g_plain(dig, ext_or, acc, t_next, base_log,
                                    levels, j_start)
    _check_geometry("extprod_step2g", n, n_d, r, j_start, n_min=64)
    wide = k1_path(n) == "wgmma"
    _check_smem("extprod_step2g", _k1_wg_smem(n, nj, n_d) if wide
                else _k1_smem(n, nj, n_d))
    _require_cuda("extprod_step2g",
                  [(dig, torch.int8), (ext_or, torch.int8),
                   (acc, torch.int64), (t_next, torch.int32)])
    _check_staged("extprod_step2g", dig, ext_or)
    out = torch.empty_like(dig)
    stem, name = (("cmux_wg", "tfhe_extprod_step2g_wg") if wide
                  else ("cmux", "tfhe_extprod_step2g"))
    f = _fn(stem, name, [_P] * 5 + [_I] * 8 + [_P])
    rc = f(dig.data_ptr(), ext_or.data_ptr(), acc.data_ptr(),
           t_next.data_ptr(), out.data_ptr(), b, n, o, r, levels, n_d,
           j_start, base_log, build.stream_ptr(acc.device))
    build.check(rc, "extprod_step2g")
    extprod_step2g.launches += 1
    extprod_step2g.launches_wg += wide
    return acc, out


extprod_step2g.launches = 0
extprod_step2g.launches_wg = 0


# ----------------------------------------- K3 the vertical-packing product

def extprod_grouped_fused_plain(dig, ext, n_d: int, j_start: int):
    """dig int8 [B, R, n_d·G, N]; ext int8 [B, O, R, 8-js, 2N]
    -> int64 [B, O, G, N]."""
    b, r, ndg, n = dig.shape
    g = ndg // n_d
    dig_planes = dig.reshape(b, r, n_d, g, n).permute(2, 0, 3, 1, 4)
    out = polynomial.nc_limb_product(dig_planes, ext.permute(0, 2, 1, 3, 4),
                                     j_start)                # [B, G, O, N]
    return out.permute(0, 2, 1, 3).contiguous()


def extprod_grouped_fused(dig: torch.Tensor, ext: torch.Tensor, n_d: int,
                          j_start: int) -> torch.Tensor:
    """K3. dig int8 [B, R, n_d·G, N] (lane b's digit limb planes);
    ext int8 [B, O, R, 8-js, 2N] (lane b's GGSW row limb planes)
    -> int64 [B, O, G, N], exact mod 2^64 over the kept planes."""
    b, r, ndg, n = dig.shape
    b2, o, r2, nj, two_n = ext.shape
    if ((b2, r2, two_n) != (b, r, 2 * n) or nj != 8 - j_start
            or ndg % n_d):
        raise ValueError(f"extprod_grouped_fused: shapes dig "
                         f"{tuple(dig.shape)}, ext {tuple(ext.shape)}, "
                         f"n_d={n_d}, j_start={j_start}")
    if _on_cpu(dig, ext):
        return extprod_grouped_fused_plain(dig, ext, n_d, j_start)
    _check_geometry("extprod_grouped_fused", n, n_d, r, j_start, n_min=64)
    _check_smem("extprod_grouped_fused",
                _mma_stage_bytes(n, nj) + 2 * _mma_dig_tile_bytes(n, n_d))
    _require_cuda("extprod_grouped_fused",
                  [(dig, torch.int8), (ext, torch.int8)])
    _check_staged("extprod_grouped_fused", dig, ext)
    g = ndg // n_d
    out = torch.empty((b, o, g, n), dtype=torch.int64, device=dig.device)
    f = _fn("vp", "tfhe_extprod_grouped_fused", [_P] * 3 + [_I] * 7 + [_P])
    rc = f(dig.data_ptr(), ext.data_ptr(), out.data_ptr(), b, g, n, o, r,
           n_d, j_start, build.stream_ptr(dig.device))
    build.check(rc, "extprod_grouped_fused")
    extprod_grouped_fused.launches += 1
    return out


extprod_grouped_fused.launches = 0



# ------------------------------------------- K5 the CMux step without glue

def extprod_step2_plain(dig, ext_or, acc, j_start: int):
    """acc += Σ_r dig[r] ⊛ BSK rows (limb planes j >= j_start), in place."""
    k1, lv, n_d, b, n = dig.shape
    dig_planes = dig.reshape(k1 * lv, n_d, b, n).permute(1, 2, 0, 3)[:, None]
    ext = ext_or.permute(1, 0, 2, 3)[None]                # [1, R, O, NJ, 2N]
    acc += polynomial.nc_limb_product(dig_planes, ext, j_start)[0].permute(
        1, 0, 2)
    return acc


def extprod_step2(dig: torch.Tensor, ext_or: torch.Tensor, acc: torch.Tensor,
                  j_start: int) -> torch.Tensor:
    """K5. dig int8 [k+1, L, n_d, B, N] (K2's output); ext_or int8
    [O, R, 8-js, 2N]; acc int64 [O, B, N], updated in place (the TPU kernel
    aliases it) and returned."""
    k1, lv, n_d, b, n = dig.shape
    o, r, nj, two_n = ext_or.shape
    if (o != k1 or r != k1 * lv or nj != 8 - j_start or two_n != 2 * n
            or acc.shape != (o, b, n)):
        raise ValueError(
            f"extprod_step2: shapes dig {tuple(dig.shape)}, ext_or "
            f"{tuple(ext_or.shape)}, acc {tuple(acc.shape)} "
            f"(j_start={j_start})")
    if _on_cpu(dig, ext_or, acc):
        return extprod_step2_plain(dig, ext_or, acc, j_start)
    _check_geometry("extprod_step2", n, n_d, r, j_start, n_min=64)
    _check_smem("extprod_step2",
                _mma_stage_bytes(n, nj) + 2 * _mma_dig_tile_bytes(n, n_d))
    _require_cuda("extprod_step2", [(dig, torch.int8), (ext_or, torch.int8),
                                    (acc, torch.int64)])
    _check_staged("extprod_step2", dig, ext_or)
    f = _fn("cmux", "tfhe_extprod_step2", [_P] * 3 + [_I] * 6 + [_P])
    rc = f(dig.data_ptr(), ext_or.data_ptr(), acc.data_ptr(), b, n, o, r,
           n_d, j_start, build.stream_ptr(acc.device))
    build.check(rc, "extprod_step2")
    extprod_step2.launches += 1
    return acc


extprod_step2.launches = 0


# ------------------------------------ K6 the CMux update, batch-major

def extprod_step_plain(digit_planes, ext_or, acc, j_start: int):
    """acc + Σ_r digits[r] ⊛ BSK rows, a new tensor."""
    prod = polynomial.nc_limb_product(
        digit_planes[:, None], ext_or.permute(1, 0, 2, 3)[None], j_start)
    return acc + prod[0]


def extprod_step(digit_planes: torch.Tensor, ext_or: torch.Tensor,
                 acc: torch.Tensor, j_start: int) -> torch.Tensor:
    """K6. digit_planes int8 [n_d, B, R, N]; ext_or int8 [O, R, 8-js, 2N]
    (the prepared BSK entry, where the TPU kernel takes [8-js, R, O, 2N]);
    acc int64 [B, O, N], left untouched -> new acc int64 [B, O, N]."""
    n_d, b, r, n = digit_planes.shape
    o, r2, nj, two_n = ext_or.shape
    if (r2 != r or two_n != 2 * n or nj != 8 - j_start
            or acc.shape != (b, o, n)):
        raise ValueError(
            f"extprod_step: shapes digit_planes {tuple(digit_planes.shape)}, "
            f"ext_or {tuple(ext_or.shape)}, acc {tuple(acc.shape)} "
            f"(j_start={j_start})")
    if _on_cpu(digit_planes, ext_or, acc):
        return extprod_step_plain(digit_planes, ext_or, acc, j_start)
    _check_geometry("extprod_step", n, n_d, r, j_start, n_min=64)
    _check_smem("extprod_step",
                _mma_stage_bytes(n, nj) + 2 * _mma_dig_tile_bytes(n, n_d))
    _require_cuda("extprod_step", [(digit_planes, torch.int8),
                                   (ext_or, torch.int8), (acc, torch.int64)])
    _check_staged("extprod_step", digit_planes, ext_or)
    out = torch.empty_like(acc)
    f = _fn("step", "tfhe_extprod_step", [_P] * 4 + [_I] * 6 + [_P])
    rc = f(digit_planes.data_ptr(), ext_or.data_ptr(), acc.data_ptr(),
           out.data_ptr(), b, n, o, r, n_d, j_start,
           build.stream_ptr(acc.device))
    build.check(rc, "extprod_step")
    extprod_step.launches += 1
    return out


extprod_step.launches = 0


# ------------------------------------------ K7 the shared-key partial sums

def extprod_partials_plain(digit_planes, ext_planes):
    """int32 [8, B, O, N] partial sums by weight 2^(8s)."""
    return polynomial.nc_limb_partials(
        digit_planes[:, None], ext_planes.permute(1, 2, 0, 3)[None], 0)[:, 0]


def extprod_partials(digit_planes: torch.Tensor,
                     ext_planes: torch.Tensor) -> torch.Tensor:
    """K7. digit_planes int8 [n_d, B, R, N]; ext_planes int8 [8, R, O, 2N]
    (all 8 limb planes of ext = [p, -p]) -> int32 [8, B, O, N]: row s sums
    the pairs i + j = s; pairs with i + j >= 8 vanish mod 2^64 and are
    dropped, so `polynomial.recombine_partials` of the result is the exact
    product."""
    n_d, b, r, n = digit_planes.shape
    nj, r2, o, two_n = ext_planes.shape
    if r2 != r or two_n != 2 * n or nj != 8:
        raise ValueError(
            f"extprod_partials: shapes digit_planes "
            f"{tuple(digit_planes.shape)}, ext_planes "
            f"{tuple(ext_planes.shape)} (all 8 key planes are taken)")
    if _on_cpu(digit_planes, ext_planes):
        return extprod_partials_plain(digit_planes, ext_planes)
    # all 8 key planes make up to 8·n_d pairs (i, j), but a bucket s still
    # takes at most n_d of them (one per i), which is _check_geometry's bound
    _check_geometry("extprod_partials", n, n_d, r, 0, n_min=64)
    _check_smem("extprod_partials",
                _mma_stage_bytes(n, 8) + 2 * _mma_dig_tile_bytes(n, n_d))
    _require_cuda("extprod_partials", [(digit_planes, torch.int8),
                                       (ext_planes, torch.int8)])
    _check_staged("extprod_partials", digit_planes, ext_planes)
    out = torch.empty((8, b, o, n), dtype=torch.int32,
                      device=digit_planes.device)
    f = _fn("step", "tfhe_extprod_partials", [_P] * 3 + [_I] * 5 + [_P])
    rc = f(digit_planes.data_ptr(), ext_planes.data_ptr(), out.data_ptr(), b,
           n, o, r, n_d, build.stream_ptr(out.device))
    build.check(rc, "extprod_partials")
    extprod_partials.launches += 1
    return out


extprod_partials.launches = 0


# ----------------------------------- K8 the vertical-packing partial sums

def extprod_partials_grouped_plain(digit_planes, ext_planes, j_start: int):
    """int32 [8, B, G, O, N] partial sums; rows s < j_start are zero."""
    return polynomial.nc_limb_partials(
        digit_planes, ext_planes.permute(1, 2, 3, 0, 4), j_start)


def extprod_partials_grouped(digit_planes: torch.Tensor,
                             ext_planes: torch.Tensor,
                             j_start: int) -> torch.Tensor:
    """K8. digit_planes int8 [n_d, B, G, R, N] (lane b's G accumulators);
    ext_planes int8 [8-js, B, R, O, 2N] (lane b's GGSW row limb planes)
    -> int32 [8, B, G, O, N] partial sums by weight 2^(8s); the rows
    s < j_start are zeros (the kernel writes them)."""
    n_d, b, g, r, n = digit_planes.shape
    nj, b2, r2, o, two_n = ext_planes.shape
    if (b2, r2, two_n) != (b, r, 2 * n) or nj != 8 - j_start:
        raise ValueError(
            f"extprod_partials_grouped: shapes digit_planes "
            f"{tuple(digit_planes.shape)}, ext_planes "
            f"{tuple(ext_planes.shape)}, j_start={j_start}")
    if _on_cpu(digit_planes, ext_planes):
        return extprod_partials_grouped_plain(digit_planes, ext_planes,
                                              j_start)
    _check_geometry("extprod_partials_grouped", n, n_d, r, j_start,
                    n_min=64)
    _check_smem("extprod_partials_grouped",
                _mma_stage_bytes(n, nj) + 2 * _mma_dig_tile_bytes(n, n_d))
    _require_cuda("extprod_partials_grouped",
                  [(digit_planes, torch.int8), (ext_planes, torch.int8)])
    _check_staged("extprod_partials_grouped", digit_planes, ext_planes)
    out = torch.empty((8, b, g, o, n), dtype=torch.int32,
                      device=digit_planes.device)
    f = _fn("vp", "tfhe_extprod_partials_grouped",
            [_P] * 3 + [_I] * 7 + [_P])
    rc = f(digit_planes.data_ptr(), ext_planes.data_ptr(), out.data_ptr(), b,
           g, n, o, r, n_d, j_start, build.stream_ptr(out.device))
    build.check(rc, "extprod_partials_grouped")
    extprod_partials_grouped.launches += 1
    return out


extprod_partials_grouped.launches = 0


# ------------------------------------- K9 the whole CMux step, one launch

K9_CLUSTER_MAX = 16   # blocks of a cluster on sm_90 (above 8 non-portable)


def _k9_smem(n: int, nj: int, n_d: int, levels: int, r: int) -> int:
    """K9's block. N <= 512 (csrc/merged.cu): the two stages of S-tables
    and raw key rows, or the [8][N] int64 accumulator tile of its glue,
    whichever is larger, then all R rows' padded digit tiles. N = 1024
    (csrc/merged_wide.cu): K1's two stages (digit tiles among them), then
    the block's own digits [L][n_d][8][512], component o's L rows at its
    512 columns."""
    if n <= 512:
        return (max(_mma_stage_bytes(n, nj), 8 * n * 8)
                + r * _mma_dig_tile_bytes(n, n_d))
    return (_mma_stage_bytes(n, nj) + 2 * _mma_dig_tile_bytes(n, n_d)
            + levels * n_d * 8 * 512)


def cmux_step_merged_plain(t, ext_or, acc, base_log: int, levels: int,
                           j_start: int):
    """acc + Σ_r digits(X^t·acc - acc)[r] ⊛ BSK rows, a new tensor."""
    n_d = torus.limbs_for_bound(decomposition.digit_bound(base_log))
    dig = rot_diff_digits_plain(acc, t, base_log, levels, n_d)
    return extprod_step2_plain(dig, ext_or, acc.clone(), j_start)


def cmux_step_merged(t: torch.Tensor, ext_or: torch.Tensor, acc: torch.Tensor,
                     base_log: int, levels: int, j_start: int) -> torch.Tensor:
    """K9. t int32 [B] in [0, 2N); ext_or int8 [O, R, 8-js, 2N]; acc int64
    [O, B, N], left untouched -> new acc int64 [O, B, N]. (The TPU kernel
    aliases its output with acc behind a sequential grid; here every block
    reads the old accumulator of all components, so the result is a second
    buffer.) At N = 1024 a lane tile's 2·O blocks launch as one cluster,
    so O <= K9_CLUSTER_MAX / 2."""
    o, b, n = acc.shape
    o2, r, nj, two_n = ext_or.shape
    if (o2 != o or r != o * levels or nj != 8 - j_start or two_n != 2 * n
            or t.shape != (b,)):
        raise ValueError(
            f"cmux_step_merged: shapes t {tuple(t.shape)}, ext_or "
            f"{tuple(ext_or.shape)}, acc {tuple(acc.shape)} "
            f"(levels={levels}, j_start={j_start})")
    if _on_cpu(t, ext_or, acc):
        return cmux_step_merged_plain(t, ext_or, acc, base_log, levels,
                                      j_start)
    n_d = torus.limbs_for_bound(decomposition.digit_bound(base_log))
    _check_geometry("cmux_step_merged", n, n_d, r, j_start, n_min=64)
    if n > 512 and 2 * o > K9_CLUSTER_MAX:
        raise ValueError(f"cmux_step_merged: at N={n} the 2·O = {2 * o} "
                         f"blocks of a lane tile are one cluster, at most "
                         f"{K9_CLUSTER_MAX}")
    _check_smem("cmux_step_merged", _k9_smem(n, nj, n_d, levels, r))
    _require_cuda("cmux_step_merged", [(t, torch.int32), (ext_or, torch.int8),
                                       (acc, torch.int64)])
    _check_staged("cmux_step_merged", ext_or)
    out = torch.empty_like(acc)
    if n <= 512:
        f = _fn("merged", "tfhe_cmux_step_merged", [_P] * 4 + [_I] * 7 + [_P])
        rc = f(t.data_ptr(), ext_or.data_ptr(), acc.data_ptr(),
               out.data_ptr(), b, n, o, levels, n_d, j_start, base_log,
               build.stream_ptr(acc.device))
    else:
        f = _fn("merged_wide", "tfhe_cmux_step_merged_wide",
                [_P] * 4 + [_I] * 6 + [_P])
        rc = f(t.data_ptr(), ext_or.data_ptr(), acc.data_ptr(),
               out.data_ptr(), b, o, levels, n_d, j_start, base_log,
               build.stream_ptr(acc.device))
    build.check(rc, "cmux_step_merged")
    cmux_step_merged.launches += 1
    return out


cmux_step_merged.launches = 0


# ---------------------------------------- K10a the glue, row-flattened

def rot_diff_digits_flat_plain(acc, t, base_log: int, levels: int, n_d: int):
    """K2's plain output [O, L, n_d, B, N] laid out as int8 [n_d, B, R·N],
    column (u·L + l)·N + m."""
    o, b, n = acc.shape
    dig = rot_diff_digits_plain(acc, t, base_log, levels, n_d)
    return dig.permute(2, 3, 0, 1, 4).reshape(n_d, b, o * levels * n)


def rot_diff_digits_flat(acc: torch.Tensor, t: torch.Tensor, base_log: int,
                         levels: int, n_d: int) -> torch.Tensor:
    """K10a. acc int64 [O, B, N]; t int32 [B] -> int8 [n_d, B, R·N], the
    digit limb planes of X^t·acc - acc with a lane's R = O·L digit
    polynomials side by side (column r·N + m, r = u·L + l). On a CUDA
    device the gadget (levels, base_log) must be one of GLUE_GADGETS, as
    for K2."""
    o, b, n = acc.shape
    if t.shape != (b,):
        raise ValueError(
            f"rot_diff_digits_flat: t shape {tuple(t.shape)} != ({b},)")
    if _on_cpu(acc, t):
        return rot_diff_digits_flat_plain(acc, t, base_log, levels, n_d)
    _check_glue("rot_diff_digits_flat", acc, t, n, n_d, levels, base_log)
    out = torch.empty((n_d, b, o * levels * n), dtype=torch.int8,
                      device=acc.device)
    f = _fn("longk", "tfhe_rot_diff_digits_flat",
            [_P, _P, _P] + [_I] * 6 + [_P])
    rc = f(acc.data_ptr(), t.data_ptr(), out.data_ptr(), b, n, o, levels,
           n_d, base_log, build.stream_ptr(acc.device))
    build.check(rc, "rot_diff_digits_flat")
    rot_diff_digits_flat.launches += 1
    return out


rot_diff_digits_flat.launches = 0


# ------------------------ K10b the CMux update, one long contraction a lane

def extprod_step_longk_plain(dig_flat, ext_or, acc, j_start: int):
    """acc += Σ_r dig[r] ⊛ BSK rows on the flat digit layout, in place."""
    n_d, b, rn = dig_flat.shape
    r = ext_or.shape[1]
    prod = polynomial.nc_limb_product(
        dig_flat.reshape(n_d, 1, b, r, rn // r),
        ext_or.permute(1, 0, 2, 3)[None], j_start)          # [1, B, O, N]
    acc += prod[0].permute(1, 0, 2)
    return acc


LONGK_BLOCK_ROWS = 0.7   # a K10b block's launch, prologue and epilogue,
                         # in contraction rows (csrc/probes/longk_splits.py)


def _longk_splits(b: int, o: int, r: int, n: int) -> int:
    """Blocks that share one (8-lane tile, component, column half)'s R
    contraction rows in K10b (csrc/longk.cu): the count s in 1..r that
    minimises the modelled time ceil(tiles·s / SMS) · (ceil(r/s) +
    LONGK_BLOCK_ROWS) — waves of one block an SM, each as long as its
    longest block — and the fewest among equals; tiles counts the column
    halves, two a lane tile at N = 1024. Block z takes rows
    [z·r/s, (z+1)·r/s): floor or ceiling of r/s, none empty."""
    tiles = -(-b // 8) * o * _column_blocks(n)
    return min(range(1, r + 1), key=lambda s: (
        -(-tiles * s // SMS) * (-(-r // s) + LONGK_BLOCK_ROWS), s))


def extprod_step_longk(dig_flat: torch.Tensor, ext_or: torch.Tensor,
                       acc: torch.Tensor, j_start: int) -> torch.Tensor:
    """K10b. dig_flat int8 [n_d, B, R·N] (K10a's output); ext_or int8
    [O, R, 8-js, 2N] — the prepared BSK entry, NOT the plane-major ext_oj
    [O, 8-js, R, 2N] that the TPU kernel takes: the kernel reads row r's key
    planes through ext_or's strides, so no key is transposed; acc int64
    [O, B, N], updated in place (the TPU kernel aliases it; with more than
    one split each block adds its partial by 64-bit atomics, exact mod 2^64
    in any order) and returned."""
    n_d, b, rn = dig_flat.shape
    o, r, nj, two_n = ext_or.shape
    n = two_n // 2
    if (rn != r * n or two_n != 2 * n or nj != 8 - j_start
            or acc.shape != (o, b, n)):
        raise ValueError(
            f"extprod_step_longk: shapes dig_flat {tuple(dig_flat.shape)}, "
            f"ext_or {tuple(ext_or.shape)}, acc {tuple(acc.shape)} "
            f"(j_start={j_start})")
    if _on_cpu(dig_flat, ext_or, acc):
        return extprod_step_longk_plain(dig_flat, ext_or, acc, j_start)
    _check_geometry("extprod_step_longk", n, n_d, r, j_start, n_min=64)
    _check_smem("extprod_step_longk",
                _mma_stage_bytes(n, nj) + 2 * _mma_dig_tile_bytes(n, n_d))
    _require_cuda("extprod_step_longk",
                  [(dig_flat, torch.int8), (ext_or, torch.int8),
                   (acc, torch.int64)])
    _check_staged("extprod_step_longk", dig_flat, ext_or)
    _launch_longk(dig_flat, ext_or, acc, j_start, _longk_splits(b, o, r, n))
    extprod_step_longk.launches += 1
    return acc


def _launch_longk(dig_flat, ext_or, acc, j_start: int,
                  splits: int) -> torch.Tensor:
    """K10b's launch with its rows split `splits` ways (1..R), on operands
    extprod_step_longk has checked; adds into acc and returns it. The card's
    checks call it at other splits than the wrapper's, uncounted."""
    n_d, b, _ = dig_flat.shape
    o, r, _, two_n = ext_or.shape
    f = _fn("longk", "tfhe_extprod_step_longk", [_P] * 3 + [_I] * 7 + [_P])
    build.check(f(dig_flat.data_ptr(), ext_or.data_ptr(), acc.data_ptr(), b,
                  two_n // 2, o, r, n_d, j_start, splits,
                  build.stream_ptr(acc.device)), "extprod_step_longk")
    return acc


extprod_step_longk.launches = 0


# ------------------------------ K11 the CMux update, bucket by bucket

def extprod_step3_plain(dig, ext_or, acc, j_start: int):
    """acc += Σ_s sext(bucket_s) << 8s with bucket_s = Σ_r Σ_{i+j=s}
    dig_i[r] ⊛ plane_j[r], in place: the int32 buckets of
    `polynomial.nc_limb_partials`, folded one after the other."""
    k1, lv, n_d, b, n = dig.shape
    dig_planes = dig.reshape(k1 * lv, n_d, b, n).permute(1, 2, 0, 3)[:, None]
    parts = polynomial.nc_limb_partials(
        dig_planes, ext_or.permute(1, 0, 2, 3)[None], j_start)[:, 0]
    for s in range(j_start, 8):                       # [8, B, O, N]
        acc += (parts[s].to(torch.int64) << (8 * s)).permute(1, 0, 2)
    return acc


BUCKET_BLOCK_ROWS = 0.7  # a K11 block's launch, prologue and epilogue, in
                         # contraction rows: any value in 0.4-1.5 picks the
                         # same splits at the measured batches
                         # (csrc/probes/bucket_splits.py)
BUCKET_WIDE_SLOTS = 2    # K11 blocks an SM that the model counts at N = 1024,
                         # of the 3 the occupancy allows: an empirical fit,
                         # not a measured cause. With
                         # csrc/probes/bucket_splits.py at lvl256's and the
                         # 8-bit model's step, 10 batches each, counting 2
                         # picks splits 1.9% over the measured best on
                         # average (worst 11%, 14 of 20 within 3%); counting
                         # the occupancy's 3, 5.5% (worst 22%) for every
                         # BUCKET_BLOCK_ROWS tried


def _bucket_splits(b: int, o: int, r: int, nj: int, resident: int,
                   n: int) -> int:
    """Blocks that share one (8-lane tile, component, bucket, column
    half)'s R rows in K11 (csrc/bucket.cu): the count s in 1..r that
    minimises the modelled time ceil(blocks·s / (SMS·slots)) ·
    (ceil(r/s) + BUCKET_BLOCK_ROWS) — waves of `slots` blocks an SM, each as
    long as its longest block — and the fewest among equals; slots is
    `resident` (the kernel's occupancy), at most BUCKET_WIDE_SLOTS at
    N = 1024, and blocks counts tiles·nj and the column halves, two a lane
    tile at N = 1024. Block z takes rows [z·r/s, (z+1)·r/s), as K10b's
    (`_longk_splits`)."""
    blocks = -(-b // 8) * o * nj * _column_blocks(n)
    slots = resident if n <= 512 else min(resident, BUCKET_WIDE_SLOTS)
    return min(range(1, r + 1), key=lambda s: (
        -(-blocks * s // (SMS * slots))
        * (-(-r // s) + BUCKET_BLOCK_ROWS), s))


_residency: dict = {}


def _bucket_residency(n: int, n_d: int) -> int:
    """K11 blocks one SM holds at once (the kernels are built for sm_90a
    alone), read once from cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    key = (n, n_d)
    if key not in _residency:
        blocks = ctypes.c_int(0)
        f = _fn("bucket", "tfhe_extprod_step3_residency",
                [_I, _I, ctypes.POINTER(ctypes.c_int)])
        build.check(f(n, n_d, ctypes.byref(blocks)), "extprod_step3")
        if blocks.value < 1:
            raise RuntimeError("extprod_step3: no block fits on an SM")
        _residency[key] = blocks.value
    return _residency[key]


def extprod_step3(dig: torch.Tensor, ext_or: torch.Tensor, acc: torch.Tensor,
                  j_start: int) -> torch.Tensor:
    """K11. dig int8 [k+1, L, n_d, B, N] (K2's output; row r = u·L + l);
    ext_or int8 [O, R, 8-js, 2N]; acc int64 [O, B, N], updated in place (the
    kernel adds each bucket — with its rows split across blocks by
    `_bucket_splits`, each block's part of it — with 64-bit atomics, exact
    mod 2^64 in any order) and returned."""
    k1, lv, n_d, b, n = dig.shape
    o, r, nj, two_n = ext_or.shape
    if (o != k1 or r != k1 * lv or nj != 8 - j_start or two_n != 2 * n
            or acc.shape != (o, b, n)):
        raise ValueError(
            f"extprod_step3: shapes dig {tuple(dig.shape)}, ext_or "
            f"{tuple(ext_or.shape)}, acc {tuple(acc.shape)} "
            f"(j_start={j_start})")
    if _on_cpu(dig, ext_or, acc):
        return extprod_step3_plain(dig, ext_or, acc, j_start)
    _check_geometry("extprod_step3", n, n_d, r, j_start, n_min=64)
    _check_smem("extprod_step3", _mma_stage_bytes(n, n_d)
                + 2 * _mma_dig_tile_bytes(n, n_d))
    _require_cuda("extprod_step3", [(dig, torch.int8), (ext_or, torch.int8),
                                    (acc, torch.int64)])
    _check_staged("extprod_step3", dig, ext_or)
    _launch_step3(dig, ext_or, acc, j_start,
                  _bucket_splits(b, o, r, nj, _bucket_residency(n, n_d), n))
    extprod_step3.launches += 1
    return acc


def _launch_step3(dig, ext_or, acc, j_start: int,
                  splits: int) -> torch.Tensor:
    """K11's launch with its rows split `splits` ways (1..R), on operands
    extprod_step3 has checked; adds into acc and returns it. The card's
    checks call it at other splits than the wrapper's, uncounted."""
    k1, lv, n_d, b, n = dig.shape
    f = _fn("bucket", "tfhe_extprod_step3", [_P] * 3 + [_I] * 7 + [_P])
    build.check(f(dig.data_ptr(), ext_or.data_ptr(), acc.data_ptr(), b, n,
                  k1, k1 * lv, n_d, j_start, splits,
                  build.stream_ptr(acc.device)), "extprod_step3")
    return acc


extprod_step3.launches = 0


def split_polys_ext(polys: torch.Tensor) -> torch.Tensor:
    """int64 [..., N] -> ext limb planes int8 [8, ..., 2N] (ext = [p, -p])."""
    return torus.split_u64_signed(polynomial.negacyclic_extend(polys))
