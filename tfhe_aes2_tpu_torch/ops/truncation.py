"""Noise-floor limb-plane truncation rules for the exact int8 contractions.

Every hot contraction multiplies small gadget digits against a u64 tensor
split into 8 balanced int8 limb planes (ops/torus.py). When that tensor is
an encryption (an evaluation key or a circuit-bootstrap GGSW), limb planes
whose weight sits below its noise floor can be dropped: dropping planes
0..js-1 replaces each coefficient x by x - (x mod± 2^(8·js)), a uniform
"truncation noise" of std 2^(8·js)/sqrt(12). Truncation hits the mask
coefficients too, so its variance is multiplied by the key amplification
1 + dim/2 of a binary secret. A plane is dropped when either arm holds:

  sigma arm   key_amp·(2^(8·js))²/12 <= (sigma/safety)²
  budget arm  A·key_amp·(2^(8·js))²/12 <= V_round, the gadget-rounding
              noise the consuming operation adds anyway.

The BSK rule deliberately omits key_amp (the JAX package documents the
measured end-to-end margin that justifies it). At PARAMS_SQRD_LVL_64 the
rules give (bsk 2, ksk 5, pfpksk 1, vp 4); at PARAMS_TEST (2, 4, 2, 5).

Copied from tfhe_aes2_tpu/ops/truncation.py with its environment switches,
read at each call as there: TFHE_BSK_TRUNC=0 keeps every BSK plane,
TFHE_KSK_TRUNC=0 every KSK and pfPKSK plane, TFHE_VP_TRUNC=0 every VP GGSW
plane (a switch at 0 disables both arms), and TFHE_TRUNC_BUDGET (default
1.0) scales the budget arm's V_round. keys.prepare_server_keys(truncate=
False) keeps all planes whatever they say.
"""

from __future__ import annotations

import math
import os

import torch

from tfhe_aes2_tpu_torch.ops.params import WopbsParams

_Q = 2.0 ** 64
_SQRT12 = math.sqrt(12.0)


def truncate_u64_values(x: torch.Tensor, js: int) -> torch.Tensor:
    """Value-level equivalent of dropping balanced int8 limb planes 0..js-1
    of int64 torus values: x - low with low = ((x + off) mod 2^(8js)) - off,
    off = Σ_{i<js} 2^(8i+7)."""
    if js <= 0:
        return x
    off = sum(1 << (8 * i + 7) for i in range(js))
    mask = (1 << (8 * js)) - 1
    low = ((x + off) & mask) - off
    return x - low


def j_start_for_sigma(sigma: float, safety: float = 8.0,
                      key_amp: float = 1.0) -> int:
    """Largest js in [0, 7] with key-amplified truncation std
    sqrt(key_amp)·2^(8·js)/sqrt(12) <= sigma/safety."""
    js = 0
    while js < 7 and (math.sqrt(key_amp) * (2.0 ** (8 * (js + 1))) / _SQRT12
                      <= sigma / safety):
        js += 1
    return js


def glwe_key_amp(params: WopbsParams) -> float:
    """Mask-plane key amplification for GLWE-keyed rows: 1 + kN/2."""
    return 1.0 + params.glwe_dimension * params.polynomial_size / 2.0


def lwe_key_amp(params: WopbsParams) -> float:
    """Mask-plane key amplification for small-LWE-keyed rows: 1 + n/2."""
    return 1.0 + params.lwe_dimension / 2.0


def _gate(env: str) -> bool:
    return os.environ.get(env, "1") != "0"


def _budget_frac() -> float:
    return float(os.environ.get("TFHE_TRUNC_BUDGET", "1.0"))


def budget_sigma(v_round: float, amplification: float) -> float:
    """Largest per-coefficient truncation std whose amplified variance stays
    within frac·V_round, frac = TFHE_TRUNC_BUDGET."""
    frac = _budget_frac()
    return math.sqrt(frac * v_round / amplification) if frac > 0 else 0.0


def bsk_j_start(params: WopbsParams) -> int:
    """BSK planes dropped in the blind-rotate CMux (no key_amp, see above);
    0 under TFHE_BSK_TRUNC=0."""
    if not _gate("TFHE_BSK_TRUNC"):
        return 0
    p = params
    sigma = max(p.glwe_noise_std * _Q / 32.0,
                budget_sigma(pbs_round_variance(p), pbs_amplification(p)))
    return j_start_for_sigma(sigma, safety=1.0)


def ksk_j_start(params: WopbsParams) -> int:
    """KSK planes dropped in the big->small keyswitch (sigma arm); 0 under
    TFHE_KSK_TRUNC=0."""
    if not _gate("TFHE_KSK_TRUNC"):
        return 0
    return j_start_for_sigma(params.lwe_noise_std * _Q, safety=8.0,
                             key_amp=lwe_key_amp(params))


def pfpksk_j_start(params: WopbsParams) -> int:
    """pfPKSK planes dropped in the pfKS contraction; 0 under
    TFHE_KSK_TRUNC=0."""
    if not _gate("TFHE_KSK_TRUNC"):
        return 0
    p = params
    sigma = max(p.pfks_noise_std * _Q / 8.0,
                budget_sigma(pfks_round_variance(p), pfks_amplification(p)))
    return j_start_for_sigma(sigma, safety=1.0, key_amp=glwe_key_amp(p))


def pbs_amplification(params: WopbsParams) -> float:
    """Factor mapping per-coefficient BSK variance into PBS output variance."""
    p = params
    beta = 2.0 ** p.pbs_base_log
    return (p.lwe_dimension * p.pbs_level * (p.glwe_dimension + 1)
            * p.polynomial_size * (beta * beta / 12.0))


def pbs_round_variance(params: WopbsParams) -> float:
    """PBS gadget-decomposition rounding term."""
    p = params
    eps = _Q / (2.0 * (2.0 ** p.pbs_base_log) ** p.pbs_level)
    return p.lwe_dimension * (1.0 + p.glwe_dimension * p.polynomial_size / 2.0) \
        * (eps * eps / 3.0)


def _trunc_var(js: int) -> float:
    """Per-coefficient variance of dropping limb planes 0..js-1."""
    return (2.0 ** (8 * js)) ** 2 / 12.0 if js else 0.0


def pbs_out_variance(params: WopbsParams) -> float:
    """Nominal variance of a scaling-PBS output, BSK truncation included."""
    sigma_bsk = params.glwe_noise_std * _Q
    return pbs_amplification(params) \
        * (sigma_bsk ** 2
           + glwe_key_amp(params) * _trunc_var(bsk_j_start(params))) \
        + pbs_round_variance(params)


def pfks_amplification(params: WopbsParams) -> float:
    """Factor mapping per-coefficient pfPKSK variance into pfKS output variance."""
    p = params
    kn1 = p.glwe_dimension * p.polynomial_size + 1
    beta = 2.0 ** p.pfks_base_log
    return kn1 * p.pfks_level * (beta * beta / 12.0)


def pfks_round_variance(params: WopbsParams) -> float:
    """pfKS gadget-decomposition rounding term."""
    p = params
    kn1 = p.glwe_dimension * p.polynomial_size + 1
    eps = _Q / (2.0 * (2.0 ** p.pfks_base_log) ** p.pfks_level)
    return (kn1 - 1) * 0.5 * (eps * eps / 3.0)


def pfks_add_variance(params: WopbsParams) -> float:
    """Nominal variance the pfKS adds, pfPKSK truncation included."""
    sigma = params.pfks_noise_std * _Q
    return pfks_amplification(params) \
        * (sigma ** 2
           + glwe_key_amp(params) * _trunc_var(pfpksk_j_start(params))) \
        + pfks_round_variance(params)


def vp_amplification(params: WopbsParams) -> float:
    """Factor mapping per-coefficient GGSW variance into one VP CMux output."""
    p = params
    beta = 2.0 ** p.cbs_base_log
    return p.cbs_level * (p.glwe_dimension + 1) * p.polynomial_size \
        * (beta * beta / 12.0)


def vp_round_variance(params: WopbsParams) -> float:
    """Per-CMux gadget rounding in vertical packing."""
    p = params
    eps = _Q / (2.0 * (2.0 ** p.cbs_base_log) ** p.cbs_level)
    return (1.0 + p.glwe_dimension * p.polynomial_size / 2.0) * (eps * eps / 3.0)


def cbs_ggsw_sigma(params: WopbsParams) -> float:
    """Nominal noise std of the circuit-bootstrap GGSW rows (PBS then pfKS)."""
    return math.sqrt(pbs_out_variance(params) + pfks_add_variance(params))


def vp_ggsw_j_start(params: WopbsParams) -> int:
    """GGSW planes dropped in the vertical-packing CMux: the selectors are
    circuit-bootstrap outputs whose noise floor covers the low planes; 0
    under TFHE_VP_TRUNC=0."""
    if not _gate("TFHE_VP_TRUNC"):
        return 0
    p = params
    sigma = max(cbs_ggsw_sigma(p) / 8.0,
                budget_sigma(vp_round_variance(p), vp_amplification(p)))
    return j_start_for_sigma(sigma, safety=1.0, key_amp=glwe_key_amp(p))
