"""Parameter sets for the WoP-PBS 1-bit model.

Transcribed from reference src/tfhe/shortint_woppbs_1bit/parameters.rs:29-205
(four 128-bit-secure sets from concrete-optimizer, keyed by the squared noise
budget) plus reduced, insecure TEST parameter sets for fast CPU unit tests.

Noise standard deviations are in torus units (fraction of q); multiply by 2^64
for integer units.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class WopbsParams:
    lwe_dimension: int          # n  (small LWE key)
    glwe_dimension: int         # k
    polynomial_size: int        # N
    lwe_noise_std: float        # std of small-LWE / fresh encryption noise
    glwe_noise_std: float       # std of GLWE (BSK) noise
    pbs_level: int              # blind-rotate gadget levels
    pbs_base_log: int
    ks_level: int               # big->small LWE keyswitch levels
    ks_base_log: int
    cbs_level: int              # circuit-bootstrap output GGSW levels
    cbs_base_log: int
    pfks_level: int             # private functional packing keyswitch levels
    pfks_base_log: int
    pfks_noise_std: float
    max_noise_level_squared: int
    # 8-bit model extras (shortint_woppbs_8bit.rs:39-86)
    message_bits: int = 1       # log2(message_modulus)
    max_noise_level_linear: int = 0  # linear NoiseLevel budget (0 = unused)

    @property
    def glwe_size(self) -> int:
        return self.glwe_dimension + 1

    @property
    def big_lwe_dimension(self) -> int:
        """Dimension of the flattened GLWE key (the 'big' LWE key)."""
        return self.glwe_dimension * self.polynomial_size

    @property
    def log2_poly_size(self) -> int:
        n = self.polynomial_size
        assert n & (n - 1) == 0
        return n.bit_length() - 1


# reference parameters.rs:29-61 — optimizer cost 111, p_error 4.2e-20
PARAMS_SQRD_LVL_1 = WopbsParams(
    lwe_dimension=671,
    glwe_dimension=2,
    polynomial_size=1024,
    lwe_noise_std=4.7280002450549286e-05,
    glwe_noise_std=3.162026630747649e-16,
    pbs_level=2, pbs_base_log=15,
    ks_level=4, ks_base_log=3,
    cbs_level=1, cbs_base_log=10,
    pfks_level=1, pfks_base_log=24,
    pfks_noise_std=3.162026630747649e-16,
    max_noise_level_squared=1,
)

# reference parameters.rs:77-109 — optimizer cost 136, p_error 4.1e-20
PARAMS_SQRD_LVL_4 = WopbsParams(
    lwe_dimension=679,
    glwe_dimension=2,
    polynomial_size=1024,
    lwe_noise_std=4.7280002450549286e-05,
    glwe_noise_std=3.162026630747649e-16,
    pbs_level=2, pbs_base_log=15,
    ks_level=4, ks_base_log=3,
    cbs_level=1, cbs_base_log=11,
    pfks_level=2, pfks_base_log=16,
    pfks_noise_std=3.162026630747649e-16,
    max_noise_level_squared=4,
)

# reference parameters.rs:125-157 — optimizer cost 181, p_error 4.6e-20.
# The production set (paired with the depth-5 fhe_sbox_gal_mul_pbs pipeline,
# main.rs:83).
PARAMS_SQRD_LVL_64 = WopbsParams(
    lwe_dimension=677,
    glwe_dimension=4,
    polynomial_size=512,
    lwe_noise_std=4.7280002450549286e-05,
    glwe_noise_std=2.2148688116005568e-16,
    pbs_level=3, pbs_base_log=12,
    ks_level=4, ks_base_log=3,
    cbs_level=1, cbs_base_log=13,
    pfks_level=2, pfks_base_log=16,
    pfks_noise_std=2.2148688116005568e-16,
    max_noise_level_squared=64,
)

# reference parameters.rs:173-205 — optimizer cost 218, p_error 4.5e-20
PARAMS_SQRD_LVL_256 = WopbsParams(
    lwe_dimension=665,
    glwe_dimension=2,
    polynomial_size=1024,
    lwe_noise_std=4.7280002450549286e-05,
    glwe_noise_std=3.162026630747649e-16,
    pbs_level=4, pbs_base_log=9,
    ks_level=6, ks_base_log=2,
    cbs_level=1, cbs_base_log=14,
    pfks_level=3, pfks_base_log=12,
    pfks_noise_std=3.162026630747649e-16,
    max_noise_level_squared=256,
)


# TPU-first re-optimization of the production geometry (this framework's,
# not the reference's): concrete-optimizer chose k=4/N=512 under a CPU-FFT
# cost model (parameters.rs:15-28 doc comments). The MXU negacirculant cost
# model scales as (k+1)²·N² per CMux step (cells × dot size) and per VP
# ladder, which at EQUAL security — the GLWE secret is the same
# 2048-coefficient binary key (k·N = 2048), same noise stds — and equal
# gadget widths favors k=8/N=256: ~19% fewer MACs in the blind rotate and
# ~19% less VP ladder traffic. The price is a 2× coarser blind-rotate
# mod-switch (Z_{2N} with N=256): its key-amplified rounding term rises from
# ~2^56.4 to ~2^57.4, which the measured dual-bit margin absorbs (57.1
# observed at N=512 vs the 58.8 bar — PERF.md "TPU-first parameter
# exploration" records the sweep and the measured decision).
PARAMS_SQRD_LVL_64_MXU = WopbsParams(
    lwe_dimension=677,
    glwe_dimension=8,
    polynomial_size=256,
    lwe_noise_std=4.7280002450549286e-05,
    glwe_noise_std=2.2148688116005568e-16,
    pbs_level=3, pbs_base_log=12,
    ks_level=4, ks_base_log=3,
    cbs_level=1, cbs_base_log=13,
    pfks_level=2, pfks_base_log=16,
    pfks_noise_std=2.2148688116005568e-16,
    max_noise_level_squared=64,
)


# reference shortint_woppbs_8bit.rs:39-86 — the 8-bit model (message modulus
# 256, optimizer cost 12143 ≈ 67x the 1-bit lvl64 set; kept for capability
# parity, outperformed by the 1-bit model per README.md:77-78)
PARAMS_WOPPBS_8BIT = WopbsParams(
    lwe_dimension=785,
    glwe_dimension=2,
    polynomial_size=1024,
    lwe_noise_std=1.5140301927925663e-5,
    glwe_noise_std=2.2148688116005568e-16,
    pbs_level=6, pbs_base_log=7,
    ks_level=8, ks_base_log=2,
    cbs_level=4, cbs_base_log=6,
    pfks_level=3, pfks_base_log=12,
    pfks_noise_std=2.2148688116005568e-16,
    max_noise_level_squared=0,
    message_bits=8,
    max_noise_level_linear=11,
)

# Small 8-bit-model test set (insecure): N >= 256 so an 8-bit LUT fits in one
# polynomial; tiny noise for deterministic CPU tests.
PARAMS_TEST_8BIT = WopbsParams(
    lwe_dimension=32,
    glwe_dimension=1,
    polynomial_size=256,
    lwe_noise_std=2.0 ** -30,
    glwe_noise_std=2.0 ** -45,
    pbs_level=3, pbs_base_log=12,
    ks_level=3, ks_base_log=5,
    cbs_level=2, cbs_base_log=9,
    pfks_level=2, pfks_base_log=16,
    pfks_noise_std=2.0 ** -45,
    max_noise_level_squared=0,
    message_bits=8,
    max_noise_level_linear=11,
)

# !Testing parameters! — NOT secure, sized for fast CPU unit tests (same role
# as the reference's flagged test PARAMS, shortint_1bit.rs:62-83). Noise is
# tiny so decrypt-and-compare tests are deterministic, dimensions are small so
# a full circuit bootstrap runs in seconds on the CPU backend.
PARAMS_TEST = WopbsParams(
    lwe_dimension=32,
    glwe_dimension=1,
    polynomial_size=64,
    lwe_noise_std=2.0 ** -25,
    glwe_noise_std=2.0 ** -40,
    pbs_level=2, pbs_base_log=15,
    ks_level=2, ks_base_log=6,
    cbs_level=1, cbs_base_log=10,
    pfks_level=2, pfks_base_log=16,
    pfks_noise_std=2.0 ** -40,
    max_noise_level_squared=64,
)

# Test params with a larger N so that 8-bit LUTs fit without a CMux tree and
# 16-bit LUTs exercise a 2-level tree (mirrors production geometry t<=log2 N).
PARAMS_TEST_N256 = WopbsParams(
    lwe_dimension=32,
    glwe_dimension=1,
    polynomial_size=256,
    lwe_noise_std=2.0 ** -25,
    glwe_noise_std=2.0 ** -40,
    pbs_level=2, pbs_base_log=15,
    ks_level=2, ks_base_log=6,
    cbs_level=1, cbs_base_log=10,
    pfks_level=2, pfks_base_log=16,
    pfks_noise_std=2.0 ** -40,
    max_noise_level_squared=64,
)
