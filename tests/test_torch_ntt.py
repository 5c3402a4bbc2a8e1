"""The port's CRT-NTT vertical-packing product (tfhe_aes2_tpu_torch/ops/
ntt.py) against the JAX package's (tfhe_aes2_tpu/ops/ntt.py): bit-equal at
tests/test_ntt.py's production geometry (N = 512, R = k+1 = 5 rows and
components, js = 4 dropped planes, digits ±2^12: the worst case the prime
product covers) and at small N; the exact reductions and Garner's
reconstruction at their edges against the JAX package's Barrett step and
Garner; and the guards, as ValueError where the JAX package asserts or
raises. Exact integer arithmetic: array equality everywhere."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_aes2_tpu.ops import ntt as jntt
from tfhe_aes2_tpu.ops import params as jparams
from tfhe_aes2_tpu.ops.polynomial import negacyclic_extend
from tfhe_aes2_tpu.ops.torus import split_u64_signed

from tfhe_aes2_tpu_torch.ops import ntt as tntt
from tfhe_aes2_tpu_torch.ops import params as tparams
from tfhe_aes2_tpu_torch.ops import polynomial as tpoly
from tfhe_aes2_tpu_torch.ops import torus as ttorus
from tfhe_aes2_tpu_torch.ops import truncation as ttrunc
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx
from tests.torch_port_common import t64, u64


def _operands(b, g, r, o, n, js, d_bound, seed=7):
    """digits [B, G, R, N] int32 and the ext planes [8-js, B, R, O, 2N]
    int8 the vertical packing feeds, made by numpy (tests/test_ntt.py's
    construction), and the polynomials [B, O, R, N] uint64."""
    rng = np.random.default_rng(seed)
    digits = rng.integers(-d_bound, d_bound + 1, (b, g, r, n)).astype(np.int32)
    ext = rng.integers(0, 1 << 64, (b, o, r, n), dtype=np.uint64)
    ext2 = np.asarray(negacyclic_extend(jnp.asarray(ext)))       # [B, O, R, 2N]
    planes = np.asarray(split_u64_signed(jnp.asarray(ext2)))     # [8, B, O, R, 2N]
    planes = np.ascontiguousarray(np.transpose(planes, (0, 1, 3, 2, 4))[js:])
    return digits, planes, ext


@pytest.mark.parametrize("b,g,r,o,n,js", [
    (2, 3, 5, 5, 512, 4),     # tests/test_ntt.py's production geometry
    (3, 2, 3, 2, 64, 5),      # PARAMS_TEST's vertical packing (k = 1)
    (1, 4, 4, 2, 256, 6),
])
def test_ntt_product_matches_jax(b, g, r, o, n, js):
    digits, planes, _ = _operands(b, g, r, o, n, js, 1 << 12)
    want = np.asarray(jntt.polymul_digits_ntt_grouped(
        jnp.asarray(digits), jnp.asarray(planes), 1 << 12, j_start=js))
    got = tntt.polymul_digits_ntt_grouped(torch.from_numpy(digits),
                                          torch.from_numpy(planes), 1 << 12,
                                          js)
    np.testing.assert_array_equal(u64(got), want)


def test_ntt_product_matches_the_truncated_negacyclic_product():
    """At N = 64 against the port's own schoolbook: Σ_r d ⊛ trunc(ext)
    over the kept planes (truncation.truncate_u64_values)."""
    b, g, r, o, n, js = 2, 3, 3, 2, 64, 4
    digits, planes, ext = _operands(b, g, r, o, n, js, 1 << 12, seed=9)
    got = tntt.polymul_digits_ntt_grouped(torch.from_numpy(digits),
                                          torch.from_numpy(planes), 1 << 12,
                                          js)
    ext_t = ttrunc.truncate_u64_values(t64(ext), js)             # [B, O, R, N]
    d = torch.from_numpy(digits).to(torch.int64)[:, :, None]     # [B, G, 1, R, N]
    want = torch.zeros((b, g, o, r, n), dtype=torch.int64)
    for j in range(n):                     # Σ_j d[j]·X^j·ext, wrapping
        want += d[..., j:j + 1] * tpoly.monomial_mul_static(ext_t, j)[:, None]
    want = want.sum(dim=3)
    np.testing.assert_array_equal(u64(got), u64(want))


@pytest.mark.parametrize("pretruncated", [True, False])
def test_ntt_against_k3_on_the_extension(pretruncated):
    """K3 (its plain version) reads both halves of the extension's kept
    planes, the NTT only the first: they agree where the dropped planes
    of -x are those of x negated — always on pre-truncated polynomials,
    not at ~1/256 of random ones (the JAX package's two products differ
    the same way)."""
    b, g, r, o, n, js, n_d = 4, 3, 2, 2, 64, 5, 2
    rng = np.random.default_rng(11)
    digits = torch.from_numpy(
        rng.integers(-512, 513, (b, g, r, n)).astype(np.int32))
    polys = t64(rng.integers(0, 1 << 64, (b, r, o, n), dtype=np.uint64))
    if pretruncated:
        polys = ttrunc.truncate_u64_values(polys, js)
    planes = kx.split_polys_ext(polys)[js:].contiguous()  # [8-js, B, R, O, 2N]
    got = tntt.polymul_digits_ntt_grouped(digits, planes, 512, js)
    dig = ttorus.split_int32_signed(digits, n_d)          # [n_d, B, G, R, N]
    k3 = kx.extprod_grouped_fused_plain(
        dig.permute(1, 3, 0, 2, 4).reshape(b, r, n_d * g, n),
        planes.permute(1, 3, 2, 0, 4).contiguous(), n_d, js)  # [B, O, G, N]
    same = torch.equal(got, k3.permute(0, 2, 1, 3))
    assert same == pretruncated


@pytest.mark.parametrize("p", tntt.PRIMES)
def test_reduce_matches_jax_barrett_at_its_edges(p):
    xs = [(1 << 28) - 1, -(1 << 28) + 1, 0, p, -p, p // 2, -(p // 2),
          p // 2 + 1, -(p // 2) - 1, 123456789, (1 << 30) - 1]
    want = np.asarray(jntt._barrett(jnp.asarray(xs, jnp.int32), p))
    got = tntt._reduce(torch.tensor(xs, dtype=torch.int64), p)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert (got.abs() <= p // 2).all()


@pytest.mark.parametrize("v", [0, 1, -1, 12288, -12289, 10 ** 15,
                               -(10 ** 15)])
def test_garner_matches_jax(v):
    big = np.prod(tntt.PRIMES, dtype=object)
    for value in (v, big // 2 - 1 - abs(v) % 7, -(big // 2) + 1 + abs(v) % 7):
        res = [value % p if value % p <= p // 2 else value % p - p
               for p in tntt.PRIMES]
        want = int(np.asarray(jntt._garner_u64(
            [jnp.asarray([x], jnp.int32) for x in res], jntt.PRIMES))[0])
        got = tntt._garner(torch.tensor(res, dtype=torch.int64)[:, None])
        assert int(u64(got)[0]) == want == value % (1 << 64)


def test_matrices_are_the_jax_packages():
    for n in (64, 512):
        for p in tntt.PRIMES:
            for a, b in zip(tntt._mats_np(n, p), jntt._mats_np(n, p)):
                np.testing.assert_array_equal(a, b)


def test_n1024_raises_the_jax_packages_error():
    """At N = 1024 13313 has no 2048-th root: both packages raise the same
    ValueError (the JAX package at trace time), and refusal() names it."""
    digits, planes, _ = _operands(1, 1, 4, 2, 1024, 4, 1 << 12)
    with pytest.raises(ValueError) as want:
        jntt.polymul_digits_ntt_grouped(jnp.asarray(digits),
                                        jnp.asarray(planes), 1 << 12, 4)
    with pytest.raises(ValueError) as got:
        tntt.polymul_digits_ntt_grouped(torch.from_numpy(digits),
                                        torch.from_numpy(planes), 1 << 12, 4)
    assert str(got.value) == str(want.value) == \
        "no primitive 2048-th root mod 13313"
    assert str(want.value) in tntt.refusal(1024)
    assert [tntt.refusal(n) for n in (64, 128, 256, 512)] == [None] * 4


@pytest.mark.parametrize("case", ["planes", "digit", "rows"])
def test_guards_raise_value_error_where_jax_asserts(case):
    """n_j 5 (8 - js with js = 3: lvl256), |digit| bound above 2^12, and
    R = 9 rows (PARAMS_SQRD_LVL_64_MXU: k = 8, cbs_level 1): the JAX
    package's assert fires, the port raises ValueError."""
    p = tparams.PARAMS_SQRD_LVL_64_MXU
    js, d_bound, r = 4, 1 << 12, 5
    if case == "planes":
        js = 3
    elif case == "digit":
        d_bound = (1 << 12) + 1
    else:
        r = (p.glwe_dimension + 1) * p.cbs_level
        assert r == 9 == (jparams.PARAMS_SQRD_LVL_64_MXU.glwe_dimension + 1)
    digits, planes, _ = _operands(1, 1, r, 2, 64, js, 1 << 12)
    with pytest.raises(AssertionError):
        jntt.polymul_digits_ntt_grouped(jnp.asarray(digits),
                                        jnp.asarray(planes), d_bound, js)
    with pytest.raises(ValueError, match="CRT-NTT covers"):
        tntt.polymul_digits_ntt_grouped(torch.from_numpy(digits),
                                        torch.from_numpy(planes), d_bound, js)
