"""The per-block addressing of the two kernels that store their int32
buckets — K8 (csrc/vp.cu, K3's tensor-core kernel built with PARTIALS) and
K7 (csrc/step.cu, K6's built the same way) — emulated in numpy and held
against `extprod_partials_grouped_plain` and `extprod_partials_plain`.

The contraction's fragment map is `contract_buckets`'s
(tests/test_torch_mma_layout.py), followed register by register, and the
staging is `staged_block`'s (tests/test_torch_step_mma_layout.py). What is
new here is where K8's operands lie: its key planes are not contiguous per
contraction row — plane j of (lane b, row r, component o) at
j·B·R·O·2N + ((b·R + r)·O + o)·2N, staged plane by plane through the
Staged record's key row and plane strides (KEY_STRIDED) — its digits are
batch-major ([n_d, B, G, R, N]: accumulators R·N bytes apart, rows N), and
its epilogue stores each int32 bucket where it is, out[s][b][g][o][m], with
the rows s < js written as zeros. K7 reads K6's batch-major digits
([n_d, B, R, N]) and all 8 key planes of [8, R, O, 2N] — plane j of (row
r, component o) at j·R·O·2N + r·O·2N + o·2N, KEY_STRIDED as K8's — and
stores bucket s of lane b at out[s][b][o][m]. Change an index in vp.cu,
step.cu or nc_mma.cuh -> change it here first. Needs nothing of the JAX
package.
"""

import re

import numpy as np
import pytest
import torch

from tfhe_aes2_tpu_torch import cli
from tfhe_aes2_tpu_torch.ops import decomposition, params, polynomial, torus
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx
from tests.test_torch_mma_layout import ROWS, block_output, contract_buckets
from tests.test_torch_step_mma_layout import staged_block

POISON = 0x5A5A5A5A


def k8_emulated(dig, ext):
    """dig int8 [n_d, B, G, R, N], ext int8 [8-js, B, R, O, 2N] -> int32
    [8, B, G, O, N] as the kernel writes it: grid (ceil(G/8), O, B); block
    (g-tile, o, b)'s Staged record; each D register's buckets stored at
    out_g + row·O·N + m + s·B·G·O·N, zeros for s < js."""
    n_d, b, g, r_cnt, n = dig.shape
    nj, _, _, o_cnt, two_n = ext.shape
    js = 8 - nj
    dig_f, ext_f = dig.reshape(-1), ext.reshape(-1)
    out = np.full(8 * b * g * o_cnt * n, POISON, dtype=np.int64)
    plane = b * g * o_cnt * n
    for lane in range(b):
        for o in range(o_cnt):
            for g0 in range(0, g, ROWS):
                rows = min(ROWS, g - g0)
                rec = ((lane * r_cnt * o_cnt + o) * two_n,
                       (lane * g + g0) * r_cnt * n,
                       n, b * g * r_cnt * n, r_cnt * n)
                tile, key = staged_block(
                    dig_f, ext_f, rec, r_cnt, rows, n_d, nj, n,
                    key_strides=(o_cnt * two_n, b * r_cnt * o_cnt * two_n))
                buckets = contract_buckets(tile, key, js)
                out_g = ((lane * g + g0) * o_cnt + o) * n
                for s in range(8):
                    block = (np.zeros((ROWS, n), dtype=np.int64) if s < js
                             else block_output(buckets[s - js], n))
                    for row in range(rows):
                        at = out_g + row * o_cnt * n + s * plane
                        assert (out[at:at + n] == POISON).all()
                        out[at:at + n] = block[row]
    assert (out != POISON).all()               # every word written once
    return out.astype(np.int32).reshape(8, b, g, o_cnt, n)


@pytest.mark.parametrize("g", [1, 5, 24])
@pytest.mark.parametrize("js", [0, 4])
@pytest.mark.parametrize("n_d", [1, 2])
def test_k8_staged_addressing_matches_plain(g, js, n_d):
    """K8 through nc::contract_mma with strided key planes and batch-major
    digits, one G-tile of up to 8 accumulators a block (G = 1 and 5 leave
    a tile ragged, 24 fills three), its buckets stored by the fragment map
    and the rows s < js zero: equal to extprod_partials_grouped_plain bit
    for bit, and recombined equal to K3's plain product."""
    rng = np.random.default_rng(100 * g + 10 * js + n_d)
    b, o_cnt, r_cnt, n = 2, 2, 3, 64
    dig = rng.integers(-128, 128, (n_d, b, g, r_cnt, n), dtype=np.int8)
    ext = rng.integers(-128, 128, (8 - js, b, r_cnt, o_cnt, 2 * n),
                       dtype=np.int8)
    want = kx.extprod_partials_grouped_plain(torch.from_numpy(dig),
                                             torch.from_numpy(ext),
                                             js).numpy()
    got = k8_emulated(dig, ext)
    assert np.array_equal(got, want)
    assert not got[:js].any()
    fused = kx.extprod_grouped_fused_plain(
        torch.from_numpy(np.ascontiguousarray(
            dig.transpose(1, 3, 0, 2, 4).reshape(b, r_cnt, n_d * g, n))),
        torch.from_numpy(np.ascontiguousarray(ext.transpose(1, 3, 2, 0, 4))),
        n_d, js)                                           # [B, O, G, N]
    assert torch.equal(polynomial.recombine_partials(torch.from_numpy(got),
                                                     js),
                       fused.permute(0, 2, 1, 3))


def test_k8_extreme_values_stay_in_int32():
    """Every digit and key byte -128 at R=5, the vertical packing's
    contraction: the buckets the kernel stores, reproduced exactly."""
    n_d, b, g, r_cnt, o_cnt, n, js = 2, 1, 3, 5, 2, 64, 4
    dig = np.full((n_d, b, g, r_cnt, n), -128, dtype=np.int8)
    ext = np.full((8 - js, b, r_cnt, o_cnt, 2 * n), -128, dtype=np.int8)
    want = kx.extprod_partials_grouped_plain(torch.from_numpy(dig),
                                             torch.from_numpy(ext),
                                             js).numpy()
    assert np.array_equal(k8_emulated(dig, ext), want)


def test_k8_needs_n_64_off_the_cpu():
    """K8's kernel is a tensor-core kernel: off the CPU it refuses N < 64
    before any launch (it takes N from 64 to 1024); on the CPU the plain
    version takes N = 32."""
    for dev in ("meta", "cpu"):
        dig = torch.zeros((2, 1, 3, 2, 32), dtype=torch.int8, device=dev)
        ext = torch.zeros((4, 1, 2, 2, 64), dtype=torch.int8, device=dev)
        if dev == "cpu":
            assert kx.extprod_partials_grouped(dig, ext, 4).shape == (
                8, 1, 3, 2, 32)
        else:
            with pytest.raises(ValueError, match=r"\[64, 1024\]"):
                kx.extprod_partials_grouped(dig, ext, 4)


@pytest.mark.parametrize("n_d", [1, 3])
def test_k3_k8_take_two_limbs_at_n1024_off_the_cpu(n_d):
    """At N = 1024 K3 and K8 are built for the n_d of extprod.WIDE_ND only,
    1 and 2 (csrc/vp.cu): off the CPU n_d = 3 is refused before a launch,
    and n_d = 1 passes the geometry check to the device check (here: no
    CUDA tensors). 2 is what the circuit bootstrap of lvl1, lvl4 and lvl256
    gives, 1 what PARAMS_WOPPBS_8BIT's gives."""
    n, js = 1024, 3
    dig3 = torch.zeros((1, 3, n_d, n), dtype=torch.int8, device="meta")
    ext3 = torch.zeros((1, 3, 3, 8 - js, 2 * n), dtype=torch.int8,
                       device="meta")
    dig8 = torch.zeros((n_d, 1, 1, 3, n), dtype=torch.int8, device="meta")
    ext8 = torch.zeros((8 - js, 1, 3, 3, 2 * n), dtype=torch.int8,
                       device="meta")
    match = ("n_d in [1, 2] only" if n_d not in kx.WIDE_ND
             else "must all lie on one CUDA device")
    with pytest.raises(ValueError, match=re.escape(match)):
        kx.extprod_grouped_fused(dig3, ext3, n_d, js)
    with pytest.raises(ValueError, match=re.escape(match)):
        kx.extprod_partials_grouped(dig8, ext8, js)
    wide = [p for p in cli.PARAM_CHOICES.values()
            if p.polynomial_size == 1024] + [params.PARAMS_WOPPBS_8BIT]
    assert len(wide) == 4
    assert {torus.limbs_for_bound(decomposition.digit_bound(p.cbs_base_log))
            for p in wide} == set(kx.WIDE_ND) == {1, 2}


def split_emulated(dig, ext, g, partials):
    """K3 (dig int8 [B, R, n_d·G, N], ext int8 [B, O, R, 8-js, 2N] -> int64
    [B, O, G, N]) or K8 (its own layouts, as k8_emulated; -> int32
    [8, B, G, O, N]) at N = 1024, as the split build runs it: grid (2·ceil(G/8), O, B), block x = 2·(G-tile)
    + h owning columns [512h, 512h + 512), c0 = 512h; each word of the
    output written once."""
    if partials:
        n_d, b, _, r_cnt, n = dig.shape
        nj, _, _, o_cnt, two_n = ext.shape
    else:
        b, r_cnt, ndg, n = dig.shape
        _, o_cnt, _, nj, two_n = ext.shape
        n_d = ndg // g
    js = 8 - nj
    assert n == 1024
    dig_f, ext_f = dig.reshape(-1), ext.reshape(-1)
    out = np.full((8 if partials else 1, b, o_cnt, g, n), POISON,
                  dtype=np.int64)
    for lane in range(b):
        for o in range(o_cnt):
            for x in range(2 * -(-g // ROWS)):
                g0, c0 = (x >> 1) * ROWS, (x & 1) * 512
                rows = min(ROWS, g - g0)
                if partials:
                    rec = ((lane * r_cnt * o_cnt + o) * two_n,
                           (lane * g + g0) * r_cnt * n,
                           n, b * g * r_cnt * n, r_cnt * n)
                    strides = (o_cnt * two_n, b * r_cnt * o_cnt * two_n)
                else:
                    rec = ((lane * o_cnt + o) * r_cnt * nj * two_n,
                           (lane * r_cnt * n_d * g + g0) * n,
                           n_d * g * n, g * n, n)
                    strides = None
                tile, key = staged_block(dig_f, ext_f, rec, r_cnt, rows,
                                         n_d, nj, n, key_strides=strides)
                buckets = contract_buckets(tile, key, js, c0)
                if partials:
                    blocks = [np.zeros((ROWS, n), dtype=np.int64) if s < js
                              else block_output(buckets[s - js], n, c0)
                              for s in range(8)]
                else:
                    total = np.zeros(buckets.shape[1:], dtype=np.uint64)
                    for s in range(nj):
                        total += (buckets[s].view(np.uint64)
                                  << np.uint64(8 * (s + js)))
                    blocks = [block_output(total.view(np.int64), n, c0)]
                for s, block in enumerate(blocks):
                    part = out[s, lane, o, g0:g0 + rows, c0:c0 + 512]
                    assert (part == POISON).all()
                    part[...] = block[:rows, c0:c0 + 512]
    assert (out != POISON).all()               # every word written once
    if partials:
        return out.astype(np.int32).transpose(0, 1, 3, 2, 4)
    return out[0]


@pytest.mark.parametrize("kernel", ["K3", "K8"])
@pytest.mark.parametrize("n_d", sorted(kx.WIDE_ND))
def test_k3_k8_split_builds_at_n1024(kernel, n_d):
    """The N = 1024 split instantiations of K3 and K8 (VP_SPLIT_DISPATCH,
    csrc/vp.cu) for every n_d they are built for, 1 (PARAMS_WOPPBS_8BIT)
    and 2: two blocks a G-tile, each contracting all 1024 digit columns for
    its own 512 output columns, G = 9 (a full tile and a ragged one),
    js = 3 (both sets' vertical packing at js = 3); stitched together they
    equal the plain version bit for bit."""
    rng = np.random.default_rng(1024 + 10 * n_d + (kernel == "K8"))
    b, o_cnt, r_cnt, n, js, g = 1, 2, 2, 1024, 3, 9
    nj = 8 - js
    if kernel == "K8":
        dig = rng.integers(-128, 128, (n_d, b, g, r_cnt, n), dtype=np.int8)
        ext = rng.integers(-128, 128, (nj, b, r_cnt, o_cnt, 2 * n),
                           dtype=np.int8)
        want = kx.extprod_partials_grouped_plain(
            torch.from_numpy(dig), torch.from_numpy(ext), js).numpy()
    else:
        dig = rng.integers(-128, 128, (b, r_cnt, n_d * g, n), dtype=np.int8)
        ext = rng.integers(-128, 128, (b, o_cnt, r_cnt, nj, 2 * n),
                           dtype=np.int8)
        want = kx.extprod_grouped_fused_plain(
            torch.from_numpy(dig), torch.from_numpy(ext), n_d, js).numpy()
    got = split_emulated(dig, ext, g, kernel == "K8")
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def k7_emulated(dig, ext):
    """dig int8 [n_d, B, R, N], ext int8 [8, R, O, 2N] -> int32 [8, B, O, N]
    as the kernel writes it: grid (ceil(B/8), O); block (tile, o)'s Staged
    record (K6's digit strides, the key planes through ext_r = O·2N and
    ext_plane = R·O·2N); each D register's 8 buckets stored at
    out_o + lane·O·N + m + s·B·O·N."""
    n_d, b, r_cnt, n = dig.shape
    nj, _, o_cnt, two_n = ext.shape
    assert nj == 8
    dig_f, ext_f = dig.reshape(-1), ext.reshape(-1)
    out = np.full(8 * b * o_cnt * n, POISON, dtype=np.int64)
    plane = b * o_cnt * n
    for o in range(o_cnt):
        for b0 in range(0, b, ROWS):
            rows = min(ROWS, b - b0)
            rec = (o * two_n, b0 * r_cnt * n, n, b * r_cnt * n, r_cnt * n)
            tile, key = staged_block(
                dig_f, ext_f, rec, r_cnt, rows, n_d, 8, n,
                key_strides=(o_cnt * two_n, r_cnt * o_cnt * two_n))
            buckets = contract_buckets(tile, key, 0)
            out_o = (b0 * o_cnt + o) * n
            for s in range(8):
                block = block_output(buckets[s], n)
                for lane in range(rows):
                    at = out_o + lane * o_cnt * n + s * plane
                    assert (out[at:at + n] == POISON).all()
                    out[at:at + n] = block[lane]
    assert (out != POISON).all()               # every word written once
    return out.astype(np.int32).reshape(8, b, o_cnt, n)


@pytest.mark.parametrize("b", [1, 13])
@pytest.mark.parametrize("n_d", [1, 2, 3])
def test_k7_staged_addressing_matches_plain(b, n_d):
    """K7 through nc::contract_mma at JS = 0 with strided key planes and
    batch-major digits, 8 lanes a block (B = 1 leaves a tile with one lane,
    13 a ragged second tile), all 8 buckets stored by the fragment map:
    equal to extprod_partials_plain bit for bit, and with the key planes
    below js = 2 zeroed, recombined equal to K6's plain update."""
    rng = np.random.default_rng(300 + 10 * b + n_d)
    o_cnt, r_cnt, n, js = 2, 3, 64, 2
    dig = rng.integers(-128, 128, (n_d, b, r_cnt, n), dtype=np.int8)
    ext = rng.integers(-128, 128, (8, r_cnt, o_cnt, 2 * n), dtype=np.int8)
    got = k7_emulated(dig, ext)
    want = kx.extprod_partials_plain(torch.from_numpy(dig),
                                     torch.from_numpy(ext)).numpy()
    assert np.array_equal(got, want)
    ext[:js] = 0
    acc = torch.zeros((b, o_cnt, n), dtype=torch.int64)
    step = kx.extprod_step_plain(
        torch.from_numpy(dig),
        torch.from_numpy(np.ascontiguousarray(ext[js:].transpose(2, 1, 0,
                                                                  3))),
        acc, js)
    assert torch.equal(polynomial.recombine_partials(
        torch.from_numpy(k7_emulated(dig, ext))), step)


def test_k7_extreme_values_stay_in_int32():
    """Every digit and key byte -128 at the blind rotation's R=15, N=512 and
    n_d=2: the int32 buckets K7 stores (each at n_d·R·N·2^14, the bound the
    wrapper admits) reproduced exactly."""
    n_d, b, r_cnt, o_cnt, n = 2, 1, 15, 1, 512
    dig = np.full((n_d, b, r_cnt, n), -128, dtype=np.int8)
    ext = np.full((8, r_cnt, o_cnt, 2 * n), -128, dtype=np.int8)
    want = kx.extprod_partials_plain(torch.from_numpy(dig),
                                     torch.from_numpy(ext)).numpy()
    assert np.abs(want.astype(np.int64)).max() == n_d * r_cnt * n * 2 ** 14
    assert np.array_equal(k7_emulated(dig, ext), want)


def test_k7_needs_n_64_off_the_cpu():
    """K7's kernel is a tensor-core kernel: off the CPU it refuses N < 64
    before any launch; on the CPU the plain version takes N = 32."""
    for dev in ("meta", "cpu"):
        dig = torch.zeros((2, 3, 2, 32), dtype=torch.int8, device=dev)
        ext = torch.zeros((8, 2, 2, 64), dtype=torch.int8, device=dev)
        if dev == "cpu":
            assert kx.extprod_partials(dig, ext).shape == (8, 3, 2, 32)
        else:
            with pytest.raises(ValueError, match=r"\[64, 1024\]"):
                kx.extprod_partials(dig, ext)
