"""The 1-bit WoP-PBS model of the PyTorch port against the JAX package:
BitCt metadata rules (noise, components, degree), lane operations, and the
circuit bootstrap on identical keys, bit for bit (truncate=False)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tfhe_aes2_tpu.models import shortint_woppbs_1bit as jm1

from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as tm1
from tests.torch_port_common import port_context, t64, u64


@pytest.fixture(scope="module")
def contexts(keys_test):
    jclient, jsks = keys_test
    jctx = jm1.FheContext(params=jclient.params,
                          sks=jax.tree_util.tree_map(jnp.asarray, jsks))
    _, tctx = port_context(keys_test, truncate=False)
    return jclient, jctx, tctx


def _pair(jclient, jctx, tctx, bits, lane_ndim):
    cts = jclient.encrypt_bits(bits)
    return (jm1.fresh_bitct(jnp.asarray(cts), jctx, lane_ndim=lane_ndim),
            tm1.fresh_bitct(t64(cts), tctx, lane_ndim=lane_ndim))


def _same(jct, tct):
    np.testing.assert_array_equal(u64(tct.array), np.asarray(jct.array))
    np.testing.assert_array_equal(tct.noise_sq, jct.noise_sq)
    np.testing.assert_array_equal(tct.degree, jct.degree)
    sizes = np.frompyfunc(len, 1, 1)
    np.testing.assert_array_equal(sizes(tct.comps), sizes(jct.comps))


def test_xor_and_lane_ops_match(contexts):
    jclient, jctx, tctx = contexts
    bits = np.random.default_rng(1).integers(0, 2, (2, 4, 8))
    ja, ta = _pair(jclient, jctx, tctx, bits, 2)
    jb, tb = _pair(jclient, jctx, tctx, bits[0], 2)
    _same(ja ^ jb, ta ^ tb)
    _same(ja.take_lanes([3, 0, 1], axis=0), ta.take_lanes([3, 0, 1], axis=0))
    _same(ja.slice_lanes(slice(2, 6), axis=-1),
          ta.slice_lanes(slice(2, 6), axis=-1))
    _same(ja.reshape_lanes(32), ta.reshape_lanes(32))
    jt, tt = jctx.trivial_bits([1, 0, 1, 1]), tctx.trivial_bits([1, 0, 1, 1])
    _same(jt, tt)
    jx = jm1.BitCt.concat_lanes([jb.slice_lanes(slice(0, 1)),
                                 ja.slice_lanes(slice(1, 2))], axis=0)
    tx = tm1.BitCt.concat_lanes([tb.slice_lanes(slice(0, 1)),
                                 ta.slice_lanes(slice(1, 2))], axis=0)
    _same(jx, tx)
    # the XOR of a trivial 0 keeps degree 0 + fresh 1 -> 1; of trivials: bit
    np.testing.assert_array_equal((tt ^ tctx.trivial_bits([1, 1, 0, 0])).degree,
                                  [1, 1, 1, 1])


def test_noise_checks_always_on(contexts):
    jclient, jctx, tctx = contexts
    _, ta = _pair(jclient, jctx, tctx, np.zeros((4, 8), int), 2)
    with pytest.raises(tm1.NoiseError, match="not independent"):
        ta ^ ta
    over = tm1.BitCt(ta.array, np.full((4, 8), 64, np.int64), ta.comps, tctx)
    _, tb = _pair(jclient, jctx, tctx, np.zeros((4, 8), int), 2)
    with pytest.raises(tm1.NoiseError, match="NoiseTooBig"):
        over ^ tb
    batched = tm1.BitCt(ta.array[None], ta.noise_sq, ta.comps, tctx)
    with pytest.raises(ValueError, match="batchless"):
        tctx.circuit_bootstrap_mixed([(batched,
                                       np.zeros((1, 1, 64), np.uint64))])


def test_circuit_bootstrap_matches(contexts):
    """The model's circuit bootstrap (8->2-bit LUT) bit-equal with the JAX
    model, metadata included (the mixed front end is held against the JAX
    package by the key schedule in test_torch_slice.py)."""
    jclient, jctx, tctx = contexts
    bits = np.unpackbits(np.array([[0x17], [0xe2]], np.uint8), axis=-1)
    ja, ta = _pair(jclient, jctx, tctx, bits, 2)            # lanes [2, 8]
    f = lambda v: (v ^ (v >> 3)) & 3                        # noqa: E731
    lut_j = jctx.generate_lookup_table(8, 2, f)
    lut_t = tctx.generate_lookup_table(8, 2, f)
    np.testing.assert_array_equal(lut_t, lut_j)
    jo, to = jctx.circuit_bootstrap(ja, lut_j), tctx.circuit_bootstrap(ta, lut_t)
    _same(jo, to)
    np.testing.assert_array_equal(
        jclient.decrypt_bits(u64(to.array)),
        [[(f(0x17) >> 1) & 1, f(0x17) & 1], [(f(0xe2) >> 1) & 1, f(0xe2) & 1]])
