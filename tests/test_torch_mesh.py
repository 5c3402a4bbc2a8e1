"""The port's mesh layer (tfhe_aes2_tpu_torch/parallel/mesh.py) against the
JAX package's (tfhe_aes2_tpu/parallel/mesh.py) on the CPU, on the same keys
and ciphertexts: every layout of the sharded entry points gives bit-equal
ciphertexts. The port's logical CPU devices stand in for the JAX package's
forced host devices. Also the lane layout's BitCt metadata against the
unsharded context's, and the mesh's refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tfhe_aes2_tpu.aes_128 import fhe as jfhe
from tfhe_aes2_tpu.parallel import mesh as jmesh

from tfhe_aes2_tpu_torch.aes_128 import aes_lib, fhe as tfhe, fhe_encryption
from tfhe_aes2_tpu_torch.aes_128 import plain
from tfhe_aes2_tpu_torch.aes_128.scenario import ctr_blocks
from tfhe_aes2_tpu_torch.models.shortint_woppbs_1bit import BitCt
from tfhe_aes2_tpu_torch.parallel import mesh as tmesh
from tests.torch_port_common import port_context, t64, u64

KEY = bytes(range(16))
JSTRAT = jfhe.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt
TSTRAT = tfhe.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt


@pytest.fixture(scope="module")
def inputs(keys_test):
    """(JAX raw keys, port client and exact context, encrypted clear key
    schedule, encrypted key, 2 encrypted blocks, the clear blocks)."""
    jclient, jsks = keys_test
    _, ctx = port_context(keys_test, truncate=False)
    blocks = ctr_blocks(bytes(8), 2)
    ks_ct = fhe_encryption.encrypt_word_array(jclient, plain.key_schedule(KEY))
    key_ct = fhe_encryption.encrypt_byte_array(jclient, KEY)
    block_cts = fhe_encryption.encrypt_blocks(jclient, blocks)
    return (jax.tree_util.tree_map(jnp.asarray, jsks), jclient, ctx, ks_ct,
            key_ct, block_cts, blocks)


def _structure(comps):
    """Component sets up to relabelling."""
    flat = comps.reshape(-1)
    return (np.array([len(s) for s in flat]),
            np.array([[len(a & b) for b in flat] for a in flat]))


def _assert_same_bitct(got: BitCt, want: BitCt):
    assert torch.equal(got.array, want.array)
    np.testing.assert_array_equal(got.noise_sq, want.noise_sq)
    np.testing.assert_array_equal(got.degree, want.degree)
    assert got.lane_shape == want.lane_shape
    for a, b in zip(_structure(got.comps), _structure(want.comps)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,lanes,n_blocks", [(2, 1, 2), (8, 8, 1),
                                              (2, 2, 1), (4, 2, 2)])
def test_sharded_encrypt_blocks_bit_equal_to_jax(inputs, n, lanes, n_blocks):
    """dp over 2 devices; one block over 8 and over 2 lanes; 2 blocks x 2
    lanes: each against the JAX package's sharded function (1 round)."""
    jsks, jclient, ctx, ks_ct, _, block_cts, blocks = inputs
    jm = jmesh.make_mesh(n, lane_shards=lanes)
    jfn = jmesh.make_sharded_encrypt_blocks_fn(JSTRAT, jclient.params, 1, jm)
    want = np.asarray(jfn(jsks, jnp.asarray(ks_ct), jax.device_put(
        jnp.asarray(block_cts[:n_blocks]),
        NamedSharding(jm, jmesh.block_spec(jm)))))

    tm = tmesh.make_mesh(n, lane_shards=lanes, device="cpu")
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape)
    fn = tmesh.make_sharded_encrypt_blocks_fn(TSTRAT, ctx.params, 1, tm,
                                              ctx.lowering)
    got = fn(ctx.sks, t64(ks_ct), t64(block_cts[:n_blocks]))
    np.testing.assert_array_equal(u64(got), want)
    assert (fhe_encryption.decrypt_blocks(jclient, u64(got))
            == plain.expand_key_and_encrypt_blocks(KEY, blocks[:n_blocks], 1))


def test_sharded_full_aes_bit_equal_to_jax(inputs):
    """The FHE key schedule and 1 round over a 2-device 'block' mesh."""
    jsks, jclient, ctx, _, key_ct, block_cts, blocks = inputs
    jm = jmesh.make_mesh(2)
    jfn = jmesh.make_sharded_full_aes_fn(JSTRAT, jclient.params, 1, jm)
    want = np.asarray(jfn(jsks, jnp.asarray(key_ct), jax.device_put(
        jnp.asarray(block_cts), NamedSharding(jm, P("block")))))
    fn = tmesh.make_sharded_full_aes_fn(
        TSTRAT, ctx.params, 1, tmesh.make_mesh(2, device="cpu"), ctx.lowering)
    got = fn(ctx.sks, t64(key_ct), t64(block_cts))
    np.testing.assert_array_equal(u64(got), want)
    assert (fhe_encryption.decrypt_blocks(jclient, u64(got))
            == plain.expand_key_and_encrypt_blocks(KEY, blocks, 1))


def _lane_context(ctx, lanes):
    sharded = tmesh.row_contexts(tmesh.make_mesh(lanes, lane_shards=lanes,
                                                 device="cpu"),
                                 ctx.sks, ctx.params, ctx.lowering)[0]
    assert isinstance(sharded, tmesh.LaneShardedContext)
    return sharded


@pytest.mark.parametrize("lanes", [2, 8])
def test_lane_bootstrap_metadata_equals_unsharded(inputs, lanes):
    """The lane layout's SubBytes-shaped bootstrap of 2 blocks: ciphertexts
    and BitCt metadata (noise_sq, components, degree, lane shape) those of
    the unsharded context; an XOR of the outputs still passes the noise
    checks."""
    ctx, block_cts = inputs[2], inputs[5]
    sharded = _lane_context(ctx, lanes)
    lut = sharded.generate_lookup_table(8, 24, lambda v: v * 0x010101)
    outs = [c.circuit_bootstrap(TSTRAT.fresh(t64(block_cts), c, lane_ndim=2),
                                lut) for c in (ctx, sharded)]
    _assert_same_bitct(outs[1], outs[0])
    _assert_same_bitct(outs[1].slice_lanes(slice(0, 8), axis=1)
                       ^ outs[1].slice_lanes(slice(8, 16), axis=1),
                       outs[0].slice_lanes(slice(0, 8), axis=1)
                       ^ outs[0].slice_lanes(slice(8, 16), axis=1))


def test_lane_mixed_bootstrap_equals_unsharded(inputs):
    """The latency path (11 mixed bootstraps of key-schedule words and
    state bytes) under a 2-lane context: output and expanded key, arrays
    and metadata, those of the unsharded context, and the AES keystream."""
    _, jclient, ctx, _, key_ct, block_cts, _ = inputs
    lat = [tfhe.encrypt_block_latency(TSTRAT, c, t64(key_ct),
                                      t64(block_cts[0]), return_eks=True)
           for c in (ctx, _lane_context(ctx, 2))]
    for got, want in zip(lat[1], lat[0]):
        _assert_same_bitct(got, want)
    assert (fhe_encryption.decrypt_blocks(jclient, u64(lat[1][0].array)[None])
            == aes_lib.encrypt_blocks(KEY, ctr_blocks(bytes(8), 1)))


def test_block_spec_slices():
    spec = tmesh.block_spec(tmesh.make_mesh(8, lane_shards=4, device="cpu"),
                            4)
    assert spec.shape == (2, 4)
    assert spec[1, 2] == (slice(2, 4), slice(8, 12))
    assert tmesh.block_spec(tmesh.make_mesh(2, device="cpu"), 6)[1] == \
        (slice(3, 6), slice(0, 16))
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.block_spec(tmesh.make_mesh(2, device="cpu"), 3)


@pytest.mark.parametrize("n,lanes", [(3, 3), (2, 4), (6, 6), (4, 0)])
def test_lane_shards_must_divide_devices_and_16(n, lanes):
    with pytest.raises(ValueError, match="lane_shards"):
        tmesh.make_mesh(n, lane_shards=lanes, device="cpu")


def test_cuda_mesh_without_cuda_raises(monkeypatch):
    """A 'cuda' mesh on a host without CUDA raises; it never falls back to
    the CPU. Asking for more GPUs than the host has names the count."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 CUDA device"):
        tmesh.make_mesh(2, device="cuda")
    assert tmesh.make_mesh(device="cuda").devices.tolist() == [
        torch.device("cuda", 0)]


def test_mesh_refuses_other_models(inputs):
    with pytest.raises(ValueError, match="1-bit WoP-PBS"):
        tmesh.make_sharded_encrypt_blocks_fn(
            tfhe.ShortintWoppbs8BitSboxPbsAesEncrypt, inputs[2].params, 1,
            tmesh.make_mesh(1, device="cpu"))


def test_prepared_keys_to_keeps_layouts(inputs):
    """PreparedServerKeys.to: a no-op on any CPU device index; K4's keys
    stay K-major views (the layout the kernel reads without a copy)."""
    from tfhe_aes2_tpu_torch.ops.kernels import matmul as kmm

    keys = inputs[2].sks
    assert keys.to(torch.device("cpu", 3)) is keys
    for t in (keys.ksk, keys.pfpksk, keys.pksk):
        ld = kmm._kmajor_ld(t)
        again = kmm.kmajor_key_planes(t.clone())
        assert ld is not None and kmm._kmajor_ld(again) == ld
        assert torch.equal(again, t)


def test_stream_ptr_refuses_a_device_not_current(monkeypatch):
    """build.stream_ptr, which every kernel wrapper passes to its launch,
    raises for a device that is not the current CUDA device, naming both
    (checked here with the current device faked: no card needed)."""
    from tfhe_aes2_tpu_torch.ops.kernels import build

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="cuda:1 while cuda:0"):
        build.stream_ptr(torch.device("cuda", 1))
    with pytest.raises(RuntimeError, match="cpu while cuda:0"):
        build.stream_ptr(torch.device("cpu"))
