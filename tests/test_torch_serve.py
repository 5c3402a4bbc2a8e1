"""The port's keystream server (tfhe_aes2_tpu_torch/serve.py) and key
bundles (ops/serialization.py) against the JAX package's: bundles written
by either package load in the other array for array, message frames packed
by either are read by the other, the server bundle holds no secret key, the
expanded key that the latency path returns is key_schedule_staged's, and
the pair runs as two OS processes on the CPU (first request on the latency
path, second a cache hit with a homomorphically derived batch). Integer
data throughout: tolerance 0."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from tfhe_aes2_tpu import serve as jserve
from tfhe_aes2_tpu.ops import serialization as jser

from tfhe_aes2_tpu_torch import serve as tserve
from tfhe_aes2_tpu_torch.aes_128 import aes_lib, fhe as tfhe, fhe_encryption
from tfhe_aes2_tpu_torch.aes_128 import plain, scenario
from tfhe_aes2_tpu_torch.ops import compression
from tfhe_aes2_tpu_torch.ops import serialization as tser
from tests.torch_port_common import CPU, port_context, port_keys, t64, u64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
IV = bytes.fromhex("bdd219b8a08ded1a")
NAMES = ("bsk", "ksk", "pfpksk", "pksk")


def test_server_bundles_cross_load_between_the_packages(tmp_path, keys_test):
    jclient, jsks = keys_test
    client, raw = port_keys(keys_test)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jser.save_server_keys(jpath, jsks, jclient.params)
    tser.save_server_keys(tpath, raw, client.params)
    # the bundle holds evaluation keys ONLY, under the same entry names
    for path in (jpath, tpath):
        with np.load(path) as z:
            assert set(z.files) == set(NAMES) | {"params"}
            assert all(z[name].dtype == np.uint64 for name in NAMES)
    with np.load(jpath) as zj, np.load(tpath) as zt:
        for name in NAMES + ("params",):
            np.testing.assert_array_equal(zt[name], zj[name])
    # JAX bundle -> the port; port bundle -> the JAX package
    loaded, params = tser.load_server_keys(jpath)
    assert params == client.params
    jloaded, jparams = jser.load_server_keys(tpath)
    assert jparams == jclient.params
    on_cpu = tser.server_keys_on(loaded, CPU)
    for name in NAMES:
        np.testing.assert_array_equal(loaded[name],
                                      np.asarray(getattr(jsks, name)))
        np.testing.assert_array_equal(np.asarray(getattr(jloaded, name)),
                                      np.asarray(getattr(jsks, name)))
        np.testing.assert_array_equal(u64(getattr(on_cpu, name)),
                                      u64(getattr(raw, name)))


def test_client_keys_cross_load_and_keep_the_rng_stream(tmp_path, keys_test):
    jclient, _ = keys_test
    client, _ = port_keys(keys_test)
    jpath, tpath = str(tmp_path / "jc.npz"), str(tmp_path / "tc.npz")
    jser.save_client_key(jpath, jclient)
    tser.save_client_key(tpath, client)
    from_jax = tser.load_client_key(jpath)
    into_jax = jser.load_client_key(tpath)
    np.testing.assert_array_equal(from_jax.lwe_sk, jclient.lwe_sk)
    np.testing.assert_array_equal(from_jax.glwe_sk, jclient.glwe_sk)
    np.testing.assert_array_equal(into_jax.glwe_sk, client.glwe_sk)
    assert from_jax.params == client.params
    # encryption stays reproducible after the round trip
    again = tser.load_client_key(tpath)
    bits = np.array([1, 0, 1, 1], np.uint64)
    np.testing.assert_array_equal(again.encrypt_bits(bits),
                                  client.encrypt_bits(bits))


def test_message_frames_cross_read_and_are_pickle_free():
    arr = np.arange(6, dtype=np.uint64).reshape(2, 3)
    meta = {"rounds": 2, "compress": 16, "fhe_counter_count": 2}
    for pack, unpack in ((tserve.pack_msg, jserve.unpack_msg),
                         (jserve.pack_msg, tserve.unpack_msg),
                         (tserve.pack_msg, tserve.unpack_msg)):
        got_meta, got = unpack(pack(meta, key_ct=arr))
        assert got_meta == meta and set(got) == {"key_ct"}
        np.testing.assert_array_equal(got["key_ct"], arr)
    assert tserve.pack_msg(meta, key_ct=arr) == jserve.pack_msg(meta,
                                                                key_ct=arr)
    # the receiver's np.load refuses object arrays
    import io
    import json
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(json.dumps({}).encode(), np.uint8),
             evil=np.array([object()], dtype=object))
    with pytest.raises(ValueError):
        tserve.unpack_msg(buf.getvalue())


def test_key_digest_and_cache_bound_match_the_jax_server():
    arr = np.arange(12, dtype=np.uint64).reshape(3, 4)
    assert tserve._key_digest(arr) == jserve._key_digest(arr)
    assert tserve._key_digest(arr.T) == jserve._key_digest(arr.T)
    assert tserve._EKS_CACHE_MAX == jserve._EKS_CACHE_MAX == 4
    cache = {}
    for i in range(6):
        tserve._cache_put(cache, f"k{i}", i)
    assert list(cache) == ["k2", "k3", "k4", "k5"]      # least recent go


def test_latency_path_returns_the_staged_expanded_key(keys_test):
    """return_eks: the groups booted along the latency path are the
    expanded key of key_schedule_staged, ciphertexts and metadata."""
    client, ctx = port_context(keys_test, truncate=True)
    strat = tfhe.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt
    blocks = scenario.ctr_blocks(IV, 1)
    key_ct, block_cts = scenario.encrypt_request(client, ctx, strat, KEY,
                                                 blocks)
    out, eks = tfhe.encrypt_block_latency(strat, ctx, key_ct, block_cts,
                                          return_eks=True)
    ref = tfhe.key_schedule_staged(strat, ctx, key_ct)
    assert eks.lane_shape == ref.lane_shape == (44, 4, 8)
    np.testing.assert_array_equal(u64(eks.array), u64(ref.array))
    np.testing.assert_array_equal(eks.noise_sq, ref.noise_sq)
    alone = tfhe.encrypt_block_latency(strat, ctx, key_ct, block_cts)
    np.testing.assert_array_equal(u64(alone.array), u64(out.array))
    assert (fhe_encryption.decrypt_blocks(client, u64(out.array))
            == aes_lib.encrypt_blocks(KEY, blocks))
    # the cached key serves a later batch
    more = scenario.ctr_blocks(IV, 2)
    out2 = tfhe.encrypt_blocks_staged(
        strat, ctx, eks, t64(fhe_encryption.encrypt_blocks(client, more)), 2)
    assert (fhe_encryption.decrypt_blocks(client, u64(out2.array))
            == plain.expand_key_and_encrypt_blocks(KEY, more, 2))


def _wait_for_socket(proc, addr):
    for _ in range(1200):
        if os.path.exists(addr):
            return
        if proc.poll() is not None:
            raise AssertionError(f"server died: {proc.stderr.read()[-2000:]}")
        time.sleep(0.1)
    raise AssertionError("server socket never appeared")


def test_two_process_serving_on_the_cpu(tmp_path, keys_test):
    """tests/test_serve.py's run with the port's server: a second OS process
    that holds only the bundle; request 1 takes the latency path and fills
    the cache, request 2 hits it and derives its two blocks from one
    uploaded block."""
    client, raw = port_keys(keys_test)
    bundle = str(tmp_path / "server_keys.npz")
    tser.save_server_keys(bundle, raw, client.params)
    addr = str(tmp_path / "fhe.sock")
    env = dict(os.environ, TFHE_BR_KERNEL="merged", OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tfhe_aes2_tpu_torch.serve", "--keys", bundle,
         "--address", addr, "--max-requests", "2", "--device", "cpu"],
        env=env, cwd=REPO, stderr=subprocess.PIPE, text=True)
    try:
        _wait_for_socket(proc, addr)
        blocks = scenario.ctr_blocks(IV, 2)
        key_ct = fhe_encryption.encrypt_byte_array(client, KEY)
        block_cts = fhe_encryption.encrypt_blocks(client, blocks)

        meta, arrays = tserve.request_keystream(addr, key_ct, block_cts[:1],
                                                rounds=10, compress=16)
        assert meta["compress"] == 16 and arrays["comp"].dtype == np.uint16
        assert (compression.decrypt_blocks_compressed(client, arrays["comp"],
                                                      16)
                == aes_lib.encrypt_blocks(KEY, blocks[:1]))

        meta, arrays = tserve.request_keystream(
            addr, key_ct, block_cts[:1], rounds=2, compress=16,
            fhe_counter_count=2)
        assert meta["shape"] == [2, 16, 8, client.params.lwe_dimension + 1]
        assert (compression.decrypt_blocks_compressed(client, arrays["comp"],
                                                      16)
                == plain.expand_key_and_encrypt_blocks(KEY, blocks, 2))
    finally:
        try:
            rc = proc.wait(timeout=240)   # exits after max-requests replies
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait(timeout=60)
    err = proc.stderr.read()
    assert rc == 0, err[-2000:]
    assert "lowering br=merged" in err, err[-2000:]
    assert err.count("cache miss") == 1, err[-2000:]
    assert "fused latency path" in err, err[-2000:]
    assert "expanded-key cache hit" in err, err[-2000:]


def test_server_answers_a_bad_request_and_goes_on(tmp_path, keys_test):
    """A request that fails inside the server is answered ok: false (the
    client raises) and the server serves the next one; served here on a
    thread of this process through `serve.serve(device=..., lowering=...)`."""
    import threading

    from tfhe_aes2_tpu_torch.ops.lowering import Lowering

    client, raw = port_keys(keys_test)
    bundle = str(tmp_path / "server_keys.npz")
    tser.save_server_keys(bundle, raw, client.params)
    addr = str(tmp_path / "fhe.sock")
    th = threading.Thread(target=tserve.serve, args=(bundle, addr),
                          kwargs=dict(max_requests=2, device=CPU,
                                      lowering=Lowering("bucket")))
    th.start()
    try:
        for _ in range(600):
            if os.path.exists(addr):
                break
            time.sleep(0.1)
        key_ct = fhe_encryption.encrypt_byte_array(client, KEY)
        block_cts = fhe_encryption.encrypt_blocks(client,
                                                  scenario.ctr_blocks(IV, 1))
        with pytest.raises(RuntimeError, match="server error"):
            tserve.request_keystream(addr, key_ct[:, :, :5], block_cts,
                                     rounds=1)
        meta, arrays = tserve.request_keystream(addr, key_ct, block_cts,
                                                rounds=1, compress=0)
        assert meta == {"ok": True, "compress": 0}
        assert (fhe_encryption.decrypt_blocks(client, arrays["out"])
                == plain.expand_key_and_encrypt_blocks(
                    KEY, scenario.ctr_blocks(IV, 1), 1))
    finally:
        th.join(timeout=240)
    assert not th.is_alive()
