"""ops/torus.device_const: the request path's constants (LUT stacks, lane
indices, clear bits) are copied to the device once and then served from a
cache keyed by their content, so a warm request makes no host-to-device
copy of its own. The helper against torch.as_tensor / to_tensor, its hits
and misses, its bound, its counts under threads, and warm requests of both
pipelines at PARAMS_TEST: no upload, outputs bit-equal to the cold run's,
and no cached constant written."""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from tfhe_aes2_tpu_torch.aes_128 import fhe, fhe_encryption, plain
from tfhe_aes2_tpu_torch.aes_128 import sbox_pbs
from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as tm1
from tfhe_aes2_tpu_torch.ops import torus
from tfhe_aes2_tpu_torch.ops.torus import device_const, to_tensor
from tests.torch_port_common import port_context, private_keys

KEY = bytes(range(16))
# the constants one warm latency-path request asks for (aes_128/fhe.py,
# sbox_gal_mul_pbs.py): group 1's preboot (round constant, RotWord index,
# SBOX LUT), 9 fused middle steps of 11 (3 LUTs, RotWord, 3 ShiftRows,
# 3 row rotations, round constant), the final step (2 LUTs, ShiftRows)
LATENCY_CONSTS = 3 + 9 * 11 + 3
# sbox_pbs.encrypt_block_for_rounds at 2 rounds: a middle round (SBOX LUT,
# ShiftRows, 2 shifted-in zeros of the leveled GalMul, 3 row rotations)
# and the final round (SBOX LUT, ShiftRows)
SBOX_PBS_2_ROUND_CONSTS = 7 + 2


def _counts():
    return device_const.uploads, device_const.hits


def _assert_cache_unchanged():
    """Every cached tensor still holds the bytes it was made from."""
    with torus._CONSTS_LOCK:
        entries = list(torus._CONSTS.items())
    assert entries
    for (_, dtype, np_dtype, shape, raw), t in entries:
        want = torch.from_numpy(
            np.frombuffer(raw, np.dtype(np_dtype)).reshape(shape).copy())
        assert torch.equal(t.to("cpu"), want.to(dtype=dtype))


@pytest.mark.parametrize("x, dtype", [
    (np.array([[1, 2**63, 2**64 - 1]], np.uint64), torch.int64),
    (np.array([4, 9, 14, 3], np.int32), torch.int64),
    (np.array([0, 1, 1, 0, 1], np.uint8), None),
    (np.array([[True, False]]), None),
    ([1, 0, 1], None),
], ids=["lut_u64", "lane_idx", "bits_u8", "bool", "list"])
def test_device_const_equals_as_tensor(x, dtype):
    got = device_const(x, "cpu", dtype)
    arr = np.asarray(x)
    want = (to_tensor(arr, "cpu") if arr.dtype == np.uint64
            else torch.as_tensor(arr, dtype=dtype))
    assert got.dtype == want.dtype and torch.equal(got, want)
    # a second call hands back the cached tensor, still equal
    assert device_const(x, "cpu", dtype) is got and torch.equal(got, want)


def test_device_const_hits_on_content_not_identity():
    base = np.random.default_rng(3).integers(0, 2**62, (3, 1, 32),
                                             dtype=np.int64).astype(np.uint64)
    up0, hit0 = _counts()
    first = device_const(base, "cpu", torch.int64)
    again = device_const(base.copy(), "cpu", torch.int64)   # equal content
    assert again is first
    other = base.copy()
    other[2, 0, 31] ^= np.uint64(1)                          # same shape
    changed = device_const(other, "cpu", torch.int64)
    assert changed is not first
    assert torch.equal(changed, to_tensor(other, "cpu"))
    assert torch.equal(first, to_tensor(base, "cpu"))
    # the same bytes under another shape or dtype are other constants
    assert device_const(base.reshape(3, 32), "cpu", torch.int64) is not first
    assert device_const(base, "cpu", torch.float64) is not first
    assert _counts() == (up0 + 4, hit0 + 1)


def test_device_const_copies_the_host_array():
    """The cached tensor does not alias the caller's array: writing the
    array afterwards changes neither the tensor nor what a hit returns."""
    arr = np.arange(6, dtype=np.int64) + 1000
    t = device_const(arr, "cpu")
    arr[:] = 0
    assert torch.equal(t, torch.arange(6) + 1000)
    assert torch.equal(device_const(np.arange(6) + 1000, "cpu"), t)


def test_device_const_lru_bound(monkeypatch):
    monkeypatch.setattr(torus, "CONST_MAX_ENTRIES", 4)
    monkeypatch.setattr(torus, "CONST_MAX_BYTES", 64)
    seq = [np.full(3, 7_000 + i, np.int64) for i in range(6)]
    for a in seq:
        device_const(a, "cpu")
    assert len(torus._CONSTS) == 4
    up0, hit0 = _counts()
    device_const(seq[-1], "cpu")               # kept: a hit
    device_const(seq[0], "cpu")                # evicted first: a miss
    assert _counts() == (up0 + 1, hit0 + 1)
    assert len(torus._CONSTS) == 4
    big = np.arange(9, dtype=np.int64)         # 72 bytes, over the cap
    t = device_const(big, "cpu")
    assert torch.equal(t, torch.arange(9))
    assert device_const(big, "cpu") is not t   # copied, never kept
    assert all(k[-1] != big.tobytes() for k in torus._CONSTS)


def test_device_const_counts_every_call_under_threads():
    """16 threads on a few shared keys with a short switch interval: every
    call is counted once, as an upload or a hit (a lost update breaks the
    sum), each key holds one tensor, and every result has its values."""
    keys = [np.array([50_000 + i, i], np.int64) for i in range(5)]
    calls, n_threads = 200, 16
    up0, hit0 = _counts()
    bad = []

    def work(seed):
        rng = np.random.default_rng(seed)
        for _ in range(calls):
            k = keys[rng.integers(len(keys))]
            if not torch.equal(device_const(k, "cpu"), torch.from_numpy(k)):
                bad.append(k)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,))
                   for s in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    up, hit = _counts()
    assert (up - up0) + (hit - hit0) == calls * n_threads
    assert len(keys) <= up - up0 <= n_threads * len(keys)
    assert not bad
    for k in keys:
        assert device_const(k, "cpu") is device_const(k, "cpu")


@pytest.fixture(scope="module")
def context(keys_test):
    return port_context(private_keys(keys_test), truncate=True)


def test_warm_latency_request_uploads_nothing(context):
    """fhe.encrypt_block_latency twice on the same ciphertexts: the second
    request finds each of its constants cached (no upload, one hit each),
    its output is bit-equal to the first's and decrypts to AES, and no
    constant was written."""
    client, ctx = context
    strat = fhe.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt
    blocks = [bytes(8) + (1).to_bytes(8, "big")]
    key_ct = to_tensor(fhe_encryption.encrypt_byte_array(client, KEY),
                       ctx.device)
    block_ct = to_tensor(fhe_encryption.encrypt_blocks(client, blocks),
                         ctx.device)
    first = fhe.encrypt_block_latency(strat, ctx, key_ct, block_ct)
    up0, hit0 = _counts()
    second = fhe.encrypt_block_latency(strat, ctx, key_ct, block_ct)
    assert _counts() == (up0, hit0 + LATENCY_CONSTS)
    assert torch.equal(second.array, first.array)
    assert (fhe_encryption.decrypt_blocks(client,
                                          torus.to_numpy(second.array))
            == plain.expand_key_and_encrypt_blocks(KEY, blocks, 10))
    _assert_cache_unchanged()


def test_warm_sbox_pbs_rounds_upload_nothing(context):
    """Two rounds of the depth-11 pipeline (sbox_pbs, under a clear key
    schedule encrypted; noise budget 256 as its XOR depth needs) twice on
    the same ciphertexts: the second run makes no upload, hits once a
    constant, is bit-equal to the first, and writes no constant."""
    client, ctx = context
    ctx = dataclasses.replace(
        ctx, params=dataclasses.replace(ctx.params,
                                        max_noise_level_squared=256))
    strat = fhe.ShortintWoppbs1BitSboxPbsAesEncrypt
    blocks = [bytes(range(16, 32))]
    eks = tm1.fresh_bitct(to_tensor(fhe_encryption.encrypt_word_array(
        client, plain.key_schedule(KEY)), ctx.device), ctx, lane_ndim=3)
    block_ct = to_tensor(fhe_encryption.encrypt_blocks(client, blocks),
                         ctx.device)
    assert strat.pipeline is sbox_pbs
    first = fhe.encrypt_blocks_staged(strat, ctx, eks, block_ct, 2)
    up0, hit0 = _counts()
    second = fhe.encrypt_blocks_staged(strat, ctx, eks, block_ct, 2)
    assert _counts() == (up0, hit0 + SBOX_PBS_2_ROUND_CONSTS)
    assert torch.equal(second.array, first.array)
    _assert_cache_unchanged()
