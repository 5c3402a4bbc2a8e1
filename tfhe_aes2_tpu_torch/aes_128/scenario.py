"""Client/server AES-CTR scenario (reference main.rs:97-159).

Per block the plaintext is IV(8 bytes) ‖ big-endian counter(8 bytes),
counter starting at 1. The client FHE-encrypts key and counter blocks; the
server expands the key and runs all rounds under FHE; the client decrypts
and the result is checked against the independent AES authority (or the
partial-round plain oracle when rounds < 10).
"""

from __future__ import annotations

import logging
import time

import torch

from tfhe_aes2_tpu_torch.aes_128 import aes_lib, fhe as fhe_mod, plain
from tfhe_aes2_tpu_torch.models.shortint_woppbs_1bit import FheContext
from tfhe_aes2_tpu_torch.ops.keys import ClientKey
from tfhe_aes2_tpu_torch.ops.torus import to_numpy, to_tensor

log = logging.getLogger("tfhe_aes2_tpu_torch")


def ctr_blocks(iv: bytes, count: int) -> list[bytes]:
    """iv ‖ counter blocks, counter = 1..count (main.rs:108-115)."""
    if len(iv) != 8:
        raise ValueError("iv must be 8 bytes")
    return [iv + int(c).to_bytes(8, "big") for c in range(1, count + 1)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_client_server_aes_scenario(
        client: ClientKey, ctx: FheContext, key_clear: bytes, iv: bytes,
        block_count: int,
        strategy=fhe_mod.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt,
        verify: bool = True, rounds: int = 10):
    """Returns (decrypted blocks, timings dict).

    A single block at 10 rounds takes the fused latency path and reports
    only `fused_latency_s`: that path has no expansion/rounds split.
    """
    dev = ctx.device
    key_ct = to_tensor(strategy.encrypt_key_client(client, key_clear), dev)
    blocks_clear = ctr_blocks(iv, block_count)
    block_cts = to_tensor(strategy.encrypt_client(client, blocks_clear), dev)
    log.info("aes key and blocks fhe encrypted")

    if block_count == 1 and rounds == 10:
        t0 = time.time()
        out = fhe_mod.encrypt_block_latency(strategy, ctx, key_ct, block_cts)
        _sync(dev)
        t_lat = time.time() - t0
        print(f"AES key expansion + #1 output computed in: {t_lat:.3f}s "
              "(fused latency path)")
        timings = {"fused_latency_s": t_lat}
    else:
        t0 = time.time()
        eks = fhe_mod.key_schedule_staged(strategy, ctx, key_ct)
        _sync(dev)
        t_expand = time.time() - t0
        print(f"AES key expansion took: {t_expand:.3f}s")
        t0 = time.time()
        out = fhe_mod.encrypt_blocks_staged(strategy, ctx, eks, block_cts,
                                            rounds)
        _sync(dev)
        t_blocks = time.time() - t0
        print(f"AES of #{block_count} outputs computed in: {t_blocks:.3f}s "
              f"({block_count / t_blocks:.4f} blocks/s)")
        timings = {"key_expansion_s": t_expand, "blocks_s": t_blocks,
                   "blocks_per_s": block_count / t_blocks}

    decrypted = strategy.decrypt_client(client, to_numpy(out.array))
    if verify:
        if rounds == 10:
            expect = aes_lib.encrypt_blocks(key_clear, blocks_clear)
            oracle = "AES authority"
        else:
            expect = plain.expand_key_and_encrypt_blocks(key_clear,
                                                         blocks_clear, rounds)
            oracle = f"plain {rounds}-round oracle"
        if decrypted != expect:
            raise AssertionError(f"FHE AES output mismatch vs {oracle}")
    return decrypted, timings
