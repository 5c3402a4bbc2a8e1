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

from tfhe_aes2_tpu_torch.aes_128 import aes_lib, ctr_fhe, fhe as fhe_mod, plain
from tfhe_aes2_tpu_torch.models.shortint_woppbs_1bit import FheContext
from tfhe_aes2_tpu_torch.ops import compression
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


def encrypt_request(client: ClientKey, ctx: FheContext, strategy,
                    key_clear: bytes, blocks_clear: list[bytes]):
    """Client: FHE-encrypt the AES key and the blocks onto the server's
    device -> (key_ct [16, 8, kN+1], block_cts [B, 16, 8, kN+1])."""
    dev = ctx.device
    return (to_tensor(strategy.encrypt_key_client(client, key_clear), dev),
            to_tensor(strategy.encrypt_client(client, blocks_clear), dev))


def serve_request(ctx: FheContext, strategy, key_ct: torch.Tensor,
                  block_cts: torch.Tensor, rounds: int = 10,
                  fhe_counter_count: int = 0):
    """Server: expand the key and run the rounds under FHE ->
    (output BitCt [B | 16, 8], timings dict).

    A single block at 10 rounds takes the fused latency path, where the
    strategy's pipeline has one (not sbox_pbs), and reports only
    `fused_latency_s`: that path has no expansion/rounds split.

    fhe_counter_count = C > 0: block_cts holds ONE encrypted iv‖ctr block;
    the server derives blocks 1..C-1 by homomorphic counter increments
    (aes_128/ctr_fhe) and runs the rounds on all C with their true metadata,
    reporting `ctr_derive_s`. Such a request never takes the latency path.
    """
    dev = ctx.device
    block_count = fhe_counter_count or block_cts.shape[0]
    if (block_count == 1 and rounds == 10 and not fhe_counter_count
            and hasattr(strategy.pipeline, "latency_fused_middle")):
        t0 = time.time()
        out = fhe_mod.encrypt_block_latency(strategy, ctx, key_ct, block_cts)
        _sync(dev)
        t_lat = time.time() - t0
        print(f"AES key expansion + #1 output computed in: {t_lat:.3f}s "
              "(fused latency path)")
        return out, {"fused_latency_s": t_lat}
    t0 = time.time()
    eks = fhe_mod.key_schedule_staged(strategy, ctx, key_ct)
    _sync(dev)
    t_expand = time.time() - t0
    print(f"AES key expansion took: {t_expand:.3f}s")
    timings = {"key_expansion_s": t_expand}
    blocks_meta = None
    if fhe_counter_count:
        t0 = time.time()
        derived = ctr_fhe.derive_ctr_batch(ctx, block_cts[0], block_count)
        _sync(dev)
        timings["ctr_derive_s"] = time.time() - t0
        # derived blocks are not fresh (the adder's bootstrap noise on the
        # counter bits): their metadata goes into the rounds
        block_cts, blocks_meta = derived.array, (derived.noise_sq,
                                                 derived.comps)
        print(f"CTR keystream of #{block_count} blocks derived "
              f"homomorphically in: {timings['ctr_derive_s']:.3f}s")
    t0 = time.time()
    out = fhe_mod.encrypt_blocks_staged(strategy, ctx, eks, block_cts, rounds,
                                        blocks_meta=blocks_meta)
    _sync(dev)
    t_blocks = time.time() - t0
    print(f"AES of #{block_count} outputs computed in: {t_blocks:.3f}s "
          f"({block_count / t_blocks:.4f} blocks/s)")
    timings.update(blocks_s=t_blocks, blocks_per_s=block_count / t_blocks)
    return out, timings


def read_response(client: ClientKey, ctx: FheContext, strategy, out,
                  compress_log2q: int | None = None) -> list[bytes]:
    """The answer's way back: the server's output BitCt -> the blocks the
    client decrypts.

    compress_log2q (16 or 32): the server keyswitches the output bits to
    the small key and modulus-switches them to q' = 2^log2q before
    transport (ops/compression.py), and the client decrypts the packed
    bytes: a ~12x / ~6x smaller response than the big-key ciphertexts.
    """
    if compress_log2q is None:
        return strategy.decrypt_client(client, to_numpy(out.array))
    comp = compression.compress_bits(out.array, ctx.sks, ctx.params,
                                     compress_log2q)
    blob = compression.pack_bytes(comp, compress_log2q)
    raw = out.array.numel() * 8
    print(f"compressed response: {len(blob)} bytes "
          f"({raw / len(blob):.1f}x smaller than big-key cts)")
    return compression.decrypt_blocks_compressed(
        client, compression.unpack_bytes(blob, tuple(comp.shape),
                                         compress_log2q), compress_log2q)


def run_client_server_aes_scenario(
        client: ClientKey, ctx: FheContext, key_clear: bytes, iv: bytes,
        block_count: int,
        strategy=fhe_mod.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt,
        verify: bool = True, rounds: int = 10,
        compress_log2q: int | None = None, fhe_counter: bool = False):
    """encrypt_request -> serve_request -> read_response, verified against
    the AES authority. Returns (decrypted blocks, timings dict).

    fhe_counter: the client uploads only the FIRST encrypted iv‖ctr block
    and the server derives the other block_count - 1 homomorphically."""
    blocks_clear = ctr_blocks(iv, block_count)
    key_ct, block_cts = encrypt_request(
        client, ctx, strategy, key_clear,
        blocks_clear[:1] if fhe_counter else blocks_clear)
    log.info("aes key and blocks fhe encrypted")
    out, timings = serve_request(
        ctx, strategy, key_ct, block_cts, rounds,
        fhe_counter_count=block_count if fhe_counter else 0)
    decrypted = read_response(client, ctx, strategy, out, compress_log2q)
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
