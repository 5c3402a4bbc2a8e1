"""Server-side homomorphic CTR keystream counter.

The reference builds its CTR blocks client-side (iv ‖ big-endian u64
counter, main.rs:108-115) and has homomorphic counter increments only as
tests (the bytewise 9-in/9-out LUT adder, shortint_woppbs_1bit.rs:833-877).
Here that adder is a serving mode (scenario `fhe_counter=True`, CLI
`--fhe-counter`, the server's `fhe_counter_count`): the client uploads ONE
encrypted iv‖ctr block and the server derives the remaining blocks by chained
homomorphic increments of the counter half (bytes 8..15, wrapping mod 2^64)
before running the batched AES pipeline.

One increment = 8 chained circuit bootstraps of [carry ‖ byte] (9 lanes)
through a shared 9->9 LUT computing byte+carry (LSB byte first; the carry
out of the top counter byte is dropped, so the counter wraps exactly like
the reference's u64). Every derived bit is a bootstrap output, so derived
blocks enter the AES rounds with nominal noise.
"""

from __future__ import annotations

import numpy as np
import torch

from tfhe_aes2_tpu_torch.models.shortint_woppbs_1bit import (
    BitCt, FheContext, _fresh_ids, fresh_bitct)


def increment_lut(ctx: FheContext) -> np.ndarray:
    """9->9 LUT [carry, b7..b0] -> [carry_out, sum byte]
    (shortint_woppbs_1bit.rs:833-877)."""
    return ctx.generate_lookup_table(9, 9, lambda v: (v & 0xFF) + (v >> 8))


def increment_block(ctx: FheContext, block: BitCt, lut,
                    counter_bytes: int = 8) -> BitCt:
    """block (lanes [16, 8], MSB-first bits) + 1 on the trailing
    `counter_bytes` bytes read as one big-endian integer; the leading bytes
    (the IV half) pass through untouched."""
    n_bytes = block.lane_shape[0]
    carry = ctx.trivial_bits(np.array([1]))
    pieces = []
    for i in range(n_bytes - 1, n_bytes - counter_bytes - 1, -1):
        byte = block.slice_lanes(slice(i, i + 1), axis=0).reshape_lanes(8)
        nine = BitCt.concat_lanes([carry, byte], axis=0)
        out = ctx.circuit_bootstrap(nine, lut)
        carry = out.slice_lanes(slice(0, 1), axis=0)
        pieces.append(out.slice_lanes(slice(1, 9), axis=0).reshape_lanes(1, 8))
    pieces.reverse()
    kept = block.slice_lanes(slice(0, n_bytes - counter_bytes), axis=0)
    return BitCt.concat_lanes([kept] + pieces, axis=0)


def derive_ctr_batch(ctx: FheContext, block0_arr: torch.Tensor, count: int,
                     counter_bytes: int = 8) -> BitCt:
    """Chained derivation from one encrypted block ct [16, 8, kN+1]: a BitCt
    whose array is [count, 16, 8, kN+1] (counter values c0, c0+1, ...,
    c0+count-1) with conservative per-lane metadata.

    A BitCt tracks ONE metadata slot per lane shared across the batch axis;
    the derived blocks differ per batch entry (block 0 is fresh, later
    counters carry the 9-bit adder's bootstrap noise), so the batch takes the
    per-lane MAX noise over its blocks — sound for the budget check — with
    one fresh id per lane. NOTE the id convention's limit: the IV lanes of
    every derived block are literally the SAME ciphertexts as block 0's, not
    independent across the batch; one id per lane is sound because no
    circuit XORs two different batch entries with each other."""
    lut = increment_lut(ctx)
    blocks = [fresh_bitct(block0_arr, ctx, lane_ndim=2)]
    for _ in range(count - 1):
        blocks.append(increment_block(ctx, blocks[-1], lut, counter_bytes))
    noise = np.maximum.reduce([b.noise_sq for b in blocks])
    return BitCt(torch.stack([b.array for b in blocks]), noise,
                 _fresh_ids(noise.shape), ctx)


def derive_ctr_blocks(ctx: FheContext, block0_arr: torch.Tensor, count: int,
                      counter_bytes: int = 8) -> torch.Tensor:
    """The derived blocks alone: [count, 16, 8, kN+1]."""
    return derive_ctr_batch(ctx, block0_arr, count, counter_bytes).array


# The JAX package compiles one program per increment under this name; an
# eager program has nothing to stage, so it is the same loop.
derive_ctr_blocks_staged = derive_ctr_blocks


def derived_blocks_meta(ctx: FheContext, block0_arr: torch.Tensor, count: int,
                        counter_bytes: int = 8):
    """(noise_sq, comps) of a derive_ctr_blocks batch, for
    `encrypt_blocks_staged(blocks_meta=...)`. The metadata is tracked on the
    real operations (no shadow trace exists here), so this derives the batch
    again; a caller that wants blocks and metadata takes both from
    `derive_ctr_batch`."""
    batch = derive_ctr_batch(ctx, block0_arr, count, counter_bytes)
    return batch.noise_sq, batch.comps
