"""The port's spans (utils/logger.py): a named torch.profiler range at each
layer boundary, one span a blind rotation around its whole step loop.

One latency-path request with its compressed answer, then a fresh key's
fused schedule and two rounds of the SBOX-only pipeline under it, traced
on the CPU at PARAMS_TEST with the kernels' plain versions: every name in
SPANS is seen and no other `tfhe.` name; each step-loop span lies inside a
PBS span and holds no span of its own; there is one a blind rotation."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tfhe_aes2_tpu_torch.aes_128 import fhe
from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as model
from tfhe_aes2_tpu_torch.ops import blind_rotate as br
from tfhe_aes2_tpu_torch.ops import compression, params
from tfhe_aes2_tpu_torch.ops.torus import to_tensor
from tfhe_aes2_tpu_torch.utils import logger

GALMUL = fhe.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt
SBOX = fhe.ShortintWoppbs1BitSboxPbsAesEncrypt


@pytest.fixture(scope="module")
def traced():
    """(the trace's `tfhe.` host ranges as (name, start ns, end ns) by
    start, the blind_rotate_glwe calls made under the profiler)."""
    # the SBOX-only pipeline's XOR depth needs lvl256's budget
    p = dataclasses.replace(params.PARAMS_TEST, max_noise_level_squared=256)
    client, ctx = model.generate_keys(p, seed=19, device="cpu")
    key = bytes(range(16))
    key_ct = to_tensor(GALMUL.encrypt_key_client(client, key), "cpu")
    block = to_tensor(GALMUL.encrypt_client(client, [bytes(16)]), "cpu")
    calls = []
    rotate = br.blind_rotate_glwe

    def counted(*args, **kwargs):
        calls.append(1)
        return rotate(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(br, "blind_rotate_glwe", counted)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fhe.encrypt_block_latency(GALMUL, ctx, key_ct, block)
            compression.compress_bits(out.array, ctx.sks, p, 16)
            eks = fhe.key_schedule_staged(GALMUL, ctx, key_ct)
            fhe.encrypt_blocks_staged(SBOX, ctx, eks, block, 2)
    spans = sorted(((e.name(), e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("tfhe.")), key=lambda s: s[1])
    return spans, len(calls)


def _inside(inner, outer) -> bool:
    return (outer[1] <= inner[1] and inner[2] <= outer[2]
            and inner is not outer)


def test_every_span_is_named_in_spans_and_seen(traced):
    spans, _ = traced
    assert {s[0] for s in spans} == set(logger.SPANS)


def test_step_span_lies_in_a_pbs_span_and_holds_none(traced):
    spans, _ = traced
    steps = [s for s in spans if s[0] == "tfhe.br.steps"]
    for s in steps:
        assert any(_inside(s, o) for o in spans if o[0] == "tfhe.wop.pbs")
        assert not any(_inside(o, s) for o in spans)


def test_one_step_span_a_blind_rotation(traced):
    spans, rotations = traced
    assert rotations > 0
    assert sum(s[0] == "tfhe.br.steps" for s in spans) == rotations


def test_spans_nest(traced):
    """One host thread: two spans are disjoint or one holds the other."""
    spans, _ = traced
    for i, a in enumerate(spans):
        for b in spans[i + 1:]:
            if b[1] >= a[2]:
                break
            assert b[2] <= a[2]
