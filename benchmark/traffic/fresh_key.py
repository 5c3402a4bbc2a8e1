"""Traffic kind `fresh_key`: every request brings a new AES key (its 128
encrypted bits) and `blocks` counter blocks. One block takes the pipeline's
fused latency path (fhe.encrypt_block_latency: key expansion and the ten
rounds in 11 shared blind rotations) where it has one, as serve.py does;
otherwise, or where a CPU test asks for fewer rounds, the key is expanded
(fhe.key_schedule_staged) and the blocks run under it. Then the compressed
answer.

Mix parameters: blocks (a request), pool (requests encrypted in set-up,
used in turn). The warm pass is one whole request: the latency path has
no shorter form that launches the same shapes."""

from __future__ import annotations

from torch.profiler import record_function

from benchmark.traffic.common import Request, ctr_blocks, draw_session


class Pool:
    def __init__(self, requests):
        self.requests = requests


def build(session, mix: dict, rng) -> Pool:
    requests = []
    for _ in range(mix["pool"]):
        key, iv, first = draw_session(rng)
        blocks = ctr_blocks(iv, first, mix["blocks"])
        requests.append(Request(
            key, blocks,
            session.strategy.encrypt_key_client(session.client, key),
            session.strategy.encrypt_client(session.client, blocks)))
    return Pool(requests)


def serve(session, pool: Pool, req: Request, rounds: int = 10):
    from tfhe_aes2_tpu_torch.aes_128 import fhe
    strategy, ctx = session.strategy, session.ctx
    key_ct = session.upload(req.key_ct)
    blocks = session.upload(req.block_cts)
    if (rounds == 10 and len(req.blocks) == 1
            and hasattr(strategy.pipeline, "latency_fused_middle")):
        with record_function("bench.latency_path"):
            out = fhe.encrypt_block_latency(strategy, ctx, key_ct, blocks)
    else:
        with record_function("bench.expand_key"):
            eks = fhe.key_schedule_staged(strategy, ctx, key_ct)
        with record_function("bench.rounds"):
            out = fhe.encrypt_blocks_staged(strategy, ctx, eks, blocks,
                                            rounds)
    return session.answer(out)


def warm(session, pool: Pool, mix: dict, rounds: int = 10) -> None:
    serve(session, pool, pool.requests[0], rounds)
