"""Traffic kind `reused_key`: one client session, its AES key expanded
once under FHE in set-up (fhe.key_schedule_staged: the fused schedule, or
the eager one where the pipeline has no fused groups); each request carries
the next `blocks` counters and runs the ten rounds on them under that key
(fhe.encrypt_blocks_staged), then the compressed answer.

Mix parameters: blocks (a request), pool (requests encrypted in set-up,
used in turn), warm_rounds (rounds of the set-up's warm pass, which
launches every kernel and shape the window will: a middle and the final
round; no more than the rounds a request runs)."""

from __future__ import annotations

from torch.profiler import record_function

from benchmark.traffic.common import Request, ctr_blocks, draw_session


class Pool:
    def __init__(self, requests, eks):
        self.requests = requests
        self.eks = eks


def build(session, mix: dict, rng) -> Pool:
    from tfhe_aes2_tpu_torch.aes_128 import fhe
    key, iv, first = draw_session(rng)
    n = mix["blocks"]
    requests = []
    for i in range(mix["pool"]):
        blocks = ctr_blocks(iv, first + i * n, n)
        requests.append(Request(key, blocks, None,
                                session.strategy.encrypt_client(
                                    session.client, blocks)))
    key_ct = session.upload(session.strategy.encrypt_key_client(
        session.client, key))
    with record_function("bench.expand_key"):
        eks = fhe.key_schedule_staged(session.strategy, session.ctx, key_ct)
    return Pool(requests, eks)


def serve(session, pool: Pool, req: Request, rounds: int = 10):
    from tfhe_aes2_tpu_torch.aes_128 import fhe
    blocks = session.upload(req.block_cts)
    with record_function("bench.rounds"):
        out = fhe.encrypt_blocks_staged(session.strategy, session.ctx,
                                        pool.eks, blocks, rounds)
    return session.answer(out)


def warm(session, pool: Pool, mix: dict, rounds: int = 10) -> None:
    serve(session, pool, pool.requests[0],
          rounds=min(mix["warm_rounds"], rounds))
