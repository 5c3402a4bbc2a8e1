"""How often tests/test_aes_fhe.py::test_noise_probe_empirical fails, over
client rng states.

The test encrypts with the session-cached PARAMS_TEST_N256 client (the
JAX package's keygen at seed 7, tests/conftest.py's keys_test_n256), whose
one rng every test on the worker draws from, so the state it meets depends
on what ran before it. This makes the same keys, runs the test's own body
on them with the client's rng set to np.random.default_rng(s) for each s in
[start, start + states), in worker processes, and prints one JSON line a
state (the ratio in the failure message where the XOR check failed) and a
last line with the count.

    JAX_PLATFORMS=cpu python tools/noise_probe_rate.py [--start 0]
        [--states 1000] [--workers 2]

~1.3 s a state in one process (PARAMS_TEST_N256 on the CPU).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _chunk(states: list[int]) -> list[dict]:
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(REPO))
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tests.test_aes_fhe import test_noise_probe_empirical
    from tfhe_aes2_tpu.models.shortint_woppbs_1bit import FheContext
    from tfhe_aes2_tpu.ops.keys import generate_keys
    from tfhe_aes2_tpu.ops.params import PARAMS_TEST_N256

    client, sks = generate_keys(PARAMS_TEST_N256, seed=7)
    ctx = FheContext(params=client.params,
                     sks=jax.tree_util.tree_map(jnp.asarray, sks))
    out = []
    for s in states:
        client.rng = np.random.default_rng(s)
        try:
            test_noise_probe_empirical((client, ctx))
            out.append({"state": s, "passed": True})
        except AssertionError as e:
            found = re.search(r"XOR variance ratio ([0-9.e+-]+)", str(e))
            out.append({"state": s, "passed": False,
                        "xor_ratio": float(found.group(1)) if found
                        else None, "message": str(e).splitlines()[0]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--states", type=int, default=1000)
    ap.add_argument("--workers", type=int, default=2)
    args = ap.parse_args(argv)
    states = list(range(args.start, args.start + args.states))
    chunks = [states[i::args.workers] for i in range(args.workers)]
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        results = [r for part in pool.map(_chunk, chunks) for r in part]
    results.sort(key=lambda r: r["state"])
    for r in results:
        print(json.dumps(r))
    failed = [r["state"] for r in results if not r["passed"]]
    print(json.dumps({"states": len(results), "failed": len(failed),
                      "rate": len(failed) / len(results),
                      "failed_states": failed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
