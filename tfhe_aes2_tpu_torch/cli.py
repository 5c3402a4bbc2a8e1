"""CLI mirroring the reference binary (src/bin/main.rs:29-39), on the GPU.

    python -m tfhe_aes2_tpu_torch.cli --key <hex16> --iv <hex8> \
        --number-of-outputs N [--implementation shortint-woppbs-1bit] \
        [--seed S] [--compress-output {16,32}] [--fhe-counter]

Same flags as `python -m tfhe_aes2_tpu.cli`. This port runs the
shortint-woppbs-1bit model only. With --fhe-counter the client uploads one
encrypted iv‖ctr block and the server derives the rest by homomorphic
counter increments (aes_128/ctr_fhe.py). The kernels the bootstraps run follow the JAX
package's TFHE_BR_KERNEL / TFHE_BR_GLUE / TFHE_VP_FUSED environment
(ops/lowering.py); the lowering in use is printed. On a CUDA device the
parameter sets with N = 1024 (lvl1, lvl4, lvl256) run under the default
lowering (gridg, fused) and under grid / partials, and are refused before
keygen under a lowering whose kernels take N <= 512 (merged, longk, bucket,
glue_out: ROADMAP.md Queue 1). lvl1's and lvl4's noise budgets
(max_noise_level_squared 1 and 4) are below what the AES pipeline's XORs
need, so there the run stops with NoiseError, as in the JAX package.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

from tfhe_aes2_tpu_torch.ops import params as params_mod
from tfhe_aes2_tpu_torch.ops.kernels.extprod import device_refusal
from tfhe_aes2_tpu_torch.ops.lowering import Lowering

PARAM_CHOICES = {"lvl1": params_mod.PARAMS_SQRD_LVL_1,
                 "lvl4": params_mod.PARAMS_SQRD_LVL_4,
                 "lvl64": params_mod.PARAMS_SQRD_LVL_64,
                 "lvl256": params_mod.PARAMS_SQRD_LVL_256,
                 "test": params_mod.PARAMS_TEST,
                 "test-n256": params_mod.PARAMS_TEST_N256}


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(prog="tfhe_aes2_tpu_torch")
    ap.add_argument("--number-of-outputs", type=int, required=True)
    ap.add_argument("--iv", type=str, required=True, help="8-byte hex IV")
    ap.add_argument("--key", type=str, required=True,
                    help="16-byte hex AES key")
    ap.add_argument("--implementation", type=str,
                    default="shortint-woppbs-1bit",
                    choices=["shortint-woppbs-1bit", "shortint-woppbs-8bit",
                             "shortint-1bit"])
    ap.add_argument("--seed", type=int, default=0, help="key generation seed")
    ap.add_argument("--log-level", type=str, default="INFO")
    ap.add_argument("--params", type=str, default="lvl64",
                    choices=sorted(PARAM_CHOICES),
                    help="parameter set for the 1-bit model ('test' sets are "
                         "INSECURE, for fast runs only; lvl1 and lvl4 run "
                         "keygen, then stop the AES pipeline with NoiseError: "
                         "their noise budgets, 1 and 4, are below what its "
                         "XORs need, as in the JAX package)")
    ap.add_argument("--rounds", type=int, default=10,
                    help="AES rounds (<10 verifies against the partial-round "
                         "plain oracle)")
    ap.add_argument("--compress-output", type=int, default=None,
                    choices=[16, 32])
    ap.add_argument("--fhe-counter", action="store_true",
                    help="upload one block; the server derives the CTR "
                         "blocks homomorphically")
    args = ap.parse_args(argv)
    lowering = Lowering.from_env()
    refusal = device_refusal(PARAM_CHOICES[args.params].polynomial_size,
                             device, lowering)
    if refusal:
        ap.error(f"--params {args.params} on {device}: {refusal}")

    if args.implementation != "shortint-woppbs-1bit":
        raise NotImplementedError(
            f"--implementation {args.implementation} is not ported yet "
            "(ROADMAP.md Queue 1, 'the other FHE models')")

    logging.basicConfig(level=args.log_level,
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    print(f"using implementation: {args.implementation}")
    key = bytes.fromhex(args.key)
    iv = bytes.fromhex(args.iv)
    if len(key) != 16:
        ap.error("invalid key length, must be 16 bytes")
    if len(iv) != 8:
        ap.error("invalid iv length, must be 8 bytes")

    from tfhe_aes2_tpu_torch.aes_128.scenario import (
        run_client_server_aes_scenario)
    from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as model

    print(f"generating keys ({args.params}) on {device}...")
    t0 = time.time()
    client, ctx = model.generate_keys(PARAM_CHOICES[args.params],
                                      seed=args.seed, device=device,
                                      lowering=lowering)
    print(f"keys generated and prepared in: {time.time() - t0:.3f}s")
    print(f"lowering: br={ctx.lowering.br} vp={ctx.lowering.vp}")
    run_client_server_aes_scenario(client, ctx, key, iv,
                                   args.number_of_outputs, rounds=args.rounds,
                                   compress_log2q=args.compress_output,
                                   fhe_counter=args.fhe_counter)
    oracle = ("AES authority" if args.rounds == 10
              else f"plain {args.rounds}-round oracle")
    print(f"ok: FHE keystream verified against {oracle}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
