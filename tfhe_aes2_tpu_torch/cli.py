"""CLI mirroring the reference binary (src/bin/main.rs:29-39), on the GPU.

    python -m tfhe_aes2_tpu_torch.cli --key <hex16> --iv <hex8> \
        --number-of-outputs N [--implementation shortint-woppbs-1bit] \
        [--seed S] [--compress-output {16,32}] [--fhe-counter]

Same flags as `python -m tfhe_aes2_tpu.cli`, and the same three models:
shortint-woppbs-1bit (the default; --params picks its set),
shortint-woppbs-8bit (always PARAMS_WOPPBS_8BIT, N = 1024) and shortint-1bit
(the tree-PBS model: PARAMS_TEST_S1 when --params starts with "test",
PARAMS_SHORTINT_1BIT otherwise). --compress-output and --fhe-counter need the
shortint-woppbs-1bit model, as in the JAX package. With --fhe-counter the
client uploads one encrypted iv‖ctr block and the server derives the rest by
homomorphic counter increments (aes_128/ctr_fhe.py). The kernels the
bootstraps run follow the JAX package's TFHE_BR_KERNEL / TFHE_BR_GLUE /
TFHE_VP_FUSED / TFHE_VP_NTT environment (ops/lowering.py); the lowering in
use is printed, and so is the stream the evaluation keys were drawn from
(the native ChaCha20 core where it builds, else numpy, as in the JAX
package). Under TFHE_AOT (default: on for a CUDA device) the kernels build
and the device context starts on background threads while keygen runs,
and the run's kernels load before the first request (aot.py).
On a CUDA device every parameter set, the ones with N = 1024 (lvl1, lvl4,
lvl256 and the 8-bit model's) among them, runs under every lowering — gridg
(the default), grid, merged, longk, bucket and glue_out, each with fused or
partials; a set above what the kernels take (N > extprod.N_MAX, none in
ops/params.py) would be refused before keygen, reading the set the chosen
model will run, and so are lvl1 and lvl4 under TFHE_VP_NTT=1, where the
CRT-NTT has no 2N-th root of unity at N = 1024 (the JAX package raises). lvl1's and lvl4's noise
budgets (max_noise_level_squared 1 and 4) are below what the AES pipeline's
XORs need, so there the run stops with NoiseError, as in the JAX package.
The tree-PBS model's parameters are flagged testing parameters by the
reference, which #[ignore]s its AES tests for noise accumulation: expect its
10-round verification to fail.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

from tfhe_aes2_tpu_torch import aot
from tfhe_aes2_tpu_torch.ops import params as params_mod
from tfhe_aes2_tpu_torch.ops import truncation
from tfhe_aes2_tpu_torch.ops.kernels.extprod import device_refusal
from tfhe_aes2_tpu_torch.ops.lowering import Lowering

PARAM_CHOICES = {"lvl1": params_mod.PARAMS_SQRD_LVL_1,
                 "lvl4": params_mod.PARAMS_SQRD_LVL_4,
                 "lvl64": params_mod.PARAMS_SQRD_LVL_64,
                 "lvl256": params_mod.PARAMS_SQRD_LVL_256,
                 "test": params_mod.PARAMS_TEST,
                 "test-n256": params_mod.PARAMS_TEST_N256}


def _implementation(name: str, params: str):
    """(model module, strategy, the parameter set it runs, that set's name)
    for --implementation `name` and --params `params`, as the JAX CLI
    dispatches them (tfhe_aes2_tpu/cli.py)."""
    from tfhe_aes2_tpu_torch.aes_128 import fhe as fhe_mod

    if name == "shortint-woppbs-1bit":
        from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as model
        return (model, fhe_mod.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt,
                PARAM_CHOICES[params], params)
    if name == "shortint-woppbs-8bit":
        from tfhe_aes2_tpu_torch.models import shortint_woppbs_8bit as model
        return (model, fhe_mod.ShortintWoppbs8BitSboxPbsAesEncrypt,
                params_mod.PARAMS_WOPPBS_8BIT, "woppbs 8bit")
    # dispatched like the reference binary (main.rs:60-92); its parameters
    # are flagged testing parameters (shortint_1bit.rs:62) and its AES tests
    # #[ignore]d for noise accumulation: expect 10 rounds to fail to verify
    from tfhe_aes2_tpu_torch.models import shortint_1bit as model
    test = params.startswith("test")
    return (model, fhe_mod.Shortint1BitSboxPbsAesEncrypt,
            model.PARAMS_TEST_S1 if test else model.PARAMS_SHORTINT_1BIT,
            "test-s1" if test else "shortint-1bit")


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
                    help="parameter set for the shortint-woppbs-1bit model "
                         "(shortint-1bit: 'test*' picks PARAMS_TEST_S1, any "
                         "other PARAMS_SHORTINT_1BIT; 'test' sets are "
                         "INSECURE, for fast runs only; lvl1, lvl4 and "
                         "lvl256 have N = 1024, which the card runs under "
                         "every lowering; lvl1 and "
                         "lvl4 run keygen, then stop the AES pipeline with "
                         "NoiseError: their noise budgets, 1 and 4, are "
                         "below what its XORs need, as in the JAX package)")
    ap.add_argument("--rounds", type=int, default=10,
                    help="AES rounds (<10 verifies against the partial-round "
                         "plain oracle)")
    ap.add_argument("--compress-output", type=int, default=None,
                    choices=[16, 32])
    ap.add_argument("--fhe-counter", action="store_true",
                    help="upload one block; the server derives the CTR "
                         "blocks homomorphically")
    args = ap.parse_args(argv)
    if (args.compress_output is not None
            and args.implementation != "shortint-woppbs-1bit"):
        ap.error("--compress-output needs the shortint-woppbs-1bit model "
                 "(big-key output bits)")
    if args.fhe_counter and args.implementation != "shortint-woppbs-1bit":
        ap.error("--fhe-counter needs the shortint-woppbs-1bit model (the "
                 "increment adder runs on its circuit bootstrap)")
    lowering = Lowering.from_env()
    model, strategy, pset, pname = _implementation(args.implementation,
                                                   args.params)
    vp_js = truncation.vp_ggsw_j_start(pset)
    refusal = device_refusal(pset.polynomial_size, device, lowering, vp_js)
    if refusal:
        ap.error(f"--implementation {args.implementation} (parameters "
                 f"{pname}) on {device}: {refusal}")

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

    # warm-up before keygen: the kernel build and the device context start
    # on background threads (aot.py), as the JAX CLI starts its programs'
    # compiles before its keygen
    handle = aot.warmup_staged(device) if aot.enabled(device) else None
    print(f"generating keys ({pname}) on {device}...")
    t0 = time.time()
    client, ctx = model.generate_keys(pset, seed=args.seed, device=device,
                                      lowering=lowering)
    print(f"keys generated and prepared in: {time.time() - t0:.3f}s "
          f"(evaluation keys from the {client.keygen_stream} stream)")
    print(f"lowering: br={ctx.lowering.br} vp={ctx.lowering.vp}")
    if ctx.lowering.ntt:
        print("vertical packing: " + (
            "the CRT-NTT" if ctx.lowering.vp_ntt(vp_js) else
            f"{ctx.lowering.vp} (TFHE_VP_NTT=1, but the selectors keep "
            f"{8 - vp_js} > 4 planes: the JAX package's fallback)"))
    if handle is not None:
        handle.attach(ctx)
        handle.wait()
        print(f"warm-up: context ready in {handle.context_ready_s}s, "
              f"kernels built or loaded in {handle.build_s:.3f}s, "
              f"{len(handle.loaded)} kernels loaded in {handle.load_s:.3f}s; "
              f"the run waited {handle.wait_s:.3f}s on it")
    run_client_server_aes_scenario(client, ctx, key, iv,
                                   args.number_of_outputs, strategy=strategy,
                                   rounds=args.rounds,
                                   compress_log2q=args.compress_output,
                                   fhe_counter=args.fhe_counter)
    oracle = ("AES authority" if args.rounds == 10
              else f"plain {args.rounds}-round oracle")
    print(f"ok: FHE keystream verified against {oracle}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
