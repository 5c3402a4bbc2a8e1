"""The two models past what chip_smoke.py's phase 8 runs, on the card:

    python3 tfhe_aes2_tpu_torch/csrc/probes/model_scale.py

1. the tree-PBS model's SubBytes on one whole AES state (16 bytes x 8 output
   bits x 255 bootstraps, the first tree level 16,384 lanes) at
   PARAMS_SHORTINT_1BIT, decrypted against SBOX[x], with each kernel's
   launches;
2. where that model's batch stops: SubBytes on 7 states at once (the first
   tree level 114,688 lanes, its selection product 57,344 pairs in K3
   launches of at most 26,214) runs and decrypts; on 8 states K1 refuses
   its 2.3 GB digit operand (past its 32-bit strides) at the first step;
3. the 8-bit model through cli.main at PARAMS_WOPPBS_8BIT, 1 block,
   10 rounds, verified against the AES authority, with each kernel's
   launches.

Prints the card's name and power limit, each step's seconds, and a JSON
line of the measurements last.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from tfhe_aes2_tpu_torch import cli
from tfhe_aes2_tpu_torch.aes_128 import SBOX
from tfhe_aes2_tpu_torch.aes_128.fhe import Shortint1BitSboxPbsAesEncrypt
from tfhe_aes2_tpu_torch.models import shortint_1bit as tm1b
from tfhe_aes2_tpu_torch.ops import torus
from tfhe_aes2_tpu_torch.ops.kernels import extprod as kx
from tfhe_aes2_tpu_torch.ops.kernels import matmul as kmm
from tfhe_aes2_tpu_torch.ops.lowering import Lowering

DEV = "cuda"
WRAPPERS = {name: getattr(kx, name) for name in kx.WRAPPERS}
WRAPPERS["fused_limb_matmul"] = kmm.fused_limb_matmul


def counted(what, fn):
    """fn() with every kernel's launch counter reset before and read after;
    returns (result, wall seconds, the non-zero counts)."""
    for w in WRAPPERS.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    secs = time.time() - t0
    counts = {k: w.launches for k, w in WRAPPERS.items() if w.launches}
    print(f"{what}: {secs:.2f} s, launches {counts}", flush=True)
    return out, secs, counts


def main() -> int:
    if not torch.cuda.is_available():
        print("model_scale: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    result = {"card": card}

    p = tm1b.PARAMS_SHORTINT_1BIT
    client, ctx = tm1b.generate_keys(p, seed=0, device=DEV,
                                     lowering=Lowering())
    ops = tm1b.Shortint1BitByteOps(ctx)
    ops._sbox_tvs()

    def sub_bytes(states):
        """SubBytes on `states` AES states at once, decrypted against
        SBOX[x]; returns (wall seconds, launches, peak GiB)."""
        byts = (np.arange(16 * states, dtype=np.uint8) * 17).reshape(
            states, 16)
        bits = np.unpackbits(byts[..., None], axis=-1)
        state = tm1b.fresh_lane_bit1ct(torus.to_tensor(
            client.encrypt_encodings_small(bits.astype(np.uint64)
                                           << np.uint64(62)), DEV), ctx,
            lane_ndim=2)
        torch.cuda.reset_peak_memory_stats()
        out, secs, counts = counted(
            f"tree SubBytes, {states} state(s) ({16 * states} bytes)",
            lambda: ops.sub_bytes(state))
        dec = b"".join(Shortint1BitSboxPbsAesEncrypt.decrypt_client(
            client, torus.to_numpy(out.array)))
        if dec != bytes(int(SBOX[x]) for x in byts.reshape(-1)):
            raise AssertionError(f"tree SubBytes on {states} state(s) "
                                 f"decrypts to {dec.hex()}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  all {16 * states} bytes decrypt to SBOX[x]; peak device "
              f"memory {peak:.2f} GiB", flush=True)
        return dict(s=secs, launches=counts, peak_gib=peak)

    result["tree_state_sub_bytes"] = sub_bytes(1)
    result["tree_7_states_sub_bytes"] = sub_bytes(7)
    try:
        sub_bytes(8)
        raise AssertionError("the tree model took 8 states at once")
    except ValueError as e:
        if "32-bit strides" not in str(e):
            raise
        print(f"  tree SubBytes on 8 states: refused: {e}", flush=True)
        result["tree_8_states"] = f"refused: {e}"
    del client, ctx, ops
    torch.cuda.empty_cache()

    argv = ["--implementation", "shortint-woppbs-8bit", "--key",
            "76b8e0ada0f13d90405d6ae55386bd28", "--iv", "bdd219b8a08ded1a",
            "--number-of-outputs", "1"]
    _, secs, counts = counted(
        "8-bit model through cli.main, 1 block, 10 rounds (keygen included)",
        lambda: cli.main(argv, device=DEV))
    result["woppbs_8bit_10_rounds"] = dict(s=secs, launches=counts)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
