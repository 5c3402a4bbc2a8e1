"""Noise checks of the port at production geometry: the decoded phase error
of real ciphertexts, with every limb-plane truncation active.

The reference builds with `noise-asserts`, so a noise violation fails every
run. The kernels drop the limb planes below each key's noise floor
themselves (keys.prepare_server_keys(truncate=True): K1 reads BSK planes
js..7, K4 KSK and pfPKSK planes js..7, K3 the runtime GGSW planes js..7), so
this measures what the card computes, not an emulation.

  measure_sbox_floor  one SBOX+GalMul circuit bootstrap of 4 bytes: the
                      big->small keyswitch (KSK js), then the scaling PBS
                      (BSK js), pfKS (pfPKSK js) and the 8->24 vertical
                      packing (VP js). Decode must be exact; at the four
                      reference sets the js and the phase-error std (log2)
                      must match SBOX_FLOOR_SETS.
  measure             the real flow: keygen, the FHE key schedule and
                      `rounds` AES rounds on n_blocks CTR blocks, decrypted
                      against the AES authority; the phase error of every
                      output bit.

    python -m tfhe_aes2_tpu_torch.noise [--device cuda|cpu]

prints one JSON line (measure at NOISE_BLOCKS=8 blocks, NOISE_ROUNDS=10
rounds, NOISE_SEED=11, PARAMS_SQRD_LVL_64) and asserts that it verified and
that log2_std <= 59 (8x below the 2^62 decode threshold) unless
NOISE_ASSERT=0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from tfhe_aes2_tpu_torch.aes_128 import SBOX, aes_lib, fhe, fhe_encryption
from tfhe_aes2_tpu_torch.aes_128 import gf_256_mul, plain
from tfhe_aes2_tpu_torch.aes_128.scenario import ctr_blocks
from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as model
from tfhe_aes2_tpu_torch.ops import circuit_bootstrap as cbs
from tfhe_aes2_tpu_torch.ops import keyswitch as ks
from tfhe_aes2_tpu_torch.ops import params as params_mod
from tfhe_aes2_tpu_torch.ops import truncation
from tfhe_aes2_tpu_torch.ops.torus import to_numpy, to_tensor

# (params, js (bsk, ksk, pfpksk, vp) the truncation rules give, the bars on
# log2 std of the keyswitched duals and of the SBOX+GalMul outputs): the JAX
# package's tests/test_params_all_sets.py:40-44, set ~0.8 bits (~3x
# variance) above the floors measured there, far below the 2^62 threshold
SBOX_FLOOR_SETS = {
    "lvl1": (params_mod.PARAMS_SQRD_LVL_1, (2, 5, 1, 4), 58.2, 59.8),
    "lvl4": (params_mod.PARAMS_SQRD_LVL_4, (2, 5, 1, 4), 58.2, 59.6),
    "lvl64": (params_mod.PARAMS_SQRD_LVL_64, (2, 5, 1, 4), 58.6, 59.2),
    "lvl256": (params_mod.PARAMS_SQRD_LVL_256, (2, 5, 1, 3), 57.6, 57.2),
}
SBOX_FLOOR_BYTES = (0x53, 0x00, 0xFF, 0xC2)
LOG2_STD_MAX = 59.0          # end to end: 8x below the 2^62 threshold
NOISE_KEY = bytes.fromhex("76b8e0ada0f13d90405d6ae55386bd28")
NOISE_IV = bytes.fromhex("bdd219b8a08ded1a")


class NoiseCheckError(AssertionError):
    """A decode failure, or a noise floor above its bar."""


def sbox_gal_mul(b: int) -> int:
    """S(b)·1 ‖ S(b)·2 ‖ S(b)·3, 24 bits."""
    s = int(SBOX[b])
    return ((gf_256_mul(s, 1) << 16) | (gf_256_mul(s, 2) << 8)
            | gf_256_mul(s, 3))


def decode(phase: np.ndarray) -> np.ndarray:
    """Threshold decode of bits at 2^63."""
    return ((phase + np.uint64(1 << 62)) >> np.uint64(63)) & np.uint64(1)


def phase_error(phase: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """Centred signed phase error of bits encoded at 2^63, float64."""
    enc = np.asarray(bits, np.uint64) << np.uint64(63)
    return (phase - enc).astype(np.int64).astype(np.float64)


def key_js(ctx: model.FheContext) -> tuple[int, int, int, int]:
    """(bsk, ksk, pfpksk, vp) planes the context's prepared keys drop."""
    sks = ctx.sks
    return (8 - sks.bsk.shape[3], 8 - sks.ksk.shape[0],
            8 - sks.pfpksk.shape[0], sks.vp_js)


def truncated_js(params) -> tuple[int, int, int, int]:
    """(bsk, ksk, pfpksk, vp) js of the truncation rules at `params`."""
    return (truncation.bsk_j_start(params), truncation.ksk_j_start(params),
            truncation.pfpksk_j_start(params),
            truncation.vp_ggsw_j_start(params))


def sbox_floor_phases(params, client, ctx):
    """The SBOX+GalMul circuit bootstrap of SBOX_FLOOR_BYTES, step by step:
    (input bits [4, 8], big-key cts [4, 8, kN+1], keyswitched duals
    [4, 8, n+1], GGSWs, outputs [4, 24, kN+1]), tensors on ctx.device."""
    bits = np.unpackbits(np.array(SBOX_FLOOR_BYTES, np.uint8)[:, None],
                         axis=-1)                             # [4, 8] MSB 1st
    cts = to_tensor(client.encrypt_bits(bits), ctx.device)
    dual = ks.keyswitch(cts, ctx.sks.ksk, params)
    ggsw = cbs.circuit_bootstrap_bits_small(dual, ctx.sks, params,
                                            ctx.lowering)
    lut = cbs.generate_lut(8, 24, sbox_gal_mul, params)
    out = cbs.vertical_packing(ggsw, to_tensor(lut, ctx.device), params,
                               ctx.sks.vp_js, ctx.lowering)
    return bits, cts, dual, ggsw, out


def measure_sbox_floor(params, client, ctx, name: str | None = None):
    """One SBOX+GalMul circuit bootstrap of 4 bytes (0x53, 0x00, 0xFF,
    0xC2) on ctx's prepared keys, which must carry every truncation
    (prepare_server_keys(truncate=True)). Raises NoiseCheckError unless the
    duals and the 24 output bits decode exactly, and, at a set named in
    SBOX_FLOOR_SETS (`name`, or found by `params`), unless the js and both
    floors match its row. Returns (js, dual log2 std, out log2 std)."""
    js = key_js(ctx)
    if js != truncated_js(params):
        raise ValueError(f"the context's keys drop js={js}, the truncation "
                         f"rules give {truncated_js(params)}: prepare them "
                         "with truncate=True")
    bits, _, dual, _, out = sbox_floor_phases(params, client, ctx)
    ph_dual = client.decrypt_phase_small(to_numpy(dual))
    if not (decode(ph_dual) == bits).all():
        raise NoiseCheckError("the keyswitched dual bits decode wrong")
    dual_std = float(np.log2(phase_error(ph_dual, bits).std()))

    ph = client.decrypt_phase(to_numpy(out))                  # [4, 24]
    want = np.array([[(sbox_gal_mul(b) >> (23 - o)) & 1 for o in range(24)]
                     for b in SBOX_FLOOR_BYTES], np.uint64)
    if not (decode(ph) == want).all():
        raise NoiseCheckError("the SBOX+GalMul outputs decode wrong")
    out_std = float(np.log2(phase_error(ph, want).std()))

    if name is None:
        name = next((n for n, row in SBOX_FLOOR_SETS.items()
                     if row[0] == params), None)
    if name is not None:
        _, want_js, dual_bar, out_bar = SBOX_FLOOR_SETS[name]
        if js != want_js:
            raise NoiseCheckError(f"{name}: js {js}, expected {want_js}")
        if dual_std > dual_bar or out_std > out_bar:
            raise NoiseCheckError(
                f"{name}: log2 std dual {dual_std:.2f} (bar {dual_bar}), "
                f"out {out_std:.2f} (bar {out_bar})")
    return js, dual_std, out_std


def run_flow(client, ctx, n_blocks: int, rounds: int):
    """The flow measure runs: the fused key schedule and `rounds` rounds
    on n_blocks CTR blocks of NOISE_IV under NOISE_KEY. Returns (output
    cts [B, 16, 8, kN+1] uint64, clear blocks, seconds)."""
    blocks = ctr_blocks(NOISE_IV, n_blocks)
    key_ct = fhe_encryption.encrypt_byte_array(client, NOISE_KEY)
    block_cts = fhe_encryption.encrypt_blocks(client, blocks)
    strategy = fhe.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt
    t0 = time.time()
    eks = fhe.key_schedule_staged(strategy, ctx, to_tensor(key_ct,
                                                           ctx.device))
    out = fhe.encrypt_blocks_staged(strategy, ctx, eks,
                                    to_tensor(block_cts, ctx.device), rounds)
    out = to_numpy(out.array)
    return out, blocks, time.time() - t0


def flow_stats(client, out: np.ndarray, blocks, rounds: int) -> dict:
    """The decoded phase error of every output bit against the clear
    oracle (the AES authority at 10 rounds)."""
    if rounds == 10:
        expect = aes_lib.encrypt_blocks(NOISE_KEY, blocks)
    else:
        expect = plain.expand_key_and_encrypt_blocks(NOISE_KEY, blocks,
                                                     rounds)
    verified = fhe_encryption.decrypt_blocks(client, out) == expect
    exp_bytes = np.frombuffer(b"".join(expect), np.uint8).reshape(
        len(blocks), 16)
    exp_bits = np.unpackbits(exp_bytes[..., None], axis=-1)  # [B, 16, 8]
    err = phase_error(client.decrypt_phase(out), exp_bits)
    std = float(err.std())
    return {
        "blocks": len(blocks),
        "rounds": rounds,
        "samples": int(err.size),
        "verified": bool(verified),
        "log2_std": round(float(np.log2(std)), 2),
        "log2_max_abs_err": round(float(np.log2(np.abs(err).max())), 2),
        "decode_margin_stds": round((1 << 62) / std, 1),
        "variance": std * std,
    }


def measure(n_blocks: int = 8, rounds: int = 10, seed: int = 11,
            params=params_mod.PARAMS_SQRD_LVL_64, device="cuda") -> dict:
    """The end-to-end noise of the real flow (run_flow) on keys made from
    `seed`, every truncation active. Returns the flow_stats keys plus the
    set, device, lowering, js and seconds."""
    t0 = time.time()
    client, ctx = model.generate_keys(params, seed=seed, device=device)
    keygen_s = time.time() - t0
    out, blocks, run_s = run_flow(client, ctx, n_blocks, rounds)
    dev = torch.device(device)
    return {
        "params": next((n for n in dir(params_mod) if n.startswith("PARAMS")
                        and getattr(params_mod, n) is params), "custom"),
        **flow_stats(client, out, blocks, rounds),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "lowering": [ctx.lowering.br, ctx.lowering.vp],
        "js": dict(zip(("bsk", "ksk", "pfpksk", "vp"), key_js(ctx))),
        "keygen_s": round(keygen_s, 2),
        "run_s": round(run_s, 2),
    }


def check(res: dict) -> None:
    """Raise NoiseCheckError unless the run verified and its log2 std is
    at most LOG2_STD_MAX."""
    if not res["verified"]:
        raise NoiseCheckError("the keystream failed verification")
    if res["log2_std"] > LOG2_STD_MAX:
        raise NoiseCheckError(
            f"noise margin regression: log2(std) {res['log2_std']} > "
            f"{LOG2_STD_MAX} (decode threshold 2^62, safety 8)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tfhe_aes2_tpu_torch.noise")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    res = measure(int(os.environ.get("NOISE_BLOCKS", "8")),
                  int(os.environ.get("NOISE_ROUNDS", "10")),
                  int(os.environ.get("NOISE_SEED", "11")),
                  device=args.device)
    print(json.dumps(res), flush=True)
    if os.environ.get("NOISE_ASSERT", "1") != "0":
        check(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
