"""Two-process client/server FHE AES serving (a REAL process boundary).

The reference's client/server split is a logical boundary inside one process
(run_client_server_aes_scenario, main.rs:97-128). Deployed, the boundary is
a process/network one: the accelerator host must hold ONLY evaluation keys.

  * server: `python -m tfhe_aes2_tpu_torch.serve --keys server_keys.npz
    --address /tmp/fhe.sock` — loads an evaluation-key bundle
    (ops/serialization.save_server_keys: bsk/ksk/pfpksk/pksk + params, no
    secret keys) onto the GPU, listens on a Unix socket, and answers
    keystream requests: FHE key expansion + batched AES rounds (+ optional
    homomorphic CTR derivation and output compression), all on ciphertexts.
    A fresh key with one block takes the fused latency path, whose expanded
    key is cached for the requests that follow under the same key.
  * client: `request_keystream` — ships the encrypted AES key + encrypted
    iv‖ctr block(s) over the wire and gets compressed output ciphertexts
    back.

Wire format, the JAX package's (tfhe_aes2_tpu/serve.py), so either client
talks to either server: length-framed messages (multiprocessing.connection)
whose payload is an npz archive — arrays + one JSON meta entry; no pickle,
so a malicious peer cannot run code in either process.

As the JAX server warms its programs while the bundle loads, this one
starts aot.py's warm-up (under TFHE_AOT, default on for a CUDA device)
once the bundle is read and accepted, before its keys go to the device:
the CUDA kernels build (or load from the store) and the device context
starts on background threads, then the kernels the context runs load
before the first request is accepted. A failed build or
load stops the server there. Without the warm-up the kernels build at the
first request's first launch. The kernels the bootstraps run follow
`lowering`, by default the TFHE_BR_KERNEL / TFHE_BR_GLUE / TFHE_VP_FUSED /
TFHE_VP_NTT environment (ops/lowering.py).
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import sys

import numpy as np

_EKS_CACHE_MAX = 4   # expanded keys kept on device (~23MB each at lvl64)


def pack_msg(meta: dict, **arrays) -> bytes:
    """npz-framed message: JSON meta + named u-int arrays (no pickle)."""
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
             **arrays)
    return buf.getvalue()


def unpack_msg(data: bytes):
    with np.load(io.BytesIO(data)) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return meta, arrays


def _key_digest(key_ct) -> str:
    return hashlib.sha256(np.ascontiguousarray(key_ct).tobytes()).hexdigest()


def _note(msg: str) -> None:
    print(f"[serve] {msg}", file=sys.stderr, flush=True)


def _cache_put(eks_cache: dict, digest: str, eks) -> None:
    """Insert as most recent; evict the least recent past the bound."""
    eks_cache[digest] = eks
    while len(eks_cache) > _EKS_CACHE_MAX:
        eks_cache.pop(next(iter(eks_cache)))


def _expanded_key(ctx, strategy, key_ct, eks_cache, digest):
    """FHE key expansion, cached by a digest of the key ciphertext bytes.

    A CTR keystream service reuses one key across requests; the reference
    expands once per scenario (main.rs:119,130-139). LRU-bounded: entries
    hold device memory."""
    from tfhe_aes2_tpu_torch.aes_128 import fhe as fhe_mod

    eks = eks_cache.pop(digest, None)
    if eks is None:
        _note(f"expanding key {digest[:12]} (cache miss)")
        eks = fhe_mod.key_schedule_staged(strategy, ctx, key_ct)
    else:
        _note(f"expanded-key cache hit {digest[:12]}")
    _cache_put(eks_cache, digest, eks)
    return eks


def _handle(ctx, strategy, meta, arrays, eks_cache):
    """One keystream request -> (meta, arrays) response."""
    from tfhe_aes2_tpu_torch.aes_128 import ctr_fhe, fhe as fhe_mod
    from tfhe_aes2_tpu_torch.ops import compression
    from tfhe_aes2_tpu_torch.ops.torus import to_numpy, to_tensor

    rounds = int(meta.get("rounds", 10))
    log2q = int(meta.get("compress", 16))
    count = int(meta.get("fhe_counter_count", 0))

    key_ct = to_tensor(arrays["key_ct"], ctx.device)
    blocks_arr = to_tensor(arrays["block_cts"], ctx.device)
    single = (blocks_arr.ndim == 3
              or (blocks_arr.ndim == 4 and blocks_arr.shape[0] == 1))
    digest = _key_digest(arrays["key_ct"])
    if single and not count and rounds == 10 and digest not in eks_cache:
        # fresh key + one block: the latency path runs key expansion AND
        # the rounds in 11 shared blind rotations and yields the expanded
        # key as a byproduct, cached for follow-up requests
        _note(f"expanding key {digest[:12]} (cache miss, fused latency path)")
        out, eks = fhe_mod.encrypt_block_latency(strategy, ctx, key_ct,
                                                 blocks_arr, return_eks=True)
        _cache_put(eks_cache, digest, eks)
    else:
        eks = _expanded_key(ctx, strategy, key_ct, eks_cache, digest)
        blocks_meta = None
        if count:
            block0 = blocks_arr[0] if blocks_arr.ndim == 4 else blocks_arr
            derived = ctr_fhe.derive_ctr_batch(ctx, block0, count)
            blocks_arr = derived.array
            blocks_meta = (derived.noise_sq, derived.comps)
        out = fhe_mod.encrypt_blocks_staged(strategy, ctx, eks, blocks_arr,
                                            rounds, blocks_meta=blocks_meta)
    if log2q:
        comp = compression.compress_bits(out.array, ctx.sks, ctx.params,
                                         log2q)
        return ({"ok": True, "compress": log2q, "shape": list(comp.shape)},
                {"comp": compression.wire_array(comp, log2q)})
    return {"ok": True, "compress": 0}, {"out": to_numpy(out.array)}


def serve(keys_path: str, address: str, one_shot: bool = False,
          max_requests: int | None = None, device="cuda",
          lowering=None) -> None:
    """Server main loop. Loads ONLY the evaluation-key bundle, onto
    `device`; `lowering` None means Lowering.from_env().

    The socket is bound BEFORE torch is imported and the keys load, so
    clients can connect (and queue a request) the moment the process starts;
    the heavy startup happens while the first request waits in the accept
    backlog. A request that fails is answered with ok: false and the server
    goes on; a bundle whose parameters the kernels of `device` do not take
    under the lowering (N > extprod.N_MAX on CUDA: no set of ops/params.py;
    on any device lvl1 and lvl4 under the CRT-NTT, which has no root of
    unity at N = 1024) is refused with ValueError as it loads, before any
    request is accepted."""
    from multiprocessing.connection import Listener

    with Listener(address, "AF_UNIX") as listener:
        _note(f"listening on {address}; loading evaluation keys")

        from tfhe_aes2_tpu_torch import aot
        from tfhe_aes2_tpu_torch.aes_128 import fhe as fhe_mod
        from tfhe_aes2_tpu_torch.models import shortint_woppbs_1bit as model
        from tfhe_aes2_tpu_torch.ops import serialization, truncation
        from tfhe_aes2_tpu_torch.ops.kernels.extprod import device_refusal
        from tfhe_aes2_tpu_torch.ops.lowering import Lowering

        if lowering is None:
            lowering = Lowering.from_env()
        raw, params = serialization.load_server_keys(keys_path)
        refusal = device_refusal(params.polynomial_size, device, lowering,
                                 truncation.vp_ggsw_j_start(params))
        if refusal:
            raise ValueError(f"key bundle {keys_path} on {device}: {refusal}")
        handle = aot.warmup_staged(device) if aot.enabled(device) else None
        ctx = model.context_from_keys(
            params, serialization.server_keys_on(raw, device),
            lowering=lowering)
        del raw
        strategy = fhe_mod.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt
        _note(f"evaluation keys loaded on {ctx.device} (lowering "
              f"br={ctx.lowering.br} vp={ctx.lowering.vp} "
              f"ntt={ctx.lowering.ntt})")
        if handle is not None:
            handle.attach(ctx)
            handle.wait()
            _note(f"warm-up: {len(handle.loaded)} kernels loaded; waited "
                  f"{handle.wait_s:.3f} s on it")

        eks_cache = {}   # key-ct digest -> expanded key (insertion = LRU)
        if one_shot:
            max_requests = 1
        served = 0
        while True:
            with listener.accept() as conn:
                try:
                    meta, arrays = unpack_msg(conn.recv_bytes())
                    resp = _handle(ctx, strategy, meta, arrays, eks_cache)
                except Exception as e:  # report, don't kill the server
                    resp = ({"ok": False, "error": f"{type(e).__name__}: {e}"},
                            {})
                conn.send_bytes(pack_msg(resp[0], **resp[1]))
            served += 1
            if max_requests is not None and served >= max_requests:
                return


def request_keystream(address: str, key_ct, block_cts, rounds: int = 10,
                      compress: int = 16, fhe_counter_count: int = 0):
    """Client side: send encrypted key + block ct(s) (numpy uint64), return
    (meta, arrays); raises RuntimeError on a server-side failure."""
    from multiprocessing.connection import Client

    with Client(address, "AF_UNIX") as conn:
        conn.send_bytes(pack_msg(
            {"rounds": rounds, "compress": compress,
             "fhe_counter_count": fhe_counter_count},
            key_ct=np.asarray(key_ct), block_cts=np.asarray(block_cts)))
        meta, arrays = unpack_msg(conn.recv_bytes())
    if not meta.get("ok"):
        raise RuntimeError(f"server error: {meta.get('error')}")
    return meta, arrays


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tfhe_aes2_tpu_torch.serve",
        description="FHE AES keystream server (evaluation keys only)")
    ap.add_argument("--keys", required=True,
                    help="evaluation-key bundle (save_server_keys npz)")
    ap.add_argument("--address", required=True, help="unix socket path")
    ap.add_argument("--one-shot", action="store_true",
                    help="serve a single request then exit")
    ap.add_argument("--max-requests", type=int, default=None,
                    help="exit after N requests (tests)")
    ap.add_argument("--device", default="cuda",
                    help="torch device holding the keys (tests: cpu)")
    args = ap.parse_args(argv)
    serve(args.keys, args.address, one_shot=args.one_shot,
          max_requests=args.max_requests, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
