"""Multi-process scale-out over torch.distributed (the JAX package's
parallel/distributed.py).

Every process is a 'host' of a (host, chip) mesh: it owns its local devices
(the chips) and meets the others through torch.distributed. CTR blocks split
over hosts and chips; evaluation keys are made once per process from the
same seed. Launch one command per process:

    python -m tfhe_aes2_tpu_torch.parallel.distributed --backend gloo \\
        --init-method file:///tmp/job/rendezvous --num-processes N \\
        --process-id I [--device cuda|cpu] [--local-devices 1] \\
        [--params test] [--rounds 1] [--blocks-per-device 1] \\
        [--layout dp|lane|lanehost] [--exact] [--out-dir DIR]

A job on one host meets through a file:// rendezvous (a fresh file that all
its processes can see); a multi-host launch gives --coordinator host:port
(tcp://) instead. The backend is never chosen for the caller:
  * nccl: every rank needs a GPU of its own (--local-rank times
    --local-devices plus its devices must fit the host's count); ranks that
    would share one are refused before init_process_group. Collectives run
    on the GPUs.
  * gloo: ranks may share a GPU (device index modulo the host's count), as
    on a one-card machine, or run on the CPU; every gathered tensor is
    staged through host memory explicitly.
Each process decrypt-verifies its own output shards against the plain
oracle and prints "ok: process I verified ..."; --out-dir also writes each
shard as shard_b{first block}_c{first byte}.npy (uint64 ciphertexts).
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from tfhe_aes2_tpu_torch.aes_128 import fhe, fhe_encryption, plain
from tfhe_aes2_tpu_torch.aes_128.scenario import ctr_blocks
from tfhe_aes2_tpu_torch.models.shortint_woppbs_1bit import FheContext
from tfhe_aes2_tpu_torch.ops import keys as keys_mod
from tfhe_aes2_tpu_torch.ops import params as params_mod
from tfhe_aes2_tpu_torch.ops.lowering import Lowering
from tfhe_aes2_tpu_torch.ops.torus import to_numpy, to_tensor
from tfhe_aes2_tpu_torch.parallel import mesh as mesh_mod

BACKENDS = ("gloo", "nccl")
LAYOUTS = ("dp", "lane", "lanehost")
PARAMS = {"test": params_mod.PARAMS_TEST,
          "test-n256": params_mod.PARAMS_TEST_N256,
          "lvl64": params_mod.PARAMS_SQRD_LVL_64}
KEY = bytes(range(16))
STRATEGY = fhe.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt


def process_devices(device: str, backend: str, local_rank: int,
                    n_local: int) -> list[torch.device]:
    """The devices of the process with index local_rank on its host: on
    "cuda", GPUs local_rank·n_local .. + n_local - 1, modulo the host's
    count under gloo, refused past it under nccl; on "cpu", n_local logical
    CPU devices (gloo only)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    kind = torch.device(device).type
    if kind == "cpu":
        if backend == "nccl":
            raise ValueError("nccl runs on GPUs only: use gloo on the CPU")
        return mesh_mod.local_devices("cpu", n_local)
    count = len(mesh_mod.local_devices("cuda"))
    first = local_rank * n_local
    if backend == "nccl" and first + n_local > count:
        raise ValueError(
            f"nccl needs a GPU of its own for every rank: local rank "
            f"{local_rank} would take cuda:{first}..{first + n_local - 1}, "
            f"but this host has {count}; ranks that share a GPU run under "
            "gloo")
    return [torch.device("cuda", (first + j) % count)
            for j in range(n_local)]


def initialize(init_method: str, num_processes: int, process_id: int,
               backend: str, devices: list[torch.device],
               timeout_s: float = 600.0) -> None:
    """torch.distributed.init_process_group with the rendezvous and backend
    given; under nccl the process's first GPU is made current first."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if not init_method.startswith(("file://", "tcp://")):
        raise ValueError(f"rendezvous {init_method!r}: file:// or tcp://")
    if backend == "nccl":
        torch.cuda.set_device(devices[0])
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))


class HostChipMesh(NamedTuple):
    """hosts: the processes of the job; host: this one's rank; chips: a
    'chip' mesh over this process's devices."""

    hosts: int
    host: int
    chips: mesh_mod.Mesh


def make_host_chip_mesh(devices) -> HostChipMesh:
    """The (host, chip) mesh of an initialised job: hosts are processes,
    chips each process's local devices."""
    return HostChipMesh(dist.get_world_size(), dist.get_rank(),
                        mesh_mod.mesh_of(devices, "chip"))


def all_gather_axis(x: torch.Tensor, sizes: list[int], axis: int,
                    group, via_host: bool) -> torch.Tensor:
    """Every rank's x (rank r's of length sizes[r] along `axis`, the other
    axes equal) concatenated in rank order along `axis`, on x's device.
    Shorter pieces travel zero-padded to the longest. via_host (gloo)
    stages the tensors through host memory."""
    longest = max(sizes)
    if x.shape[axis] < longest:
        pad = list(x.shape)
        pad[axis] = longest - x.shape[axis]
        x = torch.cat([x, x.new_zeros(pad)], dim=axis)
    send = x.cpu() if via_host else x.contiguous()
    bufs = [torch.empty_like(send) for _ in sizes]
    dist.all_gather(bufs, send, group=group)
    return torch.cat([b.narrow(axis, 0, n).to(x.device)
                      for b, n in zip(bufs, sizes)], dim=axis)


@dataclass
class DistributedLaneContext(FheContext):
    """An FheContext whose circuit bootstraps split their lanes over the
    ranks of `group`: rank r bootstraps the r-th of `world` near-equal runs
    of the axis before the T input bits (the bytes) on its own device, and
    every rank gathers the outputs back in rank order, so the linear layers
    that follow run replicated on each process. The metadata is made once
    for the whole output, as FheContext makes it. (circuit_bootstrap_mixed
    keeps FheContext's arrays: it runs replicated, unsplit.)"""

    group: object = None
    rank: int = 0
    world: int = 1
    via_host: bool = True

    def bootstrap_arrays(self, bits: torch.Tensor,
                         lut: np.ndarray) -> torch.Tensor:
        axis = mesh_mod.split_axis(bits)
        if axis is None:
            return super().bootstrap_arrays(bits, lut)
        parts = torch.tensor_split(bits, self.world, dim=axis)
        mine = parts[self.rank]
        if mine.numel():
            out = super().bootstrap_arrays(mine, lut)
        else:
            out = bits.new_zeros(mine.shape[:-2] + (lut.shape[0],
                                                    bits.shape[-1]))
        return all_gather_axis(out, [p.shape[axis] for p in parts], axis,
                               self.group, self.via_host)


def load_shards(out_dir) -> list[tuple[int, int, np.ndarray]]:
    """(first block, first byte, uint64 ciphertexts [blocks, bytes, 8,
    n1]) of every shard run_demo wrote to out_dir."""
    shards = []
    for f in sorted(Path(out_dir).glob("shard_b*_c*.npy")):
        b0, c0 = (int(x) for x in f.stem[len("shard_b"):].split("_c"))
        shards.append((b0, c0, np.load(f)))
    return shards


def demo_inputs(params, n_blocks: int, seed: int, device, exact: bool):
    """What every process of the demo makes alike: (client, prepared keys,
    the encrypted clear key schedule [44, 4, 8, n1], the encrypted blocks
    [B, 16, 8, n1] as numpy uint64, the clear blocks). exact keeps every
    limb plane (prepare_server_keys(truncate=False)): the JAX package's
    CPU arithmetic, bit for bit."""
    client, raw = keys_mod.generate_keys(params, seed=seed, device=device)
    keys = keys_mod.prepare_server_keys(raw, params, truncate=not exact)
    blocks = ctr_blocks(bytes(8), n_blocks)
    ks_ct = fhe_encryption.encrypt_word_array(client, plain.key_schedule(KEY))
    block_cts = fhe_encryption.encrypt_blocks(client, blocks)
    return client, keys, ks_ct, block_cts, blocks


def run_demo(params_name: str = "test", rounds: int = 1,
             blocks_per_device: int = 1, seed: int = 3, layout: str = "dp",
             devices=None, exact: bool = False, out_dir: str | None = None,
             lowering: Lowering | None = None) -> int:
    """One sharded FHE AES run across the job's processes; each process
    verifies its own output shards, raises on a mismatch and returns their
    count.

    layout:
      dp       — blocks split over (host, chip) flattened.
      lane     — blocks over 'host', the 16 bytes of each over the local
                 'chip' devices (mesh.LaneShardedContext, no communication
                 between processes).
      lanehost — the 16 bytes over 'host' (DistributedLaneContext: each
                 process bootstraps its bytes, all gather), blocks over the
                 local 'chip' devices: with N single-device processes,
                 N-way intra-block sharding across processes (gate.py).
    """
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} is not one of {LAYOUTS}")
    pset = PARAMS[params_name]
    lowering = Lowering.from_env() if lowering is None else lowering
    hc = make_host_chip_mesh(devices)
    n_local = len(devices)
    if layout == "lane":
        n_blocks = hc.hosts * blocks_per_device
    elif layout == "lanehost":
        if mesh_mod.BYTES % hc.hosts:
            raise ValueError(f"lanehost needs the {hc.hosts} processes to "
                             f"divide {mesh_mod.BYTES}")
        n_blocks = n_local * blocks_per_device
    else:
        n_blocks = hc.hosts * n_local * blocks_per_device
    via_host = dist.get_backend() == "gloo"

    t0 = time.time()
    client, keys, ks_ct, block_cts, blocks = demo_inputs(
        pset, n_blocks, seed, devices[0], exact)
    keygen_s = time.time() - t0
    ks = to_tensor(ks_ct, devices[0])

    t0 = time.time()
    if layout == "lanehost":
        per = mesh_mod.BYTES // hc.hosts
        c0 = hc.host * per
        local = to_tensor(block_cts[:, c0: c0 + per], devices[0])
        # the linear layers run on the whole state: gather the bytes once;
        # one group a local chip, so the chips' rows gather concurrently
        groups = [dist.new_group(list(range(hc.hosts)))
                  for _ in range(n_local)]
        state = all_gather_axis(local, [per] * hc.hosts, 1, groups[0],
                                via_host)
        replicas = mesh_mod.KeyReplicas()
        ctxs = [DistributedLaneContext(
            params=pset, sks=replicas(keys, d), lowering=lowering,
            group=g, rank=hc.host, world=hc.hosts, via_host=via_host)
            for d, g in zip(devices, groups)]

        def row(ctx, part):
            eks = STRATEGY.fresh(ks.to(ctx.device), ctx, lane_ndim=3)
            out = fhe.encrypt_blocks_eager(STRATEGY, ctx, eks, part, rounds)
            return out.array[:, c0: c0 + per]
        out = mesh_mod.run_rows(ctxs, state, row)
        shards = [(j * blocks_per_device, c0, out[j * blocks_per_device:
                                                  (j + 1) * blocks_per_device])
                  for j in range(n_local)]
    else:
        lane = layout == "lane"
        per = n_blocks // hc.hosts
        b0 = hc.host * per
        mesh = mesh_mod.mesh_of(devices, "chip",
                                lane_shards=n_local if lane else 1)
        fn = mesh_mod.make_sharded_encrypt_blocks_fn(STRATEGY, pset, rounds,
                                                     mesh, lowering)
        out = fn(keys, ks, to_tensor(block_cts[b0: b0 + per], devices[0]))
        spec = mesh_mod.block_spec(mesh, per)
        shards = [(b0 + sb.start, sc.start, out[sb, sc])
                  for sb, sc in spec.reshape(-1)]
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    run_s = time.time() - t0

    expect = plain.expand_key_and_encrypt_blocks(KEY, blocks, rounds)
    for b0, c0, shard in shards:
        rows = to_numpy(shard)                           # [bs, bytes, 8, n1]
        if out_dir is not None:
            np.save(Path(out_dir) / f"shard_b{b0}_c{c0}.npy", rows)
        bits = client.decrypt_bits(rows).astype(np.uint8)
        got = np.packbits(bits, axis=-1)[..., 0]
        for i in range(got.shape[0]):
            want = np.frombuffer(expect[b0 + i], np.uint8)[
                c0: c0 + got.shape[1]]
            if not (got[i] == want).all():
                raise AssertionError(f"process {hc.host} shard @({b0 + i}, "
                                     f"{c0}) decrypts wrong")
    print(f"ok: process {hc.host} verified {len(shards)} local shards over "
          f"{hc.hosts} hosts x {n_local} chips (layout={layout}, "
          f"params={params_name}, rounds={rounds}, "
          f"backend={dist.get_backend()}, devices="
          f"{','.join(str(d) for d in devices)}; keygen {keygen_s:.2f} s, "
          f"run {run_s:.2f} s)", flush=True)
    return len(shards)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tfhe_aes2_tpu_torch.parallel."
                                 "distributed")
    ap.add_argument("--backend", required=True, choices=BACKENDS)
    where = ap.add_mutually_exclusive_group(required=True)
    where.add_argument("--init-method", type=str,
                       help="file:///path (one host) or tcp://host:port")
    where.add_argument("--coordinator", type=str,
                       help="host:port of rank 0 (tcp://), multi-host")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-rank", type=int, default=None,
                    help="this process's index on its host (default: "
                         "--process-id, one host)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--local-devices", type=int, default=1)
    ap.add_argument("--params", choices=tuple(PARAMS), default="test")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--blocks-per-device", type=int, default=1)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--layout", choices=LAYOUTS, default="dp")
    ap.add_argument("--exact", action="store_true",
                    help="keep every limb plane (no truncation)")
    ap.add_argument("--out-dir", type=str, default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)

    local_rank = (args.process_id if args.local_rank is None
                  else args.local_rank)
    if args.device == "cpu":
        # the job's processes share this host's cores: torch's intra-op
        # pools of one process each would oversubscribe them (two such
        # processes measured ~90x slower a round than one)
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // args.num_processes))
    devices = process_devices(args.device, args.backend, local_rank,
                              args.local_devices)
    init = args.init_method or f"tcp://{args.coordinator}"
    initialize(init, args.num_processes, args.process_id, args.backend,
               devices, args.timeout)
    try:
        run_demo(args.params, args.rounds, args.blocks_per_device, args.seed,
                 args.layout, devices, args.exact, args.out_dir)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
