"""Device meshes and the sharded AES entry points (the JAX package's
parallel/mesh.py, on torch devices).

Two layouts over a ('block',) or ('block', 'lane') mesh:

  * batch DP (throughput): blocks [B, 16, 8, n1] split along the batch axis
    over 'block'. CTR blocks are independent, so each position runs its
    blocks' rounds against its own copy of the keys, with no communication.
  * intra-block (latency): the 16-byte axis additionally split over 'lane'.
    Every circuit bootstrap of a block row splits its bytes over the row's
    lane positions (LaneShardedContext): keyswitch, blind rotation, pfKS and
    vertical packing are lane-local. The outputs are gathered back onto the
    row's first device, where the cheap linear layers (XORs, ShiftRows,
    MixColumns) run once.

Keys are replicated once per device (PreparedServerKeys.to). On "cuda" a
mesh position is one GPU, and each GPU's work runs in a host thread of its
own that first makes that GPU the current device: the kernels launch on the
current device (ops/kernels/build.stream_ptr), and one thread enqueuing for
several GPUs would serialise them on the host. On "cpu", n logical CPU
devices stand in for n GPUs, as XLA's forced host device count does for the
JAX package; they share the host's memory.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from tfhe_aes2_tpu_torch.aes_128 import fhe
from tfhe_aes2_tpu_torch.models.shortint_woppbs_1bit import BitCt, FheContext
from tfhe_aes2_tpu_torch.ops.keys import PreparedServerKeys
from tfhe_aes2_tpu_torch.ops.lowering import Lowering
from tfhe_aes2_tpu_torch.ops.params import WopbsParams

BYTES = 16          # the AES byte axis that 'lane' splits


@dataclass(frozen=True)
class Mesh:
    """devices: an object array of torch.device, one array axis a mesh
    axis, named by axis_names."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def rows(self) -> np.ndarray:
        """[block positions, lane positions] of the devices."""
        return self.devices.reshape(self.devices.shape[0], -1)


def local_devices(device="cuda", n: int | None = None) -> list[torch.device]:
    """n devices of this process: the first n GPUs on "cuda" (all of them
    when n is None), n logical CPU devices on "cpu" (1 when n is None).
    "cuda" without a CUDA device raises: it never runs on the CPU."""
    kind = torch.device(device).type
    if n is not None and n < 1:
        raise ValueError(f"a mesh needs at least one device, not {n}")
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device on this host: a 'cuda' mesh "
                               "does not run on the CPU (pass device='cpu' "
                               "for logical CPU devices)")
        count = torch.cuda.device_count()
        if n is not None and n > count:
            raise ValueError(f"{n} devices asked for, but this host has "
                             f"{count} CUDA device(s)")
        return [torch.device("cuda", i) for i in range(count if n is None
                                                       else n)]
    if kind == "cpu":
        return [torch.device("cpu", i) for i in range(1 if n is None else n)]
    raise ValueError(f"device {device!r} is neither 'cuda' nor 'cpu'")


def mesh_of(devices, axis_name: str = "block", lane_shards: int = 1) -> Mesh:
    """A 1-D mesh over `devices` named axis_name, or (axis_name, 'lane')
    when lane_shards > 1. lane_shards must divide both the device count and
    16 (the AES byte axis it splits)."""
    n = len(devices)
    if lane_shards < 1 or n % lane_shards or BYTES % lane_shards:
        raise ValueError(f"lane_shards {lane_shards} must divide the {n} "
                         f"devices and {BYTES}")
    arr = np.empty(n, dtype=object)
    arr[:] = list(devices)
    if lane_shards == 1:
        return Mesh(arr, (axis_name,))
    return Mesh(arr.reshape(n // lane_shards, lane_shards),
                (axis_name, "lane"))


def make_mesh(n_devices: int | None = None, axis_name: str = "block",
              lane_shards: int = 1, device="cuda") -> Mesh:
    """The JAX package's make_mesh: a 1-D 'block' mesh over n_devices of
    this process (local_devices), or ('block', 'lane') when
    lane_shards > 1."""
    return mesh_of(local_devices(device, n_devices), axis_name, lane_shards)


def block_spec(mesh: Mesh, n_blocks: int) -> np.ndarray:
    """Which part of a blocks tensor [B, 16, 8, n1] each mesh position owns:
    an object array shaped like mesh.devices of (block slice, byte slice).
    B must divide over the 'block' axis."""
    rows = mesh.rows()
    n_rows, n_lanes = rows.shape
    if n_blocks % n_rows:
        raise ValueError(f"{n_blocks} blocks do not divide over {n_rows} "
                         "'block' positions")
    per_row, per_lane = n_blocks // n_rows, BYTES // n_lanes
    out = np.empty(rows.shape, dtype=object)
    for r in range(n_rows):
        for j in range(n_lanes):
            out[r, j] = (slice(r * per_row, (r + 1) * per_row),
                         slice(j * per_lane, (j + 1) * per_lane))
    return out.reshape(mesh.devices.shape)


def on_devices(fn, jobs) -> list:
    """[fn(device, *args) for (device, *args) in jobs], each job in a host
    thread of its own; on a CUDA device the thread first makes that device
    current. A single job runs in the calling thread, its device current
    for the call. Every job's exception is raised here."""
    def run(device, *args):
        if device.type == "cuda":
            torch.cuda.set_device(device)
        return fn(device, *args)

    if len(jobs) == 1:
        device, *args = jobs[0]
        if device.type != "cuda":
            return [fn(device, *args)]
        with torch.cuda.device(device):
            return [fn(device, *args)]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = [pool.submit(run, *job) for job in jobs]
        return [f.result() for f in futures]


def split_axis(array: torch.Tensor) -> int | None:
    """The axis a bootstrap's input [..., T, kN+1] splits along: the one
    before the T input bits (the byte axis of an AES state), or None."""
    return array.ndim - 3 if array.ndim >= 3 else None


@dataclass
class LaneShardedContext(FheContext):
    """An FheContext whose circuit bootstraps split their lanes over
    `shards`, one FheContext a device (the same parameters and lowering,
    the keys replicated): shard j bootstraps the j-th of len(shards)
    near-equal runs of the axis before the T input bits (the bytes) on its
    device, and the outputs are gathered back onto this context's device
    (that of shards[0]) in order. Every lane's arithmetic is that of the
    unsharded bootstrap, and the metadata is made once for the whole
    output, as FheContext makes it: ciphertexts and metadata are those of
    the unsharded run."""

    shards: tuple = ()

    def bootstrap_arrays(self, bits: torch.Tensor,
                         lut: np.ndarray) -> torch.Tensor:
        axis = split_axis(bits)
        if axis is None:
            return super().bootstrap_arrays(bits, lut)
        parts = torch.tensor_split(bits, len(self.shards), dim=axis)
        jobs = [(ctx.device, ctx, part) for ctx, part in
                zip(self.shards, parts) if part.numel()]
        outs = on_devices(
            lambda dev, ctx, part: ctx.bootstrap_arrays(part.to(dev), lut),
            jobs)
        return torch.cat([o.to(self.device) for o in outs], dim=axis)

    def bootstrap_mixed_arrays(self, parts) -> list[torch.Tensor]:
        n = len(self.shards)
        # each request's chunks: a split along its axis before T, or the
        # whole request on the first shard
        chunks = []
        for bits, _ in parts:
            axis = split_axis(bits)
            chunks.append(torch.tensor_split(bits, n, dim=axis)
                          if axis is not None
                          else (bits,) + (bits[:0],) * (n - 1))
        jobs = []
        for j, ctx in enumerate(self.shards):
            mine = [(i, chunks[i][j], lut) for i, (_, lut) in enumerate(parts)
                    if chunks[i][j].numel()]
            if mine:
                jobs.append((ctx.device, ctx, mine))
        outs = on_devices(
            lambda dev, ctx, mine: list(zip(
                [i for i, _, _ in mine], ctx.bootstrap_mixed_arrays(
                    [(x.to(dev), lut) for _, x, lut in mine]))), jobs)
        gathered = [[] for _ in parts]
        for shard_outs in outs:                       # shards in order
            for i, out in shard_outs:
                gathered[i].append(out.to(self.device))
        return [torch.cat(g, dim=split_axis(bits)) if len(g) > 1 else g[0]
                for g, (bits, _) in zip(gathered, parts)]


class KeyReplicas:
    """The keys of the last call, copied once onto each device asked for."""

    def __init__(self):
        self.keys, self.on = None, {}

    def __call__(self, keys: PreparedServerKeys,
                 device: torch.device) -> PreparedServerKeys:
        if keys is not self.keys:
            self.keys, self.on = keys, {}
        if device not in self.on:
            self.on[device] = keys.to(device)
        return self.on[device]


def row_contexts(mesh: Mesh, keys: PreparedServerKeys, params: WopbsParams,
                 lowering: Lowering, replicas=None) -> list[FheContext]:
    """One context a 'block' position: a plain FheContext on a one-device
    row, a LaneShardedContext over the row's devices otherwise."""
    replicas = replicas or KeyReplicas()
    ctxs = []
    for row in mesh.rows():
        shards = tuple(FheContext(params=params, sks=replicas(keys, d),
                                  lowering=lowering) for d in row)
        ctxs.append(shards[0] if len(shards) == 1 else LaneShardedContext(
            params=params, sks=shards[0].sks, lowering=lowering,
            shards=shards))
    return ctxs


def _check_strategy(strategy) -> None:
    if not issubclass(strategy, fhe.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt):
        raise ValueError(f"{strategy.__name__}: the mesh runs the 1-bit "
                         "WoP-PBS model's strategies only")


def run_rows(ctxs, blocks: torch.Tensor, row_fn) -> torch.Tensor:
    """row_fn(ctx, its blocks on its device) on each row's device; the
    outputs concatenated on the blocks' own device."""
    if blocks.shape[0] % len(ctxs):
        raise ValueError(f"{blocks.shape[0]} blocks do not divide over "
                         f"{len(ctxs)} 'block' positions")
    parts = torch.tensor_split(blocks, len(ctxs))
    outs = on_devices(lambda dev, ctx, part: row_fn(ctx, part.to(dev)),
                      [(ctx.device, ctx, part) for ctx, part in
                       zip(ctxs, parts)])
    return torch.cat([o.to(blocks.device) for o in outs])


def make_sharded_encrypt_blocks_fn(strategy, params: WopbsParams,
                                   rounds: int, mesh: Mesh,
                                   lowering: Lowering | None = None):
    """fn(keys, ks_cts [44, 4, 8, n1], blocks [B, 16, 8, n1]) ->
    [B, 16, 8, n1]: the rounds under a clear key schedule supplied
    encrypted, blocks split over 'block', bytes over 'lane'. keys: the
    prepared keys (PreparedServerKeys) on any device, copied once onto each
    mesh device; the output lies on the blocks' device. `lowering` None
    means Lowering.from_env()."""
    _check_strategy(strategy)
    lowering = Lowering.from_env() if lowering is None else lowering
    replicas = KeyReplicas()

    def fn(keys, ks_cts, blocks):
        ctxs = row_contexts(mesh, keys, params, lowering, replicas)

        def row(ctx, part):
            eks = strategy.fresh(ks_cts.to(ctx.device), ctx, lane_ndim=3)
            return fhe.encrypt_blocks_eager(strategy, ctx, eks, part,
                                            rounds).array
        return run_rows(ctxs, blocks, row)
    return fn


def make_sharded_full_aes_fn(strategy, params: WopbsParams, rounds: int,
                             mesh: Mesh, lowering: Lowering | None = None):
    """fn(keys, key_cts [16, 8, n1], blocks [B, 16, 8, n1]) ->
    [B, 16, 8, n1]: the FHE key schedule once, on the first row (its
    bootstraps split over that row's lanes), its expanded key copied to the
    other rows, then the rounds as make_sharded_encrypt_blocks_fn runs
    them."""
    _check_strategy(strategy)
    lowering = Lowering.from_env() if lowering is None else lowering
    replicas = KeyReplicas()

    def fn(keys, key_cts, blocks):
        ctxs = row_contexts(mesh, keys, params, lowering, replicas)
        first = ctxs[0]
        eks = on_devices(lambda dev: fhe.key_schedule_eager(
            strategy, first, key_cts.to(dev)), [(first.device,)])[0]

        def row(ctx, part):
            mine = BitCt(eks.array.to(ctx.device), eks.noise_sq, eks.comps,
                         ctx, eks.degree)
            return fhe.encrypt_blocks_eager(strategy, ctx, mine, part,
                                            rounds).array
        return run_rows(ctxs, blocks, row)
    return fn
