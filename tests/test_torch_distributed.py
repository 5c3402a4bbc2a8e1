"""The port's multi-process layer (tfhe_aes2_tpu_torch/parallel/
distributed.py and gate.py) as real 2-process torch.distributed jobs on the
CPU: gloo, a file:// rendezvous in a fresh directory (no port is picked),
each worker's output shards bit-equal to the JAX package's unsharded output
on the same keys and ciphertexts. Children are waited for with one shared
timeout and killed by their own PIDs. Also the backend refusals."""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_aes2_tpu.aes_128 import fhe as jfhe
from tfhe_aes2_tpu.ops import keys as jkeys
from tfhe_aes2_tpu.ops.params import PARAMS_TEST as JPARAMS_TEST

from tfhe_aes2_tpu_torch.ops import keys as tkeys
from tfhe_aes2_tpu_torch.parallel import distributed, gate

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 240


@pytest.fixture(scope="module")
def unsharded():
    """The JAX package's unsharded 1-round output on the demo's keys and
    ciphertexts (2 blocks; keys from the port's seeded keygen, which every
    worker repeats)."""
    params = distributed.PARAMS["test"]
    _, raw = tkeys.generate_keys_numpy(params, seed=3, device="cpu")
    _, _, ks_ct, block_cts, _ = distributed.demo_inputs(params, 2, 3, "cpu",
                                                        exact=True)
    sks = jkeys.ServerKeySet(**{k: jnp.asarray(v) for k, v in raw.items()})
    fn = jfhe.make_encrypt_blocks_fn(
        jfhe.ShortintWoppbs1BitSboxGalMulPbsAesEncrypt, JPARAMS_TEST, 1)
    return np.asarray(fn(sks, jnp.asarray(ks_ct), jnp.asarray(block_cts)))


def _job(tmp_path, layout: str, blocks_per_device: int):
    out = tmp_path / "shards"
    out.mkdir()
    cmds = [[sys.executable, "-m", "tfhe_aes2_tpu_torch.parallel.distributed",
             "--backend", "gloo", "--init-method",
             f"file://{tmp_path}/rendezvous", "--num-processes", "2",
             "--process-id", str(rank), "--device", "cpu", "--params", "test",
             "--rounds", "1", "--layout", layout, "--exact",
             "--blocks-per-device", str(blocks_per_device),
             "--out-dir", str(out)] for rank in (0, 1)]
    rcs, outs, timed_out = gate.run_processes(cmds, TIMEOUT, cwd=REPO)
    assert not timed_out, "\n".join(o[-1500:] for o in outs)
    for rank, (rc, text) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"process {rank} failed:\n{text[-3000:]}"
        assert f"ok: process {rank} verified" in text, text[-3000:]
    return out


@pytest.mark.parametrize("layout,blocks_per_device", [
    ("dp", 1), ("lane", 1), ("lanehost", 2)])
def test_two_process_gloo_job_bit_equal_to_jax(tmp_path, unsharded, layout,
                                                blocks_per_device):
    """dp: blocks over the processes; lane: blocks over the processes, the
    bytes over each one's single chip; lanehost: the 16 bytes over the
    processes (all-gathered through host memory by gloo). Every byte of
    the 2 blocks is written by exactly one shard, and equals the JAX
    package's unsharded output."""
    out = _job(tmp_path, layout, blocks_per_device)
    seen = np.zeros(unsharded.shape[:2], np.int64)
    for b0, c0, shard in distributed.load_shards(out):
        bs, nb = shard.shape[:2]
        np.testing.assert_array_equal(shard,
                                      unsharded[b0: b0 + bs, c0: c0 + nb])
        seen[b0: b0 + bs, c0: c0 + nb] += 1
    assert (seen == 1).all(), seen


def test_gate_two_processes_on_the_cpu(tmp_path):
    """The gate at PARAMS_TEST: 2 single-device processes, lanehost, a
    file:// rendezvous; its record goes to --out only."""
    record = tmp_path / "gate.json"
    res = subprocess.run(
        [sys.executable, "-m", "tfhe_aes2_tpu_torch.parallel.gate",
         "--processes", "2", "--backend", "gloo", "--device", "cpu",
         "--params", "test", "--out", str(record), "--timeout",
         str(TIMEOUT)], cwd=REPO, capture_output=True, text=True,
        timeout=TIMEOUT + 30)
    assert res.returncode == 0, res.stderr[-3000:] + res.stdout[-3000:]
    assert "ok: gate verified 2 processes" in res.stdout
    rec = json.loads(record.read_text())
    assert rec["decrypt_verified"] and rec["rendezvous"] == "file"
    assert rec["processes"] == rec["lane_shards"] == 2
    assert all(line.startswith(f"ok: process {r} verified")
               for r, line in enumerate(rec["worker_lines"]))


def test_run_processes_kills_its_children_on_timeout():
    """One shared deadline; each child still running is killed by its own
    PID and reaped."""
    sleeper = [sys.executable, "-c", "import time; time.sleep(60)"]
    quick = [sys.executable, "-c", "print('done')"]
    rcs, outs, timed_out = gate.run_processes([quick, sleeper, sleeper],
                                              1.5)
    assert timed_out
    assert rcs[0] == 0 and outs[0].strip() == "done"
    assert rcs[1] is not None and rcs[1] < 0 and rcs[2] < 0


def test_nccl_refuses_ranks_sharing_a_gpu(monkeypatch):
    """Two ranks on a one-GPU host under nccl are refused before
    init_process_group; under gloo they share the GPU; nccl on the CPU
    is refused; the backend has no default."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def never(*args, **kwargs):
        raise AssertionError("init_process_group reached")
    monkeypatch.setattr(torch.distributed, "init_process_group", never)
    argv = ["--init-method", "file:///nonexistent/rendezvous",
            "--num-processes", "2", "--process-id", "1", "--device", "cuda"]
    with pytest.raises(ValueError, match="nccl needs a GPU of its own"):
        distributed.main(argv + ["--backend", "nccl"])
    assert distributed.process_devices("cuda", "nccl", 0, 1) == [
        torch.device("cuda", 0)]
    assert distributed.process_devices("cuda", "gloo", 1, 1) == [
        torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="nccl runs on GPUs only"):
        distributed.process_devices("cpu", "nccl", 0, 1)
    with pytest.raises(SystemExit):
        distributed.main(argv)
