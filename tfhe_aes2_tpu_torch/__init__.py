"""tfhe_aes2_tpu_torch — the PyTorch/CUDA port of tfhe_aes2_tpu.

Evaluates AES-128 homomorphically with WoP-PBS TFHE on an NVIDIA H100. The
layout mirrors the JAX package module for module:

  ops/          — L0 primitives on int64 torus tensors (wrapping mod 2^64):
                  decomposition, LWE, negacyclic polynomials, keys,
                  keyswitch, blind rotation, circuit bootstrap + vertical
                  packing.
  ops/kernels/  — the hand-written Hopper kernels (CUDA C++ under csrc/,
                  built with nvcc at first use and bound with ctypes), each
                  beside its plain PyTorch version and a launch counter.
  models/       — the 1-bit WoP-PBS FHE model (BitCt, noise accounting).
  aes_128/      — the AES-128 circuit, clear oracles, client codecs and
                  the staged server entry points.

Torus elements are torch.int64: two's-complement wrapping gives the ring
Z/2^64, and the tensors view bit-for-bit to and from numpy uint64. Entry
points run on "cuda" unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
