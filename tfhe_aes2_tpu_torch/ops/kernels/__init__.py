"""Hand-written Hopper kernels (CUDA C++ in tfhe_aes2_tpu_torch/csrc/).

Each wrapper module holds, per kernel: the wrapper (checks, launch, a
`launches` counter), its plain PyTorch version (the CPU path and the
reference the kernel is held against on the card), and a note on what it
replaces and what bounds it. Kernels are built with nvcc at first use
(build.py); importing these modules needs neither nvcc nor a card.
"""
