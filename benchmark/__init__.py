"""The benchmark of the PyTorch/CUDA port (tfhe_aes2_tpu_torch): one cell a
run, as `python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` from the root of a checkout. BENCHMARK.json names the cells
and metrics; everything of one configuration, traffic mix or per-layer
metric lives in a file of its own here, found by name (spec.py)."""
