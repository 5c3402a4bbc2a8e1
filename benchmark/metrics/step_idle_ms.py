"""step_idle_ms.{batch,request}: the device's idle time while the
innermost open range is the blind rotation's step loop (the port's
`tfhe.br.steps` span, one a blind rotation), in ms over the blocks or
requests answered. It is the share of the idle time that CUDA graphs of
the CMux scan can take away. None where the program opens no span
(benchmark/spans.py)."""

from benchmark.spans import read_idle_ms


def read(view, entry):
    return read_idle_ms(view, entry, "lowering and step loop")
