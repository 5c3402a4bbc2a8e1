"""primitive_idle_ms.{batch,request}: the device's idle time while the
innermost open range is a wop-pbs primitive (`tfhe.wop.*`: keyswitch, PBS
outside its step loop, pfKS, vertical packing, compression), in ms over
the blocks or requests answered. None where the program opens no span
(benchmark/spans.py)."""

from benchmark.spans import read_idle_ms


def read(view, entry):
    return read_idle_ms(view, entry, "wop-pbs primitives")
