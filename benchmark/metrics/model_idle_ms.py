"""model_idle_ms.{batch,request}: the device's idle time while the
innermost open range is the AES circuit or the FHE model's host work
(`tfhe.aes.*`: key schedule, rounds, their XORs and lane moves;
`tfhe.model.*`: the noise and component bookkeeping), in ms over the
blocks or requests answered. None where the program opens no span
(benchmark/spans.py)."""

from benchmark.spans import read_idle_ms


def read(view, entry):
    return read_idle_ms(view, entry, "AES circuit, FHE model")
