"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), the denominator of every share of a peak here."""

INT8_OPS_PER_S = 1979e12      # dense int8 tensor-core rate, ops/s
