"""Which kernels the blind rotation and the vertical packing run.

Every lowering computes the same exact mod-2^64 arithmetic over the same
kept limb planes, so all give bit-equal ciphertexts; they differ in how the
work is cut into launches. The names follow the JAX package's environment
switches (tfhe_aes2_tpu/ops/blind_rotate.py, ops/pallas/extprod.py), which
`Lowering.from_env` reads so that one setting selects the counterpart
schedule in both packages:

  br  "gridg"     K2 once, then K1 per step (dots + recombine + the next
                  step's glue in one launch); TFHE_BR_KERNEL=gridg, default
      "grid"      K2 then K5 per step (glue and dots as two launches);
                  TFHE_BR_KERNEL=grid
      "merged"    K9 per step (glue, dots and recombine in one launch, the
                  digits never in device memory); TFHE_BR_KERNEL=merged
      "longk"     K10a then K10b per step (row-flattened digits, one long
                  contraction a lane, its rows split across blocks to
                  fill the card); TFHE_BR_KERNEL=longk
      "bucket"    K2 then K11 per step (one weight bucket per block, added
                  with atomics); TFHE_BR_KERNEL=bucket
      "glue_out"  rotate, subtract, decompose and split in plain torch, then
                  K6 per step on batch-major layouts; TFHE_BR_GLUE=xla
  vp  "fused"     K3 per CMux stage (u64 recombination in the kernel);
                  default
      "partials"  K8 per CMux stage (int32 partial sums), recombined in
                  torch; TFHE_VP_FUSED=0
"""

from __future__ import annotations

import os
from dataclasses import dataclass

BR_CHOICES = ("gridg", "grid", "merged", "longk", "bucket", "glue_out")
VP_CHOICES = ("fused", "partials")

# The kernel wrappers each schedule launches (ops/kernels/extprod.py); K4,
# the keyswitches' contraction, runs under every lowering. Which N each
# takes on the card is extprod.N_MAX, read by extprod.device_refusal: at
# N = 1024 every lowering but merged (K9 takes N <= 512).
# tests/test_torch_device_refusal.py holds these tables against the
# wrappers that blind_rotate.py and circuit_bootstrap.py call.
BR_KERNELS = {"gridg": ("rot_diff_digits", "extprod_step2g"),
              "grid": ("rot_diff_digits", "extprod_step2"),
              "merged": ("cmux_step_merged",),
              "longk": ("rot_diff_digits_flat", "extprod_step_longk"),
              "bucket": ("rot_diff_digits", "extprod_step3"),
              "glue_out": ("extprod_step",)}
VP_KERNELS = {"fused": ("extprod_grouped_fused",),
              "partials": ("extprod_partials_grouped",)}


@dataclass(frozen=True)
class Lowering:
    br: str = "gridg"
    vp: str = "fused"

    def __post_init__(self):
        if self.br not in BR_CHOICES:
            raise ValueError(f"Lowering.br {self.br!r} not in {BR_CHOICES}")
        if self.vp not in VP_CHOICES:
            raise ValueError(f"Lowering.vp {self.vp!r} not in {VP_CHOICES}")

    def kernels(self) -> tuple[str, ...]:
        """The names of the kernel wrappers this lowering's blind rotation
        and vertical packing launch."""
        return BR_KERNELS[self.br] + VP_KERNELS[self.vp]

    @classmethod
    def from_env(cls) -> "Lowering":
        """The lowering the JAX package would run under the same
        TFHE_BR_GLUE / TFHE_BR_KERNEL / TFHE_VP_FUSED. As there,
        TFHE_BR_GLUE=xla takes the blind rotation whatever TFHE_BR_KERNEL
        says."""
        env = os.environ
        kernel = env.get("TFHE_BR_KERNEL", "gridg")
        if env.get("TFHE_BR_GLUE", "pallas") == "xla":
            br = "glue_out"
        elif kernel in BR_CHOICES and kernel != "glue_out":
            br = kernel
        else:
            raise ValueError(f"TFHE_BR_KERNEL={kernel!r} is not a schedule "
                             "of the blind rotation")
        vp = "partials" if env.get("TFHE_VP_FUSED", "1") == "0" else "fused"
        return cls(br=br, vp=vp)
