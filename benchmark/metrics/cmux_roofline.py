"""cmux_roofline.{batch,request}: the CMux steps' share of their
int8 roofline, %: the frozen CMux work of what the window answered over
(the device time of the CMux-step kernels, CMUX_KERNELS below, x the H100's
dense int8 peak).

The work is counted here from the configuration's parameter numbers and
the cell's traffic only, never from the port, so it stays the same whatever
implements it:
  blind rotations  the circuit bootstraps the AES circuit of the
                   configuration needs (its `circuit`): per block
                   rounds x round_bootstrap_bits, plus
                   key_schedule_bootstrap_bits a request that brings a
                   fresh key; lanes the program pads do not count;
  x n CMux steps each (lwe_dimension);
  x int8 work a lane-step: (k+1) x (k+1)L negacyclic products of size N,
                   x KEPT_DOTS limb-plane dots of the int8 split,
                   x 2 operations a multiply-add.
KEPT_DOTS is frozen at 11, the dots the default truncation keeps at both
sets (checked once against tfhe_aes2_tpu_torch.bench.kept_dot_ops by
benchmark/tests). A program that computes fewer dots reads a higher share;
one over 105% means this count is wrong, and a benchmark change corrects
it."""

from benchmark import peaks
KEPT_DOTS = 11

# The CMux-step kernels: every kernel that the blind rotation's step loop
# (ops/blind_rotate.py) launches under any lowering of ops/lowering.py,
# matched by name in the trace: extprod_step2g K1 (gridg), extprod_step2
# K5 (grid), extprod_step K6/K7 (glue_out, partials), extprod_step_longk
# K10b, extprod_step3 K11 (bucket), cmux_step_merged(_wide) K9 (merged),
# rot_diff_digits K2 (step 0's glue, or every step's under grid and
# bucket), rot_diff_digits_flat K10a (longk's glue). A lowering with other
# kernel names lands outside this set until a benchmark change adds them.
CMUX_KERNELS = ("extprod_step", "cmux_step_merged", "rot_diff_digits")


def is_cmux(name: str) -> bool:
    return any(k in name for k in CMUX_KERNELS)


def lane_step_ops(p: dict) -> int:
    k1 = p["glwe_dimension"] + 1
    rows = k1 * p["pbs_level"]
    return k1 * rows * p["polynomial_size"] ** 2 * KEPT_DOTS * 2


def blind_rotations(circuit: dict, kind: str, blocks: int,
                    requests: int) -> int:
    per_block = circuit["rounds"] * circuit["round_bootstrap_bits"]
    fresh = circuit["key_schedule_bootstrap_bits"] if kind == "fresh_key" \
        else 0
    return blocks * per_block + requests * fresh


def work_ops(config: dict, kind: str, blocks: int, requests: int) -> int:
    p = config["param_values"]
    return (blind_rotations(config["circuit"], kind, blocks, requests)
            * p["lwe_dimension"] * lane_step_ops(p))


def read(view, entry):
    secs = sum(o.end - o.start for o in view.kernels if is_cmux(o.name)) / 1e6
    if secs <= 0 or not view.blocks:
        return None
    ops = work_ops(view.config, view.mix["kind"], view.blocks, view.requests)
    return 100.0 * ops / (secs * peaks.INT8_OPS_PER_S)
