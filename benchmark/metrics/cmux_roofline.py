"""cmux_roofline.{batch,request}: the CMux steps' share of their
int8 roofline, %: the frozen CMux work of what the window answered over
(the device time of the CMux-step kernels, CMUX_KERNELS below, x the H100's
dense int8 peak).

The work is counted here from the numbers the configuration file states
and the cell's traffic only, never from the port, so it stays the same
whatever implements it:
  blind rotations  the circuit's (its `circuit`): per block and round
                   round_blind_rotations, plus key_schedule_blind_rotations
                   a request that brings a fresh key; where those are not
                   stated, one rotation a bootstrapped bit
                   (round_bootstrap_bits, key_schedule_bootstrap_bits);
                   lanes the program pads do not count;
  x n CMux steps each (lwe_dimension);
  x int8 work a lane-step: (k+1) x (k+1)L negacyclic products of size N,
                   x the limb-plane dots of the int8 split that the
                   default truncation keeps (the configuration's
                   `kept_dots`, KEPT_DOTS where not stated),
                   x 2 operations a multiply-add.
So a configuration whose set keeps another number of dots than KEPT_DOTS,
or takes more than one blind rotation a bootstrapped bit (cbs_level above
1, or bits extracted by PBS), states `kept_dots`, `round_blind_rotations`
and `key_schedule_blind_rotations` (benchmark/tests holds the dots against
tfhe_aes2_tpu_torch.bench.kept_dot_ops at each configuration's set). A
program that computes fewer dots reads a higher share; one over 105% means
a count is wrong, and a benchmark change corrects it."""

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


def lane_step_ops(config: dict) -> int:
    p = config["param_values"]
    k1 = p["glwe_dimension"] + 1
    rows = k1 * p["pbs_level"]
    return (k1 * rows * p["polynomial_size"] ** 2
            * config.get("kept_dots", KEPT_DOTS) * 2)


def _stated(circuit: dict, key: str, fallback: str) -> int:
    return circuit[key] if key in circuit else circuit[fallback]


def blind_rotations(circuit: dict, kind: str, blocks: int,
                    requests: int) -> int:
    per_round = _stated(circuit, "round_blind_rotations",
                        "round_bootstrap_bits")
    fresh = (_stated(circuit, "key_schedule_blind_rotations",
                     "key_schedule_bootstrap_bits")
             if kind == "fresh_key" else 0)
    return blocks * circuit["rounds"] * per_round + requests * fresh


def work_ops(config: dict, kind: str, blocks: int, requests: int) -> int:
    return (blind_rotations(config["circuit"], kind, blocks, requests)
            * config["param_values"]["lwe_dimension"] * lane_step_ops(config))


def read(view, entry):
    secs = sum(o.end - o.start for o in view.kernels if is_cmux(o.name)) / 1e6
    if secs <= 0 or not view.blocks:
        return None
    ops = work_ops(view.config, view.mix["kind"], view.blocks, view.requests)
    return 100.0 * ops / (secs * peaks.INT8_OPS_PER_S)
