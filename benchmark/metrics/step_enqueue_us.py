"""step_enqueue_us.request: the host's time in the blind rotation's step
loop, in us a CMux step: the `tfhe.br.steps` spans' summed length over
(spans x the configuration's lwe_dimension): what the host takes to
enqueue a step, the profiler's own cost a launch included, while the
device keeps up (were the launch queue full, it would read the device's
step instead). None where the program opens no span (benchmark/spans.py)."""

from benchmark.spans import STEPS


def read(view, entry):
    steps = [b - a for name, a, b in getattr(view, "spans", ())
             if name == STEPS]
    if not steps:
        return None
    return sum(steps) / (len(steps)
                         * view.config["param_values"]["lwe_dimension"])
