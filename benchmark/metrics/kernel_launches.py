"""kernel_launches.{batch,request}: device kernels in the traced window
(counted from the trace, not from the port's counters) over the blocks or
requests answered in it, as the unit says. Fusion and fewer steps lower it;
CUDA graphs leave it as it is."""


def read(view, entry):
    n = view.per(entry["unit"])
    if not n or not view.kernels:
        return None
    return len(view.kernels) / n
