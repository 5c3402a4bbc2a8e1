"""noncmux_device_ms.{batch,request}: device time of every operation
outside the CMux-step kernels (cmux_roofline.CMUX_KERNELS): the
vertical packing (K3), the keyswitch and pfKS (K4), torch's own glue and
compression kernels, the copies and fills, in ms over the blocks or
requests answered."""

from benchmark.metrics.cmux_roofline import is_cmux


def read(view, entry):
    n = view.per(entry["unit"])
    if not n or not view.ops:
        return None
    secs = sum(o.end - o.start for o in view.ops
               if not (o.is_kernel and is_cmux(o.name))) / 1e6
    return 1e3 * secs / n
