"""Reading a torch.profiler trace of the window: the device operations
(kernels, copies, fills) and the harness's own host ranges, on the trace's
one clock. The arithmetic is csrc/probes/latency_trace.py's (busy time as
the union of device intervals), copied so that the yardstick stays here."""

from __future__ import annotations

import bisect
import dataclasses

WINDOW = "bench.window"
HOST_PREFIX = "bench."


@dataclasses.dataclass
class Op:
    name: str
    start: float      # microseconds, the trace's clock
    end: float
    is_kernel: bool


@dataclasses.dataclass
class TraceView:
    """What the per-layer readers read: the window's device operations, its
    length and busy time, what was answered in it, and the cell's
    configuration and traffic mix."""

    ops: list
    window_s: float
    busy_s: float
    requests: int
    blocks: int
    config: dict
    mix: dict

    @property
    def kernels(self) -> list:
        return [o for o in self.ops if o.is_kernel]

    def per(self, unit: str) -> int:
        """The count a unit such as `ms/block` or `launches/request` is
        taken over."""
        return {"block": self.blocks, "request": self.requests}[
            unit.rsplit("/", 1)[1]]


def union(intervals) -> list:
    """Sorted, merged [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace marker and
    argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(", 1)[0].strip()


def raw_events(prof):
    """(name, on the device, a user annotation, start us, end us) of every
    event of a finished torch.profiler run, read from its kineto results
    without building the profiler's FunctionEvent tree."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        yield (e.name(), e.device_type() == cuda, e.is_user_annotation(),
               e.start_ns() / 1e3, e.end_ns() / 1e3)


def collect(events) -> tuple[list, list]:
    """raw_events -> (device ops, host ranges (name, start, end) of the
    harness). The device's projections of the host's annotations are not
    device work and are left out."""
    ops, host = [], []
    for name, on_device, annotation, start, end in events:
        if on_device:
            if annotation or name.startswith(HOST_PREFIX):
                continue
            low = name.lower()
            is_kernel = not (low.startswith("memcpy")
                             or low.startswith("memset"))
            ops.append(Op(name, start, end, is_kernel))
        elif name.startswith(HOST_PREFIX):
            host.append((name, start, end))
    return ops, host


def window_of(host: list) -> tuple[float, float]:
    spans = [(a, b) for n, a, b in host if n == WINDOW]
    if len(spans) != 1:
        raise RuntimeError(f"the trace holds {len(spans)} window ranges")
    return spans[0]


def clip(ops: list, lo: float, hi: float) -> list:
    """The ops inside [lo, hi], cut to it (one of no length counts where it
    starts inside)."""
    out = []
    for o in ops:
        a, b = max(o.start, lo), min(o.end, hi)
        if b > a or (o.start == o.end and lo <= o.start < hi):
            out.append(Op(o.name, a, b, o.is_kernel))
    return out


def device_breakdown(ops: list, top: int = 10) -> list:
    """[[kernel or copy, seconds]] by total device time, largest first."""
    tot: dict = {}
    for o in ops:
        k = short_name(o.name)
        tot[k] = tot.get(k, 0.0) + (o.end - o.start) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda x: -x[1])][:top]


def idle_gaps(busy: list, host: list, lo: float, hi: float,
              top: int = 10) -> list:
    """[[host range, seconds]]: the device's idle time in the window, summed
    by the innermost harness range open at each gap's middle (the window
    itself where no other is)."""
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    # by start, and of two that start together the outer (longer) first
    ranges = sorted(((a, b, n) for n, a, b in host),
                    key=lambda r: (r[0], -r[1]))
    starts = [r[0] for r in ranges]
    tot: dict = {}
    for a, b in gaps:
        mid = (a + b) / 2
        name = WINDOW
        # ranges nest on the one host thread: scanning back from the last
        # range that starts before `mid`, the first holding it is innermost
        for ra, rb, rn in reversed(ranges[:bisect.bisect_right(starts, mid)]):
            if mid < rb:
                name = rn
                break
        tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda x: -x[1])][:top]


def view(events, requests: int, blocks: int, config: dict,
         mix: dict) -> tuple[TraceView, dict]:
    """-> (the readers' view, the result line's `breakdown`)."""
    ops, host = collect(events)
    lo, hi = window_of(host)
    ops = clip(ops, lo, hi)
    busy = union((o.start, o.end) for o in ops)
    busy_s = sum(b - a for a, b in busy) / 1e6
    tv = TraceView(ops=ops, window_s=(hi - lo) / 1e6, busy_s=busy_s,
                   requests=requests, blocks=blocks, config=config, mix=mix)
    inner = [h for h in host if h[0] != WINDOW]
    return tv, {"device_ops": device_breakdown(ops),
                "idle_gaps": idle_gaps(busy, inner, lo, hi)}
