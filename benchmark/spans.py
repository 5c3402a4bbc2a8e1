"""The program's spans in the traced window, beside the harness's ranges.

The port opens a torch.profiler range named `tfhe.<layer>.<what>` at each
layer boundary while a profiler records (tfhe_aes2_tpu_torch/utils/
logger.py, SPANS). They are host events on the trace's one clock, so each
of the device's idle gaps can be put on the innermost range open at its
middle, a harness range or a program span alike (trace.idle_gaps's rule).

`view` is trace.view with that added: the view also holds `spans`, the
program's ranges in the window, and `idle_by_range`, the idle seconds by
innermost range, every one of them; the breakdown's `idle_gaps` is the top
10 of that map. The device's copies of the spans are left out as those of
the harness's ranges are. Where the program opens no span, `spans` is
empty and the readers of metrics/step_idle_ms.py, primitive_idle_ms.py,
model_idle_ms.py and step_enqueue_us.py give None.

The benchmark reads these once benchmark/harness.py calls spans.view where
it calls trace.view; until then the result line holds none of them."""

from __future__ import annotations

import dataclasses

from benchmark import trace

PREFIX = "tfhe."
STEPS = "tfhe.br.steps"

# layer (PERF.md §3) -> the prefixes of the innermost spans whose idle
# time it takes
LAYERS = {
    "lowering and step loop": ("tfhe.br.",),
    "wop-pbs primitives": ("tfhe.wop.",),
    "AES circuit, FHE model": ("tfhe.aes.", "tfhe.model."),
}


@dataclasses.dataclass
class SpanView(trace.TraceView):
    """trace.TraceView and the program's spans: (name, start us, end us)
    clipped to the window, by start; idle seconds by innermost range."""

    spans: list = dataclasses.field(default_factory=list)
    idle_by_range: dict = dataclasses.field(default_factory=dict)


def view(events, requests: int, blocks: int, config: dict,
         mix: dict) -> tuple[SpanView, dict]:
    """raw_events -> (the readers' view, the result line's `breakdown`),
    as trace.view, with the program's spans."""
    kept, ranges = [], []
    for ev in events:
        name, on_device, _, start, end = ev
        if not on_device and name.startswith((PREFIX, trace.HOST_PREFIX)):
            ranges.append((name, start, end))
        if not name.startswith(PREFIX):
            kept.append(ev)
    tv, breakdown = trace.view(kept, requests, blocks, config, mix)
    lo, hi = trace.window_of(ranges)
    spans = sorted(((n, max(a, lo), min(b, hi)) for n, a, b in ranges
                    if n.startswith(PREFIX) and a < hi and b > lo),
                   key=lambda s: s[1])
    busy = trace.union((o.start, o.end) for o in tv.ops)
    inner = [r for r in ranges if r[0] != trace.WINDOW]
    by_range = trace.idle_gaps(busy, inner, lo, hi, top=None)
    breakdown["idle_gaps"] = by_range[:10]
    return SpanView(**vars(tv), spans=spans,
                    idle_by_range=dict(by_range)), breakdown


def layer_of(name: str) -> str | None:
    """The layer whose idle time a gap under innermost range `name` is;
    None outside every program span."""
    for layer, prefixes in LAYERS.items():
        if name.startswith(prefixes):
            return layer
    return None


def layer_idle_s(view, layer: str) -> float | None:
    """Idle seconds whose innermost range is a span of `layer`; None where
    the window holds no program span."""
    if not getattr(view, "spans", None):
        return None
    return sum(s for name, s in view.idle_by_range.items()
               if layer_of(name) == layer)


def read_idle_ms(view, entry, layer: str) -> float | None:
    """A layer's idle ms over the blocks or requests the unit names."""
    secs, n = layer_idle_s(view, layer), view.per(entry["unit"])
    if secs is None or not n:
        return None
    return 1e3 * secs / n
