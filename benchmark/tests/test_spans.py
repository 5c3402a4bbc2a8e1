"""benchmark/spans.py and its readers on synthetic event lists: the idle
time put on the innermost range, harness range or program span; the
device's copies of the spans left out, flagged as annotations or not; the
readers that were there reading the same with and without program events;
None where the program opens no span."""

import pytest

from benchmark import spans, spec
from benchmark import trace as trace_mod

CFG = spec.config("lvl64-galmul")
MIX = {"kind": "reused_key"}
OLD = ("device_idle_share.request", "cmux_roofline.request",
       "noncmux_device_ms.request", "kernel_launches.request")
NEW = {"step_idle_ms": "lowering and step loop",
       "primitive_idle_ms": "wop-pbs primitives",
       "model_idle_ms": "AES circuit, FHE model"}
UNIT = {"request": "ms/request", "batch": "ms/block"}


def _event(name, start, end, cuda=False, annotation=False):
    return (name, cuda, annotation, start, end)


STEP = "void extprod_step2g_kernel<2, 2>(signed char const*)"
# A 1 s window, one request of 16 blocks; busy 0.65 s. Its four gaps fall
# under the PBS outside its step loop (0.06 s), the step loop (0.02 s), the
# model's metadata work (0.12 s) and the readback (0.15 s).
HARNESS = [_event("bench.window", 0, 1e6),
           _event("bench.request", 0, 1e6),
           _event("bench.rounds", 0, 8e5),
           _event("bench.readback", 8e5, 1e6)]
DEVICE = [_event("fused_limb_matmul_kernel", 0, 1e5, True),
          _event(STEP, 1.6e5, 3e5, True),
          _event(STEP, 3.2e5, 5.2e5, True),
          _event("Memcpy HtoD (Pageable -> Device)", 5.2e5, 5.5e5, True),
          _event("elementwise_kernel", 6.7e5, 8.5e5, True),
          _event("aten::add", 0, 1)]
PROGRAM = [_event("tfhe.aes.encrypt_blocks", 1e4, 7.9e5),
           _event("tfhe.aes.round", 1e4, 7.9e5),
           _event("tfhe.wop.pbs", 1e5, 5e5),
           _event("tfhe.br.steps", 1.5e5, 4.5e5),
           _event("tfhe.wop.vp", 5e5, 6e5),
           _event("tfhe.model.meta", 6e5, 7e5)]
# the device's copies of two spans: one flagged as an annotation, one not
COPIES = [_event("tfhe.br.steps", 1.5e5, 4.5e5, True, True),
          _event("tfhe.wop.vp", 5e5, 6e5, True)]


def _views(events):
    """(spans.view, trace.view without the program's events) of a list."""
    plain = [e for e in events if not e[0].startswith("tfhe.")]
    return (spans.view(events, 1, 16, CFG, MIX),
            trace_mod.view(plain, 1, 16, CFG, MIX))


def _read(name, view):
    per = name.split(".")[1]
    return spec.metric_reader(name).read(view, {"unit": UNIT[per]})


def test_idle_split_by_layer():
    (tv, breakdown), _ = _views(HARNESS + DEVICE + PROGRAM + COPIES)
    assert tv.busy_s == pytest.approx(0.65)
    assert tv.idle_by_range == {"tfhe.wop.pbs": pytest.approx(0.06),
                                "tfhe.br.steps": pytest.approx(0.02),
                                "tfhe.model.meta": pytest.approx(0.12),
                                "bench.readback": pytest.approx(0.15)}
    assert dict(breakdown["idle_gaps"]) == tv.idle_by_range
    assert [s[0] for s in tv.spans] == [e[0] for e in PROGRAM]
    want = {"step_idle_ms": 20.0, "primitive_idle_ms": 60.0,
            "model_idle_ms": 120.0}
    for m, ms in want.items():
        assert _read(f"{m}.request", tv) == pytest.approx(ms)
        assert _read(f"{m}.batch", tv) == pytest.approx(ms / 16)
    lwe_n = CFG["param_values"]["lwe_dimension"]
    assert spec.metric_reader("step_enqueue_us.request").read(
        tv, {"unit": "us/step"}) == pytest.approx(3e5 / lwe_n)


@pytest.mark.parametrize("copies", [[], COPIES[:1], COPIES[1:], COPIES],
                         ids=["none", "annotation", "unflagged", "both"])
def test_old_readers_read_the_same(copies):
    """The readers that were there, and the device ops, with and without
    the program's spans and their device copies."""
    (tv, got), (plain, want) = _views(HARNESS + DEVICE + PROGRAM + copies)
    assert [o.name for o in tv.ops] == [o.name for o in plain.ops]
    assert (tv.busy_s, tv.window_s) == (plain.busy_s, plain.window_s)
    assert got["device_ops"] == want["device_ops"]
    for name in OLD:
        assert _read(name, tv) == _read(name, plain)


def test_layers_and_the_rest_sum_to_the_idle_time():
    (tv, _), _ = _views(HARNESS + DEVICE + PROGRAM + COPIES)
    parts = [spans.layer_idle_s(tv, layer) for layer in NEW.values()]
    rest = sum(s for n, s in tv.idle_by_range.items()
               if spans.layer_of(n) is None)
    assert sum(parts) + rest == pytest.approx(tv.window_s - tv.busy_s)
    assert _read("device_idle_share.request", tv) / 100 * tv.window_s == \
        pytest.approx(sum(parts) + rest)


def test_no_program_span_reads_none():
    """As on a program without spans: the new readers give None, the
    breakdown is trace.view's."""
    (tv, got), (plain, want) = _views(HARNESS + DEVICE)
    assert tv.spans == [] and got == want
    for view in (tv, plain):
        for m in list(NEW) + ["step_enqueue_us"]:
            assert _read(f"{m}.request", view) is None


def test_a_layer_with_no_idle_reads_zero():
    """Spans but no gap under the step loop: 0, not None."""
    device = DEVICE[:1] + [_event(STEP, 1.6e5, 5.2e5, True)] + DEVICE[3:]
    (tv, _), _ = _views(HARNESS + device + PROGRAM)
    assert _read("step_idle_ms.request", tv) == 0
