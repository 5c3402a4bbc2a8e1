"""The port's utils/ (tfhe_aes2_tpu_torch/utils/) against the JAX
package's (tfhe_aes2_tpu/utils/): the MSB-first bit helpers value for
value, the logger's TFHE_AES_LOG level, idempotent init and the span
(a profiler range only while a profiler records), and profile(), which takes
a torch.profiler trace (the JAX package's takes a jax.profiler one), here of
CPU work."""

import json
import logging

import numpy as np
import pytest
import torch

from tfhe_aes2_tpu.utils import bits as jbits
from tfhe_aes2_tpu_torch.utils import bits as tbits
from tfhe_aes2_tpu_torch.utils import logger as tlogger


@pytest.mark.parametrize("val", [0, 1, 0x5A, 0xFF])
def test_u8_bits_match(val):
    np.testing.assert_array_equal(tbits.u8_to_bits(val), jbits.u8_to_bits(val))
    assert tbits.bits_to_u8(tbits.u8_to_bits(val)) == \
        jbits.bits_to_u8(jbits.u8_to_bits(val)) == val


@pytest.mark.parametrize("val", [0, 0x1234, 0xFFFF])
def test_u16_bits_match(val):
    np.testing.assert_array_equal(tbits.u16_to_bits(val),
                                  jbits.u16_to_bits(val))


@pytest.mark.parametrize("val", [0, 1, 0x0123456789ABCDEF, 2 ** 64 - 1])
def test_u64_bits_match(val):
    np.testing.assert_array_equal(tbits.u64_to_bits(val),
                                  jbits.u64_to_bits(val))
    assert tbits.bits_to_u64(tbits.u64_to_bits(val)) == val == \
        jbits.bits_to_u64(jbits.u64_to_bits(val))


def test_byte_bits_match():
    data = bytes(range(0, 256, 7))
    np.testing.assert_array_equal(tbits.bytes_to_bits(data),
                                  jbits.bytes_to_bits(data))
    assert tbits.bits_to_bytes(tbits.bytes_to_bits(data)) == data == \
        jbits.bits_to_bytes(jbits.bytes_to_bits(data))


@pytest.mark.parametrize("call", [lambda: tbits.bits_to_u8([1, 0]),
                                  lambda: tbits.bits_to_u64([1] * 63),
                                  lambda: tbits.bits_to_bytes([1] * 9)])
def test_bits_refuse_wrong_lengths(call):
    """ValueError where the JAX package asserts."""
    with pytest.raises(ValueError):
        call()


def test_logger_init_reads_tfhe_aes_log_once(monkeypatch):
    calls = []
    monkeypatch.setattr(tlogger, "_INITIALIZED", False)
    monkeypatch.setattr(logging, "basicConfig",
                        lambda **kw: calls.append(kw["level"]))
    monkeypatch.setenv("TFHE_AES_LOG", "WARNING")
    tlogger.init("INFO")
    tlogger.test_init()
    assert calls == ["WARNING"]
    monkeypatch.setattr(tlogger, "_INITIALIZED", False)
    monkeypatch.delenv("TFHE_AES_LOG")
    tlogger.test_init()
    assert calls == ["WARNING", "DEBUG"]


def test_span_is_a_range_only_while_profiling(monkeypatch):
    """No profiler: the shared null context, record_function never entered.
    Under one: a range of that name in the trace."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with tlogger.span("tfhe.wop.vp") as got:
        assert got is None
    assert tlogger.span("tfhe.br.steps") is tlogger.span("tfhe.wop.pbs")
    monkeypatch.undo()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tlogger.span("tfhe.wop.vp"):
            torch.ones(4).sum()
    assert "tfhe.wop.vp" in {e.key for e in prof.key_averages()}


def test_profile_traces_cpu_work(tmp_path):
    a = torch.ones((64, 64), dtype=torch.float64)
    with tlogger.profile(str(tmp_path)) as prof:
        (a @ a).sum()
    names = {e.key for e in prof.key_averages()}
    assert "aten::mm" in names or "aten::matmul" in names
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
