"""The traced run's reduction on a made-up profile: device intervals,
spans, idle shares, kernel sums and the breakdown's labels."""

import types

import pytest
import torch

from spbench.trace import Trace, kernel_name, union_seconds

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def event(name, start_us, dur_us, dev=CPU, index=-1):
    return types.SimpleNamespace(
        name=lambda: name, device_type=lambda: dev, device_index=lambda: index,
        start_ns=lambda: start_us * 1000, duration_ns=lambda: dur_us * 1000)


def trace(events):
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return Trace(prof)


def test_union_seconds():
    assert union_seconds([0, 1, 5], [2, 3, 6]) == pytest.approx(4)
    assert union_seconds([0, 1, 5], [2, 3, 6], 1.5, 5.5) == pytest.approx(2)
    assert union_seconds([], []) == 0


def test_kernel_name():
    assert kernel_name("void encode_kernel<16>(Params)") == "encode_kernel"
    assert kernel_name("analyze_blocks_kernel(unsigned char const*)") == "analyze_blocks_kernel"


def test_spans_idle_kernels_and_breakdown():
    t = trace([
        event("spbench.window", 0, 100),
        event("spbench.Encoder.encode_batch", 10, 40),
        event("aten::copy_", 20, 10),
        event("void encode_kernel<8>(Params)", 12, 8, CUDA, 0),
        event("Memcpy HtoD (Pageable -> Device)", 30, 10, CUDA, 0),
        event("spbench.Encoder.encode_batch", 60, 20, CUDA, 0),  # GPU copy of a range
    ])
    assert t.span_seconds("Encoder.encode_batch") == pytest.approx(40e-6)
    assert t.idle_share("Encoder.encode_batch", [0]) == pytest.approx(1 - 18 / 40)
    assert t.device_seconds("Encoder.encode_batch", "encode_kernel") == pytest.approx(8e-6)
    assert int(t.within("Encoder.encode_batch", kernels_only=True).sum()) == 1
    b = t.breakdown("window", [0])
    assert [n for n, _ in b["device_ops"]] == ["Memcpy HtoD (Pageable -> Device)",
                                              "void encode_kernel<8>(Params)"]
    gaps = dict(b["idle_gaps"])
    # idle 0-12, 20-30 and 40-100: cut at the span's edges (10, 50)
    assert gaps["window / python"] == pytest.approx((10 + 50) * 1e-6)
    assert gaps["Encoder.encode_batch / python"] == pytest.approx((2 + 10) * 1e-6)
    assert gaps["Encoder.encode_batch / aten::copy_"] == pytest.approx(10e-6)
    assert sum(gaps.values()) == pytest.approx(82e-6)
