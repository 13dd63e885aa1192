"""The reduction of a traced window, on a synthetic trace whose answers
are worked out by hand."""
import pytest

from benchmark import layers, roofline, trace


def events():
    # two calls: [0, 100] and [120, 200] us; a window of 200 us
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.CALL_SPAN,
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": trace.CALL_SPAN,
           "ts": 120, "dur": 80},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 10,
           "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 20, "dur": 30},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 50,
           "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 130, "dur": 40},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 0,
           "dur": 5},
          {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3}]
    return ev


def test_view_and_layers():
    v = trace.from_events(events(), least_s=7e-6)
    assert v.window == (0.0, 200.0)
    assert len(v.ops) == 4 and len(v.calls) == 2
    assert trace.busy_us(v) == pytest.approx(100.0)
    # call 1: 100 us less 60 busy; call 2: 80 less 40
    assert layers.host_ms(v) == pytest.approx((40 + 40) / 2 * 1e-3)
    assert layers.copy_ms(v) == pytest.approx(30 / 2 * 1e-3)
    assert layers.kernel_roofline(v) == pytest.approx(7 / 70 * 100)
    assert layers.device_idle(v) == pytest.approx(50.0)


def test_breakdown():
    v = trace.from_events(events(), least_s=None)
    b = trace.breakdown(v, "compress_batch")
    assert b["device_ops"][0] == ["k", pytest.approx(70e-6)]
    gaps = {(n, round(s * 1e6)) for n, s in b["idle_gaps"]}
    # idle: [0,10] call, [70,130] mostly call 1's tail and the gap
    # between calls (middle at 100: inside call 1), [170,200] call 2
    assert gaps == {("compress_batch", 10), ("compress_batch", 60),
                    ("compress_batch", 30)}


def test_nothing_to_read():
    ev = [e for e in events() if e["cat"] == "user_annotation"]
    v = trace.from_events(ev, least_s=1e-6)
    for f in (layers.host_ms, layers.copy_ms, layers.kernel_roofline,
              layers.device_idle):
        assert f(v) is None
    v = trace.from_events(events(), least_s=None)
    assert layers.kernel_roofline(v) is None


def test_least_time():
    assert roofline.least_seconds(3.35e12, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(1.0)
    assert roofline.least_seconds(1, "some other card") is None
    assert roofline.call_bytes(10, 4) == 14
