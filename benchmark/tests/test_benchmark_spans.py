"""The program's spans in a traced window (`benchmark/program_spans.py`),
on a synthetic trace whose answers are worked out by hand, and on a
small traced run on the CPU."""
import io

import pytest

from benchmark import layers, program_spans as ps, trace
from benchmark.tests.small import small_cell
from benchmark.tests.test_benchmark_trace import events as base_events


def span(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def events():
    """`test_benchmark_trace`'s two calls, [0, 100] and [120, 200] us
    (device busy 10-70 and 130-170), with the program's spans inside."""
    return base_events() + [
        span("lz4t.compress_batch", 2, 96),
        span("lz4t.pack", 4, 5),
        span("lz4t.h2d", 9, 13),
        span("lz4t.launch", 22, 3),
        span("lz4t.d2h", 25, 55),
        span("lz4t.to_bytes", 80, 15),
        span("lz4t.compress_batch", 121, 78),
        span("lz4t.pack", 122, 4),
        span("lz4t.h2d", 126, 2),
        span("lz4t.launch", 128, 3),
        span("lz4t.build", 128.5, 1),
        span("lz4t.d2h", 131, 49),
        span("lz4t.to_bytes", 180, 15),
        # not the program's spans
        span("other.step", 30, 5),
        span("lz4t.pack", 4, 5, cat="gpu_user_annotation"),
        {"ph": "i", "cat": "user_annotation", "name": "lz4t.mark", "ts": 3}]


def test_spans_are_the_program_s_complete_annotations():
    got = ps.spans_of(events())
    assert len(got) == 13
    assert got[0] == ("lz4t.compress_batch", 2.0, 98.0)
    assert got[1] == ("lz4t.pack", 4.0, 9.0)
    assert {n for n, _, _ in got} == set(ps.STEPS) | {
        "lz4t.compress_batch", "lz4t.build"}


def test_self_time_is_less_children():
    every = ps.with_calls(trace.from_events(events(), None),
                          ps.spans_of(events()))
    assert every[0] == (trace.CALL_SPAN, 0.0, 100.0)
    assert ps.self_intervals(every, 0) == [(0.0, 2.0), (98.0, 100.0)]
    assert ps.self_intervals(every, 1) == [(2.0, 4.0), (95.0, 98.0)]
    launch = every.index(("lz4t.launch", 128.0, 131.0))
    assert ps.self_intervals(every, launch) == [(128.0, 128.5),
                                                (129.5, 131.0)]


def test_host_time_a_call_by_step():
    v = trace.from_events(events(), None)
    sp = ps.spans_of(events())
    # call 1 / call 2 host us: pack 5 / 4, h2d 13 - 12 busy / 2,
    # launch 0 (all busy) / 2 - 1 busy less the 1 us build child,
    # d2h 55 - 45 / 49 - 39, to_bytes 15 / 15
    want = {"lz4t.pack": 4.5e-3, "lz4t.h2d": 1.5e-3, "lz4t.launch": 0.5e-3,
            "lz4t.d2h": 10e-3, "lz4t.to_bytes": 15e-3}
    by = ps.host_ms_by_span(v, sp)
    for name, ms in want.items():
        assert by[name] == pytest.approx(ms)
    assert by["lz4t.build"] == pytest.approx(0.5e-3)
    assert by["lz4t.compress_batch"] == pytest.approx(5e-3)    # 5 / 5
    assert by[trace.CALL_SPAN] == pytest.approx(3e-3)          # 4 / 2
    # the self times part each call: every span's host time is host_ms
    assert sum(by.values()) == pytest.approx(layers.host_ms(v))
    r = ps.report(v, sp, "compress_batch")
    assert r["steps_sum_ms"] == pytest.approx(31.5e-3)
    assert r["steps_share"] == pytest.approx(31.5 / 40)
    assert r["call_ms"] == pytest.approx(90e-3)
    assert r["per_call"]["lz4t.h2d"] == 1.0


def test_a_missing_span_is_absent():
    base = trace.from_events(base_events(), None)
    assert set(ps.host_ms_by_span(base, [])) == {trace.CALL_SPAN}
    sp = [s for s in ps.spans_of(events()) if s[0] != "lz4t.d2h"]
    v = trace.from_events(events(), None)
    by = ps.host_ms_by_span(v, sp)
    assert "lz4t.d2h" not in by
    assert by["lz4t.pack"] == pytest.approx(4.5e-3)
    assert "lz4t.d2h" not in ps.report(v, sp, "compress_batch")["steps_ms"]
    no_calls = trace.View(ops=v.ops, calls=[])
    assert ps.host_ms_by_span(no_calls, sp) == {}


def test_busy_time_is_trace_s_rule():
    v = trace.from_events(events(), None)
    dev = trace.union(v.in_window())
    ends = [e for _, e in dev]
    for a in range(-5, 210, 7):
        for b in range(a, 215, 11):
            assert ps._covered(dev, ends, a, b) == \
                pytest.approx(trace.covered(dev, a, b))


def test_gaps_are_named_by_step():
    v = trace.from_events(events(), None)
    gaps = {(n, round(s * 1e6))
            for n, s in ps.named_gaps(v, ps.spans_of(events()),
                                      "compress_batch")}
    # [0,10] middle 5 in pack; [70,130] middle 100 in call 1, after its
    # compress_batch; [170,200] middle 185 in call 2's to_bytes
    assert gaps == {("compress_batch/lz4t.pack", 10),
                    ("compress_batch", 60),
                    ("compress_batch/lz4t.to_bytes", 30)}


@pytest.mark.parametrize("with_spans", [False, True])
def test_without_program_spans_the_gaps_are_the_breakdown_s(with_spans):
    v = trace.from_events(events(), None)
    want = trace.breakdown(v, "compress_batch")["idle_gaps"]
    sp = ps.spans_of(events()) if with_spans else []
    got = ps.named_gaps(v, sp, "compress_batch")
    assert [s for _, s in got] == [s for _, s in want]
    assert [n.split("/")[0] for n, _ in got] == [n for n, _ in want]
    if not with_spans:
        assert got == want


def test_the_harness_s_readers_read_what_they_read_without_spans():
    with_, without = (trace.from_events(ev, 7e-6)
                      for ev in (events(), base_events()))
    assert with_ == without
    for f in (layers.host_ms, layers.copy_ms, layers.kernel_roofline,
              layers.device_idle, trace.busy_us):
        assert f(with_) == f(without)
    assert trace.breakdown(with_, "x") == trace.breakdown(without, "x")


@pytest.mark.parametrize("name,steps", [
    ("lz4-64k.compress", set(ps.STEPS)),
    ("lz4hc9-64k.compress", set(ps.STEPS)),
    ("lz4-64k.device-compress", {"lz4t.h2d", "lz4t.launch"})])
def test_a_small_traced_run_reads_its_steps(name, steps):
    rep = ps.traced_run(small_cell(name), 2**31 + 17, 0.3, device="cpu",
                        out=io.StringIO())
    assert rep["result"]["correct"]
    assert set(rep["steps_ms"]) == steps
    assert all(v >= 0 for v in rep["steps_ms"].values())
    # no device operations on the CPU: the spans part the calls' time
    total = sum(rep["steps_ms"].values()) + sum(rep["other_ms"].values())
    assert total == pytest.approx(rep["call_ms"])
    assert rep["host_ms"] is None and rep["steps_share"] is None
    assert rep["builds"] == {}
    label = "encode_blocks" if "device" in name else "compress_batch"
    assert all(n.split("/")[0] in (label, "between calls")
               for n, _ in rep["idle_gaps"])


def test_exits_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert ps.main(["--workload", "lz4-64k.compress", "--seed", "1",
                    "--seconds", "1"]) == 2
