"""The reduction of a profiler trace: busy union, kernel seconds, idle
gaps named by the host's activity."""

import pytest

from benchmark import trace


class Ev:
    def __init__(self, name, s, e, dev="CPU", ann=False):
        self._n, self._s, self._e, self._d, self._a = name, s, e, dev, ann

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return "DeviceType." + self._d

    def is_user_annotation(self):
        return self._a


def test_bench_trace_summary():
    ms = 1_000_000
    events = [
        Ev("bench/tokenize", 0, 40 * ms, ann=True),
        Ev("bench/tokenize", 0, 40 * ms, "CUDA", ann=True),  # the device copy of an annotation
        Ev("aten::mm", 41 * ms, 42 * ms),
        Ev("gemm_kernel", 42 * ms, 50 * ms, "CUDA"),
        Ev("gemm_kernel", 45 * ms, 55 * ms, "CUDA"),
        Ev("aten::item", 55 * ms, 80 * ms),
        Ev("attn_kernel", 60 * ms, 70 * ms, "CUDA"),
    ]
    s = trace.summarize(events, window_s=0.1)
    assert abs(s["busy_s"] - 0.023) < 1e-12
    assert sorted(s["kernel_s"]) == ["attn_kernel", "gemm_kernel"]
    assert abs(s["kernel_s"]["gemm_kernel"] - 0.018) < 1e-12 and abs(s["kernel_s"]["attn_kernel"] - 0.01) < 1e-12
    gaps = dict((n.rsplit(" (", 1)[0], v) for n, v in s["idle_gaps"])
    # 0-42 under the tokenize span, 55-60 in aten::item, 70-100 after it
    assert abs(gaps["tokenize"] - 0.042) < 1e-12
    assert abs(gaps["aten::item"] - 0.005) < 1e-12
    assert abs(gaps["host (no torch op)"] - 0.030) < 1e-12
    assert s["device_ops"][0][0] == "gemm_kernel"


def test_bench_spans_count_only_while_active():
    sp = trace.Spans()
    with sp.span("a"):
        pass
    assert sp.seconds == {}
    sp.active = True
    with sp.span("a"):
        pass
    assert list(sp.seconds) == ["a"]


def test_bench_marked_calls_split_the_device_timeline():
    """Marks from another thread, on the host's clock, moved onto the
    trace's by the clock annotation: each segment gets the device work
    that starts in it, and only segments that end inside the window
    report."""
    ms = 1_000_000
    host0 = 5_000 * ms  # the host's clock when the trace's read 0
    marks = [
        (host0 + 10 * ms, "decode_step", (3, 30)),
        (host0 + 30 * ms, "prefill", None),
        (host0 + 50 * ms, "decode_step", (4, 44)),
        (host0 + 90 * ms, "decode_step", (4, 48)),  # its segment runs past the window
    ]
    events = [
        Ev("bench/clock", 0, 1000, ann=True),
        Ev("step_kernel", 12 * ms, 20 * ms, "CUDA"),
        Ev("step_kernel", 18 * ms, 25 * ms, "CUDA"),
        Ev("prefill_kernel", 31 * ms, 45 * ms, "CUDA"),
        Ev("step_kernel", 52 * ms, 60 * ms, "CUDA"),
        Ev("step_kernel", 92 * ms, 99 * ms, "CUDA"),
    ]
    s = trace.summarize(events, window_s=0.1, marks=marks, clock_ns=host0)
    seg = s["segments"]
    assert [n for n, _ in seg["decode_step"]] == [(3, 30), (4, 44)]
    assert [d for _, d in seg["decode_step"]] == pytest.approx([0.013, 0.008])
    assert seg["prefill"] == [[None, pytest.approx(0.014)]]
    gaps = dict((n.rsplit(" (", 1)[0], v) for n, v in s["idle_gaps"])
    # a gap is named at its middle: 45-52 ms by the prefill's segment;
    # 25-31, 60-92 and 99-100 by the steps'; 0-12 comes before any mark
    assert gaps["prefill"] == pytest.approx(0.007)
    assert gaps["decode_step"] == pytest.approx(0.039)
    assert gaps["host (no torch op)"] == pytest.approx(0.012)


def test_bench_marked_records_only_while_a_trace_runs():
    sp = trace.Spans()
    calls = []
    f = sp.marked(lambda x: calls.append(x) or x, "step", lambda: "note")
    assert f(1) == 1 and sp.marks == []
    sp.annotate = True
    assert f(2) == 2
    assert [(n, note) for _, n, note in sp.marks] == [("step", "note")] and calls == [1, 2]
