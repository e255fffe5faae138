"""The answer cell's readers of the batcher's split counters: by hand on
a small record, on a record of the parent's kind (no split counters), and
on the record of a window of the answer generator run on the CPU at a
tiny size, whose ``stats`` must keep the batcher's two identities. With a
card, a traced tiny run prints all eight."""

import pytest

from benchmark import harness
from benchmark.tests import tiny
from benchmark.trace import Spans

NEW = (
    "step_launch_ms.answer", "step_sync_ms.answer", "prefill_launch_ms.answer",
    "prefill_sync_ms.answer", "boundary_ms.answer", "queue_wait_ms.answer", "submit_ms.answer",
    "prefill_real_share.answer",
)


def _read(name: str, rec: dict):
    return harness.metric_module(name).read(rec)


def test_bench_split_readers_by_hand():
    rec = {"stats": {
        "submitted": 5, "decode_steps": 40, "prefills": 4,
        "step_seconds": 1.2, "step_launch_seconds": 1.0, "step_sync_seconds": 0.2,
        "prefill_seconds": 0.5, "prefill_launch_seconds": 0.4, "prefill_sync_seconds": 0.1,
        "loop_seconds": 1.9, "queue_seconds": 0.3, "submit_seconds": 0.01,
        "prefill_tokens": 300, "prefill_positions": 400,
    }}
    want = {
        "step_launch_ms.answer": 25.0, "step_sync_ms.answer": 5.0,
        "prefill_launch_ms.answer": 100.0, "prefill_sync_ms.answer": 25.0,
        "boundary_ms.answer": 5.0, "queue_wait_ms.answer": 75.0, "submit_ms.answer": 2.0,
        "prefill_real_share.answer": 75.0,
    }
    for name in NEW:
        assert _read(name, rec) == pytest.approx(want[name]), name


@pytest.mark.parametrize("name", NEW)
def test_bench_split_readers_read_nothing_without_the_counters(name):
    # the parent's batcher has no split counters
    parent = {"stats": {
        "submitted": 5, "completed": 5, "decode_steps": 40, "prefills": 4, "max_queue": 1,
        "prefill_seconds": 0.5, "step_seconds": 1.2,
    }}
    assert _read(name, parent) is None
    assert _read(name, {}) is None
    idle = {"stats": dict.fromkeys(
        ("submitted", "decode_steps", "prefills", "prefill_tokens", "prefill_positions"), 0,
    ) | dict.fromkeys(
        ("step_seconds", "step_launch_seconds", "step_sync_seconds", "prefill_seconds",
         "prefill_launch_seconds", "prefill_sync_seconds", "loop_seconds", "queue_seconds",
         "submit_seconds"), 0.0,
    )}
    assert _read(name, idle) is None


def test_bench_answer_window_reads_every_split_metric():
    from benchmark.generators import chat_closed

    run = chat_closed.Run(tiny.DECODER, tiny.answer_traffic(), 2**31 + 21, "cpu", Spans())
    win = run.window(0.5, None)
    st = win["rec"]["stats"]
    assert st["decode_steps"] > 0 and st["prefills"] > 0
    ns = 1e-9  # each counter is whole nanoseconds, published in seconds
    assert st["step_launch_seconds"] + st["step_sync_seconds"] == pytest.approx(st["step_seconds"], abs=ns)
    assert st["prefill_launch_seconds"] + st["prefill_sync_seconds"] == pytest.approx(
        st["prefill_seconds"], abs=ns
    )
    assert st["loop_seconds"] >= st["step_seconds"] + st["prefill_seconds"] - ns
    for name in NEW:
        value = _read(name, win["rec"])
        assert isinstance(value, float) and value >= 0, name
    assert 0 < _read("prefill_real_share.answer", win["rec"]) <= 100
    run.release()


@pytest.mark.cuda
def test_bench_traced_answer_prints_the_split(cuda_card):
    spec = harness.load_spec()
    r = harness.run_cell(
        spec, tiny.ANSWER_CELL, 2**31 + 23, 1.0, True, device=cuda_card, model=tiny.DECODER,
        traffic=tiny.answer_traffic(), limits=tiny.LIMITS[tiny.ANSWER_CELL],
    )
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(NEW) <= set(m)
    assert m["step_launch_ms.answer"] + m["step_sync_ms.answer"] == pytest.approx(m["decode_step_ms.answer"])
