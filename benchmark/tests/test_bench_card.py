"""On the card: the profiler's trace reads device time, and each cell
runs at a tiny size through the card's path (K1 included) and comes out
correct, the answer cell's trace split into decode steps. Run on the card with
``python -m pytest benchmark/tests -m cuda -q``."""

import pytest

from benchmark import harness
from benchmark.tests import tiny


@pytest.mark.cuda
def test_bench_trace_reads_the_card(cuda_card):
    import torch

    from benchmark.trace import DeviceTrace

    a = torch.randn(1024, 1024, device=cuda_card)
    tr = DeviceTrace()
    tr.start()
    for _ in range(10):
        a = a @ a
        a = a / a.norm()
    tr.stop()
    s = tr.summary()
    assert 0 < s["busy_s"] <= s["window_s"]
    assert s["kernel_s"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [tiny.EMBED_CELL, tiny.ANSWER_CELL])
def test_bench_tiny_cell_on_the_card(cuda_card, cell):
    spec = harness.load_spec()
    if cell == tiny.EMBED_CELL:
        model, traffic = tiny.ENCODER, tiny.embed_traffic()
    else:
        model, traffic = tiny.DECODER, tiny.answer_traffic()
    r = harness.run_cell(spec, cell, 2**31 + 3, 1.0, True, device=cuda_card, model=model, traffic=traffic,
                         limits=tiny.LIMITS[cell])
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
    assert r["metrics"]
    if cell == tiny.ANSWER_CELL:
        # the decode thread's marks split the trace into steps
        assert 0 < r["metrics"]["decode_roofline.answer"]["value"] <= 100
        assert r["metrics"]["decode_device_ms.answer"]["value"] > 0
