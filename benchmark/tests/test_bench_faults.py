"""Runs of the harness at a tiny size on the CPU (past its look for a
card): a sound run comes out correct, and a run with the timed path
broken underneath comes out not correct, once for each fault the cell
can have."""

import pytest
import torch

from benchmark.tests import tiny


def test_bench_sound_runs_are_correct():
    for cell in (tiny.EMBED_CELL, tiny.ANSWER_CELL):
        r = tiny.run(cell)
        assert r["correct"], r["checks"]
        assert r["attempted"] > 0 and r["failed"] == 0
        assert list(r)[-1] == "checks"


def _altered_rows(monkeypatch, how):
    from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder

    real = TorchEmbedder.encode_tokens

    def broken(self, ids, mask):
        return how(real(self, ids, mask))

    monkeypatch.setattr(TorchEmbedder, "encode_tokens", broken)


def test_bench_embedding_altered_where_produced(monkeypatch):
    _altered_rows(monkeypatch, lambda out: torch.roll(out, 1, dims=0))
    assert not tiny.run(tiny.EMBED_CELL)["correct"]


def test_bench_half_the_batch_left_out(monkeypatch):
    def half(out):
        out = out.clone()
        n = out.shape[0] // 2
        out[n:] = out[:n][: out.shape[0] - n]
        return out

    _altered_rows(monkeypatch, half)
    assert not tiny.run(tiny.EMBED_CELL)["correct"]


def test_bench_token_altered_where_produced(monkeypatch):
    from pathway_tpu_torch.models import transformer

    real = transformer.decode_step_slots

    def broken(params, cache, token, pos, pad_len, cfg):
        nxt, cache = real(params, cache, token, pos, pad_len, cfg)
        return (nxt + 1) % cfg.vocab_size, cache

    monkeypatch.setattr(transformer, "decode_step_slots", broken)
    assert not tiny.run(tiny.ANSWER_CELL)["correct"]


def test_bench_step_that_leaves_its_state_unchanged(monkeypatch):
    """A decode step that computes on a copy of the KV cache: its new
    keys and values never reach the cache."""
    from pathway_tpu_torch.models import transformer

    real = transformer.decode_step_slots

    def broken(params, cache, token, pos, pad_len, cfg):
        nxt, _ = real(params, {k: v.clone() for k, v in cache.items()}, token, pos, pad_len, cfg)
        return nxt, cache

    monkeypatch.setattr(transformer, "decode_step_slots", broken)
    assert not tiny.run(tiny.ANSWER_CELL)["correct"]


@pytest.mark.parametrize("cell", [tiny.EMBED_CELL, tiny.ANSWER_CELL])
def test_bench_control_fails_its_limit(cell):
    """The control (the reference in fp8 in the program's place) comes
    out not correct by the harness's own verdict, against the limit at
    this size; at the cells' own sizes `benchmark/calibrate.py` reads it
    on the card (PERF.md)."""
    r = tiny.run(cell, control=True)
    assert r["correct"], r["checks"]
    assert r["control_correct"] is False, (r["control"], r["checks"])


def test_bench_judge():
    from benchmark import harness

    limits = {"gap": {"limit": 0.1}}
    assert harness.judge({"gap": 0.05}, limits) == ({"gap": {"value": 0.05, "limit": 0.1}}, True)
    assert harness.judge({"gap": 0.1}, limits)[1] is True
    assert harness.judge({"gap": 0.11}, limits)[1] is False
    # a control that gives no number has failed
    checks, ok = harness.judge({"gap": float("inf")}, limits)
    assert not ok and checks["gap"]["value"] is None
    assert harness.judge({"gap": float("nan")}, limits)[1] is False
    assert harness.judge({}, limits)[1] is False
