"""The port's spans and the continuous batcher's split counters.

``ContinuousBatcher.stats`` splits a decode step and a prefill at the
return of their program (launch) and the token read-back (sync), times
the decode loop, each request's queue wait and the callers' submits, and
counts the prefills' real and padded positions. With the observability
plane on, the batcher and the embedder record spans into the plane's
ring; while a ``torch.profiler`` session runs, leaf spans are profiler
annotations. Everything runs on the CPU at a tiny size, with the port
alone.
"""

import asyncio
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from pathway_tpu_torch.internals import observability as obs
from pathway_tpu_torch.internals import spans
from pathway_tpu_torch.models import DeepseekConfig, KimiLinearConfig, embedder_config, lm_config
from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder, bucket_len
from pathway_tpu_torch.xpacks.llm.llms import TorchLMChat

TINY = dict(vocab_size=256, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_len=64)
PROMPTS = [" ".join(f"w{j}" for j in range(1 + 3 * i)) for i in range(7)]
TIMED = (
    "step_seconds", "step_launch_seconds", "step_sync_seconds", "prefill_seconds",
    "prefill_launch_seconds", "prefill_sync_seconds", "loop_seconds", "queue_seconds",
    "submit_seconds",
)


@pytest.fixture(autouse=True)
def _plane_off(monkeypatch):
    """Each test starts with the plane off (whatever the environment
    says) and leaves it as it found it."""
    monkeypatch.delenv("PATHWAY_OBSERVABILITY", raising=False)
    monkeypatch.delenv("PATHWAY_PROFILE", raising=False)
    before = obs.PLANE
    obs.disable()
    yield
    obs.PLANE = before


def _chat(**kw) -> TorchLMChat:
    kw.setdefault("max_new_tokens", 4)
    kw.setdefault("decode_slots", 3)
    return TorchLMChat(config=lm_config(dtype=torch.float32, **TINY), device="cpu", **kw)


def _ask_all(chat: TorchLMChat, prompts=PROMPTS) -> list[str]:
    async def go():
        return await asyncio.gather(*(chat.__wrapped__(p) for p in prompts))

    return asyncio.run(go())


def _ns(seconds: float) -> int:
    return round(seconds * 1e9)


def _identities_hold(st: dict) -> bool:
    """Exact in whole nanoseconds."""
    return (
        _ns(st["step_launch_seconds"]) + _ns(st["step_sync_seconds"]) == _ns(st["step_seconds"])
        and _ns(st["prefill_launch_seconds"]) + _ns(st["prefill_sync_seconds"]) == _ns(st["prefill_seconds"])
        and _ns(st["loop_seconds"]) >= _ns(st["step_seconds"]) + _ns(st["prefill_seconds"])
    )


def test_step_and_prefill_splits_sum_exactly():
    chat = _chat()
    _ask_all(chat)
    st = chat.batcher_stats()
    assert st["decode_steps"] > 0 and st["prefills"] == len(PROMPTS)
    assert _identities_hold(st)
    assert st["step_launch_seconds"] > 0 and st["step_sync_seconds"] > 0
    assert st["prefill_launch_seconds"] > 0 and st["prefill_sync_seconds"] > 0
    assert st["loop_seconds"] > st["step_seconds"] + st["prefill_seconds"]


def test_every_copy_of_stats_holds_whole_steps():
    """A copy taken on another thread while the batcher decodes sees a
    step's or a prefill's counters whole."""
    chat = _chat(max_new_tokens=6)
    copies, done = [], threading.Event()

    def watch():
        while not done.wait(0.0005):  # leaves the decode thread the GIL
            copies.append(chat.batcher_stats())

    t = threading.Thread(target=watch)
    t.start()
    try:
        _ask_all(chat, PROMPTS * 3)
    finally:
        done.set()
        t.join(30)
    assert not t.is_alive()
    assert len(copies) > 5
    assert all(_identities_hold(c) for c in copies)


def test_concurrent_submits_lose_no_count():
    """More submitting threads than cores, switching often: every count
    and both identities hold once the work drains."""
    chat = _chat(max_new_tokens=2, decode_slots=4)
    cb = chat._cb
    futures, lock = [], threading.Lock()

    def submit_all():
        mine = [cb.submit(p) for p in PROMPTS]
        with lock:
            futures.extend(mine)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submit_all) for _ in range(2 * (os.cpu_count() or 8))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        for f in futures:
            f.result(timeout=120)
    finally:
        sys.setswitchinterval(old)
    cb.drain(60)
    st = chat.batcher_stats()
    n = len(threads) * len(PROMPTS)
    assert st["submitted"] == st["completed"] == st["prefills"] == n
    assert _identities_hold(st)


def test_queue_and_prefill_tokens_counted_once_a_prefill():
    chat = _chat()
    obs.enable()
    _ask_all(chat)
    st = chat.batcher_stats()
    budget = TINY["max_len"] - 4
    lengths = [len(chat.tokenizer.tokenize(p)[-budget:]) for p in PROMPTS]
    assert st["prefills"] == len(PROMPTS)
    assert st["prefill_tokens"] == sum(lengths)
    assert st["prefill_positions"] == sum(bucket_len(n, budget) for n in lengths)
    queue = [s for s in spans.spans() if s["name"] == "cb.queue"]
    assert len(queue) == len(PROMPTS)
    # the stats' queue time is the queue spans' time, to the nanosecond
    assert sum(s["end_ns"] - s["start_ns"] for s in queue) == _ns(st["queue_seconds"])
    m = obs.PLANE.metrics
    pool = {"pool": chat._cb.pool.name}
    assert m.histogram_stats("pathway_serving_queue_wait_seconds", pool)[0] == len(PROMPTS)
    assert m.histogram_stats("pathway_serving_first_token_seconds", pool)[0] == len(PROMPTS)
    steps = m.histogram_stats("pathway_serving_step_seconds", dict(pool, phase="step_sync"))
    assert steps[0] == st["decode_steps"]
    assert steps[1] == pytest.approx(st["step_sync_seconds"])


def test_stats_are_numbers_with_window_differences():
    chat = _chat()
    s0 = chat.batcher_stats()
    _ask_all(chat)
    s1 = chat.batcher_stats()
    assert set(s0) == set(s1) and set(TIMED) <= set(s1)
    for k, v in s1.items():
        assert type(v) in (int, float), k
        assert s1[k] - s0[k] >= 0, k
    s1["decode_steps"] = -1  # a copy: the batcher's own is untouched
    assert chat.batcher_stats()["decode_steps"] >= 0
    assert _chat(continuous_batching=False).batcher_stats() is None


# what the benchmark's metrics and README read of the batcher: its stats
# keys, and with the plane on the spans of a request, each with the names
# of its attributes
STATS = {
    "submitted", "completed", "decode_steps", "prefills", "max_queue", "prefill_tokens",
    "prefill_positions", "prefill_replays", "prefill_captures", "step_replays", "step_captures", *TIMED,
}
SPANS = {
    "cb.request": {"slot", "steps", "first_token_ms"}, "cb.queue": set(),
    "cb.prefill": {"slot", "tokens", "positions", "graphed"}, "cb.prefill.launch": set(),
    "cb.prefill.sync": set(), "cb.step": {"rows", "keys", "graphed"}, "cb.step.upload": set(),
    "cb.step.launch": set(), "cb.step.sync": set(),
}
EXPERTS = ("moe_assignments", "moe_experts_hit", "moe_max_load", "latent_positions")
TINY_MLA_MOE = dict(
    vocab_size=256, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=64, kv_lora_rank=16,
    qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8, n_routed_experts=4, n_experts_per_tok=2,
    n_shared_experts=1, moe_d_ff=16, first_k_dense=1,
)
TINY_KIMI = dict(
    TINY_MLA_MOE, n_layers=4, kda_layers=(1, 2, 3), kda_heads=2, kda_head_dim=8, kda_gate_rank=8,
    n_routed_experts=8, experts_held=range(2, 6),
)


@pytest.mark.parametrize("family", ["transformer", "deepseek", "kimi_linear"])
def test_stats_keys_and_spans_of_a_request_are_pinned(family):
    if family == "deepseek":
        chat = TorchLMChat(
            config=DeepseekConfig(dtype=torch.float32, **TINY_MLA_MOE), device="cpu", max_new_tokens=4,
            decode_slots=2, continuous_batching=True,
        )
        stats, spans_of = STATS | set(EXPERTS), {
            **SPANS, "cb.step": SPANS["cb.step"] | {"decode_steps", *EXPERTS}, "lm.mla": set(), "lm.moe": set(),
        }
    elif family == "kimi_linear":
        chat = TorchLMChat(
            config=KimiLinearConfig(dtype=torch.float32, **TINY_KIMI), device="cpu", max_new_tokens=4,
            decode_slots=2, continuous_batching=True,
        )
        stats, spans_of = STATS | set(EXPERTS) | {"kda_tokens"}, {
            **SPANS, "cb.step": SPANS["cb.step"] | {"decode_steps", "kda_tokens", *EXPERTS},
            "lm.kda": set(), "lm.mla": set(), "lm.moe": set(),
        }
    else:
        chat, stats, spans_of = _chat(), STATS, SPANS
    obs.enable()
    _ask_all(chat, PROMPTS[3:4])
    assert set(chat.batcher_stats()) == stats
    seen = {}
    for s in spans.spans():
        seen.setdefault(s["name"], set()).update(s["attrs"])
    assert seen == spans_of


def test_submit_time_is_counted_a_request():
    chat = _chat()
    _ask_all(chat)
    st = chat.batcher_stats()
    assert st["submitted"] == len(PROMPTS)
    assert 0 < st["submit_seconds"] < st["loop_seconds"]


def test_request_spans_share_one_id_and_children_nest():
    chat = _chat()
    obs.enable()
    _ask_all(chat)
    ring = spans.spans()
    by_id = {s["id"]: s for s in ring}
    requests = [s for s in ring if s["name"] == "cb.request"]
    assert len(requests) == len(PROMPTS)
    for r in requests:
        mine = [s for s in ring if s["request"] == r["request"]]
        assert {s["name"] for s in mine} == {
            "cb.request", "cb.queue", "cb.prefill", "cb.prefill.launch", "cb.prefill.sync",
        }
        assert r["attrs"]["steps"] == 3 and r["attrs"]["first_token_ms"] > 0
        assert r["tid"] is None  # a request is no call on one thread
    names = {s["name"] for s in ring}
    assert {"cb.step", "cb.step.upload", "cb.step.launch", "cb.step.sync"} <= names
    for s in ring:
        if s["parent"]:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"], (s["name"], p["name"])
    step = next(s for s in ring if s["name"] == "cb.step")
    assert step["parent"] == 0 and step["attrs"]["rows"] > 0 and step["attrs"]["keys"] > 0
    kids = {s["name"] for s in ring if s["parent"] == step["id"]}
    assert kids == {"cb.step.upload", "cb.step.launch", "cb.step.sync"}


def test_chrome_trace_export_loads_and_merges(tmp_path, monkeypatch):
    chat = _chat()
    obs.enable()
    _ask_all(chat)
    path = tmp_path / "spans.json"
    n = spans.export_chrome_trace(str(path))
    assert n == len(spans.spans()) > 0
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    assert {e["ph"] for e in events} == {"X", "b", "e"}
    assert all(e["name"].startswith("pathway/cb.") for e in events)
    # beside a profiler's trace: its base time, its events first
    torch_path = tmp_path / "torch.json"
    torch_path.write_text(json.dumps({
        "baseTimeNanoseconds": 1_000_000_000, "traceEvents": [{"ph": "X", "name": "k", "ts": 1.0}],
    }))
    merged = tmp_path / "merged.json"
    monkeypatch.setattr(spans, "profiler_clock_offset_ns", lambda: 0)
    spans.export_chrome_trace(str(merged), merge_with=str(torch_path))
    mdoc = json.loads(merged.read_text())
    assert mdoc["traceEvents"][0]["name"] == "k" and len(mdoc["traceEvents"]) == len(events) + 1
    first = spans.spans()[0]
    x = next(e for e in mdoc["traceEvents"] if e.get("args", {}).get("id") == first["id"])
    assert x["ts"] == pytest.approx((first["start_ns"] - 1_000_000_000) / 1e3)


def test_span_parents_and_requests_follow_the_open_span():
    obs.enable()
    with spans.span("outer", request=7, leaf=False) as outer:
        with spans.span("inner") as inner:
            inner.set(rows=3)
    by_name = {s["name"]: s for s in spans.spans()}
    assert by_name["inner"]["parent"] == outer.id and by_name["inner"]["request"] == 7
    assert by_name["inner"]["attrs"] == {"rows": 3} and by_name["outer"]["parent"] == 0
    assert by_name["inner"]["tid"] == threading.get_native_id()


def test_spans_keep_a_ring_of_their_own_beside_the_flight_ring():
    """Serving's spans never push the flight ring's rare events out: they
    go to a ring of their own, as long as the flight ring, fresh for a
    fresh plane."""
    plane = obs.enable(ring_size=8)
    obs.record("breaker", state="open")
    _ask_all(_chat())
    assert [e["k"] for e in plane.recorder.snapshot()] == ["breaker"]
    ring = spans.spans()
    assert len(ring) == 8 and ring[-1]["name"] == "cb.request"
    obs.disable()
    obs.enable()
    assert spans.spans() == []


def _embedder() -> TorchEmbedder:
    cfg = embedder_config(vocab_size=512, d_model=32, n_heads=4, n_layers=1, d_ff=64, max_len=32, embed_dim=32)
    return TorchEmbedder(cfg, device="cpu")


def test_plane_off_records_no_span_and_enters_no_annotation(monkeypatch):
    entered = []
    monkeypatch.setattr(spans._torch_profiler, "record_function", lambda name: entered.append(name))
    assert spans.span("x") is spans.NULL_SPAN
    chat = _chat()
    _ask_all(chat)
    _embedder().encode_many(["a b c", "d"])
    assert obs.PLANE is None and entered == []
    obs.enable()
    assert spans.spans() == []


def test_profiler_sees_the_embedders_leaf_annotations():
    emb = _embedder()
    emb.encode_many(["warm"])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        emb.encode_many(["a b c", "d e"])
    names = {ev.name for ev in prof.events()}
    for phase in ("tokenize", "pad", "upload", "encode", "readback"):
        assert f"pathway/embed.{phase}" in names
    assert "pathway/embed.batch" not in names  # it would hide its phases
    assert obs.PLANE is None


def test_embedder_counts_phases_and_tokens():
    emb = _embedder()
    obs.enable()
    texts = ["a b c", "d", "e f g h i"]
    out = emb.encode_many(texts)
    assert len(out) == 3 and all(np.isfinite(v).all() for v in out)
    m = obs.PLANE.metrics
    real = int(sum(emb.tokenizer.batch(texts)[1].sum(axis=1)))
    assert m.counter_value("pathway_embed_tokens_total", {"kind": "real"}) == real
    positions = m.counter_value("pathway_embed_tokens_total", {"kind": "padded"}) + real
    assert positions >= real and positions % 16 == 0
    for phase in ("tokenize", "pad", "upload", "encode", "readback"):
        assert m.counter_value("pathway_embed_seconds_total", {"phase": phase}) > 0
    batch = next(s for s in spans.spans() if s["name"] == "embed.batch")
    kids = [s for s in spans.spans() if s["parent"] == batch["id"]]
    assert [s["name"] for s in kids] == [
        "embed.tokenize", "embed.pad", "embed.upload", "embed.encode", "embed.readback",
    ]
