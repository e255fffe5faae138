"""The port's serving path: slot pool, continuous batching and TorchLMChat.

The cases of ``tests/test_continuous_batching.py`` carried over to the
port (slot counters are read off the pool: the port has no metrics
registry yet), plus the chat model against ``JaxLMChat`` on carried-across
parameters at f32, where greedy tokens are identical. Everything runs on
the CPU at a tiny size.
"""

import asyncio
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import transformer as jtfm
from pathway_tpu.xpacks.llm.llms import JaxLMChat
from pathway_tpu_torch.engine.device_plane import DevicePlane, SlotPool
from pathway_tpu_torch.models import convert, lm_config
from pathway_tpu_torch.serving import ContinuousBatcher
from pathway_tpu_torch.xpacks.llm.llms import TorchLMChat

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=256, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_len=64)
PROMPTS = ["a b c", "d", "hello world longer prompt", "x y", "q", "z z z"]
# past the 64 - 24 = 40-token budget: the prompt keeps its last 40 tokens
LONG = " ".join(f"w{i}" for i in range(70))


def _chat(**kw) -> TorchLMChat:
    kw.setdefault("config", lm_config(dtype=torch.float32, **TINY))
    kw.setdefault("max_new_tokens", 4)
    return TorchLMChat(device="cpu", **kw)


# ------------------------------------------------------------ slot pool


def test_slot_pool_acquire_release_and_counters():
    pool = SlotPool("t", 2)
    a = pool.acquire()
    b = pool.acquire()
    assert {a, b} == {0, 1}
    assert pool.acquire() is None  # exhausted: the request stays queued
    assert pool.joined_inflight == 1  # b acquired while a was in flight
    assert pool.refills == 0
    pool.release(a)
    c = pool.acquire()
    assert c == a
    assert pool.refills == 1  # a freed row re-filled
    assert pool.joined_inflight == 2
    assert pool.high_water == 2
    assert pool.snapshot() == {
        "n_slots": 2, "active": 2, "acquired_total": 3, "refills": 1,
        "joined_inflight": 2, "high_water": 2,
    }
    pool.release(b)
    with pytest.raises(ValueError, match="released twice"):
        pool.release(b)
    with pytest.raises(ValueError):
        SlotPool("empty", 0)


def test_plane_slot_pool_registry_and_namespace_drop():
    plane = DevicePlane()
    pool = plane.slot_pool("cb#1/slots", 4)
    assert plane.slot_pool("cb#1/slots", 4) is pool
    with pytest.raises(ValueError):
        plane.slot_pool("cb#1/slots", 8)  # a size conflict fails loudly
    assert plane.slot_pools() == {"cb#1/slots": pool.snapshot()}
    plane.program("cb#1/prefill", lambda x: x)
    plane.program("cb#10/prefill", lambda x: x)  # a prefix sibling
    plane.restore(("cb_kv_cache", "cb#1", 4), {"k": 0})
    plane.restore(("cb_kv_cache", "cb#10", 4), {"k": 1})
    plane.drop_namespace("cb#1")
    assert "cb#1/prefill" not in plane.programs
    assert "cb#10/prefill" in plane.programs  # the match respects "/"
    assert "cb#1/slots" not in plane._slot_pools
    assert list(plane._leases) == [("cb_kv_cache", "cb#10", 4)]


def test_plane_leases_pool_buffers_and_drop_with_their_program():
    plane = DevicePlane()
    made = []

    def make():
        made.append(object())
        return made[-1]

    key = ("lm_kv_cache", "lm_generate#1", 8)
    a = plane.lease(key, make)
    b = plane.lease(key, make)  # a is out: a second buffer
    assert a is not b and len(made) == 2
    plane.restore(key, a)
    assert plane.lease(key, make) is a and len(made) == 2
    plane.restore(key, a)
    plane.restore(("other", 1), b)
    plane.program("lm_generate#1", lambda x: x)
    plane.drop_program("lm_generate#1")
    assert "lm_generate#1" not in plane.programs and key not in plane._leases
    plane.drop_lease(("other", 1))
    assert plane._leases == {}


# ---------------------------------------------------- the two paths agree


def test_continuous_batching_matches_wave_aligned_byte_identically():
    """The central equivalence: the slot scheduler's output equals the
    wave-aligned generate dispatch byte for byte, per request (a prompt
    truncated to the budget among them)."""
    cb = _chat(continuous_batching=True, decode_slots=4, max_new_tokens=24)
    wa = _chat(continuous_batching=False, max_new_tokens=24, params=cb.params)
    prompts = PROMPTS + [LONG]
    futs = [cb._cb.submit(p) for p in prompts]
    got_cb = [f.result(timeout=60) for f in futs]
    assert got_cb == wa._generate_batch(prompts)
    assert all(len(r.split()) == 24 for r in got_cb)
    cb._cb.drain()


@pytest.mark.parametrize("continuous", [True, False])
def test_chat_matches_jax_lm_chat(continuous):
    """The same parameters (drawn by jax.random) in both chats at f32:
    the same token strings, through either dispatch of the port."""
    jcfg = jtfm.lm_config(dtype=jnp.float32, **TINY)
    jp = jtfm.init_params(jax.random.PRNGKey(3), jcfg)
    tcfg = lm_config(dtype=torch.float32, **TINY)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    prompts = PROMPTS + [LONG]
    want = JaxLMChat(
        config=jcfg, params=jp, max_new_tokens=24, continuous_batching=False
    )._generate_batch(prompts)
    chat = _chat(config=tcfg, params=tp, max_new_tokens=24, continuous_batching=continuous, decode_slots=3)

    async def run():
        return await asyncio.gather(*(chat.__wrapped__(p) for p in prompts))

    assert asyncio.run(run()) == want


def test_chat_takes_messages_and_coalesces_a_wave():
    chat = _chat(continuous_batching=False)
    msgs = [[{"role": "system", "content": "be brief"}, {"role": "user", "content": p}] for p in PROMPTS]

    async def run():
        return await asyncio.gather(*(chat.__wrapped__(m) for m in msgs))

    got = asyncio.run(run())
    assert chat._batcher.flushes == 1
    assert got == chat._generate_batch(["be brief\n" + p for p in PROMPTS])


# ---------------------------------------------------------- the switches


def test_kill_switch_env_restores_wave_aligned_path(monkeypatch):
    monkeypatch.setenv("PATHWAY_CONTINUOUS_BATCH", "0")
    assert _chat()._cb is None  # the wave-aligned coalescer only
    monkeypatch.setenv("PATHWAY_CONTINUOUS_BATCH", "1")
    assert _chat()._cb is not None
    assert _chat(continuous_batching=False)._cb is None


def test_sampled_generation_keeps_wave_aligned_path_and_is_seeded():
    chat = _chat(temperature=0.7, max_new_tokens=12)
    assert chat._cb is None  # a per-request generator in a shared step: later
    a = chat._generate_batch(PROMPTS)
    assert a == chat._generate_batch(PROMPTS)  # seeded from the prompts
    assert a != _chat(max_new_tokens=12, params=chat.params, continuous_batching=False)._generate_batch(PROMPTS)


def test_config_guards():
    with pytest.raises(ValueError, match="max_new_tokens"):
        _chat(max_new_tokens=64)
    chat = _chat()
    # the mesh-spanning pool needs a mesh: none without a card or
    # PATHWAY_MESH_DEVICES, and that raises (tests/test_torch_sharded.py
    # drives the pool over 8 CPU shards)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("PATHWAY_MESH_DEVICES", raising=False)
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ContinuousBatcher(
                params=chat.params, cfg=chat.config, tokenizer=chat.tokenizer, n_steps=4, mesh_span=True
            )
    with pytest.raises(ValueError, match="n_steps"):
        ContinuousBatcher(params=chat.params, cfg=chat.config, tokenizer=chat.tokenizer, n_steps=0)


def test_chat_without_a_gpu_raises(monkeypatch):
    """No device and no card: an error, never a quiet move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchLMChat(lm_config(**TINY), max_new_tokens=4)
    assert _chat().device == torch.device("cpu")


# ------------------------------------------- mid-generation join acceptance


def test_mid_generation_join_refills_slot_without_new_shape():
    """A request admitted while another is mid-generation joins the
    in-flight decode batch: the programs' shape ledgers gain nothing
    (the step shape and the prompt bucket are warm) and the pool's
    counters record the join and the re-fill."""
    chat = _chat(max_new_tokens=24, continuous_batching=True, decode_slots=2)
    cb = chat._cb
    cb.submit("warm up prompt").result(timeout=60)
    cb.drain()
    warmed = (dict(cb._step.shape_counts), dict(cb._prefill.shape_counts))
    pool_before = cb.pool.snapshot()

    # hold the decode thread inside its 3rd step until the second
    # request is queued, so the join is mid-generation by construction
    in_step3, queued = threading.Event(), threading.Event()
    step_fn = cb._step._fn

    def held_step(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        if cb.stats["decode_steps"] == pool_before_steps + 2:
            in_step3.set()
            assert queued.wait(30)
        return out

    pool_before_steps = cb.stats["decode_steps"]
    cb._step._fn = held_step
    first = cb.submit("first long running request")
    assert in_step3.wait(30), "the first request never started decoding"
    second = cb.submit("second joins the flight")
    queued.set()
    r1, r2 = first.result(timeout=60), second.result(timeout=60)
    cb.drain()
    assert not cb._thread.is_alive()
    # outputs still equal the wave-aligned path (no cross-slot bleed)
    wa = _chat(continuous_batching=False, max_new_tokens=24, params=chat.params)
    assert [r1, r2] == wa._generate_batch(["first long running request", "second joins the flight"])
    after = (dict(cb._step.shape_counts), dict(cb._prefill.shape_counts))
    assert after == warmed, f"the join added a shape: {warmed} -> {after}"
    pool_after = cb.pool.snapshot()
    assert pool_after["joined_inflight"] > pool_before["joined_inflight"]
    assert pool_after["refills"] > pool_before["refills"]
    assert pool_after["high_water"] == 2 and pool_after["active"] == 0
    # 23 steps each, the second started 3 steps late
    assert cb.stats["decode_steps"] - pool_before_steps == 26


def test_queue_overflow_waits_for_free_slot():
    """More requests than slots: the excess queues and lands in freed
    slots (refills), every result still byte-equal to wave-aligned."""
    chat = _chat(continuous_batching=True, decode_slots=2)
    cb = chat._cb
    prompts = [f"prompt number {i}" for i in range(7)]
    futs = [cb.submit(p) for p in prompts]
    got = [f.result(timeout=120) for f in futs]
    cb.drain()
    wa = _chat(continuous_batching=False, params=chat.params)
    assert got == wa._generate_batch(prompts)
    snap = cb.pool.snapshot()
    assert snap["refills"] >= 5  # 7 requests over 2 slots
    assert snap["active"] == 0  # fully drained
    assert cb.stats["max_queue"] >= 5 and cb.stats["prefills"] == 7


def test_single_token_generation_finishes_at_prefill():
    chat = _chat(max_new_tokens=1, continuous_batching=True, decode_slots=2)
    wa = _chat(max_new_tokens=1, continuous_batching=False, params=chat.params)
    got = [f.result(timeout=60) for f in [chat._cb.submit(p) for p in PROMPTS]]
    assert got == wa._generate_batch(PROMPTS)
    chat._cb.drain()
    assert chat._cb.stats["decode_steps"] == 0


# --------------------------------------------------- failure and teardown


def test_failure_reaches_every_waiter_and_returns_every_slot():
    chat = _chat(continuous_batching=True, decode_slots=2)
    cb = chat._cb

    def boom(*args, **kwargs):
        raise RuntimeError("step failed")

    step_fn = cb._step._fn
    cb._step._fn = boom
    futs = [cb.submit(p) for p in PROMPTS]
    for f in futs:
        with pytest.raises(RuntimeError, match="step failed"):
            f.result(timeout=60)
    cb.drain()
    assert cb.pool.snapshot()["active"] == 0 and not cb._queue and not cb._active
    # the batcher recovers: the next request starts a fresh thread
    cb._step._fn = step_fn
    wa = _chat(continuous_batching=False, params=chat.params)
    assert cb.submit(PROMPTS[0]).result(timeout=60) == wa._generate_batch(PROMPTS[:1])[0]


def test_chat_finalizer_releases_cb_namespace():
    chat = _chat(continuous_batching=True, decode_slots=2)
    cb = chat._cb
    cb.submit("a b").result(timeout=60)
    cb.drain()
    chat._generate_batch(["c d"])
    plane, name, gen = chat._plane, cb.name, chat._gen.name
    assert f"{name}/prefill" in plane.programs and f"{name}/step" in plane.programs
    assert f"{name}/slots" in plane._slot_pools
    assert any(isinstance(k, tuple) and name in k for k in plane._leases)
    assert any(isinstance(k, tuple) and gen in k for k in plane._leases)
    chat._finalizer()  # what gc runs when the instance dies
    assert f"{name}/prefill" not in plane.programs and f"{name}/step" not in plane.programs
    assert f"{name}/slots" not in plane._slot_pools and gen not in plane.programs
    assert not any(isinstance(k, tuple) and (name in k or gen in k) for k in plane._leases)


def test_cache_lease_is_not_restored_into_a_dropped_namespace():
    """A finalizer that drops the namespace mid-generation: the decode
    thread finishes its requests and leaves the cache unpinned."""
    chat = _chat(continuous_batching=True, decode_slots=2, max_new_tokens=12)
    cb = chat._cb
    started, dropped = threading.Event(), threading.Event()
    step_fn = cb._step._fn

    def held_step(*args, **kwargs):
        started.set()
        assert dropped.wait(30)
        return step_fn(*args, **kwargs)

    cb._step._fn = held_step
    fut = cb.submit("a b c")
    assert started.wait(30)
    chat._plane.drop_namespace(cb.name)
    dropped.set()
    assert len(fut.result(timeout=60).split()) == 12
    cb.drain()
    assert not any(isinstance(k, tuple) and cb.name in k for k in chat._plane._leases)


# ------------------------------------------------------------- isolation


def test_process_exits_cleanly_after_a_chat():
    """The decode thread is not a daemon: interpreter exit waits for it
    to drain instead of freezing it inside a torch call (an abort)."""
    code = (
        "import asyncio\n"
        "from pathway_tpu_torch import TorchLMChat\n"
        "from pathway_tpu_torch.models import lm_config\n"
        f"cfg = lm_config(**{TINY!r})\n"
        "chat = TorchLMChat(cfg, max_new_tokens=8, device='cpu')\n"
        "print(asyncio.run(chat.__wrapped__([{'role': 'user', 'content': 'what is a slot?'}])))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(proc.stdout.split()) == 8


def test_serving_modules_load_no_jax():
    code = (
        "import sys, pathway_tpu_torch.serving, pathway_tpu_torch.xpacks.llm.llms\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pathway_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
