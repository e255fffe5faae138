"""The continuous batcher's decode step replayed from a captured CUDA graph.

A family declares in ``GRAPH_PHASES`` which of the batcher's phases a
graph may capture: the GPT-2 family its slot prefill and its slot decode
step, the DeepSeek family neither. On the CPU the batcher keeps the eager
``decode_step_slots``, its ``step_replays`` and ``step_captures`` stay 0,
and the form a graph captures is held to the eager step. The tests marked
``cuda`` skip without a card; there they hold
``serving.continuous_batching.PhaseGraphs`` over the step (capture,
replay, a new cache buffer) to the eager step bit for bit in bf16, count
the batcher's step replays, and check that a DeepSeek batcher on the card
keeps its eager step. This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_step_graph.py -q
"""

import asyncio
import dataclasses
import functools

import numpy as np
import pytest
import torch

from benchmark import weights_mla_moe
from pathway_tpu_torch.internals import observability as obs
from pathway_tpu_torch.internals import spans
from pathway_tpu_torch.models import DeepseekConfig, deepseek, lm_config, transformer
from pathway_tpu_torch.serving.continuous_batching import PhaseGraphs
from pathway_tpu_torch.xpacks.llm.llms import TorchLMChat

TINY = dict(vocab_size=256, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_len=128)
N_SLOTS = 4
NEW_TOKENS = 8
# (token, position, pad) of each slot before the first step: rows at
# different positions and pads, and slot 2 empty (token 0 at position 0)
ROWS = [(17, 20, 3), (201, 70, 0), (0, 0, 0), (99, 100, 30)]
EMPTY = 2
MLA_MOE = {
    "kind": "mla_moe_decoder", "vocab_size": 512, "d_model": 64, "n_heads": 4, "n_layers": 3,
    "d_ff": 128, "max_len": 96, "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 16,
    "v_head_dim": 16, "n_routed_experts": 8, "n_experts_per_tok": 2, "n_shared_experts": 1,
    "moe_d_ff": 32, "first_k_dense": 1, "routed_scaling_factor": 2.446, "rope_theta": 50000.0,
    "norm_eps": 1e-5, "dtype": "bfloat16",
}
PROMPTS = [" ".join(f"w{j}" for j in range(3 + 7 * i)) for i in range(10)]


@pytest.fixture
def cuda_device():
    # decided when the test runs, never at import: every xdist worker
    # must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs capture and replay only on a card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _plane_off(monkeypatch):
    monkeypatch.delenv("PATHWAY_OBSERVABILITY", raising=False)
    before = obs.PLANE
    obs.disable()
    yield
    obs.PLANE = before


def _model(dtype=torch.float32, device="cpu", seed=0, **kw):
    cfg = lm_config(dtype=dtype, **{**TINY, **kw})
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, transformer.cast_params(transformer.init_params(gen, cfg, dtype=dtype), dtype)


def _filled_cache(cfg, device="cpu", seed=1):
    """A serving cache whose every row holds other requests' K/V."""
    cache = transformer.init_kv_cache(cfg, N_SLOTS, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for c in cache.values():
        c.copy_(torch.randn(c.shape, generator=gen, device=device).to(c.dtype))
    return cache


def _clone(cache):
    return {n: c.clone() for n, c in cache.items()}


def _same(a, b) -> bool:
    return all(torch.equal(a[n], b[n]) for n in a)


def _rows(device, step: int = 0, tokens=None):
    """The [n_slots] tokens, positions and pads of step `step`: each
    occupied row one position further a step, the empty slot at 0."""
    tok, pos, pad = (torch.tensor(col, device=device) for col in zip(*ROWS))
    pos = torch.where(pos > 0, pos + step, pos)
    if tokens is not None:
        tok = torch.where(pos > 0, tokens, 0)
    return tok, pos, pad


def _deepseek(dtype, device):
    keys = [f.name for f in dataclasses.fields(DeepseekConfig) if f.name != "dtype"]
    cfg = DeepseekConfig(dtype=dtype, **{k: MLA_MOE[k] for k in keys})
    return cfg, weights_mla_moe.make(MLA_MOE, 3, device, dtype)


def _ask_all(chat, prompts=PROMPTS) -> list[str]:
    async def go():
        return await asyncio.gather(*(chat.__wrapped__(p) for p in prompts))

    return asyncio.run(go())


# ------------------------------------------------------------- on the CPU


def test_each_family_declares_the_phases_a_graph_may_capture():
    assert set(transformer.GRAPH_PHASES) == {"prefill", "step"}
    assert transformer.GRAPH_PHASES["prefill"] is transformer.prefill_slot
    assert deepseek.GRAPH_PHASES == {}


@pytest.mark.parametrize("steps", [1, 3])
def test_the_step_a_graph_captures_equals_the_eager_step(steps):
    """The declared step form returns ``decode_step_slots``'s tokens on
    the device and writes the same cache, step after step."""
    cfg, params = _model()
    step = functools.partial(transformer.GRAPH_PHASES["step"], cfg=cfg)
    got, want = _filled_cache(cfg), _filled_cache(cfg)
    before = _clone(got)
    tokens = None
    for i in range(steps):
        tok, pos, pad = _rows("cpu", i, tokens)
        nxt = step(params, got, tok, pos, pad)
        ref, out = transformer.decode_step_slots(params, want, tok, pos, pad, cfg)
        assert out is want
        assert nxt.shape == (N_SLOTS,) and nxt.dtype == torch.int64
        assert torch.equal(nxt, ref)
        assert _same(got, want)
        tokens = nxt
    # the step wrote each row at its positions and nowhere else
    for n in got:
        for slot, (_, p, _) in enumerate(ROWS):
            written = list(range(p, p + steps)) if slot != EMPTY else [0]
            kept = [j for j in range(cfg.max_len) if j not in written]
            assert torch.equal(got[n][:, slot, :, kept], before[n][:, slot, :, kept])


@pytest.mark.parametrize("family", ["transformer", "deepseek"])
def test_the_cpu_batcher_keeps_the_eager_step(family):
    """Off the card the step program is the family's eager
    ``decode_step_slots``: no graph, both step counters 0, and every
    ``cb.step`` span says it was not graphed."""
    if family == "deepseek":
        cfg, params = _deepseek(torch.float32, "cpu")
    else:
        cfg, params = _model()
    chat = TorchLMChat(
        config=cfg, params=params, device="cpu", max_new_tokens=3, decode_slots=2,
        continuous_batching=True,
    )
    cb = chat._cb
    assert cb._step_graphs is None and cb._graphs is None
    assert cb._step._fn.func is (deepseek if family == "deepseek" else transformer).decode_step_slots
    obs.enable()
    got = _ask_all(chat, PROMPTS[:3])
    assert all(len(a.split()) == 3 for a in got)
    cb.drain()
    st = chat.batcher_stats()
    assert st["decode_steps"] > 0
    assert st["step_replays"] == 0 and st["step_captures"] == 0
    steps = [s for s in spans.spans() if s["name"] == "cb.step"]
    assert len(steps) == st["decode_steps"]
    assert not any(s["attrs"]["graphed"] for s in steps)
    pool = {"pool": cb.pool.name}
    assert obs.PLANE.metrics.counter_value("pathway_serving_step_graph_replays_total", pool) == 0


# ------------------------------------------------------------- on the card


@pytest.mark.cuda
def test_replayed_steps_equal_the_eager_step_bit_for_bit(cuda_device):
    """bf16, five steps with rows at different positions and pads and one
    slot empty: the first call captures (and serves its step eagerly),
    each later one replays; the tokens and the whole cache equal the eager
    ``decode_step_slots``'s, bit for bit."""
    cfg, params = _model(torch.bfloat16, cuda_device, d_model=128, d_ff=256)
    graphs = PhaseGraphs(functools.partial(transformer.GRAPH_PHASES["step"], cfg=cfg))
    cache = _filled_cache(cfg, cuda_device)
    eager = _clone(cache)
    tokens = None
    for i in range(5):
        tok, pos, pad = _rows(cuda_device, i, tokens)
        nxt, out = graphs(params, cache, tok, pos, pad)
        assert out is cache
        assert graphs.last == ("capture" if i == 0 else "replay"), i
        want, _ = transformer.decode_step_slots(params, eager, tok, pos, pad, cfg)
        assert torch.equal(nxt, want), i
        torch.cuda.synchronize()
        assert _same(cache, eager), i
        tokens = nxt.clone()  # the graph's output is overwritten by its next replay
    assert len(graphs._graphs) == 1


@pytest.mark.cuda
def test_a_new_cache_buffer_recaptures_the_step(cuda_device):
    cfg, params = _model(torch.bfloat16, cuda_device, d_model=128, d_ff=256)
    graphs = PhaseGraphs(functools.partial(transformer.GRAPH_PHASES["step"], cfg=cfg))
    first, second = _filled_cache(cfg, cuda_device), _filled_cache(cfg, cuda_device, seed=2)
    graphs(params, first, *_rows(cuda_device, 0))
    graphs(params, first, *_rows(cuda_device, 1))
    assert graphs.last == "replay"
    kept, want = _clone(first), _clone(second)
    nxt, _ = graphs(params, second, *_rows(cuda_device, 2))
    assert graphs.last == "capture" and len(graphs._graphs) == 1  # the old buffer's graph is gone
    nxt = nxt.clone()
    nxt2, _ = graphs(params, second, *_rows(cuda_device, 3))
    assert graphs.last == "replay"
    assert torch.equal(nxt, transformer.decode_step_slots(params, want, *_rows(cuda_device, 2), cfg)[0])
    assert torch.equal(nxt2, transformer.decode_step_slots(params, want, *_rows(cuda_device, 3), cfg)[0])
    torch.cuda.synchronize()
    assert _same(second, want)
    assert _same(first, kept)  # never written through a stale graph
    graphs(params, first, *_rows(cuda_device, 4))
    assert graphs.last == "capture"


@pytest.mark.cuda
def test_the_batcher_replays_every_step_after_its_capture(cuda_device):
    """Through ``TorchLMChat`` at f32 on the card: one step capture for the
    cache buffer, every other step a replay, the plane's counter and each
    step span's ``graphed`` agree, and the tokens equal the wave-aligned
    path."""
    cfg, params = _model(torch.float32, cuda_device)
    chat = TorchLMChat(
        config=cfg, params=params, device=cuda_device, max_new_tokens=NEW_TOKENS,
        decode_slots=N_SLOTS, continuous_batching=True,
    )
    cb = chat._cb
    assert cb._step_graphs is not None and cb._graphs is not None
    rng = np.random.default_rng(11)
    lengths = (3, 12, 17, 30, 40, 60, 70, 100, 5, 33)
    prompts = [" ".join(f"w{x}" for x in rng.integers(0, 999, n)) for n in lengths]
    obs.enable()
    got = _ask_all(chat, prompts)
    cb.drain()
    st = chat.batcher_stats()
    assert st["decode_steps"] >= NEW_TOKENS - 1
    assert st["step_captures"] == 1 == len(cb._step_graphs._graphs)
    assert st["step_replays"] == st["decode_steps"] - st["step_captures"]
    pool = {"pool": cb.pool.name}
    replays = obs.PLANE.metrics.counter_value("pathway_serving_step_graph_replays_total", pool)
    assert replays == st["step_replays"]
    graphed = [s["attrs"]["graphed"] for s in spans.spans() if s["name"] == "cb.step"]
    assert sorted(graphed) == [False] * st["step_captures"] + [True] * st["step_replays"]
    wave = TorchLMChat(
        config=cfg, params=chat.params, device=cuda_device, max_new_tokens=NEW_TOKENS,
        continuous_batching=False,
    )
    assert got == wave._generate_batch(prompts)


@pytest.mark.cuda
def test_a_deepseek_batcher_on_the_card_keeps_its_eager_step(cuda_device):
    cfg, params = _deepseek(torch.bfloat16, cuda_device)
    chat = TorchLMChat(
        config=cfg, params=params, device=cuda_device, max_new_tokens=4, decode_slots=3,
        continuous_batching=True,
    )
    cb = chat._cb
    assert cb._step_graphs is None and cb._graphs is None
    assert cb._step._fn.func is deepseek.decode_step_slots
    assert all(len(a.split()) == 4 for a in _ask_all(chat, PROMPTS[:5]))
    cb.drain()
    st = chat.batcher_stats()
    assert st["decode_steps"] > 0
    assert st["step_replays"] == st["step_captures"] == 0
    assert st["prefill_replays"] == st["prefill_captures"] == 0
