"""The GPT-2 family's capturable slot prefill and the batcher's prefill
graphs.

``transformer.prefill_slot`` takes the slot as a device tensor and writes
and reads the slot's K/V through index operations, so that one CUDA graph
per prompt width serves every slot; ``prefill_into_slot`` runs it eagerly.
On the CPU, at f32, it is held to the prefill over a one-row view of the
cache sliced at a host index (the form ``prefill_into_slot`` had before):
the first token, the slot's K/V, every other slot and the slot's positions
past the prompt. The tests marked ``cuda`` skip without a card; there they
hold ``serving.continuous_batching.PhaseGraphs`` (capture, replay, a new
cache buffer) to the eager prefill bit for bit in bf16, and count the
batcher's replays. This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_prefill_graph.py -q
"""

import asyncio
import functools

import numpy as np
import pytest
import torch

from pathway_tpu_torch.internals import observability as obs
from pathway_tpu_torch.internals import spans
from pathway_tpu_torch.models import lm_config, transformer
from pathway_tpu_torch.serving.continuous_batching import PhaseGraphs
from pathway_tpu_torch.xpacks.llm.embedders import bucket_len, pad_left_rows
from pathway_tpu_torch.xpacks.llm.llms import TorchLMChat

TINY = dict(vocab_size=256, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_len=128)
N_SLOTS = 4
NEW_TOKENS = 8
BUDGET = TINY["max_len"] - NEW_TOKENS  # 120: the widths are 16, 32, 64 and the cap, 120
WIDTHS = sorted({bucket_len(n, BUDGET) for n in range(1, BUDGET + 1)})


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


def _prompt(length: int, seed: int, device="cpu"):
    rng = np.random.default_rng(seed)
    ids, mask = pad_left_rows([list(rng.integers(1, TINY["vocab_size"], length))], BUDGET, n_rows=1)
    return torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)


def _view_prefill(params, ids, mask, cache, slot: int, cfg) -> torch.Tensor:
    """The slot prefill over a one-row view of the cache sliced at a host
    index: ``prefill_into_slot``'s form before the capturable one."""
    rows = {n: c[:, slot:slot + 1] for n, c in cache.items()}
    lg, _ = transformer.prefill(params, ids.long(), rows, cfg, mask)
    return torch.argmax(lg, dim=-1)


def _clone(cache):
    return {n: c.clone() for n, c in cache.items()}


def _same(a, b) -> bool:
    return all(torch.equal(a[n], b[n]) for n in a)


# ------------------------------------------------------------- on the CPU


def test_widths_reach_every_bucket_up_to_the_cap():
    assert WIDTHS == [16, 32, 64, BUDGET]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("slot", [0, N_SLOTS - 1])
@pytest.mark.parametrize("full", [True, False], ids=["full", "left-padded"])
def test_prefill_slot_equals_the_view_prefill(width, slot, full):
    cfg, params = _model()
    below = ([0] + WIDTHS)[WIDTHS.index(width)]  # the next narrower bucket
    length = width if full else (below + width) // 2 + 1
    ids, mask = _prompt(length, seed=width + slot)
    assert ids.shape[1] == width
    before = _filled_cache(cfg)
    got, want = _clone(before), _clone(before)
    tok = transformer.prefill_slot(params, ids, mask, got, torch.tensor(slot), cfg)
    assert torch.equal(tok, _view_prefill(params, ids, mask, want, slot, cfg))
    assert tok.shape == (1,) and tok.dtype == torch.int64
    assert _same(got, want)
    for n in got:
        others = [r for r in range(N_SLOTS) if r != slot]
        assert torch.equal(got[n][:, others], before[n][:, others])  # other slots untouched
        assert torch.equal(got[n][:, slot, :, width:], before[n][:, slot, :, width:])
        assert not torch.equal(got[n][:, slot, :, :width], before[n][:, slot, :, :width])


def test_a_slot_holding_a_longer_earlier_request():
    """A short prompt over a slot's longer earlier request rewrites only
    its own width and leaves the rest of the row as it was, as the view
    prefill does (decode masks it)."""
    cfg, params = _model()
    slot = 2
    got, want = _filled_cache(cfg), _filled_cache(cfg)
    long_ids, long_mask = _prompt(BUDGET, seed=5)
    short_ids, short_mask = _prompt(9, seed=6)
    assert (long_ids.shape[1], short_ids.shape[1]) == (BUDGET, 16)
    at = torch.tensor(slot)
    transformer.prefill_slot(params, long_ids, long_mask, got, at, cfg)
    _view_prefill(params, long_ids, long_mask, want, slot, cfg)
    after_long = _clone(got)
    tok = transformer.prefill_slot(params, short_ids, short_mask, got, at, cfg)
    assert torch.equal(tok, _view_prefill(params, short_ids, short_mask, want, slot, cfg))
    assert _same(got, want)
    for n in got:
        assert torch.equal(got[n][:, slot, :, 16:], after_long[n][:, slot, :, 16:])


def test_prefill_into_slot_keeps_its_signature_and_results():
    cfg, params = _model()
    ids, mask = _prompt(21, seed=7)
    for slot in (1, torch.tensor(1)):
        got, want = _filled_cache(cfg), _filled_cache(cfg)
        tok, out = transformer.prefill_into_slot(params, ids, mask, got, slot, cfg)
        assert out is got
        assert torch.equal(tok, _view_prefill(params, ids, mask, want, 1, cfg))
        assert _same(got, want)
    with pytest.raises(ValueError, match="outside the cache"):
        transformer.prefill_into_slot(params, ids, mask, got, N_SLOTS, cfg)


def test_the_cpu_batcher_keeps_the_eager_prefill():
    """Off the card the prefill program is the family's eager
    ``prefill_into_slot``: no graph, and both graph counters stay 0."""
    cfg, params = _model()
    chat = TorchLMChat(
        config=cfg, params=params, device="cpu", max_new_tokens=3, decode_slots=2,
        continuous_batching=True,
    )
    cb = chat._cb
    assert cb._graphs is None
    assert cb._prefill._fn.func is transformer.prefill_into_slot
    futs = [cb.submit(p) for p in ("a b c", "d e", "f")]
    assert all(len(f.result(timeout=60).split()) == 3 for f in futs)
    cb.drain()
    st = chat.batcher_stats()
    assert st["prefills"] == 3 and st["prefill_replays"] == 0 and st["prefill_captures"] == 0


# ------------------------------------------------------------- on the card


@pytest.mark.cuda
def test_replay_equals_the_eager_prefill_bit_for_bit(cuda_device):
    """bf16 at every width: the first call of a width captures (and serves
    its request eagerly), each later one replays into another slot; the
    token and the whole cache equal the eager prefill's and the view
    prefill's, bit for bit."""
    cfg, params = _model(torch.bfloat16, cuda_device, d_model=128, d_ff=256)
    graphs = PhaseGraphs(functools.partial(transformer.prefill_slot, cfg=cfg))
    cache = _filled_cache(cfg, cuda_device)
    eager, view = _clone(cache), _clone(cache)
    calls = [(w, slot, seed) for w in WIDTHS for slot, seed in ((0, 1), (N_SLOTS - 1, 2), (1, 3))]
    for i, (width, slot, seed) in enumerate(calls):
        ids, mask = _prompt(width - seed, seed=100 * width + seed, device=cuda_device)
        tok, out = graphs(params, ids, mask, cache, torch.tensor(slot))
        assert out is cache
        assert graphs.last == ("capture" if seed == 1 else "replay"), (width, slot)
        want = transformer.prefill_slot(params, ids, mask, eager, torch.tensor(slot, device=cuda_device), cfg)
        assert torch.equal(tok, want), (width, slot)
        assert torch.equal(tok, _view_prefill(params, ids, mask, view, slot, cfg)), (width, slot)
        torch.cuda.synchronize()
        assert _same(cache, eager) and _same(cache, view), (width, slot)
    assert len(graphs._graphs) == len(WIDTHS)


@pytest.mark.cuda
def test_a_new_cache_buffer_recaptures(cuda_device):
    cfg, params = _model(torch.bfloat16, cuda_device, d_model=128, d_ff=256)
    graphs = PhaseGraphs(functools.partial(transformer.prefill_slot, cfg=cfg))
    first, second = _filled_cache(cfg, cuda_device), _filled_cache(cfg, cuda_device, seed=2)
    ids, mask = _prompt(40, seed=8, device=cuda_device)
    graphs(params, ids, mask, first, torch.tensor(0))
    graphs(params, ids, mask, first, torch.tensor(1))
    assert graphs.last == "replay"
    kept, want = _clone(first), _clone(second)
    tok, _ = graphs(params, ids, mask, second, torch.tensor(3))
    assert graphs.last == "capture" and len(graphs._graphs) == 1  # the old buffer's graph is gone
    tok2, _ = graphs(params, ids, mask, second, torch.tensor(2))
    assert graphs.last == "replay"
    at = functools.partial(torch.tensor, device=cuda_device)
    assert torch.equal(tok, transformer.prefill_slot(params, ids, mask, want, at(3), cfg))
    assert torch.equal(tok2, transformer.prefill_slot(params, ids, mask, want, at(2), cfg))
    torch.cuda.synchronize()
    assert _same(second, want)
    assert _same(first, kept)  # never written through a stale graph
    graphs(params, ids, mask, first, torch.tensor(0))
    assert graphs.last == "capture"


@pytest.mark.cuda
def test_the_batcher_replays_every_prefill_after_the_first_of_each_width(cuda_device):
    """Through ``TorchLMChat`` at f32 on the card: one capture a width,
    every other prefill a replay, the plane's counter and each prefill
    span's ``graphed`` agree, and the tokens equal the wave-aligned path."""
    cfg, params = _model(torch.float32, cuda_device)
    chat = TorchLMChat(
        config=cfg, params=params, device=cuda_device, max_new_tokens=NEW_TOKENS,
        decode_slots=N_SLOTS, continuous_batching=True,
    )
    cb = chat._cb
    assert cb._graphs is not None
    rng = np.random.default_rng(9)
    lengths = [3, 12, 17, 30, 40, 60, 70, 100, 150, 5, 33, 90]
    prompts = [" ".join(f"w{x}" for x in rng.integers(0, 999, n)) for n in lengths]
    obs.enable()

    async def ask():
        return await asyncio.gather(*(chat.__wrapped__(p) for p in prompts))

    got = asyncio.run(ask())
    cb.drain()
    st = chat.batcher_stats()
    widths = {bucket_len(len(chat.tokenizer.tokenize(p)[-BUDGET:]), BUDGET) for p in prompts}
    assert st["prefills"] == len(prompts)
    assert st["prefill_captures"] == len(widths) == len(cb._graphs._graphs)
    assert st["prefill_replays"] == len(prompts) - len(widths)
    pool = {"pool": cb.pool.name}
    replays = obs.PLANE.metrics.counter_value("pathway_serving_prefill_graph_replays_total", pool)
    assert replays == st["prefill_replays"]
    graphed = [s["attrs"]["graphed"] for s in spans.spans() if s["name"] == "cb.prefill"]
    assert sorted(graphed) == [False] * len(widths) + [True] * st["prefill_replays"]
    wave = TorchLMChat(
        config=cfg, params=chat.params, device=cuda_device, max_new_tokens=NEW_TOKENS,
        continuous_batching=False,
    )
    assert got == wave._generate_batch(prompts)
