"""The DeepSeek-V3 family (``models/deepseek.py``: latent attention over a
compressed cache, routed and shared experts) on the port's serving path,
against the plain f32 reference ``benchmark/reference/mla_moe.py``, at a
tiny size on the CPU: d 64, 4 heads, latent 32, rope 16, nope 16, v 16,
8 experts top-2 plus 1 shared, 3 layers with the first dense, vocab 512,
96 positions."""

import asyncio
import dataclasses
import threading

import numpy as np
import pytest
import torch

from benchmark import weights_mla_moe
from benchmark.reference import mla_moe as ref
from pathway_tpu_torch.internals import observability as obs
from pathway_tpu_torch.internals import spans
from pathway_tpu_torch.models import DeepseekConfig, build_lm, deepseek, family_of, lm_config, transformer
from pathway_tpu_torch.serving import ContinuousBatcher
from pathway_tpu_torch.xpacks.llm.embedders import pad_left_rows
from pathway_tpu_torch.xpacks.llm.llms import TorchLMChat

MODEL = {
    "kind": "mla_moe_decoder", "vocab_size": 512, "d_model": 64, "n_heads": 4, "n_layers": 3,
    "d_ff": 128, "max_len": 96, "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 16,
    "v_head_dim": 16, "n_routed_experts": 8, "n_experts_per_tok": 2, "n_shared_experts": 1,
    "moe_d_ff": 32, "first_k_dense": 1, "routed_scaling_factor": 2.446, "rope_theta": 50000.0,
    "norm_eps": 1e-5, "dtype": "bfloat16",
}
KEYS = [f.name for f in dataclasses.fields(DeepseekConfig) if f.name != "dtype"]
PROMPTS = [" ".join(f"w{j}" for j in range(3 + 5 * i)) for i in range(6)]
N_STEPS = 6


def _cfg(dtype=torch.float32) -> DeepseekConfig:
    return DeepseekConfig(dtype=dtype, **{k: MODEL[k] for k in KEYS})


def _params(seed: int = 3, dtype=torch.float32) -> dict:
    return weights_mla_moe.make(MODEL, seed, "cpu", dtype)


@pytest.fixture(autouse=True)
def _plane_off(monkeypatch):
    monkeypatch.delenv("PATHWAY_OBSERVABILITY", raising=False)
    monkeypatch.delenv("PATHWAY_PROFILE", raising=False)
    before = obs.PLANE
    obs.disable()
    yield
    obs.PLANE = before


def _chat(params, cfg, slots=3, n_steps=N_STEPS) -> TorchLMChat:
    return TorchLMChat(
        config=cfg, params=params, max_new_tokens=n_steps, decode_slots=slots,
        continuous_batching=True, device="cpu",
    )


def _ask_all(chat, prompts=PROMPTS) -> list[list[int]]:
    async def go():
        return await asyncio.gather(*(chat.__wrapped__(p) for p in prompts))

    return [[int(t.strip("<>")) for t in a.split()] for a in asyncio.run(go())]


def _gaps(params, chat, prompts, served) -> list[torch.Tensor]:
    """For each prompt, the gap by which each served token's reference
    logit lies below the reference's best at its position."""
    budget = chat.config.max_len - chat.max_new_tokens
    rows = [chat.tokenizer.tokenize(p)[-budget:] for p in prompts]
    lgs = ref.lm_logits(
        params, [r + s[:-1] for r, s in zip(rows, served)], MODEL, [len(r) - 1 for r in rows]
    )
    return [
        lg.max(dim=-1).values - lg.gather(1, torch.tensor(s)[:, None])[:, 0]
        for lg, s in zip(lgs, served, strict=True)
    ]


def test_family_of_and_build_lm():
    assert family_of(_cfg()) is deepseek
    assert family_of(lm_config(vocab_size=16, d_model=8, n_heads=2, n_layers=1, d_ff=8)) is transformer
    with pytest.raises(TypeError):
        family_of(object())
    lm = build_lm(_cfg(), _params(), device="cpu")
    assert isinstance(lm, deepseek.DeepseekLM)
    assert lm.params["blocks"][1]["router_bias"].dtype == torch.float32
    bf = build_lm(_cfg(torch.bfloat16), _params(), device="cpu")
    assert bf.params["blocks"][1]["wq"].dtype == torch.bfloat16
    assert bf.params["blocks"][1]["router_bias"].dtype == torch.float32


@pytest.mark.parametrize("seed", [2**31 + 3, 11])
def test_full_forward_matches_the_reference(seed):
    params = _params(seed)
    row = [1] + np.random.default_rng(seed).integers(2, 512, size=50).tolist()
    ids = torch.tensor([row])
    got = deepseek.logits(params, ids, torch.ones_like(ids), _cfg())[0]
    want = ref.lm_logits(params, [row], MODEL, [0])[0]
    assert torch.allclose(got, want, atol=1e-4), float((got - want).abs().max())


def test_absorbed_decode_matches_the_decompressed_path():
    """Prefill into a slot, then decode steps through the absorbed latent
    attention, against the full forward's decompressed attention at the
    same positions, f32: equal to 1e-4 (the two differ only in the order
    of f32 sums)."""
    cfg, params = _cfg(), _params(5)
    row = [1] + np.random.default_rng(5).integers(2, 512, size=30).tolist()
    cache = deepseek.init_kv_cache(cfg, 2, "cpu")
    pad = 9
    ids = torch.tensor([[0] * pad + row[:20]])
    mask = torch.tensor([[0] * pad + [1] * 20])
    deepseek.prefill_into_slot(params, ids, mask, cache, 1, cfg)
    full = deepseek.logits(params, torch.tensor([row]), torch.ones(1, len(row), dtype=torch.long), cfg)[0]
    for i in range(10):
        tok = torch.tensor([0, row[20 + i]])
        pos = torch.tensor([0, ids.shape[1] + i])
        lg = deepseek._decode(params, cache, tok, pos, torch.tensor([0, pad]), cfg)
        assert torch.allclose(lg[1], full[20 + i], atol=1e-4), float((lg[1] - full[20 + i]).abs().max())


def test_prefill_of_one_padded_row_is_its_row_in_a_batch():
    """One left-padded row alone gives its logits inside a padded batch of
    two, f32 to 1e-4: the prefill computes the batch it is given."""
    cfg, params = _cfg(), _params(41)
    rng = np.random.default_rng(41)
    rows = [[1] + rng.integers(2, 512, size=n).tolist() for n in (13, 40)]
    ids, mask = (torch.from_numpy(a) for a in pad_left_rows(rows, 64, n_rows=2))
    one, _ = deepseek.prefill(params, ids[:1], deepseek.init_kv_cache(cfg, 1, "cpu"), cfg, mask[:1])
    two, _ = deepseek.prefill(params, ids, deepseek.init_kv_cache(cfg, 2, "cpu"), cfg, mask)
    assert int(mask[0].sum()) < ids.shape[1]  # the row is padded in both
    assert torch.allclose(one[0], two[0], atol=1e-4), float((one[0] - two[0]).abs().max())


def test_slot_prefill_writes_only_its_real_positions():
    """``prefill_into_slot`` writes the real positions of its slot and no
    other cell of the cache: the latent rows of the real tokens alone,
    from the first real position on."""
    cfg, params = _cfg(), _params(43)
    row = [1] + np.random.default_rng(43).integers(2, 512, size=19).tolist()
    pad = 11
    cache = deepseek.init_kv_cache(cfg, 3, "cpu")
    cache["latent"].fill_(float("nan"))
    ids, mask = torch.tensor([[0] * pad + row]), torch.tensor([[0] * pad + [1] * len(row)])
    first, _ = deepseek.prefill_into_slot(params, ids, mask, cache, 1, cfg)
    written = ~cache["latent"].isnan().all(-1)  # [layers, slots, positions]
    want = torch.zeros_like(written)
    want[:, 1, pad:pad + len(row)] = True
    assert torch.equal(written, want)
    alone = deepseek.init_kv_cache(cfg, 1, "cpu")
    lg, _ = deepseek.prefill(params, torch.tensor([row]), alone, cfg)
    assert torch.equal(cache["latent"][:, 1, pad:pad + len(row)], alone["latent"][:, 0, :len(row)])
    assert torch.equal(first, lg.argmax(-1))


def test_router_matches_the_reference_and_its_bias_picks_but_never_weighs():
    cfg, params = _cfg(), _params(7)
    blk = params["blocks"][1]
    x = torch.randn(40, MODEL["d_model"], generator=torch.Generator().manual_seed(1))
    idx, w = deepseek.route(x, blk, cfg)
    ridx, rw = ref.route(x, blk, MODEL)
    assert torch.equal(idx.sort(dim=1).values, ridx.sort(dim=1).values)
    order, rorder = idx.argsort(dim=1), ridx.argsort(dim=1)
    assert torch.allclose(w.gather(1, order), rw.gather(1, rorder), atol=1e-6)
    # the weights are the chosen scores without the bias, renormalized, scaled
    scores = torch.sigmoid(x @ blk["router"])
    plain = scores.gather(1, idx)
    assert torch.allclose(w, plain / plain.sum(1, keepdim=True) * cfg.routed_scaling_factor, atol=1e-6)
    # a router without the bias chooses other experts for some tokens
    idx0, _ = deepseek.route(x, {**blk, "router_bias": torch.zeros_like(blk["router_bias"])}, cfg)
    assert not torch.equal(idx.sort(dim=1).values, idx0.sort(dim=1).values)


def test_served_tokens_match_the_reference_at_f32():
    """Prefill then decode through ContinuousBatcher (TorchLMChat's slot
    path), f32: every served token is the reference's best at its
    position, to 1e-4 (sums in another order)."""
    params = _params(13)
    chat = _chat(params, _cfg())
    served = _ask_all(chat)
    assert all(len(s) == N_STEPS for s in served)
    assert float(torch.cat(_gaps(params, chat, PROMPTS, served)).max()) <= 1e-4


@pytest.mark.parametrize("seed", [17, 30])
def test_served_tokens_match_the_reference_in_bf16(seed):
    """The same in bf16 against the f32 reference on the same (bf16)
    weights: at least 7 in 8 served tokens lie within 0.05 of the
    reference's best. bf16 keeps 8 bits of mantissa, so the logits (spread
    about 1) move by some 0.03-0.07 at this size, and a served token is
    the port's best, so where the best two are that close its reference
    logit trails. Past that, a token whose k-th and (k+1)-th expert scores
    lie within bf16's rounding of each other takes the other expert, as
    the published model in bf16 does against f32, and its logits move by
    that expert's share (up to 2.7 here, at 2 of 8 experts): on 24 seeds
    at most 3 of 36 served positions a seed (2.3% of all) trail by more
    than 0.05, and the median trails by 0."""
    params = _params(seed, torch.bfloat16)
    chat = _chat(params, _cfg(torch.bfloat16))
    gaps = torch.cat(_gaps(params, chat, PROMPTS, _ask_all(chat)))
    assert float((gaps > 0.05).float().mean()) <= 1 / 8, gaps
    assert float(gaps.median()) <= 1e-3


def test_request_joining_mid_generation_gets_its_tokens_alone():
    cfg, params = _cfg(), _params(19)
    alone = [_ask_all(_chat(params, cfg, n_steps=12), [p])[0] for p in PROMPTS[:2]]
    chat = _chat(params, cfg, slots=2, n_steps=12)
    cb = chat._cb
    in_step, queued = threading.Event(), threading.Event()
    step_fn = cb._step._fn

    def held_step(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        if cb.stats["decode_steps"] == 3:
            in_step.set()
            assert queued.wait(30)
        return out

    cb._step._fn = held_step
    first = cb.submit(PROMPTS[0])
    assert in_step.wait(30)
    second = cb.submit(PROMPTS[1])
    queued.set()
    got = [[int(t.strip("<>")) for t in f.result(timeout=60).split()] for f in (first, second)]
    cb.drain()
    assert got == alone


def test_stats_counters_add_up():
    cfg, params = _cfg(), _params(23)
    chat = _chat(params, cfg, slots=3)
    _ask_all(chat)
    st = chat.batcher_stats()
    k, moe_layers = cfg.n_experts_per_tok, cfg.n_layers - cfg.first_k_dense
    lengths = [len(chat.tokenizer.tokenize(p)) for p in PROMPTS]
    decoded = len(PROMPTS) * (N_STEPS - 1)  # the first token comes from the prefill
    assert st["moe_assignments"] == decoded * k * moe_layers
    # a row reads its prompt and the tokens before, plus its own
    assert st["latent_positions"] == sum(n + i + 1 for n in lengths for i in range(N_STEPS - 1))
    steps = st["decode_steps"]
    assert steps * moe_layers <= st["moe_experts_hit"] <= min(
        st["moe_assignments"], steps * moe_layers * cfg.n_routed_experts
    )
    assert st["moe_assignments"] / cfg.n_routed_experts <= st["moe_max_load"] * 1.0
    assert st["moe_max_load"] <= st["moe_assignments"] and st["moe_max_load"] >= steps * moe_layers
    # the GPT-2-style family keeps its counters as they were
    gpt = TorchLMChat(
        config=lm_config(vocab_size=64, d_model=8, n_heads=2, n_layers=1, d_ff=8, max_len=32),
        max_new_tokens=3, device="cpu",
    )
    assert "moe_assignments" not in gpt.batcher_stats()


@pytest.mark.parametrize("plane", [True, False])
def test_layer_spans_follow_the_plane(plane):
    cfg, params = _cfg(), _params(29)
    chat = _chat(params, cfg, slots=2)
    if plane:
        obs.enable()
    _ask_all(chat, PROMPTS[:3])
    ring = spans.spans()
    if not plane:
        assert ring == []
        return
    by_id = {s["id"]: s for s in ring}
    for name in ("lm.mla", "lm.moe"):
        mine = [s for s in ring if s["name"] == name]
        parents = {by_id[s["parent"]]["name"] for s in mine}
        assert parents == {"cb.step.launch", "cb.prefill.launch"}, parents
        per_parent = {}
        for s in mine:
            per_parent[s["parent"]] = per_parent.get(s["parent"], 0) + 1
        assert set(per_parent.values()) == {cfg.n_layers}
    steps = [s for s in ring if s["name"] == "cb.step"]
    assert steps and all(s["attrs"]["moe_assignments"] > 0 for s in steps)


def test_paths_left_out_raise():
    cfg, params = _cfg(), _params(31)
    with pytest.raises(NotImplementedError):
        TorchLMChat(config=cfg, params=params, continuous_batching=False, device="cpu")
    with pytest.raises(NotImplementedError):
        TorchLMChat(config=cfg, params=params, temperature=0.7, device="cpu")
    with pytest.raises(NotImplementedError):
        deepseek.generate(params, torch.tensor([[1, 2]]), 2, cfg, temperature=0.5)
    with pytest.raises(NotImplementedError):
        ContinuousBatcher(params=params, cfg=cfg, tokenizer=None, n_steps=2, mesh_span=True)


def test_generate_matches_the_served_path():
    cfg, params = _cfg(), _params(37)
    chat = _chat(params, cfg)
    served = _ask_all(chat, PROMPTS[:2])
    for p, s in zip(PROMPTS[:2], served):
        ids = torch.tensor([chat.tokenizer.tokenize(p)])
        out = deepseek.generate(params, ids, N_STEPS, cfg)
        assert out[0, ids.shape[1]:].tolist() == s
