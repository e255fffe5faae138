"""The port's causal LM against the JAX package, on the CPU at a tiny size.

Parameters are drawn once by ``jax.random`` and carried across with
``params_from_numpy``; inputs are seeded numpy. f32 logits agree within
1e-4 and f32 greedy tokens are identical. At bf16 the two round at one
place apart: the port applies GELU to the ff_in product after it is
rounded to bf16, the JAX package to the f32 sum. The logits are held
within BF16_ATOL, and a greedy token may differ only where the JAX
logits' top two lie closer than that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import transformer as jtfm
from pathway_tpu.xpacks.llm.embedders import pad_left_rows as jax_pad_left_rows
from pathway_tpu_torch.models import convert
from pathway_tpu_torch.models import transformer as ttfm
from pathway_tpu_torch.xpacks.llm.embedders import pad_left_rows

TINY = dict(vocab_size=256, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_len=64)
# bf16 logits: one bf16 rounding of the GELU input apart per layer, on
# logits of |l| < 0.2 (tok_embed std 0.02 against unit-RMS hidden states);
# the measured gap is below 2e-3
BF16_ATOL = 5e-3


def _pair(dtype: str = "f32", seed: int = 0):
    """(jax cfg, jax params, port cfg, port params) over one f32 tree, as
    JaxLMChat keeps it: the products cast to cfg.dtype."""
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jcfg, tcfg = jtfm.lm_config(dtype=jd, **TINY), ttfm.lm_config(dtype=td, **TINY)
    jp = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _rows(seed: int, n: int, lo: int = 2, hi: int = 20) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [list(rng.integers(2, 256, int(rng.integers(lo, hi + 1)))) for _ in range(n)]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, atol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)


# ---------------------------------------------------------------- forward


def test_causal_logits_match_jax_and_see_no_future():
    jcfg, jp, tcfg, tp = _pair(seed=1)
    rng = np.random.default_rng(1)
    ids = rng.integers(2, 256, (4, 24)).astype(np.int32)
    mask = (np.arange(24)[None, :] < np.array([24, 20, 9, 1])[:, None]).astype(np.int32)
    want = jtfm.logits(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg)
    got = ttfm.logits(tp, _t(ids).long(), _t(mask), tcfg)
    assert got.shape == (4, 24, 256) and got.dtype == torch.float32
    _close(got, want, 1e-4)
    later = ids.copy()
    later[:, 12:] = rng.integers(2, 256, (4, 12))
    got2 = ttfm.logits(tp, _t(later).long(), _t(mask), tcfg)
    torch.testing.assert_close(got2[:, :12], got[:, :12], rtol=0, atol=0)


def test_lm_module_and_param_bridge_take_the_lm_tree():
    jcfg, jp, tcfg, tp = _pair(seed=2)
    assert ttfm.count_params(tp) == jtfm.count_params(jp)
    model = ttfm.TransformerLM(tcfg, tp, device="cpu")
    ids, mask = jax_pad_left_rows(_rows(2, 3), 32)
    ids, mask = ids[:3], mask[:3]
    _close(model.logits(_t(ids).long(), _t(mask)), jtfm.logits(jp, ids, mask, jcfg), 1e-4)
    # lm_config pools the last valid token: right-padded rows here
    rmask = np.flip(mask, axis=1).copy()
    _close(model.encode(_t(ids).long(), _t(rmask)), jtfm.encode(jp, ids, rmask, jcfg), 1e-4)


def test_init_params_builds_bf16_leaves_one_at_a_time():
    _jcfg, _jp, tcfg, _tp = _pair()
    p = ttfm.init_params(torch.Generator().manual_seed(3), tcfg, dtype=torch.bfloat16)
    shapes = convert.param_shapes(tcfg)
    assert p["tok_embed"].dtype == torch.bfloat16 and tuple(p["tok_embed"].shape) == shapes["tok_embed"]
    assert all(v.dtype == torch.bfloat16 for blk in p["blocks"] for v in blk.values())
    f32 = ttfm.init_params(torch.Generator().manual_seed(3), tcfg)
    torch.testing.assert_close(p["blocks"][1]["ff_out"], f32["blocks"][1]["ff_out"].bfloat16(), rtol=0, atol=0)


# ------------------------------------------------------- prefill + decode


def _prefill_decode(jcfg, jp, tcfg, tp, ids, mask, steps: int):
    """Prefill then `steps` decode steps in both packages, each fed the
    JAX package's greedy token; returns the per-step logits of both and
    the port's cache."""
    b, p = ids.shape
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else _t(mask)
    jl, jc = jtfm.prefill(jp, jnp.asarray(ids), jtfm.init_kv_cache(jcfg, b), jcfg, jmask)
    tl, tc = ttfm.prefill(tp, _t(ids).long(), ttfm.init_kv_cache(tcfg, b, "cpu"), tcfg, tmask)
    jpad = None if mask is None else jnp.asarray(p - mask.sum(1), jnp.int32)
    tpad = None if mask is None else _t(p - mask.sum(1)).long()
    want, got = [jl], [tl]
    for i in range(steps):
        tok = np.asarray(jnp.argmax(want[-1], -1), np.int32)
        jl, jc = jtfm.decode_step(jp, jc, jnp.asarray(tok), p + i, jcfg, pad_len=jpad)
        tl, tc = ttfm.decode_step(tp, tc, _t(tok).long(), p + i, tcfg, pad_len=tpad)
        want.append(jl)
        got.append(tl)
    return [np.asarray(w, np.float32) for w in want], got, tc


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_and_decode_logits_match_jax(dtype, padded):
    jcfg, jp, tcfg, tp = _pair(dtype, seed=3)
    if padded:
        ids, mask = jax_pad_left_rows(_rows(3, 5), 48, n_rows=5)
    else:
        ids, mask = np.random.default_rng(3).integers(2, 256, (5, 16)).astype(np.int32), None
    want, got, _cache = _prefill_decode(jcfg, jp, tcfg, tp, ids, mask, steps=4)
    for w, g in zip(want, got):
        assert g.shape == (5, 256) and g.dtype == torch.float32
        _close(g, w, 1e-4 if dtype == "f32" else BF16_ATOL)


def test_bf16_greedy_tokens_differ_only_at_near_ties():
    """Teacher-forced over 12 steps: wherever the two packages' argmax
    differ at bf16, the JAX logits' top two lie within BF16_ATOL."""
    jcfg, jp, tcfg, tp = _pair("bf16", seed=4)
    ids, mask = jax_pad_left_rows(_rows(4, 8), 48, n_rows=8)
    want, got, _cache = _prefill_decode(jcfg, jp, tcfg, tp, ids, mask, steps=12)
    for w, g in zip(want, got):
        differ = np.argmax(w, -1) != g.argmax(-1).numpy()
        top2 = np.sort(w, -1)[:, -2:]
        assert np.all(top2[differ, 1] - top2[differ, 0] < BF16_ATOL)


def test_cache_is_head_major_and_written_in_place():
    jcfg, jp, tcfg, tp = _pair(seed=5)
    ids = np.random.default_rng(5).integers(2, 256, (2, 16)).astype(np.int32)
    cache = ttfm.init_kv_cache(tcfg, 2, "cpu")
    assert cache["k"].shape == (2, 2, 2, 64, 8)  # [L, B, H, S, Dh]
    ptr = cache["k"].data_ptr()
    _toks, out = ttfm.generate_serving(tp, _t(ids), cache, 5, tcfg)
    assert out["k"].data_ptr() == ptr
    _jt, jc = jtfm.generate_serving(jp, jnp.asarray(ids), jtfm.init_kv_cache(jcfg, 2), 5, jcfg)
    # positions 0..p+3 hold the same K/V (JAX's scan also writes p+4)
    want = np.asarray(jc["k"]).transpose(0, 1, 3, 2, 4)[:, :, :, :20]
    _close(out["k"][:, :, :, :20], want, 1e-5)
    assert not out["k"][:, :, :, 20:].any()


# ---------------------------------------------------------------- generate


@pytest.mark.parametrize("padded", [False, True])
def test_generate_greedy_tokens_identical_to_jax(padded):
    jcfg, jp, tcfg, tp = _pair(seed=6)
    if padded:  # mixed lengths, left-padded to one bucket
        ids, mask = pad_left_rows(_rows(6, 6, 1, 30), 40, n_rows=6)
        jm, tm = jnp.asarray(mask), _t(mask)
    else:
        ids, jm, tm = np.random.default_rng(6).integers(2, 256, (3, 10)).astype(np.int32), None, None
    want = np.asarray(jtfm.generate(jp, jnp.asarray(ids), 16, jcfg, prompt_mask=jm))
    got = ttfm.generate(tp, _t(ids), 16, tcfg, prompt_mask=tm)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_serving_reuses_a_stale_cache():
    """A cache that held a longer wave first gives the same tokens."""
    jcfg, jp, tcfg, tp = _pair(seed=7)
    cache = ttfm.init_kv_cache(tcfg, 4, "cpu")
    ids1, m1 = pad_left_rows(_rows(7, 4, 20, 30), 40, n_rows=4)
    ttfm.generate_serving(tp, _t(ids1), cache, 20, tcfg, prompt_mask=_t(m1))
    ids, mask = pad_left_rows(_rows(8, 4, 1, 12), 40, n_rows=4)
    got, _ = ttfm.generate_serving(tp, _t(ids), cache, 12, tcfg, prompt_mask=_t(mask))
    want, _ = jtfm.generate_serving(
        jp, jnp.asarray(ids), jtfm.init_kv_cache(jcfg, 4), 12, jcfg, prompt_mask=jnp.asarray(mask)
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_serving_guards_the_cache_edge():
    """p + n_steps == max_len stays in range (every write lands inside
    the cache); one more raises before anything runs."""
    jcfg, jp, tcfg, tp = _pair(seed=9)
    ids = np.random.default_rng(9).integers(2, 256, (2, 48)).astype(np.int32)
    cache = ttfm.init_kv_cache(tcfg, 2, "cpu")
    got, _ = ttfm.generate_serving(tp, _t(ids), cache, 16, tcfg)
    want, _ = jtfm.generate_serving(jp, jnp.asarray(ids), jtfm.init_kv_cache(jcfg, 2), 16, jcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="exceeds max_len"):
        ttfm.generate_serving(tp, _t(ids), cache, 17, tcfg)
    with pytest.raises(ValueError, match="outside the cache"):
        ttfm.decode_step(tp, cache, torch.zeros(2, dtype=torch.long), 64, tcfg)


def test_sampled_generation_is_seeded_and_needs_a_generator():
    _jcfg, _jp, tcfg, tp = _pair(seed=10)
    ids = np.random.default_rng(10).integers(2, 256, (3, 8)).astype(np.int32)

    def run(seed: int) -> torch.Tensor:
        gen = torch.Generator().manual_seed(seed)
        return ttfm.generate(tp, _t(ids), 24, tcfg, temperature=1.0, generator=gen)

    a, b, c = run(0), run(0), run(1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert int(a[:, 8:].min()) >= 0 and int(a[:, 8:].max()) < 256
    with pytest.raises(ValueError, match="requires a generator"):
        ttfm.generate(tp, _t(ids), 4, tcfg, temperature=0.5)


# -------------------------------------------------------------- slot path


def _drive_slots(prefill_fn, step_fn, requests, n_slots: int, n_steps: int, joins: dict):
    """A small slot scheduler over both packages' programs: request r is
    admitted at the first step boundary at or after joins[r] that finds a
    free slot, into the lowest one; returns each request's tokens."""
    budget = TINY["max_len"] - n_steps
    free, active, out = list(range(n_slots)), {}, {}
    pending = sorted(range(len(requests)), key=lambda r: joins[r])
    step = 0
    while len(out) < len(requests):
        while pending and joins[pending[0]] <= step and free:
            r, slot = pending.pop(0), free.pop(0)
            ids, mask = pad_left_rows([requests[r][-budget:]], budget, n_rows=1)
            first = prefill_fn(ids, mask, slot)
            active[slot] = [r, ids.shape[1], ids.shape[1] - int(mask.sum()), [first]]
        tok, pos, pad = (np.zeros(n_slots, np.int32) for _ in range(3))
        for slot, (r, width, pad_len, toks) in active.items():
            tok[slot], pos[slot], pad[slot] = toks[-1], width + len(toks) - 1, pad_len
        nxt = step_fn(tok, pos, pad)
        step += 1
        for slot in list(active):
            toks = active[slot][3]
            toks.append(int(nxt[slot]))
            if len(toks) >= n_steps:
                out[active.pop(slot)[0]] = toks
                free.append(slot)
                free.sort()
    return [out[r] for r in range(len(requests))]


def test_slot_prefill_and_decode_identical_to_jax():
    """Rows at different positions and prompt buckets (16 and 32), a slot
    refilled after a longer request, a prompt truncated to the budget."""
    jcfg, jp, tcfg, tp = _pair(seed=11)
    n_slots, n_steps = 3, 12
    requests = _rows(11, 5, 1, 14) + [list(range(2, 30)), list(range(40, 100))]
    joins = {0: 0, 1: 0, 2: 3, 3: 5, 4: 9, 5: 12, 6: 14}
    jcache = {"c": jtfm.init_kv_cache(jcfg, n_slots)}
    tcache = ttfm.init_kv_cache(tcfg, n_slots, "cpu")

    def jprefill(ids, mask, slot):
        first, jcache["c"] = jtfm.prefill_into_slot(
            jp, jnp.asarray(ids), jnp.asarray(mask), jcache["c"], jnp.int32(slot), jcfg
        )
        return int(first[0])

    def jstep(tok, pos, pad):
        nxt, jcache["c"] = jtfm.decode_step_slots(
            jp, jcache["c"], jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(pad), jcfg
        )
        return np.asarray(nxt)

    def tprefill(ids, mask, slot):
        first, _ = ttfm.prefill_into_slot(tp, _t(ids), _t(mask), tcache, slot, tcfg)
        return int(first[0])

    def tstep(tok, pos, pad):
        nxt, _ = ttfm.decode_step_slots(tp, tcache, _t(tok).long(), _t(pos).long(), _t(pad).long(), tcfg)
        return nxt.numpy()

    want = _drive_slots(jprefill, jstep, requests, n_slots, n_steps, joins)
    got = _drive_slots(tprefill, tstep, requests, n_slots, n_steps, joins)
    assert got == want
    # the same as each request generated alone (no cross-slot bleed)
    for r in (2, 5, 6):
        ids, mask = pad_left_rows([requests[r][-(64 - n_steps):]], 64 - n_steps, n_rows=1)
        alone = ttfm.generate(tp, _t(ids), n_steps, tcfg, prompt_mask=_t(mask))
        assert alone[0, ids.shape[1]:].tolist() == got[r]


def test_slot_reused_after_a_longer_request_gives_the_same_tokens():
    """Prefill writes straight into the slot's rows: a slot that held a
    longer request keeps its stale K/V past the new prompt, and the
    masks keep it out of every output."""
    _jcfg, _jp, tcfg, tp = _pair(seed=12)
    short = _rows(12, 1, 3, 8)[0]
    cache = ttfm.init_kv_cache(tcfg, 2, "cpu")

    def run(slot_cache) -> list[int]:
        ids, mask = pad_left_rows([short], 48, n_rows=1)
        first, _ = ttfm.prefill_into_slot(tp, _t(ids), _t(mask), slot_cache, 1, tcfg)
        toks, width, pad = [int(first[0])], ids.shape[1], ids.shape[1] - int(mask.sum())
        for i in range(10):
            nxt, _ = ttfm.decode_step_slots(
                tp, slot_cache, torch.tensor([0, toks[-1]]), torch.tensor([0, width + i]),
                torch.tensor([0, pad]), tcfg,
            )
            toks.append(int(nxt[1]))
        return toks

    fresh = run(ttfm.init_kv_cache(tcfg, 2, "cpu"))
    ids, mask = pad_left_rows([list(range(2, 40))], 48, n_rows=1)  # width 48
    ttfm.prefill_into_slot(tp, _t(ids), _t(mask), cache, 1, tcfg)
    assert cache["k"][:, 1, :, 16:48].abs().sum() > 0  # stale rows past the new prompt
    assert run(cache) == fresh
    with pytest.raises(ValueError, match="outside the cache"):
        ttfm.prefill_into_slot(tp, _t(ids), _t(mask), cache, 2, tcfg)
