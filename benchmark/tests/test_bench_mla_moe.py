"""The Moonlight cell (``moonlight-16b-a3b.rag-long``) at a tiny size of its
own on the CPU: a sound run comes out correct, and each fault it can have
comes out not correct; the new metrics read by hand-made records; the
roofline counts against hand counts; the trace's parts by correlation id
on hand-made events."""

import dataclasses

import pytest
import torch

from benchmark import harness
from benchmark import roofline_mla_moe as rl
from benchmark.generators import chat_closed_mla_moe as gen
from benchmark.trace import CLOCK

CELL = "moonlight-16b-a3b.rag-long"
# the Moonlight block at a tiny size: the published ratios of experts a
# token (6 of 64, 2 shared) kept as 6 of 16 and 2 shared, so that one
# expert's share of a token is what it is at full size
MODEL = {
    "kind": "mla_moe_decoder", "vocab_size": 512, "d_model": 64, "n_heads": 4, "n_layers": 3,
    "d_ff": 128, "max_len": 96, "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 16,
    "v_head_dim": 16, "n_routed_experts": 16, "n_experts_per_tok": 6, "n_shared_experts": 2,
    "moe_d_ff": 16, "first_k_dense": 1, "routed_scaling_factor": 2.446, "rope_theta": 50000.0,
    "norm_eps": 1e-5, "dtype": "bfloat16",
}
# from tiny readings on the CPU, 16 seeds from 2**31 + 11: logit_gap_mean
# sound <= 0.0140, the fp8 control >= 0.0664
LIMITS = {"logit_gap_mean": {"limit": 0.03}}
SEEDS = [2**31 + 11, 2**31 + 12]


def traffic() -> dict:
    t = harness.traffic_of("rag-long")
    t.update(
        count=16, prompt_tokens={"median": 55, "sigma": 0.3, "floor": 40, "cap": 70}, chunks=[2, 4],
        new_tokens=16, slots=4, clients=4, settle_s=0.2, check={"requests": 4},
    )
    return t


def run(seed: int = SEEDS[0], control: bool = False) -> dict:
    return harness.run_cell(
        harness.load_spec(), CELL, seed, 2.0, False, device="cpu", model=MODEL, traffic=traffic(),
        limits=LIMITS, control=control,
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_bench_moonlight_sound_run_is_correct_and_its_control_is_not(seed):
    r = run(seed, control=True)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["control_correct"] is False, (r["control"], r["checks"])
    assert set(r["metrics"]) == {"answer_tokens_per_s", "answer_p95_ms", "setup_s"}


def _break(monkeypatch, name, wrap):
    from pathway_tpu_torch.models import deepseek

    monkeypatch.setattr(deepseek, name, wrap(getattr(deepseek, name)))


def test_bench_router_without_its_bias(monkeypatch):
    def wrap(real):
        def route(x, blk, cfg):
            return real(x, {**blk, "router_bias": torch.zeros_like(blk["router_bias"])}, cfg)
        return route

    _break(monkeypatch, "route", wrap)
    assert not run()["correct"]


def test_bench_decode_without_the_rope_half_of_the_scores(monkeypatch):
    from pathway_tpu_torch.models import deepseek

    def wrap(real):
        def attend(q, cache_l, key_ok, blk, cfg):
            nope = cfg.qk_nope_head_dim
            q = torch.cat((q[..., :nope], torch.zeros_like(q[..., nope:])), dim=-1)
            return real(q, cache_l, key_ok, blk, cfg)
        return attend

    _break(monkeypatch, "_attend_absorbed", wrap)
    assert deepseek._attend_absorbed is not None
    assert not run()["correct"]


def test_bench_step_that_leaves_the_latent_cache_unwritten(monkeypatch):
    def wrap(real):
        def step(params, cache, token, pos, pad_len, cfg):
            nxt, _ = real(params, {k: v.clone() for k, v in cache.items()}, token, pos, pad_len, cfg)
            return nxt, cache
        return step

    _break(monkeypatch, "decode_step_slots", wrap)
    assert not run()["correct"]


# ------------------------------------------------------------ the readers

M = {**MODEL, "n_routed_experts": 64}


def _read(name: str, rec: dict):
    return harness.metric_module(name).read(rec)


NEW = (
    "mfu.moonlight", "mla_roofline.moonlight", "moe_roofline.moonlight", "mla_device_ms.moonlight",
    "moe_device_ms.moonlight", "expert_load_max.moonlight", "decode_step_ms.moonlight",
    "prefill_share.moonlight", "idle_share.moonlight",
)


@pytest.mark.parametrize("name", NEW)
def test_bench_moonlight_readers_read_nothing_from_an_empty_record(name):
    assert _read(name, {}) is None
    # a record of the answer cell's kind: no layer steps, no expert counters
    parent = {"stats": {"decode_steps": 0, "prefills": 0}, "model": {"d_model": 8}, "requests": [],
              "trace": None, "window_s": 1.0, "new_tokens": 4}
    assert _read(name, parent) is None


def test_bench_moonlight_readers_by_hand():
    steps = [
        {"rows": 4, "keys": 100, "moe_assignments": 48, "moe_experts_hit": 20, "mla_s": 0.002, "moe_s": 0.003},
        {"rows": 2, "keys": 50, "moe_assignments": 24, "moe_experts_hit": 12, "mla_s": 0.004, "moe_s": 0.001},
    ]
    rec = {
        "model": M, "window_s": 10.0, "new_tokens": 4, "layer_steps": steps,
        "requests": [(1.0, 3.0, 20)],
        "stats": {"decode_steps": 40, "prefills": 4, "step_seconds": 1.2, "prefill_seconds": 0.5,
                  "moe_assignments": 6400, "moe_max_load": 300},
        "trace": {"busy_s": 0.5, "window_s": 2.0},
    }
    assert _read("mla_device_ms.moonlight", rec) == pytest.approx(3.0)
    assert _read("moe_device_ms.moonlight", rec) == pytest.approx(2.0)
    mla = rl.least_s(*rl.mla_step(4, 100, M)) + rl.least_s(*rl.mla_step(2, 50, M))
    assert _read("mla_roofline.moonlight", rec) == pytest.approx(100 * mla / 0.006)
    moe = rl.least_s(*rl.moe_step(4, 48, 20, M)) + rl.least_s(*rl.moe_step(2, 24, 12, M))
    assert _read("moe_roofline.moonlight", rec) == pytest.approx(100 * moe / 0.004)
    # 300 tokens at the busiest against 6400 / 64 = 100 an expert
    assert _read("expert_load_max.moonlight", rec) == pytest.approx(3.0)
    w = rl.answer_work(rec["requests"], 10.0, 4, M)
    assert _read("mfu.moonlight", rec) == pytest.approx(
        100 * (w["prefill_flops"] + w["decode_flops"]) / (10.0 * rl.BF16_FLOPS)
    )
    assert _read("decode_step_ms.moonlight", rec) == pytest.approx(30.0)
    assert _read("prefill_share.moonlight", rec) == pytest.approx(5.0)
    assert _read("idle_share.moonlight", rec) == pytest.approx(75.0)


# -------------------------------------------------------------- the counts

R = {
    "vocab_size": 100, "d_model": 8, "n_heads": 2, "n_layers": 3, "d_ff": 24, "kv_lora_rank": 4,
    "qk_nope_head_dim": 4, "qk_rope_head_dim": 2, "v_head_dim": 3, "n_routed_experts": 5,
    "n_experts_per_tok": 2, "n_shared_experts": 1, "moe_d_ff": 6, "first_k_dense": 1,
}


def test_bench_roofline_mla_moe_by_hand():
    # W_q 8 x 2 x 6 = 96, W_kva 8 x 6 = 48, W_kvb 4 x 2 x 7 = 56, W_o 6 x 8 = 48, norms 8 + 4
    assert rl.mla_weights(R) == 96 + 48 + 56 + 48 + 12
    assert rl.expert_weights(R) == 3 * 8 * 6
    # shared 3 x 8 x 6, router 8 x 5, norm 8
    assert rl.shared_weights(R) == 144 + 40 + 8
    assert rl.dense_weights(R) == 3 * 8 * 24 + 8
    # one dense layer, two expert layers of 2 routed and the shared
    assert rl.active_weights(R) == 3 * 260 + 584 + 2 * (2 * 144 + 192)
    assert rl.head_weights(R) == 8 * 101
    # a prefill pair: 2 x (4 + 2 + 3) x 2 heads x 3 layers; a decode key: 2 x (8 + 2) x 2 x 3
    assert rl.prefill_pair_flops(R) == 108
    assert rl.decode_key_flops(R) == 120
    assert rl.prefill_flops(3, R) == 2 * 3 * 2324 + 108 * 6 + 2 * 808
    assert rl.decode_flops(2, 9, R) == 2 * 2 * (2324 + 808) + 120 * 9
    # a step of 2 rows over 9 entries before: each entry 6 x 2 bytes a layer
    f, b = rl.mla_step(2, 9, R)
    assert f == 2 * 2 * 3 * 260 + 120 * 11
    assert b == 3 * (260 * 2 + 11 * 12 + 2 * 2 * 8 * 2)
    # 8 choices over 3 experts hit: dense 584 + 2 x 192 shared, read once
    f, b = rl.moe_step(2, 8, 3, R)
    assert f == 2 * 2 * (584 + 2 * 192) + 2 * 8 * 144
    assert b == (584 + 2 * 192 + 3 * 144) * 2 + 3 * 2 * 2 * 8 * 2
    assert rl.least_s(989e12, 0) == pytest.approx(1.0)
    assert rl.least_s(0, 3.35e12) == pytest.approx(1.0)


def test_bench_answer_work_counts_the_moonlight_model():
    reqs = [(1.0, 3.0, 4), (-2.0, 2.0, 4)]
    w = rl.answer_work(reqs, 10.0, 3, R)
    assert w["prefill_flops"] == rl.prefill_flops(4, R)
    assert w["decode_rows"] == pytest.approx(3)
    assert w["decode_keys"] == pytest.approx(11 + 5.5)


# ---------------------------------------------------- parts by correlation


@dataclasses.dataclass
class _Ev:
    dev: str
    nm: str
    s: int
    e: int
    corr: int = 0
    ann: bool = False

    def device_type(self):
        return f"DeviceType.{self.dev}"

    def name(self):
        return self.nm

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def correlation_id(self):
        return self.corr

    def is_user_annotation(self):
        return self.ann


def test_bench_layer_steps_put_device_work_where_it_was_launched():
    # span stamps + 10_000 = wall clock; the trace's clock is the wall clock + 500
    ring = [
        {"name": "cb.step", "id": 1, "parent": 0, "start_ns": 1000, "end_ns": 9000,
         "attrs": {"rows": 3, "keys": 30, "moe_assignments": 12}},
        {"name": "cb.step.launch", "id": 2, "parent": 1, "start_ns": 1100, "end_ns": 5000, "attrs": {}},
        {"name": "lm.mla", "id": 3, "parent": 2, "start_ns": 1200, "end_ns": 2000, "attrs": {}},
        {"name": "lm.moe", "id": 4, "parent": 2, "start_ns": 2000, "end_ns": 3000, "attrs": {}},
        {"name": "lm.mla", "id": 5, "parent": 99, "start_ns": 3000, "end_ns": 3500, "attrs": {}},
        {"name": "cb.step", "id": 6, "parent": 0, "start_ns": 60000, "end_ns": 90000, "attrs": {"rows": 1}},
    ]
    shift = 10_000 + 500
    events = [
        _Ev("CPU", CLOCK, 10_600, 10_700, ann=True),
        _Ev("CPU", "cudaLaunchKernel", 1300 + shift, 1310 + shift, corr=7),
        _Ev("CPU", "cudaLaunchKernel", 1500 + shift, 1510 + shift, corr=8),
        _Ev("CPU", "cudaMemsetAsync", 2100 + shift, 2110 + shift, corr=9),
        _Ev("CPU", "cudaLaunchKernel", 3100 + shift, 3110 + shift, corr=10),  # not under a step
        _Ev("CUDA", "k7", 1400 + shift, 1900 + shift, corr=7),
        _Ev("CUDA", "k8", 1800 + shift, 2400 + shift, corr=8),  # overlaps k7: the union counts
        _Ev("CUDA", "k9", 2500 + shift, 2800 + shift, corr=9),
        _Ev("CUDA", "k10", 3200 + shift, 9500 + shift, corr=10),
    ]
    out = gen.layer_steps(events, 10_100, ring, 10_000)
    assert out == [{"rows": 3, "keys": 30, "moe_assignments": 12, "mla_s": 1000e-9, "moe_s": 300e-9}]
    assert gen.layer_steps(events[:1], 10_100, ring, 10_000) == []
    # a kernel whose launch record was lost, inside the step's device time:
    # the step cannot be split and is left out
    lost = _Ev("CUDA", "k11", 2420 + shift, 2480 + shift, corr=11)
    assert gen.layer_steps(events + [lost], 10_100, ring, 10_000) == []
