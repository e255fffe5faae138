"""The Kimi Linear cell (``kimi-linear-48b-a3b.rag-long-16k``) at a tiny size
of its own on the CPU: a sound run comes out correct and the fp8 control
does not; the new metrics read by hand-made records and read nothing from
empty ones; the roofline counts against hand counts; the trace's parts of
decode steps and prefills by correlation id on hand-made events."""

import pytest

from benchmark import harness
from benchmark import roofline_kda as rl
from benchmark import roofline_mla_moe as rl_mla
from benchmark.generators import chat_closed_kimi_linear as gen
from benchmark.tests.test_bench_mla_moe import _Ev
from benchmark.trace import CLOCK

CELL = "kimi-linear-48b-a3b.rag-long-16k"
# the Kimi Linear block at a tiny size: the published pattern of 3 KDA
# layers to 1 MLA (and a last KDA layer), the first feed-forward dense,
# 8 of 32 experts held as 64 of 256 are, 8 a token and 1 shared
MODEL = {
    "kind": "kda_mla_moe_decoder", "vocab_size": 512, "d_model": 64, "n_heads": 4, "n_layers": 5,
    "d_ff": 128, "max_len": 96, "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 16,
    "v_head_dim": 16, "kda_layers": [1, 2, 3, 5], "kda_heads": 4, "kda_head_dim": 16,
    "kda_conv": 4, "kda_gate_rank": 16, "n_routed_experts": 32, "experts_held": [0, 8],
    "n_experts_per_tok": 8, "n_shared_experts": 1, "moe_d_ff": 16, "first_k_dense": 1,
    "routed_scaling_factor": 2.446, "norm_eps": 1e-5, "dtype": "bfloat16",
}
# from tiny readings on the CPU, seeds 2**31 + 11 to + 18: logit_gap_mean
# sound <= 0.037, the fp8 control >= 0.19
LIMITS = {"logit_gap_mean": {"limit": 0.1}}
SEEDS = [2**31 + 11, 2**31 + 13]


def traffic() -> dict:
    t = harness.traffic_of("rag-long-16k")
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
def test_bench_kimi_sound_run_is_correct_and_its_control_is_not(seed):
    r = run(seed, control=True)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["control_correct"] is False, (r["control"], r["checks"])
    assert set(r["metrics"]) == {"answer_tokens_per_s", "answer_p95_ms", "setup_s"}


def test_bench_kimi_step_that_drops_the_kda_state(monkeypatch):
    """A decode step whose KDA layers forget the prompt (a state zeroed
    before each update) comes out not correct."""
    from pathway_tpu_torch.models import kimi_linear

    step = kimi_linear._kda_step

    def forgetful(x, blk, cfg, state, tail):
        state.zero_()
        return step(x, blk, cfg, state, tail)

    monkeypatch.setattr(kimi_linear, "_kda_step", forgetful)
    assert not run()["correct"]


def test_bench_the_model_config_takes_every_key():
    cfg = gen.model_config(MODEL)
    assert cfg.kda_layers == (1, 2, 3, 5) and cfg.experts_held == range(0, 8) and not cfg.mla_rope
    full = harness.config_of(harness.load_spec(), "kimi-linear-48b-a3b")
    big = gen.model_config(full["model"])
    assert big.max_len == full["model_max_length"] == 16384
    assert len(big.experts_held) == full["num_experts"] == 64
    assert big.n_routed_experts == full["published"]["num_experts"] == 256
    assert list(big.kda_layers) == full["linear_attn_config"]["kda_layers"]


def test_bench_prompts_keep_the_corpus_seeded_order(monkeypatch):
    """The callers are dealt the corpus's prompts in its seeded order, as
    ``chat_closed`` deals them: the generator neither sorts nor reorders
    the mix's draw (set-up is stopped once the prompts are made)."""
    from benchmark import corpus

    class Stop(Exception):
        pass

    def stop(model):
        raise Stop

    monkeypatch.setattr(gen, "model_config", stop)
    t = traffic()
    run = gen.Run.__new__(gen.Run)
    with pytest.raises(Stop):
        run.__init__(MODEL, t, SEEDS[0], "cpu", None)
    assert run.prompts == corpus.prompts(t, SEEDS[0])
    lengths = [n for _, n in run.prompts]
    assert lengths != sorted(lengths)


# ------------------------------------------------------------ the readers

M = {**MODEL, "kda_heads": 32, "kda_head_dim": 128}


def _read(name: str, rec: dict):
    return harness.metric_module(name).read(rec)


NEW = (
    "mfu.kimi", "kda_device_ms.kimi", "kda_roofline.kimi", "kda_prefill_share.kimi", "mla_device_ms.kimi",
    "moe_device_ms.kimi", "decode_step_ms.kimi", "prefill_share.kimi", "idle_share.kimi",
    "step_launch_ms.kimi", "step_sync_ms.kimi", "prefill_launch_ms.kimi", "prefill_sync_ms.kimi",
    "queue_wait_ms.kimi", "decode_device_ms.kimi", "expert_load_max.kimi", "mla_roofline.kimi",
    "moe_roofline.kimi",
)


@pytest.mark.parametrize("name", NEW)
def test_bench_kimi_readers_read_nothing_from_an_empty_record(name):
    assert _read(name, {}) is None
    # a record of the Moonlight cell's kind: its layer steps, no parts
    parent = {"stats": {"decode_steps": 0, "prefills": 0}, "model": {"d_model": 8, "kv_lora_rank": 4},
              "requests": [], "trace": None, "window_s": 1.0, "new_tokens": 4,
              "layer_steps": [{"rows": 1, "keys": 2, "mla_s": 0.1, "moe_s": 0.1}]}
    assert _read(name, parent) is None


def test_bench_kimi_readers_by_hand():
    steps = [
        {"rows": 4, "keys": 100, "kda_s": 0.004, "mla_s": 0.002, "moe_s": 0.003, "total_s": 0.010,
         "moe_assignments": 40, "moe_experts_hit": 30},
        {"rows": 2, "keys": 50, "kda_s": 0.002, "mla_s": 0.004, "moe_s": 0.001, "total_s": 0.008,
         "moe_assignments": 20, "moe_experts_hit": 18},
    ]
    prefills = [
        {"tokens": 60, "kda_s": 0.03, "mla_s": 0.01, "moe_s": 0.02, "total_s": 0.07},
        {"tokens": 20, "kda_s": 0.01, "mla_s": 0.005, "moe_s": 0.01, "total_s": 0.03},
    ]
    rec = {
        "model": M, "window_s": 10.0, "new_tokens": 4, "part_steps": steps, "part_prefills": prefills,
        "requests": [(1.0, 3.0, 20)],
        "stats": {
            "decode_steps": 40, "prefills": 4, "step_seconds": 1.2, "prefill_seconds": 0.5,
            "step_launch_seconds": 0.8, "step_sync_seconds": 0.4, "prefill_launch_seconds": 0.3,
            "prefill_sync_seconds": 0.2, "queue_seconds": 6.0, "moe_assignments": 800, "moe_max_load": 250,
        },
        "trace": {"busy_s": 0.5, "window_s": 2.0, "segments": {"decode_step": [(0.0, 0.02), (0.1, 0.04)]}},
    }
    assert _read("kda_device_ms.kimi", rec) == pytest.approx(3.0)
    assert _read("mla_device_ms.kimi", rec) == pytest.approx(3.0)
    assert _read("moe_device_ms.kimi", rec) == pytest.approx(2.0)
    least = rl.least_s(*rl.kda_step(4, M)) + rl.least_s(*rl.kda_step(2, M))
    assert _read("kda_roofline.kimi", rec) == pytest.approx(100 * least / 0.006)
    assert _read("kda_prefill_share.kimi", rec) == pytest.approx(40.0)
    w = rl.answer_work(rec["requests"], 10.0, 4, M)
    assert _read("mfu.kimi", rec) == pytest.approx(100 * (w["prefill_flops"] + w["decode_flops"]) / (10.0 * rl.BF16_FLOPS))
    assert _read("decode_step_ms.kimi", rec) == pytest.approx(30.0)
    assert _read("prefill_share.kimi", rec) == pytest.approx(5.0)
    assert _read("idle_share.kimi", rec) == pytest.approx(75.0)
    assert _read("step_launch_ms.kimi", rec) == pytest.approx(20.0)
    assert _read("step_sync_ms.kimi", rec) == pytest.approx(10.0)
    assert _read("prefill_launch_ms.kimi", rec) == pytest.approx(75.0)
    assert _read("prefill_sync_ms.kimi", rec) == pytest.approx(50.0)
    assert _read("queue_wait_ms.kimi", rec) == pytest.approx(1500.0)
    assert _read("decode_device_ms.kimi", rec) == pytest.approx(30.0)
    # 800 choices among the 8 held experts: 100 each on an even load
    assert _read("expert_load_max.kimi", rec) == pytest.approx(2.5)
    # latent attention in the one MLA layer of the five
    one = {**M, "n_layers": 1}
    least = rl_mla.least_s(*rl_mla.mla_step(4, 100, one)) + rl_mla.least_s(*rl_mla.mla_step(2, 50, one))
    assert _read("mla_roofline.kimi", rec) == pytest.approx(100 * least / 0.006)
    least = rl_mla.least_s(*rl_mla.moe_step(4, 40, 30, M)) + rl_mla.least_s(*rl_mla.moe_step(2, 20, 18, M))
    assert _read("moe_roofline.kimi", rec) == pytest.approx(100 * least / 0.004)


# -------------------------------------------------------------- the counts

R = {
    "vocab_size": 100, "d_model": 8, "n_heads": 2, "n_layers": 4, "d_ff": 24, "kv_lora_rank": 4,
    "qk_nope_head_dim": 4, "qk_rope_head_dim": 2, "v_head_dim": 3, "kda_layers": [1, 2, 3], "kda_heads": 2,
    "kda_head_dim": 3, "kda_conv": 4, "kda_gate_rank": 5, "n_routed_experts": 8, "experts_held": [2, 6],
    "n_experts_per_tok": 2, "n_shared_experts": 1, "moe_d_ff": 6, "first_k_dense": 1,
}


def test_bench_roofline_kda_by_hand():
    # W_qkv 8 x 18, conv 18 x 4, W_beta 8 x 2, W_fa 8 x 5 and W_fb 5 x 6 (twice, the gate's too),
    # W_o 6 x 8, the output norm 3, the block's norm 8; A_log 2 and dt_bias 6 in f32
    assert rl.kda_weights(R) == (144 + 72 + 16 + 2 * (40 + 30) + 48 + 3 + 8, 8)
    assert rl.kda_token_flops(R) == 7 * 2 * 9
    assert rl.held_share(R) == 0.5
    assert (rl.kda_layers(R), rl.mla_layers(R)) == (3, 1)
    # one MLA layer (260, as roofline_mla_moe counts it at these widths), three KDA layers (431 + 8),
    # one dense layer (584), three expert layers of 2 x 0.5 routed experts (144) and the
    # shared expert, router (8 x 8) and norm (144 + 64 + 8)
    assert rl_mla.mla_weights(R) == 260
    active = 260 + 3 * (431 + 8) + 584 + 3 * (2 * 0.5 * 144 + 216)
    assert rl.active_weights(R) == pytest.approx(active)
    # a prefill pair: 2 x (4 + 2 + 3) x 2 heads in the one MLA layer; a decode key: 2 x (8 + 2) x 2
    assert rl.prefill_pair_flops(R) == 36
    assert rl.decode_key_flops(R) == 40
    head = 8 * 101
    assert rl.prefill_flops(3, R) == pytest.approx(2 * 3 * active + 3 * 3 * 126 + 36 * 6 + 2 * head)
    assert rl.decode_flops(2, 9, R) == pytest.approx(2 * (2 * (active + head) + 3 * 126) + 40 * 9)
    # a step of 2 rows: weights once, each row's f32 state (2 x 3 x 3) and its
    # conv tail (3 x 18) read and written, its hidden state in and out
    f, b = rl.kda_step(2, R)
    assert f == 3 * 2 * (2 * (431 + 8) + 126)
    assert b == 3 * (431 * 2 + 8 * 4 + 2 * (2 * 18 * 4 + 2 * 54 * 2 + 2 * 8 * 2))
    # the decode step's latent attention in the one MLA layer: its weights, 9 keys and 2 new
    # entries of 4 + 2, each row's hidden state in and out
    f, b = rl.mla_step(2, 9, R)
    assert f == 2 * 2 * 260 + 40 * 11
    assert b == 260 * 2 + 11 * 6 * 2 + 2 * 2 * 8 * 2
    assert rl.least_s(989e12, 0) == pytest.approx(1.0)
    assert rl.least_s(0, 3.35e12) == pytest.approx(1.0)


def test_bench_answer_work_counts_the_kimi_model():
    reqs = [(1.0, 3.0, 4), (-2.0, 2.0, 4)]
    w = rl.answer_work(reqs, 10.0, 3, R)
    assert w["prefill_flops"] == rl.prefill_flops(4, R)
    assert w["decode_rows"] == pytest.approx(3)
    assert w["decode_keys"] == pytest.approx(11 + 5.5)


# ---------------------------------------------------- parts by correlation


def test_bench_layer_parts_split_steps_and_prefills_by_launch():
    # span stamps + 10_000 = wall clock; the trace's clock is the wall clock + 500
    ring = [
        {"name": "cb.step", "id": 1, "parent": 0, "start_ns": 1000, "end_ns": 9000,
         "attrs": {"rows": 3, "keys": 30}},
        {"name": "cb.step.launch", "id": 2, "parent": 1, "start_ns": 1100, "end_ns": 5000, "attrs": {}},
        {"name": "lm.kda", "id": 3, "parent": 2, "start_ns": 1200, "end_ns": 2000, "attrs": {}},
        {"name": "lm.moe", "id": 4, "parent": 2, "start_ns": 2000, "end_ns": 3000, "attrs": {}},
        {"name": "lm.mla", "id": 5, "parent": 2, "start_ns": 3000, "end_ns": 4000, "attrs": {}},
        {"name": "cb.prefill", "id": 6, "parent": 77, "start_ns": 20000, "end_ns": 30000,
         "attrs": {"slot": 1, "tokens": 40}},
        {"name": "cb.prefill.launch", "id": 7, "parent": 6, "start_ns": 20100, "end_ns": 25000, "attrs": {}},
        {"name": "lm.kda", "id": 8, "parent": 7, "start_ns": 20200, "end_ns": 21000, "attrs": {}},
        {"name": "lm.mla", "id": 9, "parent": 99, "start_ns": 40000, "end_ns": 41000, "attrs": {}},
    ]
    shift = 10_000 + 500
    events = [
        _Ev("CPU", CLOCK, 10_600, 10_700, ann=True),
        _Ev("CPU", "cudaLaunchKernel", 1300 + shift, 1310 + shift, corr=7),
        _Ev("CPU", "cudaLaunchKernel", 1500 + shift, 1510 + shift, corr=8),
        _Ev("CPU", "cudaMemsetAsync", 2100 + shift, 2110 + shift, corr=9),
        _Ev("CPU", "cudaLaunchKernel", 3100 + shift, 3110 + shift, corr=10),
        _Ev("CPU", "cudaLaunchKernel", 4500 + shift, 4510 + shift, corr=11),  # the step's head
        _Ev("CPU", "cudaLaunchKernel", 20300 + shift, 20310 + shift, corr=12),
        _Ev("CPU", "cudaLaunchKernel", 22000 + shift, 22010 + shift, corr=13),
        _Ev("CPU", "cudaLaunchKernel", 40100 + shift, 40110 + shift, corr=14),  # under no phase
        _Ev("CUDA", "k7", 1400 + shift, 1900 + shift, corr=7),
        _Ev("CUDA", "k8", 1800 + shift, 2400 + shift, corr=8),  # overlaps k7: the union counts
        _Ev("CUDA", "k9", 2500 + shift, 2800 + shift, corr=9),
        _Ev("CUDA", "k10", 3200 + shift, 3400 + shift, corr=10),
        _Ev("CUDA", "k11", 4600 + shift, 4700 + shift, corr=11),
        _Ev("CUDA", "k12", 20400 + shift, 21400 + shift, corr=12),
        _Ev("CUDA", "k13", 22100 + shift, 22600 + shift, corr=13),
        _Ev("CUDA", "k14", 40200 + shift, 49000 + shift, corr=14),
    ]
    out = gen.layer_parts(events, 10_100, ring, 10_000)
    assert out["steps"] == [{"rows": 3, "keys": 30, "kda_s": 1000e-9, "mla_s": 200e-9, "moe_s": 300e-9,
                             "total_s": 1600e-9}]
    assert out["prefills"] == [{"slot": 1, "tokens": 40, "kda_s": 1000e-9, "mla_s": 0.0, "moe_s": 0.0,
                                "total_s": 1500e-9}]
    assert gen.layer_parts(events[:1], 10_100, ring, 10_000) == {"steps": [], "prefills": []}
    # a kernel whose launch record was lost, inside the prefill's device
    # time: the prefill cannot be split and is left out, the step stays
    lost = _Ev("CUDA", "k15", 21500 + shift, 21600 + shift, corr=15)
    out = gen.layer_parts(events + [lost], 10_100, ring, 10_000)
    assert len(out["steps"]) == 1 and out["prefills"] == []
