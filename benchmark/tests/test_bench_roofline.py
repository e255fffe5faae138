"""Every operation and byte count against a hand count at a small shape,
and the per-layer readers on a record made by hand."""

import pytest

from benchmark import harness, roofline

ENC = {"vocab_size": 100, "d_model": 8, "n_heads": 2, "n_layers": 3, "d_ff": 16, "embed_dim": 4, "dtype": "bfloat16"}
DEC = {"vocab_size": 100, "d_model": 8, "n_heads": 2, "n_layers": 3, "d_ff": 16, "dtype": "bfloat16"}


def test_bench_block_weights():
    # qkv 8x24 + o 8x8 + ff_in 8x16 + ff_out 16x8, three layers
    assert roofline.block_weights(ENC) == 3 * (192 + 64 + 128 + 128)


def test_bench_encoder_flops():
    # a chunk of 5 tokens: 2 x 5 x 1536 + 4 x 5 x 5 x 8 x 3 + 2 x 8 x 4
    assert roofline.encoder_flops(5, ENC) == 2 * 5 * 1536 + 4 * 25 * 8 * 3 + 64


def test_bench_attention_least_s():
    # rows of 3 and 5 tokens, d 8, h 2, bf16: bytes (3 + 5) x (24 + 8) x 2
    # + (3 + 5) x 4; flops 4 x 2 x (9 + 25) x 4
    nbytes = 8 * 32 * 2 + 8 * 4
    flops = 4 * 2 * 34 * 4
    want = max(nbytes / roofline.HBM_BYTES_PER_S, flops / roofline.BF16_FLOPS)
    assert roofline.attention_least_s([3, 5], 8, 2) == pytest.approx(want, rel=1e-12)
    # a full batch at one length is attention_bound's count
    ms, _, b, f = roofline.attention_bound(2, 5, 8, 2)
    assert roofline.attention_least_s([5, 5], 8, 2) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_bench_prefill_and_decode_flops():
    # prompt of 4: projections 2 x 4 x 1536, causal attention 4 x (1+2+3+4) x 8 x 3,
    # tied logits of the last position 2 x 100 x 8
    assert roofline.prefill_flops(4, DEC) == 2 * 4 * 1536 + 4 * 10 * 8 * 3 + 1600
    # two rows over 6 and 7 keys: projections and logits 2 x 2 x (1536 + 800), keys 4 x 13 x 8 x 3
    assert roofline.decode_flops(2, 13, DEC) == 2 * 2 * 2336 + 4 * 13 * 8 * 3


def test_bench_decode_bytes():
    # one step, two rows with 6 and 7 keys (5 and 6 read before their own):
    # weights (1536 + 800) x 2 once; keys read 11 x (2 x 8 x 3 x 2);
    # per row the new key and value 96, embedding rows 2 x 8 x 2, logits 100 x 4
    want = 2336 * 2 + 11 * 96 + 2 * (96 + 32 + 400)
    assert roofline.decode_bytes(1, 2, 11, DEC) == want


def test_bench_answer_work_apportions_by_time():
    # one request inside a 10 s window, one half inside (sent at -2, done at 2)
    reqs = [(1.0, 3.0, 4), (-2.0, 2.0, 4)]
    w = roofline.answer_work(reqs, 10.0, 3, DEC)
    assert w["prefill_flops"] == roofline.prefill_flops(4, DEC)
    # 2 decode steps a request, over 5 and 6 keys: 11 keys
    assert w["decode_rows"] == pytest.approx(2 + 1)
    assert w["decode_keys"] == pytest.approx(11 + 5.5)


def test_bench_busy_union_and_percentile():
    assert roofline.busy_union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert roofline.busy_union([]) == 0
    assert roofline.percentile_ms([0.1 * i for i in range(1, 21)], 95) == pytest.approx(1900.0)
    assert roofline.percentile_ms([], 95) is None


def test_bench_metric_readers_by_hand():
    rec = {
        "window_s": 2.0, "model": dict(ENC, max_len=16), "spans": {"tokenize": 1.5},
        "calls": [[3, 5], [5, 5]],
        "trace": {"busy_s": 0.5, "window_s": 2.0, "kernel_s": {"void wgmma_attention_kernel<x>": 1e-6, "gemm": 1.0}},
    }
    read = lambda n: harness.metric_module(n).read(rec)  # noqa: E731
    assert read("tokenize_share.embed") == pytest.approx(75.0)
    flops = 2 * roofline.encoder_flops(5, rec["model"]) + roofline.encoder_flops(3, rec["model"]) + roofline.encoder_flops(5, rec["model"])
    assert read("mfu.embed") == pytest.approx(100 * flops / (2.0 * roofline.BF16_FLOPS))
    least = 3 * (roofline.attention_least_s([3, 5], 8, 2) + roofline.attention_least_s([5, 5], 8, 2))
    assert read("k1_roofline.embed") == pytest.approx(100 * least / 1e-6)
    assert read("idle_share.embed") == pytest.approx(75.0)

    ans = {
        "window_s": 10.0, "model": dict(DEC, max_len=16), "new_tokens": 3,
        "requests": [(1.0, 3.0, 4)],
        "stats": {"decode_steps": 4, "step_seconds": 0.02, "prefills": 1, "prefill_seconds": 0.5},
        "trace": {
            "busy_s": 4.0, "window_s": 8.0, "kernel_s": {},
            # two traced decode steps: (rows, real keys before), device seconds
            "segments": {"decode_step": [[[2, 9], 0.004], [[2, 10], 0.006]], "prefill": [[None, 0.5]]},
        },
    }
    read = lambda n: harness.metric_module(n).read(ans)  # noqa: E731
    assert read("decode_step_ms.answer") == pytest.approx(5.0)
    assert read("prefill_share.answer") == pytest.approx(5.0)
    assert read("idle_share.answer") == pytest.approx(50.0)
    want = roofline.prefill_flops(4, DEC) + roofline.decode_flops(2, 11, DEC)
    assert read("mfu.answer") == pytest.approx(100 * want / (10.0 * roofline.BF16_FLOPS))
    least = sum(
        max(roofline.decode_bytes(1, 2, k, DEC) / roofline.HBM_BYTES_PER_S, roofline.decode_flops(2, k + 2, DEC) / roofline.BF16_FLOPS)
        for k in (9, 10)
    )
    assert read("decode_roofline.answer") == pytest.approx(100 * least / 0.01)
    assert read("decode_device_ms.answer") == pytest.approx(5.0)


@pytest.mark.parametrize("metric", [m["name"] for m in harness.load_spec()["per_layer"]])
def test_bench_metric_reads_nothing_from_an_empty_record(metric):
    rec = {"window_s": 1.0, "model": dict(DEC, max_len=16), "spans": {}, "calls": [], "requests": [],
           "stats": {"decode_steps": 0, "step_seconds": 0.0, "prefills": 0, "prefill_seconds": 0.0},
           "trace": None, "new_tokens": 3}
    assert harness.metric_module(metric).read(rec) is None
