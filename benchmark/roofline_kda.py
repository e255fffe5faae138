"""Operations and bytes of the Kimi Linear family (KDA layers beside latent
attention, a share of the experts held), and their least times on the chip.

They count the work the model needs, whatever implements it, as
``roofline_mla_moe.py`` does: the active parameters of each real token
(latent attention's projections in the MLA layers, KDA's in the others;
the dense SwiGLU, or the router, the shared expert and the held experts'
share of the ``n_experts_per_tok`` choices, their expected number; the
untied head where a token's logits are taken), each at 2 operations a
weight; latent attention over each token's real context in the MLA
layers; and KDA's state work of each token in each KDA layer, the
state's decay, its product with k, the rank-one update and its product
with q: (1 + 3 * 2) * H * K * V operations, a prefill's chunked form
counted as the recurrence it computes.

A decode step's KDA (:func:`kda_step`) reads each KDA weight once, reads
and writes each occupied row's f32 state and its conv tail once, and
reads and writes each row's hidden state. Weights, the latent cache and
the conv tails are 2 bytes (bf16); A_log and dt_bias 4. The peaks are
``benchmark/roofline.py``'s; `cfg` is a configuration's ``model`` keys.
"""

from __future__ import annotations

from benchmark import roofline_mla_moe as rl
from benchmark.roofline import BF16_FLOPS, HBM_BYTES_PER_S

ITEM = rl.ITEM
STATE_ITEM = 4  # bytes an entry of a KDA state (f32)


def kda_layers(cfg: dict) -> int:
    return len(cfg["kda_layers"])


def mla_layers(cfg: dict) -> int:
    return cfg["n_layers"] - kda_layers(cfg)


def kda_weights(cfg: dict) -> tuple[int, int]:
    """Weights of one KDA layer: (those in bf16, those in f32). W_qkv, the
    conv taps, W_beta, the decay's and the gate's low-rank pairs, W_o, the
    output norm and the block's norm; A_log and dt_bias."""
    d, h, kd, r = cfg["d_model"], cfg["kda_heads"], cfg["kda_head_dim"], cfg["kda_gate_rank"]
    p = h * kd
    bf16 = d * 3 * p + 3 * p * cfg["kda_conv"] + d * h + 2 * (d * r + r * p) + p * d + kd + d
    return bf16, h + p


def kda_token_flops(cfg: dict) -> int:
    """Operations of one token's state work in one KDA layer."""
    return 7 * cfg["kda_heads"] * cfg["kda_head_dim"] ** 2


def held_share(cfg: dict) -> float:
    start, stop = cfg["experts_held"]
    return (stop - start) / cfg["n_routed_experts"]


def active_weights(cfg: dict) -> float:
    """Weights one token uses below the head: each layer's token mixing
    and its feed-forward (the held experts' expected share of its
    choices)."""
    moe = cfg["n_layers"] - cfg["first_k_dense"]
    routed = cfg["n_experts_per_tok"] * held_share(cfg) * rl.expert_weights(cfg) + rl.shared_weights(cfg)
    return (
        mla_layers(cfg) * rl.mla_weights(cfg) + kda_layers(cfg) * sum(kda_weights(cfg))
        + cfg["first_k_dense"] * rl.dense_weights(cfg) + moe * routed
    )


def prefill_pair_flops(cfg: dict) -> int:
    """Operations of one query and one key in all MLA layers' prefill."""
    return rl.prefill_pair_flops(cfg) // cfg["n_layers"] * mla_layers(cfg)


def decode_key_flops(cfg: dict) -> int:
    """Operations of one row over one key in all MLA layers' decode."""
    return rl.decode_key_flops(cfg) // cfg["n_layers"] * mla_layers(cfg)


def prefill_flops(p: int, cfg: dict) -> float:
    """A prompt of p real tokens: every token's active weights and KDA
    state work, the i-th token's causal attention over i keys, and the
    logits of the last."""
    return (
        2 * p * active_weights(cfg) + p * kda_layers(cfg) * kda_token_flops(cfg)
        + prefill_pair_flops(cfg) * p * (p + 1) // 2 + 2 * rl.head_weights(cfg)
    )


def decode_flops(rows: float, keys: float, cfg: dict) -> float:
    """`rows` decoded tokens attending over `keys` real keys in all (each
    row's own new key included): active weights, KDA state work and the
    head of each."""
    per_row = 2 * (active_weights(cfg) + rl.head_weights(cfg)) + kda_layers(cfg) * kda_token_flops(cfg)
    return rows * per_row + decode_key_flops(cfg) * keys


def kda_step(rows: int, cfg: dict) -> tuple[float, float]:
    """(operations, bytes) of one decode step's KDA in all KDA layers over
    `rows` occupied rows. Bytes: each weight once, each row's state read
    and written once, its conv tail read and written once, its hidden
    state read and written."""
    d, h, kd, p = cfg["d_model"], cfg["kda_heads"], cfg["kda_head_dim"], cfg["kda_heads"] * cfg["kda_head_dim"]
    bf16, f32 = kda_weights(cfg)
    layers = kda_layers(cfg)
    flops = layers * rows * (2 * (bf16 + f32) + kda_token_flops(cfg))
    state = h * kd * kd * STATE_ITEM
    tail = (cfg["kda_conv"] - 1) * 3 * p * ITEM
    nbytes = layers * (bf16 * ITEM + f32 * STATE_ITEM + rows * (2 * state + 2 * tail + 2 * d * ITEM))
    return flops, nbytes


def mla_step(rows: int, keys_before: int, cfg: dict) -> tuple[float, float]:
    """(operations, bytes) of one decode step's latent attention in the
    MLA layers alone, as ``roofline_mla_moe.mla_step`` counts a layer."""
    return rl.mla_step(rows, keys_before, {**cfg, "n_layers": mla_layers(cfg)})


def least_s(flops: float, nbytes: float) -> float:
    """The larger of the operations over the bf16 peak and the bytes over
    the HBM rate."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def answer_work(requests, window_s: float, new_tokens: int, cfg: dict) -> dict:
    """The model's operations inside a window of `window_s` seconds, from
    the requests (sent, done, prompt tokens), apportioned as
    ``roofline_mla_moe.answer_work`` does."""
    prefill = rows = keys = 0.0
    steps = new_tokens - 1
    for sent, done, p in requests:
        if 0 <= sent < window_s:
            prefill += prefill_flops(p, cfg)
        if done <= sent:
            continue
        share = max(0.0, min(done, window_s) - max(sent, 0.0)) / (done - sent)
        rows += share * steps
        keys += share * (steps * p + steps * (steps + 1) / 2)
    return {"prefill_flops": prefill, "decode_rows": rows, "decode_keys": keys,
            "decode_flops": decode_flops(rows, keys, cfg)}
