"""Operations and bytes of the DeepSeek-V3 family (latent attention and
routed experts), and their least times on the chip.

They count the work the model needs, whatever implements it: the active
parameters of each real token (its ``n_experts_per_tok`` routed experts
and the shared ones, or a dense layer's SwiGLU; latent attention's
projections; the untied head where a token's logits are taken), each at
2 operations a weight; attention over each token's real context, never
a padded bucket or the whole cache; and in a decode step each weight
read once, each expert only if a token chose it, each row's latent
entries before its new token read once and its new entry written once.

Attention's operations a query and key a head: a prefill decompresses
the latent (its W_kvb product is a weight of every token) and takes
q.k over nope + rope and p.v over v: 2 * (nope + rope + v); a decode step
takes q in the latent (W_kvb's halves are weights of each row) and reads
the cache rows as they are: 2 * (kv_lora_rank + rope + kv_lora_rank).

The peaks are ``benchmark/roofline.py``'s. `cfg` is a configuration's
``model`` keys; weights and the cache are 2 bytes (bf16).
"""

from __future__ import annotations

from benchmark.roofline import BF16_FLOPS, HBM_BYTES_PER_S

ITEM = 2  # bytes a weight and a cache entry (bf16)


def moe_layers(cfg: dict) -> int:
    return cfg["n_layers"] - cfg["first_k_dense"]


def mla_weights(cfg: dict) -> int:
    """Weights of one layer's latent attention: W_q, W_kva, W_kvb, W_o
    and the two norms before it (the block's and c_kv's)."""
    d, h, r = cfg["d_model"], cfg["n_heads"], cfg["kv_lora_rank"]
    nope, rd, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return d * h * (nope + rd) + d * (r + rd) + r * h * (nope + dv) + h * dv * d + d + r


def expert_weights(cfg: dict) -> int:
    """Weights of one routed expert (gate, up, down)."""
    return 3 * cfg["d_model"] * cfg["moe_d_ff"]


def shared_weights(cfg: dict) -> int:
    """Weights of one layer's shared experts, its router and its norm."""
    d = cfg["d_model"]
    return 3 * d * cfg["n_shared_experts"] * cfg["moe_d_ff"] + d * cfg["n_routed_experts"] + d


def dense_weights(cfg: dict) -> int:
    """Weights of one dense layer's SwiGLU and its norm."""
    return 3 * cfg["d_model"] * cfg["d_ff"] + cfg["d_model"]


def ffn_active_weights(cfg: dict) -> int:
    """Feed-forward weights one token uses in all layers."""
    routed = cfg["n_experts_per_tok"] * expert_weights(cfg) + shared_weights(cfg)
    return cfg["first_k_dense"] * dense_weights(cfg) + moe_layers(cfg) * routed


def active_weights(cfg: dict) -> int:
    """Weights one token uses below the head: latent attention in every
    layer and its feed-forward."""
    return cfg["n_layers"] * mla_weights(cfg) + ffn_active_weights(cfg)


def head_weights(cfg: dict) -> int:
    """The final norm and the untied head."""
    return cfg["d_model"] * (cfg["vocab_size"] + 1)


def prefill_pair_flops(cfg: dict) -> int:
    """Operations of one query and one key in all layers' prefill attention."""
    per_head = 2 * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"])
    return per_head * cfg["n_heads"] * cfg["n_layers"]


def decode_key_flops(cfg: dict) -> int:
    """Operations of one row over one key in all layers' decode attention."""
    per_head = 2 * (2 * cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"])
    return per_head * cfg["n_heads"] * cfg["n_layers"]


def prefill_flops(p: int, cfg: dict) -> int:
    """A prompt of p real tokens: every token's active weights, the i-th
    token's causal attention over i keys, and the logits of the last."""
    return 2 * p * active_weights(cfg) + prefill_pair_flops(cfg) * p * (p + 1) // 2 + 2 * head_weights(cfg)


def decode_flops(rows: float, keys: float, cfg: dict) -> float:
    """`rows` decoded tokens attending over `keys` real keys in all (each
    row's own new key included): active weights and the head of each."""
    return 2 * rows * (active_weights(cfg) + head_weights(cfg)) + decode_key_flops(cfg) * keys


def mla_step(rows: int, keys_before: int, cfg: dict) -> tuple[float, float]:
    """(operations, bytes) of one decode step's latent attention in all
    layers: `rows` rows with `keys_before` real cache entries before
    their new tokens. Bytes: the weights once, the entries before read,
    each new entry written, each row's hidden state read and written."""
    layers, d = cfg["n_layers"], cfg["d_model"]
    entry = (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]) * ITEM
    flops = 2 * rows * layers * mla_weights(cfg) + decode_key_flops(cfg) * (keys_before + rows)
    nbytes = layers * (mla_weights(cfg) * ITEM + (keys_before + rows) * entry + 2 * rows * d * ITEM)
    return flops, nbytes


def moe_step(rows: int, assignments: int, experts_hit: int, cfg: dict) -> tuple[float, float]:
    """(operations, bytes) of one decode step's feed-forward in all layers
    (the dense layers' SwiGLU, the routers, routed and shared experts):
    `assignments` token-expert choices and `experts_hit` layer-expert
    pairs chosen at least once, each read once."""
    layers, d, moe = cfg["n_layers"], cfg["d_model"], moe_layers(cfg)
    dense = cfg["first_k_dense"] * dense_weights(cfg)
    flops = 2 * rows * (dense + moe * shared_weights(cfg)) + 2 * assignments * expert_weights(cfg)
    weights = dense + moe * shared_weights(cfg) + experts_hit * expert_weights(cfg)
    nbytes = weights * ITEM + layers * 2 * rows * d * ITEM
    return flops, nbytes


def least_s(flops: float, nbytes: float) -> float:
    """The larger of the operations over the bf16 peak and the bytes over
    the HBM rate."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def answer_work(requests, window_s: float, new_tokens: int, cfg: dict) -> dict:
    """The model's operations inside a window of `window_s` seconds, from
    the requests (sent, done, prompt tokens), as
    ``roofline.answer_work`` apportions them: a prompt counts when it was
    sent in the window, a request's new_tokens - 1 decode steps (over p + 1
    .. p + new_tokens - 1 keys) by the share of its time inside it."""
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
