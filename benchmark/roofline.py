"""The chip's peaks and the arithmetic of least times.

Peaks: the NVIDIA H100 SXM data sheet, dense rates without sparsity, at
the card's full 700 W limit (a run prints the card's own limit beside
them): 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in f32
outside them, 3.35 TB/s of HBM3.

Frozen copies, from ``chip_smoke.py`` at commit a5f5f3e, never imported
from it: ``cuda_ms`` (:405), ``percentile_ms`` (:2540) and
``attention_bound`` (:448). ``busy_union`` replaces the busy sum of
``profile_window`` (:3066) by the union of the device's intervals, so
that kernels that overlap on two streams count once.

A least time counts what the inputs need: each input byte read once,
each output byte written once, and the operations of the real tokens and
real contexts, never of a padded bucket or of the whole cache.
"""

from __future__ import annotations

import statistics

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def cuda_ms(fn, reps: int, rounds: int = 3) -> float:
    """Device time of one call: CUDA events around `reps` calls launched
    back to back, over the count, after one warm-up call; the median of
    `rounds` such runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def percentile_ms(xs: list[float], p: float) -> float | None:
    """Nearest-rank percentile of seconds, in ms."""
    if not xs:
        return None
    xs = sorted(xs)
    return 1e3 * xs[min(int(round(p / 100.0 * (len(xs) - 1))), len(xs) - 1)]


def attention_bound(b: int, s: int, d: int, h: int, dtype: str = "bf16") -> tuple[float, str, int, int]:
    """Least time of one attention launch over b rows of s tokens, in ms:
    qkv and the mask read once, ctx written once (2 or 4 bytes an
    element), over the HBM rate; against 4*b*h*s*s*dh flops (q.k^T and
    p.v) over the bf16 tensor-core rate, or the f32 rate at f32."""
    esize = 4 if dtype == "f32" else 2
    nbytes = b * s * 3 * d * esize + b * s * 4 + b * s * d * esize
    flops = 4 * b * h * s * s * (d // h)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / (F32_FLOPS if dtype == "f32" else BF16_FLOPS)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, bound_by, nbytes, flops


def attention_least_s(lengths, d: int, h: int, dtype: str = "bf16") -> float:
    """Least seconds of one attention launch over rows of the given real
    lengths: ``attention_bound``'s count summed row by row at each row's
    own length, the bytes and the operations each over its peak."""
    esize = 4 if dtype == "f32" else 2
    n = [int(x) for x in lengths]
    nbytes = sum(k * 3 * d * esize + k * 4 + k * d * esize for k in n)
    flops = sum(4 * h * k * k * (d // h) for k in n)
    return max(nbytes / HBM_BYTES_PER_S, flops / (F32_FLOPS if dtype == "f32" else BF16_FLOPS))


def block_weights(cfg: dict) -> int:
    """Weights of the projections of every block: qkv, o, ff_in, ff_out."""
    d, f = cfg["d_model"], cfg["d_ff"]
    return cfg["n_layers"] * (4 * d * d + 2 * d * f)


def encoder_flops(n: int, cfg: dict) -> int:
    """Model operations of one chunk of n real tokens through the
    encoder: 2 a weight a token for the projections, 4*n*d a layer a
    token for q.k and p.v over its n keys, and the pooled head once."""
    d, e = cfg["d_model"], cfg.get("embed_dim") or cfg["d_model"]
    return 2 * n * block_weights(cfg) + 4 * n * n * d * cfg["n_layers"] + 2 * d * e


def prefill_flops(p: int, cfg: dict) -> int:
    """Model operations of a prompt of p real tokens: 2 a weight a token
    for the projections, 4*i*d a layer for the i-th token's causal
    attention over i keys, and the tied logits of the last position."""
    d = cfg["d_model"]
    return 2 * p * block_weights(cfg) + 2 * p * (p + 1) * d * cfg["n_layers"] + 2 * cfg["vocab_size"] * d


def decode_flops(rows: float, keys: float, cfg: dict) -> float:
    """Model operations of decoding `rows` tokens that attend over `keys`
    real keys in all: the projections and the tied logits of each row,
    and q.k and p.v over each key."""
    d = cfg["d_model"]
    return 2 * rows * (block_weights(cfg) + cfg["vocab_size"] * d) + 4 * keys * d * cfg["n_layers"]


def decode_bytes(steps: float, rows: float, keys_before: float, cfg: dict) -> float:
    """Bytes that `steps` decode steps over `rows` row-steps in all need:
    the block weights and the tied embedding read once a step; the keys
    and values before each row's position read once (`keys_before` of
    them); each row's new key and value written, its embedding rows
    (token and position) read, and its f32 logits written."""
    d, layers, item = cfg["d_model"], cfg["n_layers"], 2  # bf16
    weights = (block_weights(cfg) + cfg["vocab_size"] * d) * item
    per_key = 2 * d * layers * item
    per_row = per_key + 2 * d * item + cfg["vocab_size"] * 4
    return steps * weights + keys_before * per_key + rows * per_row


def decode_least_s(rows: int, keys_before: int, cfg: dict) -> float:
    """Least seconds of one decode step over `rows` rows with
    `keys_before` real keys before their new tokens in all: its bytes
    (:func:`decode_bytes`) over the HBM rate against its operations
    (:func:`decode_flops`, each row attending its new key too) over the
    bf16 peak."""
    return max(
        decode_bytes(1, rows, keys_before, cfg) / HBM_BYTES_PER_S,
        decode_flops(rows, keys_before + rows, cfg) / BF16_FLOPS,
    )


def answer_work(requests, window_s: float, new_tokens: int, cfg: dict) -> dict:
    """The decoder's work inside a window of `window_s` seconds, from the
    requests (sent, done, prompt tokens), times relative to the window's
    start. A prompt counts when it was sent in the window. A request's
    new_tokens - 1 decode steps (the first token comes from its prefill)
    attend over p + 1 .. p + new_tokens - 1 keys; they are spread evenly
    over its time from sent to done, and the share inside the window
    counts."""
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
    return {
        "prefill_flops": prefill,
        "decode_rows": rows,
        "decode_keys": keys,
        "decode_flops": decode_flops(rows, keys, cfg),
    }


def busy_union(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total = 0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total
