"""Seeded weights, made on the device in a few large calls.

The benchmark makes the weights and hands the same numbers to the
program and, made again from the seed after the program is gone, to the
plain reference. The tree has the parameter layout the port's
``models/transformer.py`` takes (projections laid out [d_in, d_out]);
the scales are its ``init_params``'s (projections 1/sqrt(d_in),
embeddings 0.02), and the norm scales are drawn around 1 so that a norm
that dropped its scale would show. Each group of leaves of one scale is
one ``torch.randn`` in the served dtype on the generator's device,
scaled in place; the leaves are views of it.
"""

from __future__ import annotations

import math

import torch


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}[name]


def make(cfg: dict, seed: int, device, dtype: torch.dtype | None = None) -> dict:
    """The parameter tree of `cfg` (a configuration file's ``model``
    keys) from `seed`, in `dtype` (default the configuration's)."""
    dtype = dtype or torch_dtype(cfg["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    d, f, layers = cfg["d_model"], cfg["d_ff"], cfg["n_layers"]
    e = cfg.get("embed_dim") or d
    vocab, max_len = cfg["vocab_size"], cfg["max_len"]

    def draw(n: int, std: float, mean: float = 0.0) -> torch.Tensor:
        x = torch.randn(n, generator=gen, device=device, dtype=dtype).mul_(std)
        return x.add_(mean) if mean else x

    wide = draw(layers * (4 * d * d + d * f) + d * e, 1.0 / math.sqrt(d))
    narrow = draw(layers * f * d, 1.0 / math.sqrt(f))
    embed = draw((vocab + max_len) * d, 0.02)
    norms = draw((2 * layers + 1) * d, 0.1, mean=1.0)

    def take(buf: torch.Tensor, at: list, shape: tuple) -> torch.Tensor:
        n = math.prod(shape)
        out = buf[at[0]:at[0] + n].view(shape)
        at[0] += n
        return out

    w, nw, em, nm = [0], [0], [0], [0]
    blocks = []
    for _ in range(layers):
        blocks.append({
            "qkv": take(wide, w, (d, 3 * d)),
            "o": take(wide, w, (d, d)),
            "ff_in": take(wide, w, (d, f)),
            "ff_out": take(narrow, nw, (f, d)),
            "ln1_scale": take(norms, nm, (d,)),
            "ln2_scale": take(norms, nm, (d,)),
        })
    return {
        "tok_embed": take(embed, em, (vocab, d)),
        "pos_embed": take(embed, em, (max_len, d)),
        "ln_f_scale": take(norms, nm, (d,)),
        "head": take(wide, w, (d, e)),
        "blocks": blocks,
    }


def to_f32(params: dict) -> dict:
    """An f32 copy of the tree, leaf by leaf."""
    return {
        k: [{bk: bv.float() for bk, bv in blk.items()} for blk in v] if k == "blocks" else v.float()
        for k, v in params.items()
    }
