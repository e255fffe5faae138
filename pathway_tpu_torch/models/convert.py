"""Parameter bridge from the JAX package's transformer to the port's.

``pathway_tpu.models.transformer.init_params`` draws from ``jax.random``,
which no ``torch.Generator`` reproduces, so parity runs carry the JAX
parameter tree across as numpy arrays. Both packages lay weights out
[d_in, d_out] (the product is ``x @ W``), so the bridge is a copy with a
shape check, never a transpose. The encoder and the causal LM share one
tree (the LM ties its logits to ``tok_embed`` and leaves ``head`` unused),
so the bridge takes both. Random parameters at full width are made on the
card by ``transformer.init_params(generator, cfg, dtype=torch.bfloat16)``,
leaf by leaf.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from pathway_tpu_torch.engine.device_plane import resolve_device
from pathway_tpu_torch.models.transformer import Params, TransformerConfig


def param_shapes(cfg: TransformerConfig) -> dict[str, Any]:
    """The parameter tree's leaf shapes for `cfg`."""
    d, f = cfg.d_model, cfg.d_ff
    block = {
        "qkv": (d, 3 * d), "o": (d, d), "ff_in": (d, f), "ff_out": (f, d),
        "ln1_scale": (d,), "ln2_scale": (d,),
    }
    return {
        "tok_embed": (cfg.vocab_size, d),
        "pos_embed": (cfg.max_len, d),
        "ln_f_scale": (d,),
        "head": (d, cfg.embed_dim or d),
        "blocks": [block] * cfg.n_layers,
    }


def params_from_numpy(
    tree: dict[str, Any],
    cfg: TransformerConfig,
    device: str | torch.device | None = None,
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Port parameters from a parameter tree with the JAX package's
    layout whose leaves are numpy arrays (or anything ``np.asarray``
    takes, bf16 included). Raises on a missing or extra key and on a
    shape that does not fit `cfg`."""
    dev = resolve_device(device)

    def leaf(x: Any, shape: tuple[int, ...], where: str) -> torch.Tensor:
        a = np.asarray(x)
        if a.shape != shape:
            raise ValueError(f"{where}: shape {a.shape}, expected {shape} for {cfg}")
        return torch.from_numpy(a.astype(np.float32)).to(device=dev, dtype=dtype)

    def check_keys(got: dict, want: dict, where: str) -> None:
        if set(got) != set(want):
            raise ValueError(
                f"{where}: keys {sorted(got)}, expected {sorted(want)}"
            )

    shapes = param_shapes(cfg)
    check_keys(tree, shapes, "params")
    if len(tree["blocks"]) != cfg.n_layers:
        raise ValueError(
            f"params: {len(tree['blocks'])} blocks, expected {cfg.n_layers}"
        )
    out: Params = {
        k: leaf(tree[k], shapes[k], k) for k in shapes if k != "blocks"
    }
    blocks = []
    for i, (blk, want) in enumerate(zip(tree["blocks"], shapes["blocks"])):
        check_keys(blk, want, f"blocks[{i}]")
        blocks.append({k: leaf(blk[k], want[k], f"blocks[{i}].{k}") for k in want})
    out["blocks"] = blocks
    return out
