"""Bidirectional transformer encoder (mean-pooled text embedder).

Counterpart of the encoder half of ``pathway_tpu/models/transformer.py``:
the same parameter tree (a dict of tensors, weights laid out [d_in, d_out]
so every projection is ``x @ W``), the same forward and the same rounding
points. Every projection multiplies in ``cfg.dtype`` with f32 sums and
rounds once, as the JAX package's einsums with
``preferred_element_type=float32`` do. The attention of each layer is
``ops.attention.fused_qkv_attention``: the CUDA kernel on the card, the
plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn

from pathway_tpu_torch.engine.device_plane import resolve_device
from pathway_tpu_torch.ops.attention import fused_qkv_attention
from pathway_tpu_torch.ops.distances import normalize

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_len: int = 512
    pool: str = "mean"  # encoder pooling: mean | cls | last
    dtype: torch.dtype = torch.bfloat16
    embed_dim: int | None = None  # projection head dim (None = d_model)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def __post_init__(self) -> None:
        if self.pool not in ("mean", "cls", "last"):
            raise ValueError(f"pool must be mean|cls|last, got {self.pool!r}")
        if self.d_model % self.n_heads != 0:
            raise ValueError("d_model must be divisible by n_heads")


def embedder_config(**kw) -> TransformerConfig:
    """SBERT-class text encoder."""
    return TransformerConfig(**kw)


# ------------------------------------------------------------------ params


def _normal(gen: torch.Generator, shape: tuple[int, ...], std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device) * std


def _init_block(gen: torch.Generator, cfg: TransformerConfig) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(d)
    return {
        "qkv": _normal(gen, (d, 3 * d), s),
        "o": _normal(gen, (d, d), s),
        "ff_in": _normal(gen, (d, f), s),
        "ff_out": _normal(gen, (f, d), 1.0 / math.sqrt(f)),
        "ln1_scale": torch.ones(d, device=gen.device),
        "ln2_scale": torch.ones(d, device=gen.device),
    }


def init_params(generator: torch.Generator, cfg: TransformerConfig) -> Params:
    """Random f32 parameters on the generator's device, with the JAX
    package's shapes and scales (not its numbers: ``jax.random`` and a
    ``torch.Generator`` draw differently; ``models.convert`` carries JAX
    parameters across)."""
    e = cfg.embed_dim or cfg.d_model
    return {
        "tok_embed": _normal(generator, (cfg.vocab_size, cfg.d_model), 0.02),
        "pos_embed": _normal(generator, (cfg.max_len, cfg.d_model), 0.02),
        "ln_f_scale": torch.ones(cfg.d_model, device=generator.device),
        "head": _normal(generator, (cfg.d_model, e), 1.0 / math.sqrt(cfg.d_model)),
        "blocks": [_init_block(generator, cfg) for _ in range(cfg.n_layers)],
    }


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], params: Params) -> Params:
    return {
        k: [{bk: fn(bv) for bk, bv in blk.items()} for blk in v] if k == "blocks" else fn(v)
        for k, v in params.items()
    }


def cast_params(params: Params, dtype: torch.dtype = torch.bfloat16) -> Params:
    """Serving parameters: floating leaves cast once to `dtype`."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, params)


# ----------------------------------------------------------------- forward


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def _attention(
    x: torch.Tensor, block: Params, cfg: TransformerConfig, token_mask: torch.Tensor
) -> torch.Tensor:
    qkv = torch.matmul(x, block["qkv"].to(cfg.dtype))
    ctx = fused_qkv_attention(qkv, token_mask, cfg.n_heads)
    return torch.matmul(ctx, block["o"].to(cfg.dtype))


def _ffn(x: torch.Tensor, block: Params, cfg: TransformerConfig) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh form; torch's default is erf. The
    # JAX package applies it to the f32 sum before rounding, the port to
    # the product rounded to cfg.dtype (computed in f32 inside F.gelu).
    hline = F.gelu(torch.matmul(x, block["ff_in"].to(cfg.dtype)), approximate="tanh")
    return torch.matmul(hline, block["ff_out"].to(cfg.dtype))


def _block_fwd(
    x: torch.Tensor, block: Params, cfg: TransformerConfig, token_mask: torch.Tensor
) -> torch.Tensor:
    x = x + _attention(_rmsnorm(x, block["ln1_scale"]), block, cfg, token_mask)
    return x + _ffn(_rmsnorm(x, block["ln2_scale"]), block, cfg)


def forward(
    params: Params, token_ids: torch.Tensor, token_mask: torch.Tensor,
    cfg: TransformerConfig,
) -> torch.Tensor:
    """Hidden states [b, s, d_model] in cfg.dtype."""
    s = token_ids.shape[1]
    if s > cfg.max_len:
        raise ValueError(f"sequence length {s} exceeds max_len={cfg.max_len}")
    x = params["tok_embed"].to(cfg.dtype)[token_ids]
    x = x + params["pos_embed"].to(cfg.dtype)[None, :s, :]
    for block in params["blocks"]:
        x = _block_fwd(x, block, cfg, token_mask)
    return _rmsnorm(x, params["ln_f_scale"])


def encode(
    params: Params, token_ids: torch.Tensor, token_mask: torch.Tensor,
    cfg: TransformerConfig,
) -> torch.Tensor:
    """Pooled, L2-normalized embeddings [b, embed_dim] (f32)."""
    h = forward(params, token_ids, token_mask, cfg)
    if cfg.pool == "mean":
        # mask-and-sum in cfg.dtype, divide in f32 (as the JAX package)
        m16 = token_mask.to(cfg.dtype)[:, :, None]
        part = torch.sum(h * m16, dim=1).float()
        cnt = torch.sum(token_mask, dim=1, keepdim=True).float()
        pooled = part / torch.clamp(cnt, min=1.0)
    elif cfg.pool == "cls":
        pooled = h[:, 0, :].float()
    else:  # last valid token
        idx = torch.clamp(torch.sum(token_mask, dim=1) - 1, min=0)
        pooled = h[torch.arange(h.shape[0], device=h.device), idx, :].float()
    return normalize(pooled @ params["head"].float())


class TransformerEncoder(nn.Module):
    """The encoder as a module: parameters cast to ``cfg.dtype`` and held
    on `device` (default: the CUDA card; raises when there is none)."""

    def __init__(
        self,
        cfg: TransformerConfig,
        params: Params | None = None,
        *,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            params = init_params(generator or torch.Generator().manual_seed(0), cfg)
        params = cast_params(params, cfg.dtype)
        self.cfg = cfg

        def held(t: torch.Tensor) -> nn.Parameter:
            return nn.Parameter(t.to(dev), requires_grad=False)

        self.top = nn.ParameterDict(
            {k: held(v) for k, v in params.items() if k != "blocks"}
        )
        self.blocks = nn.ModuleList(
            nn.ParameterDict({k: held(v) for k, v in blk.items()})
            for blk in params["blocks"]
        )

    @property
    def params(self) -> Params:
        """The parameter tree the functional API takes."""
        return {**dict(self.top.items()), "blocks": [dict(b.items()) for b in self.blocks]}

    @property
    def device(self) -> torch.device:
        return self.top["tok_embed"].device

    def forward(self, token_ids: torch.Tensor, token_mask: torch.Tensor) -> torch.Tensor:
        return encode(self.params, token_ids, token_mask, self.cfg)
