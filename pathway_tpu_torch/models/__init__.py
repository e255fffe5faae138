"""The port's models: the flagship text encoder and its tokenizer."""

from pathway_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerEncoder,
    cast_params,
    embedder_config,
    encode,
    forward,
    init_params,
)

__all__ = [
    "TransformerConfig",
    "TransformerEncoder",
    "cast_params",
    "embedder_config",
    "encode",
    "forward",
    "init_params",
]
