"""The port's models: the flagship text encoder, the causal LM and their
tokenizer."""

from pathway_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerEncoder,
    TransformerLM,
    cast_params,
    count_params,
    embedder_config,
    encode,
    forward,
    init_params,
    lm_config,
)

__all__ = [
    "TransformerConfig",
    "TransformerEncoder",
    "TransformerLM",
    "cast_params",
    "count_params",
    "embedder_config",
    "encode",
    "forward",
    "init_params",
    "lm_config",
]
