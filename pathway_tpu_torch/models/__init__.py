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
    lm_loss,
    make_train_step,
    param_specs,
    shard_params,
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
    "lm_loss",
    "make_train_step",
    "param_specs",
    "shard_params",
]
