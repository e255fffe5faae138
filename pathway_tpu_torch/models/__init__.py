"""The port's models: the flagship text encoder, the causal LMs of two
families (the GPT-2-style ``transformer`` and the DeepSeek-V3 ``deepseek``)
and their tokenizer. :func:`family_of` gives a config's module, whose
``init_kv_cache``, ``prefill_into_slot`` and ``decode_step_slots`` the
continuous batcher calls, whose ``STEP_COUNTERS`` it reads back with
each step's tokens and whose ``GRAPH_PHASES`` it replays from CUDA graphs
on the card; :func:`build_lm` holds either family's
parameters on the card."""

from typing import Any

import torch

from pathway_tpu_torch.models import deepseek, transformer
from pathway_tpu_torch.models.deepseek import DeepseekConfig, DeepseekLM
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


def family_of(cfg: Any):
    """The module of `cfg`'s model family: ``deepseek`` for a
    :class:`DeepseekConfig`, ``transformer`` for a :class:`TransformerConfig`."""
    if isinstance(cfg, DeepseekConfig):
        return deepseek
    if isinstance(cfg, TransformerConfig):
        return transformer
    raise TypeError(f"no model family takes a {type(cfg).__name__}")


def build_lm(
    cfg: Any, params: Any = None, *, device: Any = None, generator: torch.Generator | None = None
) -> TransformerLM | DeepseekLM:
    """The causal LM of `cfg`'s family, its parameters on `device` (random
    from `generator` without `params`)."""
    lm = DeepseekLM if family_of(cfg) is deepseek else TransformerLM
    return lm(cfg, params, device=device, generator=generator)


__all__ = [
    "DeepseekConfig",
    "DeepseekLM",
    "TransformerConfig",
    "TransformerEncoder",
    "TransformerLM",
    "build_lm",
    "cast_params",
    "count_params",
    "embedder_config",
    "family_of",
    "encode",
    "forward",
    "init_params",
    "lm_config",
    "lm_loss",
    "make_train_step",
    "param_specs",
    "shard_params",
]
