"""The port's models: the flagship text encoder, the causal LMs of three
families (the GPT-2-style ``transformer``, the DeepSeek-V3 ``deepseek``
and the Kimi Linear ``kimi_linear``, KDA layers beside latent attention)
and their tokenizer. :func:`family_of` gives a config's module, whose
``init_kv_cache``, ``prefill_into_slot`` and ``decode_step_slots`` the
continuous batcher calls, whose ``STEP_COUNTERS`` it reads back with
each step's tokens, whose ``SCAN_COUNTER`` it counts on the host and
whose ``GRAPH_PHASES`` it replays from CUDA graphs on the card;
:func:`build_lm` holds any family's parameters on the card."""

from typing import Any

import torch

from pathway_tpu_torch.models import deepseek, kimi_linear, transformer
from pathway_tpu_torch.models.deepseek import DeepseekConfig, DeepseekLM
from pathway_tpu_torch.models.kimi_linear import KimiLinearConfig, KimiLinearLM
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
    :class:`DeepseekConfig`, ``kimi_linear`` for a :class:`KimiLinearConfig`,
    ``transformer`` for a :class:`TransformerConfig`."""
    if isinstance(cfg, DeepseekConfig):
        return deepseek
    if isinstance(cfg, KimiLinearConfig):
        return kimi_linear
    if isinstance(cfg, TransformerConfig):
        return transformer
    raise TypeError(f"no model family takes a {type(cfg).__name__}")


def build_lm(
    cfg: Any, params: Any = None, *, device: Any = None, generator: torch.Generator | None = None
) -> TransformerLM | DeepseekLM | KimiLinearLM:
    """The causal LM of `cfg`'s family, its parameters on `device` (random
    from `generator` without `params`)."""
    lm = {deepseek: DeepseekLM, kimi_linear: KimiLinearLM}.get(family_of(cfg), TransformerLM)
    return lm(cfg, params, device=device, generator=generator)


__all__ = [
    "DeepseekConfig",
    "DeepseekLM",
    "KimiLinearConfig",
    "KimiLinearLM",
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
