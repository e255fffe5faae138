"""The port's serving layer: continuous batching for LLM decode."""

from pathway_tpu_torch.serving.continuous_batching import (
    ContinuousBatcher,
    continuous_batching_on,
)

__all__ = ["ContinuousBatcher", "continuous_batching_on"]
