"""Segment reductions: a batched groupby aggregation on the device.

Counterpart of ``pathway_tpu/ops/segment.py``, which runs the
``jax.ops.segment_*`` family; here each op is one ``scatter_reduce`` into
a buffer that starts at the reduction's identity, and the edge cases are
the JAX package's:

* ids outside ``[0, num_segments)`` are dropped (``scatter_reduce`` would
  raise on them, so they are masked out first);
* an empty segment reads the identity: 0 for sum, count and mean,
  +inf for a float min (the dtype's largest value for an integer one),
  -inf for a float max (the smallest for an integer one);
* ``any`` is the max of ``values != 0`` as int32, cast to bool, so an
  empty segment reads True (int32's smallest value is nonzero), as in
  the JAX package;
* ``mean`` divides the sum by the count (at least 1) as f32, so an
  integer mean comes back f32.

On CUDA the float sums go through atomics, so their last bits may move
between runs; min, max, count and any are exact.
"""

from __future__ import annotations

import torch

__all__ = ["segment_reduce"]

_REDUCERS = ("sum", "min", "max", "count", "mean", "any")


def _scatter(
    values: torch.Tensor, ids: torch.Tensor, num_segments: int, reduce: str, init: float | int
) -> torch.Tensor:
    out = torch.full(
        (num_segments,) + tuple(values.shape[1:]), init, dtype=values.dtype, device=values.device
    )
    idx = ids.view((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    return out.scatter_reduce_(0, idx, values, reduce=reduce, include_self=True)


def _extreme(dtype: torch.dtype, largest: bool) -> float | int:
    if dtype.is_floating_point:
        return float("inf") if largest else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if largest else info.min


def segment_reduce(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, op: str = "sum"
) -> torch.Tensor:
    """Reduce `values` grouped by `segment_ids` into [num_segments, ...]."""
    if op not in _REDUCERS:
        raise ValueError(f"unknown op {op!r}; expected one of {_REDUCERS}")
    ids = segment_ids.to(device=values.device, dtype=torch.long)
    keep = (ids >= 0) & (ids < num_segments)
    if not bool(keep.all()):
        values, ids = values[keep], ids[keep]
    if op == "sum":
        return _scatter(values, ids, num_segments, "sum", 0)
    if op == "count":
        ones = torch.ones(ids.shape[0], dtype=torch.int32, device=values.device)
        return _scatter(ones, ids, num_segments, "sum", 0)
    if op == "mean":
        sums = _scatter(values, ids, num_segments, "sum", 0)
        ones = torch.ones(ids.shape[0], dtype=torch.float32, device=values.device)
        counts = _scatter(ones, ids, num_segments, "sum", 0)
        return sums / torch.clamp(counts, min=1.0).view((num_segments,) + (1,) * (values.dim() - 1))
    if op == "min":
        return _scatter(values, ids, num_segments, "amin", _extreme(values.dtype, True))
    if op == "max":
        return _scatter(values, ids, num_segments, "amax", _extreme(values.dtype, False))
    nz = (values != 0).to(torch.int32)
    return _scatter(nz, ids, num_segments, "amax", torch.iinfo(torch.int32).min).bool()
