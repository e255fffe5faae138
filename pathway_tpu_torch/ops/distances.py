"""Pairwise distances as one queries @ docs^T product plus cheap corrections.

Counterpart of ``pathway_tpu/ops/distances.py``. Inputs go to bf16 for
the product and the sum is kept in f32, as the JAX package asks XLA for
(``preferred_element_type=float32``).
"""

from __future__ import annotations

import torch


def normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize rows."""
    norm = torch.sqrt(torch.sum(x.float() ** 2, dim=-1, keepdim=True))
    return (x / torch.clamp(norm, min=eps)).to(x.dtype)


def dot_products(queries: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """[q, d] x [n, d] -> [q, n] f32 inner products of the bf16-rounded
    inputs. On the card cuBLAS multiplies bf16 and writes the f32 sum
    (``mm`` with ``out_dtype``), so the doc slab is never copied at
    another width; PyTorch's CPU ``mm`` has no such mode, and there the
    rounded inputs are multiplied in f32, which gives the same products
    (each bf16 x bf16 product is exact in f32)."""
    q16 = queries.to(torch.bfloat16)
    d16 = docs.to(torch.bfloat16)
    if q16.device.type == "cuda":
        return torch.mm(q16, d16.t(), out_dtype=torch.float32)
    return q16.float() @ d16.float().t()


def cosine_distances(
    queries: torch.Tensor, docs: torch.Tensor, *, normalized: bool = False
) -> torch.Tensor:
    """Cosine distance (1 - cos similarity), [q, n]. `normalized=True`
    promises unit-norm doc rows (the index serving layout)."""
    qn = normalize(queries.float())
    dn = docs if normalized else normalize(docs.float())
    return 1.0 - dot_products(qn, dn)


def l2_distances(queries: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distance via ||q||^2 - 2 q.d + ||d||^2."""
    q32 = queries.float()
    d32 = docs.float()
    qq = torch.sum(q32 * q32, dim=-1, keepdim=True)
    dd = torch.sum(d32 * d32, dim=-1)
    qd = dot_products(queries, docs)
    return torch.clamp(qq - 2.0 * qd + dd[None, :], min=0.0)


METRICS = {
    "cos": cosine_distances,
    "cosine": cosine_distances,
    "l2": l2_distances,
    "l2sq": l2_distances,
    "dot": lambda q, d, **_: -dot_products(q, d),  # distance = -similarity
}


def metric_fn(name: str):
    try:
        return METRICS[name]
    except KeyError:
        raise ValueError(
            f"unknown metric {name!r}; expected one of {sorted(METRICS)}"
        ) from None
