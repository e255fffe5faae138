"""Batched second-stage reranking.

Counterpart of ``pathway_tpu/ops/rerank.py``. Every (query, candidate)
pair of a wave is scored in one dispatch, ``[B, C, d]`` candidate rows
against ``[B, d]`` queries, through the device plane's program and its
per-bucket shape ledger: B pads to the plane's row bucket and C to the
power-of-two cap bucket, so a stream of ragged waves dispatches a small
ladder of shapes.

The default scorer is the exact f32 metric (cos, dot, l2sq) over the
candidates' full-precision rows, as an elementwise product and sum: no
matrix product, so TF32 never touches it. A custom ``scorer(q [B, d],
cands [B, C, d], valid [B, C]) -> [B, C]`` is a torch callable and goes
through the same padded dispatch.

On the card a failed dispatch raises: the JAX package's degradation to
the numpy mirror is not ported. ``device=False`` is the only road to
``rerank_scores_host``.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from pathway_tpu_torch.engine.device_plane import (
    DeviceProgram,
    get_device_plane,
    resolve_device,
)

__all__ = [
    "BatchedReranker",
    "rerank_scores_host",
]


def _rerank_scores_fn(q, cands, valid, *, metric: str = "cos"):
    """[B, d] queries x [B, C, d] candidate rows -> [B, C] f32 scores
    (larger is better; invalid slots pinned to -inf)."""
    q = q.float()
    c = cands.float()
    if metric in ("cos", "cosine"):
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
        c = c / torch.clamp(torch.linalg.vector_norm(c, dim=-1, keepdim=True), min=1e-12)
        s = (c * q[:, None, :]).sum(-1)
    elif metric == "l2sq":
        diff = q[:, None, :] - c
        s = -(diff * diff).sum(-1)
    elif metric == "dot":
        s = (c * q[:, None, :]).sum(-1)
    else:
        raise NotImplementedError(f"rerank metric {metric!r}")
    return s.masked_fill(~valid, -math.inf)


def rerank_scores_host(
    q: np.ndarray, cands: np.ndarray, valid: np.ndarray, metric: str = "cos"
) -> np.ndarray:
    """Numpy mirror of `_rerank_scores_fn`."""
    q = np.asarray(q, np.float32)
    c = np.asarray(cands, np.float32)
    if metric in ("cos", "cosine"):
        q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
        c = c / np.maximum(np.linalg.norm(c, axis=-1, keepdims=True), 1e-12)
        s = np.einsum("bd,bcd->bc", q, c)
    elif metric == "l2sq":
        diff = q[:, None, :] - c
        s = -np.sum(diff * diff, axis=-1)
    elif metric == "dot":
        s = np.einsum("bd,bcd->bc", q, c)
    else:
        raise NotImplementedError(f"rerank metric {metric!r}")
    return np.where(np.asarray(valid, bool), s, -np.inf).astype(np.float32)


class BatchedReranker:
    """Second-stage pair scorer with bucketed dispatch.

    `device` is where the scores are computed: True (the default) means
    the CUDA card, a name or ``torch.device`` names one, False computes
    them with the numpy mirror. The default scorer dispatches through the
    plane's program `name`; a custom scorer through a program of its own
    (`program`), so two scorers never share a plane entry."""

    def __init__(
        self,
        metric: str = "cos",
        *,
        device: bool | str | torch.device = True,
        scorer: Callable | None = None,
        name: str = "rerank_scores",
    ):
        self.metric = metric if metric != "cosine" else "cos"
        self.name = name
        self.device = (
            None if device is False else resolve_device(None if device is True else device)
        )
        if scorer is not None and self.device is None:
            raise ValueError("a custom rerank scorer runs on a device; it has no numpy mirror")
        self._scorer = scorer
        self.program = DeviceProgram(name, scorer) if scorer is not None else None

    def scores(
        self, q: np.ndarray, cands: np.ndarray, valid: np.ndarray
    ) -> np.ndarray:
        """[B, d], [B, C, d], [B, C] -> [B, C] f32; -inf on invalid."""
        if self.device is None:
            return rerank_scores_host(q, cands, valid, self.metric)
        plane = get_device_plane()
        B, C = valid.shape
        d = q.shape[1]
        Bb = B if B > plane.buckets.max_rows else plane.buckets.rows_bucket(B)
        Cb = plane.buckets.cap_bucket(max(C, 1))
        qp = np.zeros((Bb, d), np.float32)
        qp[:B] = q
        cp = np.zeros((Bb, Cb, d), np.float32)
        cp[:B, :C] = cands
        vp = np.zeros((Bb, Cb), bool)
        vp[:B, :C] = valid
        args = [torch.from_numpy(a).to(self.device) for a in (qp, cp, vp)]
        bucket = (Bb, Cb, d, self.metric)
        if self.program is not None:
            s = self.program(*args, bucket=bucket)
        else:
            prog = plane.program(self.name, _rerank_scores_fn)
            s = prog(*args, metric=self.metric, bucket=bucket)
        return s[:B, :C].float().cpu().numpy()
