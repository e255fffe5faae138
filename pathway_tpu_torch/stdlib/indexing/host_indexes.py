"""Mutable vector index answering top-k queries: a host slab plus a
device mirror.

Counterpart of ``HostIndex`` and ``VectorSlabIndex`` in
``pathway_tpu/stdlib/indexing/host_indexes.py``. The host keeps one
growable f32 slab of (pre-normalized, for cosine) vectors with a validity
mask. With a device, a bf16 mirror of the slab lives there and queries
are batched into one masked distance + top-k (``ops.topk.knn_search_masked``).
Small deltas are written into the persistent mirror in place
(``index_copy_``); the mirror is rebuilt only when the padded slot count
grew or most rows changed. Deletions tombstone the mask.

On a CUDA mirror a failed search raises: the port does not degrade to
the host scan. ``device=False`` builds a CPU index that scans the host
slab with numpy. Metadata-filtered search waits for the filters module.
"""

from __future__ import annotations

import math
from typing import Any, Hashable

import numpy as np
import torch

from pathway_tpu_torch.engine.device_plane import get_device_plane, resolve_device

Matches = list[tuple[Hashable, float]]


def _sort_value(key: Any) -> Any:
    # engine keys order by their integer value; plain keys by themselves
    return getattr(key, "value", key)


class HostIndex:
    """Protocol: add/remove/search. `search` returns [(key, score)]."""

    def add(self, key: Hashable, data: Any, metadata: Any = None) -> None:
        raise NotImplementedError

    def remove(self, key: Hashable) -> None:
        raise NotImplementedError

    def search(self, query: Any, k: int, metadata_filter: str | None = None) -> Matches:
        raise NotImplementedError


def _as_vector(data: Any) -> np.ndarray:
    return np.asarray(data, dtype=np.float32).ravel()


class VectorSlabIndex(HostIndex):
    """Growable vector slab with a device-resident bf16 mirror.

    `device` is where the mirror lives: True (the default) means the
    CUDA card, a device name or ``torch.device`` names one, and False
    keeps no mirror and scans the host slab. `approx` is accepted as
    False only: the JAX package's ``approx_max_k`` has no torch
    counterpart, and the exact ``torch.topk`` serves both.
    """

    def __init__(
        self,
        dimensions: int | None = None,
        reserved_space: int = 1024,
        metric: str = "cos",
        approx: bool = False,
        device: bool | str | torch.device = True,
    ):
        if approx:
            raise NotImplementedError(
                "approx=True (approx_max_k) has no torch counterpart; the exact "
                "top-k serves this index"
            )
        self.dim = dimensions
        self.metric = "cos" if metric == "cosine" else metric
        self.device = (
            None if device is False else resolve_device(None if device is True else device)
        )
        self.capacity = max(64, reserved_space)
        self.vectors: np.ndarray | None = None  # [capacity, dim] f32
        self.valid = np.zeros(self.capacity, dtype=bool)
        self.slot_of: dict[Hashable, int] = {}
        self.key_of: dict[int, Hashable] = {}
        self.metadata: dict[Hashable, Any] = {}
        self.free: list[int] = []
        self.n_slots = 0  # high-water mark
        self._device_docs: torch.Tensor | None = None  # [padded, dim] bf16
        self._device_valid: torch.Tensor | None = None  # [padded] bool
        # slots changed since the last mirror sync (None: rebuild it all)
        self._dirty_slots: set[int] | None = None

    def __getstate__(self):
        # the device mirror is rebuilt from the host slab on the first
        # search after unpickling
        st = dict(self.__dict__)
        st["_device_docs"] = None
        st["_device_valid"] = None
        st["_dirty_slots"] = None
        return st

    # ------------------------------------------------------------- mutation

    def _ensure_storage(self, dim: int) -> None:
        if self.vectors is None:
            self.dim = self.dim or dim
            if dim != self.dim:
                raise ValueError(f"vector dim {dim} != index dim {self.dim}")
            self.vectors = np.zeros((self.capacity, self.dim), np.float32)

    def _grow(self) -> None:
        self.capacity *= 2
        new = np.zeros((self.capacity, self.dim), np.float32)
        new[: self.vectors.shape[0]] = self.vectors
        self.vectors = new
        nv = np.zeros(self.capacity, dtype=bool)
        nv[: self.valid.shape[0]] = self.valid
        self.valid = nv

    def _mark(self, slot: int) -> None:
        if self._dirty_slots is not None:
            self._dirty_slots.add(slot)

    def add(self, key: Hashable, data: Any, metadata: Any = None) -> None:
        vec = _as_vector(data)
        self._ensure_storage(vec.shape[0])
        if vec.shape[0] != self.dim:
            raise ValueError(f"vector dim {vec.shape[0]} != index dim {self.dim}")
        if self.metric == "cos":
            norm = float(np.linalg.norm(vec))
            if norm > 0:
                vec = vec / norm
        slot = self.slot_of.get(key)
        if slot is None:
            if self.free:
                slot = self.free.pop()
            else:
                if self.n_slots >= self.capacity:
                    self._grow()
                slot = self.n_slots
                self.n_slots += 1
            self.valid[slot] = True
            self.slot_of[key] = slot
            self.key_of[slot] = key
        self.vectors[slot] = vec
        self.metadata[key] = metadata
        self._mark(slot)

    def remove(self, key: Hashable) -> None:
        slot = self.slot_of.pop(key, None)
        if slot is None:
            return
        self.valid[slot] = False
        del self.key_of[slot]
        self.metadata.pop(key, None)
        self.free.append(slot)
        self._mark(slot)

    def __len__(self) -> int:
        return len(self.slot_of)

    # -------------------------------------------------------------- search

    def _padded_slots(self) -> int:
        # a power of two: the mirror takes a handful of shapes as it grows
        n = max(self.n_slots, 64)
        return min(self.capacity, 1 << math.ceil(math.log2(n)))

    def _refresh_device(self) -> None:
        """Sync the persistent device mirror with the host slab."""
        padded = self._padded_slots()
        dirty = self._dirty_slots
        if (
            self._device_docs is not None
            and dirty is not None
            and self._device_docs.shape[0] == padded
            and len(dirty) <= padded // 2
        ):
            if dirty:
                idx = np.fromiter(dirty, np.int64, len(dirty))
                tidx = torch.from_numpy(idx).to(self.device)
                rows = torch.from_numpy(self.vectors[idx]).to(self.device, torch.bfloat16)
                self._device_docs.index_copy_(0, tidx, rows)
                self._device_valid.index_copy_(
                    0, tidx, torch.from_numpy(self.valid[idx]).to(self.device)
                )
        else:
            self._device_docs = torch.from_numpy(self.vectors[:padded]).to(
                self.device, torch.bfloat16
            )
            self._device_valid = torch.from_numpy(self.valid[:padded].copy()).to(self.device)
        self._dirty_slots = set()

    def device_docs(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The synced mirror: (bf16 rows [padded, dim], validity [padded])."""
        if self.device is None:
            raise ValueError("this index keeps no device mirror (device=False)")
        self._refresh_device()
        return self._device_docs, self._device_valid

    def search(self, query: Any, k: int, metadata_filter: str | None = None) -> Matches:
        return self.search_batch([(query, k, metadata_filter)])[0]

    def search_batch(self, items: list[tuple[Any, int, str | None]]) -> list[Matches]:
        if any(f for _q, _k, f in items):
            raise NotImplementedError(
                "metadata-filtered search needs the filters module, which "
                "is not ported yet"
            )
        if not self.slot_of or not items:
            return [[] for _ in items]
        kmax = max(k for _q, k, _f in items)
        qmat = np.stack([_as_vector(q) for q, _k, _f in items])
        # candidates are re-ranked by (score, key) so equal scores never
        # depend on insertion order; the device path over-fetches 8 rows
        # of headroom for ties at the k-th boundary, the host path returns
        # every tie
        top = self._topk(qmat, min(kmax + 8, len(self.slot_of)))
        results: list[Matches] = []
        for (_q, k, _f), (idxs, dists) in zip(items, top):
            matches = [
                (self.key_of[slot], float(d))
                for slot, d in zip(idxs.tolist(), dists.tolist())
                if slot in self.key_of
            ]
            matches.sort(key=lambda m: (m[1], _sort_value(m[0])))
            results.append(matches[:k])
        return results

    def _topk(self, qmat: np.ndarray, k: int):
        if self.device is None:
            return self._topk_host(qmat, k)
        return self._topk_device(qmat, k)

    def _topk_device(self, qmat: np.ndarray, k: int):
        from pathway_tpu_torch.ops.topk import knn_search_masked

        docs, valid = self.device_docs()
        plane = get_device_plane()
        # pad the query batch to the row bucket, as the JAX package does;
        # batches past the cap dispatch at their exact size
        n_q = qmat.shape[0]
        if n_q > plane.buckets.max_rows:
            qpad, qbucket = qmat, n_q
        else:
            (qpad,), qbucket = plane.pad_rows([qmat], n_q)
        k = min(k, int(docs.shape[0]))
        prog = plane.program("knn_slab_search", knn_search_masked)
        res = prog(
            torch.from_numpy(np.ascontiguousarray(qpad)).to(self.device),
            docs, valid, k, self.metric,
            bucket=(int(docs.shape[0]), qbucket, k, self.dim),
        )
        idxs = res.indices[:n_q].cpu().numpy()
        dists = res.distances[:n_q].float().cpu().numpy()
        out = []
        for r in range(n_q):
            keep = np.isfinite(dists[r])
            out.append((idxs[r][keep], dists[r][keep]))
        return out

    def _topk_host(self, qmat: np.ndarray, k: int):
        docs = self.vectors[: self.n_slots]
        dists = self._host_distances(qmat, docs)
        dists[:, ~self.valid[: self.n_slots]] = np.inf
        k = min(k, dists.shape[1])
        part = np.argpartition(dists, k - 1, axis=1)[:, :k]
        out = []
        for r in range(qmat.shape[0]):
            # every candidate tied with the k-th distance, so the caller's
            # (score, key) re-rank is exact however many ties
            kth = np.max(dists[r][part[r]])
            if not np.isfinite(kth):
                cand = np.flatnonzero(np.isfinite(dists[r]))
            else:
                cand = np.flatnonzero(dists[r] <= kth)
            out.append((cand, dists[r][cand]))
        return out

    def _host_distances(self, qmat: np.ndarray, docs: np.ndarray) -> np.ndarray:
        if self.metric == "cos":
            qn = qmat / np.maximum(np.linalg.norm(qmat, axis=1, keepdims=True), 1e-12)
            return 1.0 - qn @ docs.T  # docs already unit-norm
        if self.metric == "dot":
            return -(qmat @ docs.T)
        qq = (qmat * qmat).sum(1, keepdims=True)
        dd = (docs * docs).sum(1)
        return np.maximum(qq - 2.0 * qmat @ docs.T + dd[None, :], 0.0)
