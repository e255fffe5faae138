"""Mutable vector index answering top-k queries: a host slab plus a
device mirror.

Counterpart of ``HostIndex`` and ``VectorSlabIndex`` in
``pathway_tpu_torch/stdlib/indexing/host_indexes.py``. The host keeps one
growable f32 slab of (pre-normalized, for cosine) vectors with a validity
mask. With a device, a bf16 mirror of the slab lives there and queries
are batched into one masked distance + top-k (``ops.topk.knn_search_masked``).
Small deltas are written into the persistent mirror in place
(``index_copy_``); the mirror is rebuilt only when the padded slot count
grew or most rows changed. Deletions tombstone the mask.

On a CUDA mirror a failed search raises: the port does not degrade to
the host scan. ``device=False`` builds a CPU index that scans the host
slab with numpy. Metadata-filtered queries scan the filtered candidate
set on the host, as in the JAX package. ``LshIndex`` and ``Bm25Index``
are numpy and copied from it.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Any, Callable, Hashable

import numpy as np
import torch

from pathway_tpu_torch.engine.device_plane import get_device_plane, resolve_device
from pathway_tpu_torch.internals.keys import Key
from pathway_tpu_torch.stdlib.indexing.filters import compile_filter

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


class _FilterCache:
    def __init__(self) -> None:
        self._cache: dict[str, Callable[[Any], bool]] = {}

    def __reduce__(self):
        # compiled predicates are closures; rebuild lazily after unpickle
        # (operator-snapshot persistence pickles whole host indexes)
        return (_FilterCache, ())

    def get(self, expression: str) -> Callable[[Any], bool]:
        fn = self._cache.get(expression)
        if fn is None:
            fn = self._cache[expression] = compile_filter(expression)
        return fn


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
        self._filters = _FilterCache()

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
        if not self.slot_of:
            return [[] for _ in items]
        plain = [(i, q, k) for i, (q, k, f) in enumerate(items) if not f]
        filtered = [(i, q, k, f) for i, (q, k, f) in enumerate(items) if f]
        results: list[Matches] = [[] for _ in items]
        if plain:
            kmax = max(k for _i, _q, k in plain)
            qmat = np.stack([_as_vector(q) for _i, q, _k in plain])
            # candidates are re-ranked by (score, key) so equal scores never
            # depend on insertion order; the device path over-fetches 8 rows
            # of headroom for ties at the k-th boundary, the host path returns
            # every tie
            top = self._topk(qmat, min(kmax + 8, len(self.slot_of)))
            for (i, _q, k), (idxs, dists) in zip(plain, top):
                matches = [
                    (self.key_of[slot], float(d))
                    for slot, d in zip(idxs.tolist(), dists.tolist())
                    if slot in self.key_of
                ]
                matches.sort(key=lambda m: (m[1], _sort_value(m[0])))
                results[i] = matches[:k]
        for i, q, k, f in filtered:
            results[i] = self._search_filtered(_as_vector(q), k, f)
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

    def _search_filtered(self, vec: np.ndarray, k: int, flt: str) -> Matches:
        pred = self._filters.get(flt)
        slots = [s for s, key in self.key_of.items() if pred(self.metadata.get(key))]
        if not slots:
            return []
        docs = self.vectors[slots]
        dists = self._host_distances(vec[None, :], docs)[0]
        matches = [(self.key_of[s], float(d)) for s, d in zip(slots, dists)]
        matches.sort(key=lambda m: (m[1], _sort_value(m[0])))
        return matches[:k]


class LshIndex(HostIndex):
    """Locality-sensitive hashing over random projections.

    Reference parity: stdlib/ml/classifiers/_lsh.py (random projections,
    bucket assignment) + _knn_lsh.py (bucketed candidate scan). OR-AND
    scheme: `n_or` tables each of `n_and` concatenated hyperplane bits.
    """

    def __init__(
        self,
        dimensions: int | None = None,
        n_or: int = 4,
        n_and: int = 8,
        bucket_length: float = 2.0,
        metric: str = "l2",
        seed: int = 0,
        projection: Any = None,
        distance: Any = None,
    ):
        """`projection` (vec -> sequence of per-table bucket ids) and
        `distance` ((query, doc) -> float) plug user callables into the
        bucket assignment and the candidate rescore — the generic-LSH
        contract of the reference's knn_lsh_generic_classifier_train
        (ml/classifiers/_knn_lsh.py:135). Defaults draw OR-AND hyperplane
        projections and use the named metric."""
        self.dim = dimensions
        self.n_or = n_or
        self.n_and = n_and
        self.bucket_length = bucket_length
        self.metric = metric
        self.seed = seed
        self.custom_projection = projection
        self.custom_distance = distance
        self.projections: list[np.ndarray] | None = None
        self.offsets: list[np.ndarray] | None = None
        self.buckets: list[dict[tuple, set[Key]]] = [defaultdict(set) for _ in range(n_or)]
        self.vectors: dict[Key, np.ndarray] = {}
        self.metadata: dict[Key, Any] = {}
        self._filters = _FilterCache()

    def _ensure(self, dim: int) -> None:
        if self.custom_projection is not None:
            return
        if self.projections is None:
            self.dim = self.dim or dim
            rng = np.random.default_rng(self.seed)
            self.projections = [
                rng.normal(size=(self.dim, self.n_and)).astype(np.float32)
                for _ in range(self.n_or)
            ]
            self.offsets = [
                rng.uniform(0, self.bucket_length, size=self.n_and).astype(np.float32)
                for _ in range(self.n_or)
            ]

    def _bucket_ids(self, vec: np.ndarray) -> list:
        if self.custom_projection is not None:
            from pathway_tpu_torch.engine.core import freeze_value

            ids = [freeze_value(b) for b in self.custom_projection(vec)]
            if len(ids) > len(self.buckets):  # grow to the callable's L
                self.buckets.extend(
                    defaultdict(set) for _ in range(len(ids) - len(self.buckets))
                )
            return ids
        return [
            tuple(np.floor((vec @ proj + off) / self.bucket_length).astype(np.int64))
            for proj, off in zip(self.projections, self.offsets)
        ]

    def add(self, key: Key, data: Any, metadata: Any = None) -> None:
        vec = _as_vector(data)
        self._ensure(vec.shape[0])
        self.remove(key)
        self.vectors[key] = vec
        self.metadata[key] = metadata
        for table, bid in zip(self.buckets, self._bucket_ids(vec)):
            table[bid].add(key)

    def remove(self, key: Key) -> None:
        vec = self.vectors.pop(key, None)
        if vec is None:
            return
        self.metadata.pop(key, None)
        for table, bid in zip(self.buckets, self._bucket_ids(vec)):
            table[bid].discard(key)

    def search(self, query: Any, k: int, metadata_filter: str | None = None) -> Matches:
        if not self.vectors:
            return []
        vec = _as_vector(query)
        self._ensure(vec.shape[0])
        candidates: set[Key] = set()
        for table, bid in zip(self.buckets, self._bucket_ids(vec)):
            candidates |= table.get(bid, set())
        if metadata_filter:
            pred = self._filters.get(metadata_filter)
            candidates = {c for c in candidates if pred(self.metadata.get(c))}
        if not candidates:
            return []
        keys = list(candidates)
        if self.custom_distance is not None:
            dists = [
                float(self.custom_distance(vec, self.vectors[c])) for c in keys
            ]
        else:
            docs = np.stack([self.vectors[c] for c in keys])
            if self.metric in ("cos", "cosine"):
                qn = vec / max(np.linalg.norm(vec), 1e-12)
                dn = docs / np.maximum(
                    np.linalg.norm(docs, axis=1, keepdims=True), 1e-12
                )
                dists = 1.0 - dn @ qn
            else:
                dists = np.linalg.norm(docs - vec[None, :], axis=1) ** 2
        matches = [(key, float(d)) for key, d in zip(keys, dists)]
        matches.sort(key=lambda m: (m[1], m[0].value))
        return matches[:k]


_TOKEN_SPLIT = None


def _bm25_tokenize(text: str) -> list[str]:
    import re

    global _TOKEN_SPLIT
    if _TOKEN_SPLIT is None:
        _TOKEN_SPLIT = re.compile(r"[a-z0-9]+")
    return _TOKEN_SPLIT.findall(text.lower())


class Bm25Index(HostIndex):
    """In-memory BM25 inverted index (Okapi BM25, k1/b standard constants).

    Reference parity: TantivyIndex (src/external_integration/
    tantivy_integration.rs:16). Scores are returned NEGATED so that the
    uniform 'smaller = closer' distance convention of the index layer holds.
    """

    K1 = 1.2
    B = 0.75

    def __init__(self) -> None:
        self.postings: dict[str, dict[Key, int]] = defaultdict(dict)
        self.doc_len: dict[Key, int] = {}
        self.metadata: dict[Key, Any] = {}
        self._filters = _FilterCache()

    def add(self, key: Key, data: Any, metadata: Any = None) -> None:
        self.remove(key)
        terms = _bm25_tokenize(str(data))
        self.doc_len[key] = len(terms)
        self.metadata[key] = metadata
        for t in terms:
            self.postings[t][key] = self.postings[t].get(key, 0) + 1

    def remove(self, key: Key) -> None:
        if key not in self.doc_len:
            return
        del self.doc_len[key]
        self.metadata.pop(key, None)
        for t in list(self.postings):
            self.postings[t].pop(key, None)
            if not self.postings[t]:
                del self.postings[t]

    def search(self, query: Any, k: int, metadata_filter: str | None = None) -> Matches:
        n = len(self.doc_len)
        if n == 0:
            return []
        avg_len = sum(self.doc_len.values()) / n
        scores: dict[Key, float] = defaultdict(float)
        for t in _bm25_tokenize(str(query)):
            plist = self.postings.get(t)
            if not plist:
                continue
            idf = math.log(1.0 + (n - len(plist) + 0.5) / (len(plist) + 0.5))
            for key, tf in plist.items():
                dl = self.doc_len[key]
                scores[key] += idf * (
                    tf * (self.K1 + 1.0)
                    / (tf + self.K1 * (1.0 - self.B + self.B * dl / avg_len))
                )
        if metadata_filter:
            pred = self._filters.get(metadata_filter)
            scores = {key: s for key, s in scores.items() if pred(self.metadata.get(key))}
        # key tie-break: scores must not depend on dict/insertion order
        ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0].value))[:k]
        return [(key, -s) for key, s in ranked]
