"""Two-stage retrieval: ANN first stage + batched rerank.

Counterpart of ``pathway_tpu/stdlib/indexing/reranking.py``.
`RerankedSlabIndex` wraps a `VectorSlabIndex`-family host index (in
practice `IvfPqIndex`) and recovers the recall the first stage loses to
probe misses:

* round 0 overfetches ``k * expand`` candidates at the base nprobe;
* the batched reranker (`ops/rerank.py`) scores every candidate's
  full-precision row in one bucketed dispatch;
* if any of the final top-k sits in the TAIL ``1/factor`` fraction of
  the first-stage ranking while the candidate horizon was clipped (the
  first stage returned as many rows as asked), the winners were
  plausibly cut off: re-query geometrically, ``nprobe * factor`` and
  ``fetch * factor``, up to ``max_rounds``;
* independently, if the best UNPROBED centroid scores at least as well
  as the current k-th neighbor (the classic IVF early-termination bound,
  inverted), a probe miss is plausible and the re-query fires even when
  the two stages agree rank for rank.

Expanding nprobe (not just k) is what recovers recall: the ANN output is
already exact-rescored within the probed lists, so a wider k alone
re-ranks the same probe footprint, while a wider nprobe reaches rows the
first stage never saw.

Results keep the host-index contract: ``[(key, dist)]`` ascending by
``(dist, key)`` with the index's own distance convention (cos ->
``1 - sim``, dot/l2sq -> ``-score``).
"""

from __future__ import annotations

import numpy as np
import torch

from pathway_tpu_torch.ops import ivf as _ivf
from pathway_tpu_torch.ops.rerank import BatchedReranker
from pathway_tpu_torch.stdlib.indexing.host_indexes import (
    HostIndex,
    Matches,
    _as_vector,
    _sort_value,
)


class RerankedSlabIndex(HostIndex):
    """Second-stage wrapper over a slab-family host index (module doc).

    `device` is where the reranker scores: None (the default) follows the
    inner index (its device, or the numpy mirror for a ``device=False``
    index); True, a name or ``torch.device`` name one; False is numpy."""

    def __init__(
        self,
        inner,
        *,
        expand: int = 4,
        factor: int = 2,
        max_rounds: int = 3,
        device: bool | str | torch.device | None = None,
        scorer=None,
    ):
        self.inner = inner
        self.expand = max(1, int(expand))
        self.factor = max(2, int(factor))
        self.max_rounds = max(1, int(max_rounds))
        if device is None:
            inner_dev = getattr(inner, "device", None)
            device = False if inner_dev is None else inner_dev
        self.reranker = BatchedReranker(
            getattr(inner, "metric", "cos"), device=device, scorer=scorer
        )
        self.counters = {"rerank_rounds": 0, "rerank_expansions": 0}

    # ------------------------------------------------------- delegation

    def add(self, key, data, metadata=None) -> None:
        self.inner.add(key, data, metadata)

    def remove(self, key) -> None:
        self.inner.remove(key)

    def __getattr__(self, name: str):
        # transparent for what callers read off the wrapped index
        # (vectors, slot_of, stats…); underscore names stay local so
        # pickling can't recurse
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.inner, name)

    # ------------------------------------------------------------ search

    def search(self, query, k, metadata_filter=None) -> Matches:
        return self.search_batch([(query, k, metadata_filter)])[0]

    def search_batch(self, items) -> list[Matches]:
        # lazy: pathway_tpu_torch.indexing re-exports this package, so a
        # module-level import would be circular
        from pathway_tpu_torch.indexing.ann import IvfPqIndex

        inner = self.inner
        n = len(items)
        results: list[Matches | None] = [None] * n
        pending = list(range(n))
        mult = 1
        for round_no in range(self.max_rounds):
            self.counters["rerank_rounds"] += 1
            fetch = [
                (items[i][0], items[i][1] * self.expand * mult, items[i][2])
                for i in pending
            ]
            nprobe = None
            if isinstance(inner, IvfPqIndex):
                nprobe = self._nprobe(mult)
                cand_lists = inner.search_batch(fetch, nprobe=nprobe)
            else:
                cand_lists = inner.search_batch(fetch)
            reranked = self._rerank(
                [items[i] for i in pending], cand_lists, nprobe
            )
            still = []
            last_round = round_no == self.max_rounds - 1
            for idx_in_pending, i in enumerate(pending):
                matches, tail_hit, probe_risk = reranked[idx_in_pending]
                requested = items[i][1] * self.expand * mult
                clipped = len(cand_lists[idx_in_pending]) >= requested
                # two independent expansion triggers: a winner near the
                # clipped candidate horizon (the reranker DISAGREES with
                # the first stage — a wider fetch may promote more), or a
                # competitive unprobed centroid (a probe MISS is
                # plausible — only a wider nprobe can reach those rows)
                if ((tail_hit and clipped) or probe_risk) and not last_round:
                    still.append(i)
                else:
                    results[i] = matches
            if not still:
                break
            pending = still
            mult *= self.factor
            self.counters["rerank_expansions"] += len(still)
        return [r if r is not None else [] for r in results]

    def _nprobe(self, mult: int) -> int | None:
        base = self.inner.nprobe
        if base is None:
            gen = getattr(self.inner, "_gen", None)
            if gen is None:
                return None
            base = _ivf.auto_nprobe(gen.n_lists)
        return base * mult

    def _probe_risk(self, qmat: np.ndarray, nprobe, kth_scores) -> np.ndarray:
        """Per-query: could an UNPROBED list hold a better neighbor than
        the current k-th? True when the (nprobe+1)-th closest centroid
        scores at least as well as the k-th reranked hit. Queries with
        -inf kth (fewer than k live candidates) always flag. Without a
        trained IVF generation there is nothing to probe wider, so the
        signal is all-False."""
        gen = getattr(self.inner, "_gen", None)
        if nprobe is None or gen is None or nprobe >= gen.n_lists:
            return np.zeros(len(qmat), bool)
        cents = np.asarray(gen.centroids, np.float32)
        q = qmat
        metric = self.reranker.metric
        if metric == "cos":
            q = q / np.maximum(
                np.linalg.norm(q, axis=1, keepdims=True), 1e-12
            )
            cn = cents / np.maximum(
                np.linalg.norm(cents, axis=1, keepdims=True), 1e-12
            )
            cscore = q @ cn.T
        elif metric == "l2sq":
            cscore = -(
                np.sum(q * q, axis=1, keepdims=True)
                - 2.0 * (q @ cents.T)
                + np.sum(cents * cents, axis=1)[None, :]
            )
        else:  # dot
            cscore = q @ cents.T
        # score of the BEST centroid left unprobed = rank-nprobe entry
        # (0-indexed) of the descending centroid ranking
        part = np.partition(-cscore, nprobe, axis=1)
        best_unprobed = -part[:, nprobe]
        return best_unprobed >= np.asarray(kth_scores, np.float32)

    def _rerank(
        self, pend_items, cand_lists, nprobe=None
    ) -> list[tuple[Matches, bool, bool]]:
        """One batched scoring pass. Returns per query (top-k matches in
        the host-index convention, tail-hit flag, probe-risk flag) for
        the adaptive loop."""
        inner = self.inner
        B = len(pend_items)
        C = max((len(c) for c in cand_lists), default=0)
        if C == 0:
            return [([], False, False) for _ in pend_items]
        d = inner.dim
        qmat = np.zeros((B, d), np.float32)
        cands = np.zeros((B, C, d), np.float32)
        valid = np.zeros((B, C), bool)
        keys: list[list] = []
        for b, ((query, _k, _f), matches) in enumerate(
            zip(pend_items, cand_lists)
        ):
            qmat[b] = _as_vector(query)
            row_keys = []
            for c, (key, _dist) in enumerate(matches):
                slot = inner.slot_of.get(key)
                if slot is None:  # retracted between stages: skip
                    continue
                cands[b, c] = inner.vectors[slot]
                valid[b, c] = True
                row_keys.append((c, key))
            keys.append(row_keys)
        scores = self.reranker.scores(qmat, cands, valid)
        metric = self.reranker.metric
        packed = []
        kth_scores = np.full(B, -np.inf, np.float32)
        for b, (item, row_keys) in enumerate(zip(pend_items, keys)):
            k = item[1]
            scored = [
                (float(scores[b, c]), c, key)
                for c, key in row_keys
                if np.isfinite(scores[b, c])
            ]
            # deterministic: score desc, then key — the same tie rule as
            # the first stage's (dist, key) ascending order
            scored.sort(key=lambda t: (-t[0], _sort_value(t[2])))
            top = scored[:k]
            if len(top) == k:
                kth_scores[b] = top[-1][0]
            if metric in ("cos", "cosine"):
                matches = [(key, 1.0 - s) for s, _c, key in top]
            else:
                matches = [(key, -s) for s, _c, key in top]
            n_cand = len(row_keys)
            tail_start = n_cand - max(1, n_cand // self.factor)
            tail_hit = any(c >= tail_start for _s, c, _key in top)
            packed.append((matches, tail_hit))
        risk = self._probe_risk(qmat, nprobe, kth_scores)
        return [
            (matches, tail_hit, bool(risk[b]))
            for b, (matches, tail_hit) in enumerate(packed)
        ]
