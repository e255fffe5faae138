"""Fused distance + top-k retrieval on one device.

Counterpart of ``pathway_tpu/ops/topk.py`` (single-device half). Exact
search is one bf16 product with f32 sums plus ``torch.topk``. Where the
JAX package asks XLA for ``approx_max_k``, the port takes the exact
``torch.topk``: recall can only rise, and JAX on the CPU is exact too.
``torch.topk`` breaks ties in another order than ``lax.top_k``; callers
that need a stable order re-sort by (score, key), as the slab index does.
``make_knn_searcher`` closes over these, or over the IVF-PQ tier.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pathway_tpu_torch.ops.distances import dot_products, metric_fn, normalize


class TopKResult(NamedTuple):
    indices: torch.Tensor  # [q, k] int32 — indices into the doc matrix
    distances: torch.Tensor  # [q, k] f32 — metric distances (smaller = closer)


def knn_search(
    queries: torch.Tensor,
    docs: torch.Tensor,
    k: int,
    metric: str = "cos",
    *,
    normalized: bool = False,
) -> TopKResult:
    """Exact k-NN: distance grid + top-k. `normalized=True` promises
    unit-norm doc rows for cosine (the serving layout)."""
    if metric in ("cos", "cosine", "dot"):
        # similarity form: top-k on the product, convert only the winners
        q = normalize(queries.float()) if metric != "dot" else queries
        d_mat = docs if (normalized or metric == "dot") else normalize(docs.float())
        s, idx = torch.topk(dot_products(q, d_mat), k, dim=1)
        d = (1.0 - s) if metric != "dot" else -s
        return TopKResult(indices=idx.to(torch.int32), distances=d)
    neg, idx = torch.topk(-metric_fn(metric)(queries, docs), k, dim=1)
    return TopKResult(indices=idx.to(torch.int32), distances=-neg)


def knn_search_masked(
    queries: torch.Tensor,
    docs: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    metric: str = "cos",
) -> TopKResult:
    """Exact k-NN with a validity mask over doc slots (tombstoned rows
    get distance +inf)."""
    dists = metric_fn(metric)(queries, docs)
    dists = dists.masked_fill(~valid[None, :], float("inf"))
    neg, idx = torch.topk(-dists, k, dim=1)
    return TopKResult(indices=idx.to(torch.int32), distances=-neg)


class QuantizedDocs(NamedTuple):
    """Serving layout for the int8 scan + bf16 rescore KNN path:
    per-row symmetric int8 values, the per-row dequant factor
    (maxabs/127) and the bf16 rows for the exact rescore."""

    values: torch.Tensor  # [n, d] int8
    scale: torch.Tensor  # [n] f32
    full: torch.Tensor  # [n, d] bf16


def _quantize_rows(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    r32 = rows.float()
    scale = torch.clamp(r32.abs().amax(dim=1), min=1e-12) / 127.0
    # torch.round is half-to-even, as jnp.round
    q = torch.clamp(torch.round(r32 / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_docs(docs: torch.Tensor) -> QuantizedDocs:
    """Build the int8 serving layout from a (row-normalized) doc matrix."""
    values, scale = _quantize_rows(docs)
    return QuantizedDocs(values=values, scale=scale, full=docs.to(torch.bfloat16))


def update_quantized_docs(
    docs: QuantizedDocs, idx: torch.Tensor, rows: torch.Tensor
) -> QuantizedDocs:
    """Quantize fresh rows on the device and write them into slots `idx`
    of a persistent layout IN PLACE (``index_copy_``), where the JAX
    package donates the buffers to a jitted scatter: the allocation is
    reused either way. Repeated (idx, row) pairs are idempotent. Returns
    `docs`, whose tensors now hold the update."""
    values, scale = _quantize_rows(rows)
    idx = idx.to(device=docs.values.device, dtype=torch.long)
    docs.values.index_copy_(0, idx, values)
    docs.scale.index_copy_(0, idx, scale)
    docs.full.index_copy_(0, idx, rows.to(torch.bfloat16))
    return docs


def _int8_scan(qi: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """[q, d] int8 x [n, d] int8 -> [q, n] int32 through ``torch._int_mm``.
    Its CUDA path wants more than 16 rows in the first operand and
    multiples of 8 for the inner and output widths, so the docs are the
    first operand ([n, d] @ [d, q]) and the queries pad with zero rows
    to a multiple of 8 (a tiny doc set pads to 17 rows)."""
    n, dim = values.shape
    if dim % 8 != 0:
        raise ValueError(f"the int8 scan needs a width that is a multiple of 8, got {dim}")
    q = qi.shape[0]
    q_pad = -(-q // 8) * 8
    if q_pad != q:
        qi = torch.cat([qi, qi.new_zeros((q_pad - q, dim))])
    a = values
    if n <= 16:
        a = torch.cat([values, values.new_zeros((17 - n, dim))])
    return torch._int_mm(a, qi.t().contiguous())[:n, :q].t()


def knn_search_quantized(
    queries: torch.Tensor,
    docs: QuantizedDocs,
    k: int,
    *,
    candidates: int = 64,
) -> TopKResult:
    """Cosine k-NN: int8 scan -> top-`candidates` -> exact bf16 rescore
    -> top-k. Queries are L2-normalized here, so distances are true
    cosine distances of the bf16 rows."""
    queries = normalize(queries.float())
    qi, _qscale = _quantize_rows(queries)
    # candidate selection needs only the order: bf16, as in the JAX package
    sims = (_int8_scan(qi, docs.values).float() * docs.scale[None, :]).to(torch.bfloat16)
    c = min(candidates, docs.values.shape[0])
    _, cand_idx = torch.topk(sims, c, dim=1)
    # exact rescore of c rows per query: bf16 rows, f32 products and sums
    cand_rows = docs.full[cand_idx].float()  # [q, c, d]
    exact = torch.einsum(
        "qd,qcd->qc", queries.to(torch.bfloat16).float(), cand_rows
    )
    s, pos = torch.topk(exact, k, dim=1)
    idx = torch.gather(cand_idx, 1, pos)
    return TopKResult(indices=idx.to(torch.int32), distances=1.0 - s)


def make_knn_searcher(
    k: int,
    metric: str = "cos",
    mesh=None,
    axis: str = "data",
    *,
    ann: bool | None = None,
    nprobe: int | None = None,
):
    """Pre-configured searcher closure ``search(queries, docs) -> TopKResult``.

    Exact by default (`knn_search`). `ann=True` routes through the IVF-PQ
    index (`ops/ivf.py`): the first search against a given doc matrix
    trains an index and keeps it resident on the matrix's device, later
    searches probe `nprobe` lists instead of scanning every row. The
    `PATHWAY_ANN` env var overrides either way: `0` forces the exact scan,
    `1` opts unlabeled call sites in; an explicit `ann=False` stays exact.
    A `mesh` (the list-sharded search) waits for the multi-device slice.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the mesh-sharded searcher is not ported yet; it comes with the "
            "multi-device slice (ROADMAP A9)"
        )
    from pathway_tpu_torch.indexing import ann_enabled

    use_ann = (
        ann is not False
        and ann_enabled(default=bool(ann))
        and metric in ("cos", "cosine", "dot", "l2sq")
    )
    if not use_ann:
        def search(queries: torch.Tensor, docs: torch.Tensor) -> TopKResult:
            return knn_search(queries, docs, k, metric)

        return search

    import os
    import weakref
    from collections import OrderedDict

    from pathway_tpu_torch.ops import ivf as _ivf

    # Bounded LRU of resident indexes, keyed by the matrix's id() but only
    # served through a LIVE weakref check: a freed tensor's address can be
    # recycled by a new matrix of the same shape, so the id alone never
    # validates a hit. Several entries keep alternating doc matrices warm
    # without a retrain per call; the bound keeps a long-lived searcher
    # from growing one index per matrix it ever saw.
    cache: "OrderedDict[int, tuple]" = OrderedDict()
    cache_cap = max(1, int(os.environ.get("PATHWAY_KNN_CACHE", "4") or 4))

    def search_ann(queries: torch.Tensor, docs: torch.Tensor) -> TopKResult:
        key = id(docs)
        index = None
        ent = cache.get(key)
        if ent is not None:
            ref, shape, cached = ent
            if ref() is docs and shape == tuple(docs.shape):
                index = cached
                cache.move_to_end(key)
            else:  # recycled id: the entry is stale, drop it
                del cache[key]
        if index is None:
            # prune entries whose matrix has been freed, THEN evict LRU
            for stale in [kk for kk, (r, _s, _i) in cache.items() if r() is None]:
                del cache[stale]
            host = docs.detach().cpu().numpy()
            index = _ivf.arrays_from_numpy(
                _ivf.build_ivf_pq(host, metric=metric, device=docs.device), docs.device
            )
            cache[key] = (weakref.ref(docs), tuple(docs.shape), index)
            while len(cache) > cache_cap:
                cache.popitem(last=False)
        slots, dists = _ivf.ivf_pq_search(queries, index, k, nprobe=nprobe, metric=metric)
        return TopKResult(indices=slots, distances=dists)

    search_ann._cache = cache  # introspection seam (tests, debugging)
    return search_ann
