"""IVF-PQ: coarse k-means routing plus a product-quantized ADC scan.

Counterpart of ``pathway_tpu/ops/ivf.py``. Docs are routed to the
nearest of ``L`` coarse centroids, and a query scores only the ``nprobe``
closest lists. Each doc row is stored as ``m`` uint8 codes, one
256-entry codebook per ``d/m``-wide subspace, so the scan reads ``m``
bytes a row, and a per-query lookup table (ADC) turns the codes into
approximate scores: ``score(q, x) = sum_j LUT[j, code_j(x)]``. The top ADC
candidates are rescored exactly against their f32 rows, so the final order
among the winners is exact.

The layout is one ``[L, cap, m]`` code cube with ``[L, cap]`` validity and
slot maps, resident on the device, plus the f32 rows in ``full``. Training
(``train_coarse_centroids``, ``train_pq_codebooks``, ``pq_encode`` and the
list assignment and packing) is seeded numpy, copied unchanged from the
JAX package so that both packages build byte-identical indexes. The search
is one function on tensors (``_ivf_pq_search_fn``) and ``ivf_pq_search_host``
is its numpy oracle.

Two choices differ from the JAX program, for the card:

* The ADC gather runs in chunks of probed lists, so its transient (an
  int64 index and the f32 gathered values, ``13 * B * cap * m`` bytes a
  probed list) stays under ``ADC_CHUNK_BYTES`` where XLA would fuse it.
* The products that decide order never use TF32, whatever
  ``torch.backends.cuda.matmul.allow_tf32`` says: the probe and the lookup
  table are float64 products rounded to f32 (cuBLAS takes TF32 only for
  f32 operands), and the exact rescore is an f32 elementwise product and
  sum. A 10-bit mantissa would scramble the near-ties that the rescore
  exists to order.

The list-sharded search (``shard_ivf_pq``, ``ivf_pq_search_sharded``)
places whole routing lists on the shards of a mesh axis, each with a
list-local copy of its rescore rows, runs probe -> ADC -> rescore on every
shard over the probed lists it owns (``parallel/spmd.py``), and merges the
shards' top-k. Only k slots and k scores a shard cross between devices.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from pathway_tpu_torch.engine.device_plane import resolve_device
from pathway_tpu_torch.parallel import spmd
from pathway_tpu_torch.parallel.mesh import P, Sharded

__all__ = [
    "ADC_CHUNK_BYTES",
    "IvfPqArrays",
    "ShardedIvfPq",
    "arrays_from_numpy",
    "auto_lists",
    "auto_nprobe",
    "auto_subvectors",
    "train_coarse_centroids",
    "train_pq_codebooks",
    "pq_encode",
    "assign_lists",
    "pack_lists",
    "build_ivf_pq",
    "ivf_pq_search",
    "ivf_pq_search_host",
    "shard_ivf_pq",
    "ivf_pq_search_sharded",
]

# the ADC gather's transient memory for one chunk of probed lists
ADC_CHUNK_BYTES = 256 << 20


class IvfPqArrays(NamedTuple):
    """The IVF-PQ layout (see module docstring): numpy arrays as training
    builds them, or tensors on one device after `arrays_from_numpy`.

    `slots` maps a (list, pos) cell back to the global row id in `full`
    (-1 on padding cells); `full` keeps the exact rows for the rescore
    phase, indexed by that global id.
    """

    centroids: np.ndarray  # [L, d] f32 (unit-norm for cos)
    codes: np.ndarray  # [L, cap, m] uint8 — PQ codes per list cell
    valid: np.ndarray  # [L, cap] bool — False = padding or tombstone
    slots: np.ndarray  # [L, cap] int32 — global row id (-1 pad)
    codebooks: np.ndarray  # [m, 256, d/m] f32
    full: np.ndarray  # [n_pad, d] f32 — exact rescore rows


# ------------------------------------------------------------- sizing

def auto_lists(n: int, lo: int = 8, hi: int = 4096) -> int:
    """Default coarse-list count: ~sqrt(n) rounded to a power of two.
    Keeps per-list fill near sqrt(n), the classic IVF balance point
    between probe cost (L) and scan cost (n/L)."""
    if n <= 0:
        return lo
    return int(min(hi, max(lo, 1 << round(math.log2(max(math.sqrt(n), 1.0))))))


def auto_nprobe(n_lists: int) -> int:
    """Default probe width: L/8 clamped to [4, 64]. At small L this scans
    ~12.5% of lists; at large L the absolute cap holds the scanned cell
    count (nprobe × cap) flat while the corpus grows — the whole point
    of the index. The per-query recall knob; raise toward L for
    exact-grade recall."""
    return max(4, min(64, n_lists // 8))


def auto_candidates(k: int) -> int:
    """Default ADC-candidate budget for the exact-rescore phase. PQ
    scores are noisy (8-dim subspaces quantized to 256 entries), so the
    rescore set must be generously wider than k — the gather is c*d per
    query, noise next to the scan, and recall@10 on clustered corpora
    moves from ~0.34 (c=64) to >0.95 (c=512)."""
    return max(48 * k, 256)


def auto_subvectors(dim: int, lo: int = 4, hi: int = 64) -> int:
    """Default PQ split: d/8 subspaces (8 dims per codebook), clamped,
    and snapped down to a divisor of `dim`."""
    m = max(lo, min(hi, dim // 8))
    while dim % m != 0:
        m -= 1
    return max(1, m)


# ------------------------------------------------------------ training

def _chunked_argmin_l2(x: np.ndarray, centers: np.ndarray, chunk: int = 65536):
    """argmin_j ||x_i - c_j||^2 without materializing [n, k] at once."""
    cc = (centers * centers).sum(1)
    out = np.empty(x.shape[0], np.int32)
    for s in range(0, x.shape[0], chunk):
        block = x[s : s + chunk]
        d = cc[None, :] - 2.0 * (block @ centers.T)
        out[s : s + chunk] = np.argmin(d, axis=1)
    return out


def train_coarse_centroids(
    vecs: np.ndarray,
    n_lists: int,
    *,
    iters: int = 8,
    seed: int = 0,
    spherical: bool = True,
    sample: int = 262_144,
) -> np.ndarray:
    """Seeded Lloyd k-means over (a sample of) the rows. `spherical`
    renormalizes centroids each round (cosine routing). Empty clusters
    are re-seeded from the densest cluster's points so every list stays
    reachable."""
    n, d = vecs.shape
    rng = np.random.default_rng(seed)
    x = vecs
    if n > sample:
        x = vecs[rng.choice(n, sample, replace=False)]
    k = min(n_lists, x.shape[0])
    centers = x[rng.choice(x.shape[0], k, replace=False)].astype(np.float32).copy()
    for _ in range(iters):
        assign = _chunked_argmin_l2(x, centers)
        counts = np.bincount(assign, minlength=k)
        sums = np.zeros((k, d), np.float64)
        np.add.at(sums, assign, x)
        nonempty = counts > 0
        centers[nonempty] = (
            sums[nonempty] / counts[nonempty, None]
        ).astype(np.float32)
        empty = np.flatnonzero(~nonempty)
        if empty.size:
            donors = rng.choice(x.shape[0], empty.size)
            centers[empty] = x[donors]
        if spherical:
            centers /= np.maximum(
                np.linalg.norm(centers, axis=1, keepdims=True), 1e-12
            )
    if k < n_lists:  # corpus smaller than the list budget: repeat rows
        reps = rng.choice(k, n_lists - k)
        centers = np.concatenate([centers, centers[reps]], axis=0)
    return centers


def train_pq_codebooks(
    vecs: np.ndarray,
    m: int,
    *,
    iters: int = 6,
    seed: int = 0,
    sample: int = 131_072,
) -> np.ndarray:
    """Per-subspace 256-entry k-means codebooks, [m, 256, d/m] f32.
    Corpora smaller than 256 rows train fewer real entries; the rest are
    zero-padded (codes never reference pad entries)."""
    n, d = vecs.shape
    if d % m != 0:
        raise ValueError(f"dim {d} not divisible by {m} subvectors")
    dsub = d // m
    rng = np.random.default_rng(seed + 1)
    x = vecs
    if n > sample:
        x = vecs[rng.choice(n, sample, replace=False)]
    books = np.zeros((m, 256, dsub), np.float32)
    ksub = min(256, x.shape[0])
    for j in range(m):
        sub = x[:, j * dsub : (j + 1) * dsub].astype(np.float32)
        centers = sub[rng.choice(sub.shape[0], ksub, replace=False)].copy()
        for _ in range(iters):
            assign = _chunked_argmin_l2(sub, centers)
            counts = np.bincount(assign, minlength=ksub)
            sums = np.zeros((ksub, dsub), np.float64)
            np.add.at(sums, assign, sub)
            nonempty = counts > 0
            centers[nonempty] = (
                sums[nonempty] / counts[nonempty, None]
            ).astype(np.float32)
            empty = np.flatnonzero(~nonempty)
            if empty.size:
                centers[empty] = sub[rng.choice(sub.shape[0], empty.size)]
        books[j, :ksub] = centers
    return books


def pq_encode(
    vecs: np.ndarray, codebooks: np.ndarray, chunk: int = 65536
) -> np.ndarray:
    """Encode rows to [n, m] uint8 codes (nearest codebook entry per
    subspace)."""
    n, d = vecs.shape
    m, _, dsub = codebooks.shape
    codes = np.empty((n, m), np.uint8)
    for j in range(m):
        sub = vecs[:, j * dsub : (j + 1) * dsub].astype(np.float32)
        codes[:, j] = _chunked_argmin_l2(sub, codebooks[j], chunk).astype(
            np.uint8
        )
    return codes


def assign_lists(
    vecs: np.ndarray, centroids: np.ndarray, chunk: int = 65536
) -> np.ndarray:
    """Route rows to their nearest coarse centroid (L2 — equivalent to
    max inner product for unit-norm rows and centroids)."""
    return _chunked_argmin_l2(vecs.astype(np.float32), centroids, chunk)


def assign_lists_balanced(
    vecs: np.ndarray,
    centroids: np.ndarray,
    cap: int,
    *,
    n_cand: int = 4,
    chunk: int = 65536,
) -> np.ndarray:
    """Route rows to their nearest centroid WITH a per-list cap: a row
    whose nearest list is full spills to its next-nearest with space
    (up to `n_cand` preferences, then the least-filled list).

    Skewed corpora make plain nearest-centroid assignment pile into hot
    lists, and the device layout pays scan cost of nprobe × cap(longest
    list) — padding, not data. Bounding fill keeps the padded cube
    dense; spilled rows stay recallable because multi-probe reads their
    second-nearest list anyway.
    """
    vecs = vecs.astype(np.float32, copy=False)
    n = vecs.shape[0]
    L = centroids.shape[0]
    if n > L * cap:
        raise ValueError(f"{n} rows exceed total capacity {L}x{cap}")
    cand = np.empty((n, n_cand), np.int32)
    cc = (centroids * centroids).sum(1)
    nc = min(n_cand, L)
    for s in range(0, n, chunk):
        block = vecs[s : s + chunk]
        dist = cc[None, :] - 2.0 * (block @ centroids.T)
        part = np.argpartition(dist, nc - 1, axis=1)[:, :nc]
        order = np.argsort(np.take_along_axis(dist, part, 1), axis=1)
        cand[s : s + chunk, :nc] = np.take_along_axis(part, order, 1)
        if nc < n_cand:
            cand[s : s + chunk, nc:] = cand[s : s + chunk, :1]
    assign = np.full(n, -1, np.int32)
    fill = np.zeros(L, np.int64)
    remaining = np.arange(n)
    for r in range(n_cand):
        if remaining.size == 0:
            break
        want = cand[remaining, r]
        order = np.argsort(want, kind="stable")
        sorted_want = want[order]
        uniq, starts, counts = np.unique(
            sorted_want, return_index=True, return_counts=True
        )
        pos_in_group = np.arange(sorted_want.size) - np.repeat(starts, counts)
        accept = pos_in_group < (cap - fill[sorted_want])
        taken = remaining[order[accept]]
        assign[taken] = sorted_want[accept]
        fill[uniq] += np.minimum(counts, np.maximum(cap - fill[uniq], 0))
        remaining = remaining[order[~accept]]
    for row in remaining:  # rare tail: every preferred list was full
        lst = int(np.argmin(fill))
        assign[row] = lst
        fill[lst] += 1
    return assign


def pack_lists(
    assign: np.ndarray,
    codes: np.ndarray,
    n_lists: int,
    *,
    cap: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack per-row codes into the [L, cap, m] cube + valid/slot maps.
    `cap` defaults to the longest list rounded up to a power of two (so
    shape buckets stay stable as lists fill)."""
    counts = np.bincount(assign, minlength=n_lists)
    longest = int(counts.max()) if counts.size else 1
    if cap is None:
        cap = 1 << math.ceil(math.log2(max(longest, 8)))
    elif cap < longest:
        raise ValueError(f"cap {cap} < longest list {longest}")
    m = codes.shape[1]
    cube = np.zeros((n_lists, cap, m), np.uint8)
    valid = np.zeros((n_lists, cap), bool)
    slots = np.full((n_lists, cap), -1, np.int32)
    order = np.argsort(assign, kind="stable")
    pos = np.zeros(n_lists, np.int64)
    for row in order:
        lst = assign[row]
        p = pos[lst]
        cube[lst, p] = codes[row]
        valid[lst, p] = True
        slots[lst, p] = row
        pos[lst] = p + 1
    return cube, valid, slots


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def build_ivf_pq(
    docs: np.ndarray,
    *,
    n_lists: int | None = None,
    subvectors: int | None = None,
    metric: str = "cos",
    seed: int = 0,
    iters: int = 8,
    device: str | torch.device | None = None,
) -> IvfPqArrays:
    """One-shot index build over a static doc matrix (the bench and
    `make_knn_searcher` path; the incremental index lives in
    `pathway_tpu_torch/indexing/ann.py`). The trained arrays stay numpy,
    byte-identical to the JAX package's; `full` is an f32 tensor on
    `device` (the card unless the caller names another).
    `arrays_from_numpy` puts the rest on the device."""
    docs = np.asarray(docs, np.float32)
    n, d = docs.shape
    if metric in ("cos", "cosine"):
        docs = docs / np.maximum(
            np.linalg.norm(docs, axis=1, keepdims=True), 1e-12
        )
    L = n_lists or auto_lists(n)
    m = subvectors or auto_subvectors(d)
    centroids = train_coarse_centroids(
        docs, L, iters=iters, seed=seed, spherical=metric in ("cos", "cosine")
    )
    books = train_pq_codebooks(docs, m, seed=seed)
    codes = pq_encode(docs, books)
    # cap at 2x the average fill (pow2): the probe scan pays nprobe x cap
    # whatever the data skew, so the cube must stay dense
    cap = 1 << math.ceil(math.log2(max(8, 2 * ((n + L - 1) // L))))
    assign = assign_lists_balanced(docs, centroids, cap)
    cube, valid, slots = pack_lists(assign, codes, L, cap=cap)
    # f32, not bf16: the rescore exists to restore exact order among
    # near-tied winners, and bf16-rounded rows (2^-8 resolution) cap
    # recall@10 at ~0.95 on clustered corpora
    full = torch.from_numpy(docs).to(resolve_device(device), copy=True)
    return IvfPqArrays(
        centroids=centroids,
        codes=cube,
        valid=valid,
        slots=slots,
        codebooks=books,
        full=full,
    )


def arrays_from_numpy(
    index: IvfPqArrays, device: str | torch.device | None = None
) -> IvfPqArrays:
    """Carry an index (numpy arrays, the JAX package's included, or
    tensors) onto `device` as tensors: centroids, codebooks and `full` f32,
    the cube uint8, `valid` bool, `slots` int32. Checks on the host that
    `full` holds a row for every slot the cube names: on the card a
    gather past its end is a device fault, not a clamp."""
    dev = resolve_device(device)
    slots = _to_numpy(index.slots).astype(np.int32, copy=False)
    n_full = int(index.full.shape[0])
    if slots.size and int(slots.max()) >= n_full:
        raise ValueError(
            f"the cube names slot {int(slots.max())} but `full` has only "
            f"{n_full} rows"
        )

    def put(x, dtype: torch.dtype) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(dev, dtype)
        # a copy, never a view of the caller's (possibly read-only) array
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    return IvfPqArrays(
        centroids=put(index.centroids, torch.float32),
        codes=put(index.codes, torch.uint8),
        valid=put(index.valid, torch.bool),
        slots=put(slots, torch.int32),
        codebooks=put(index.codebooks, torch.float32),
        full=put(index.full, torch.float32),
    )


# -------------------------------------------------------------- search


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # float64 operands: cuBLAS never takes TF32 for them, and the f64 sum
    # rounded once is at least as close as an f32 sum
    return torch.matmul(a.double(), b.double()).float()


def _adc_scores(
    lut: torch.Tensor, codes: torch.Tensor, probe: torch.Tensor
) -> torch.Tensor:
    """[B, P*cap] ADC scores: sum over the m subspaces of the query's LUT
    entry at each probed cell's code. Runs in blocks of queries and of
    probed lists so that the uint8 codes, the int64 gather index and the
    gathered f32 values of a block (13 bytes a cell and subspace) stay
    under ADC_CHUNK_BYTES."""
    B, m, ncode = lut.shape
    _, cap, _ = codes.shape
    P = probe.shape[1]
    lut_flat = lut.reshape(B, m * ncode)
    offsets = torch.arange(m, device=lut.device) * ncode  # subspace j -> j*256
    adc = torch.empty((B, P * cap), dtype=torch.float32, device=lut.device)
    per_list = 13 * cap * m  # bytes of one probed list of one query
    rows = min(B, max(1, ADC_CHUNK_BYTES // per_list))
    step = max(1, ADC_CHUNK_BYTES // (per_list * rows))
    for b0 in range(0, B, rows):
        b1 = min(B, b0 + rows)
        for p0 in range(0, P, step):
            p1 = min(P, p0 + step)
            idx = codes[probe[b0:b1, p0:p1]].long()  # [b, p, cap, m]
            idx += offsets
            part = lut_flat[b0:b1].gather(1, idx.view(b1 - b0, -1))
            adc[b0:b1, p0 * cap : p1 * cap] = part.view(b1 - b0, (p1 - p0) * cap, m).sum(-1)
            del idx, part
    return adc


def _ivf_pq_search_fn(
    q,
    centroids,
    codes,
    valid,
    slots,
    codebooks,
    full,
    *,
    k: int,
    nprobe: int,
    candidates: int,
    metric: str = "cos",
    n_live: int | None = None,
):
    """probe -> ADC scan -> exact rescore -> top-k, on tensors of one
    device. Returns (slot_ids [B, k] int32, distances [B, k] f32); empty
    ranks carry slot -1 and distance +inf. `n_live` masks trailing pad
    lists out of the probe. The caller guarantees that `full` has a row
    for every slot in `slots` (`arrays_from_numpy` and the incremental
    index check it on the host)."""
    B, d = q.shape
    L, cap, m = codes.shape
    dsub = d // m
    # each stage is a profiler range (`ivf_pq.<stage>`), so a trace splits
    # the search's device time by stage
    with record_function("ivf_pq.probe"):
        q = q.float()
        if metric in ("cos", "cosine"):
            q = q / torch.clamp(torch.linalg.vector_norm(q, dim=1, keepdim=True), min=1e-12)
        csim = _f32_product(q, centroids.t())
        if metric == "l2sq":
            csim = -(
                (q * q).sum(1, keepdim=True)
                - 2.0 * csim
                + (centroids * centroids).sum(1)[None, :]
            )
        if n_live is not None and n_live < L:
            csim[:, n_live:] = -math.inf
        P = min(nprobe, n_live if n_live is not None else L)
        probe = torch.topk(csim, P, dim=1).indices  # [B, P]
    with record_function("ivf_pq.lut"):
        # one [m, 256] row of partial scores per query
        qs = q.view(B, m, dsub)
        lut = _f32_product(qs.transpose(0, 1), codebooks.transpose(1, 2)).transpose(0, 1)
        if metric == "l2sq":
            # ||q_s - c||^2 per subspace entry, negated: larger is better
            lut = -(
                (qs * qs).sum(-1)[:, :, None]
                - 2.0 * lut
                + (codebooks * codebooks).sum(-1)[None, :, :]
            )
    with record_function("ivf_pq.adc"):
        adc = _adc_scores(lut.contiguous(), codes, probe)
        pvalid = valid[probe].view(B, P * cap)
        adc.masked_fill_(~pvalid, -math.inf)
    with record_function("ivf_pq.topc"):
        c = min(candidates, P * cap)
        cand = torch.topk(adc, c, dim=1).indices
        cslots = slots[probe].view(B, P * cap).gather(1, cand)  # [B, c]
        cvalid = pvalid.gather(1, cand)
    with record_function("ivf_pq.rescore"):
        # exact f32 rows of the candidates, an elementwise product and sum
        rows = full.index_select(0, cslots.clamp(min=0).view(-1)).view(B, c, d).float()
        if metric == "l2sq":
            exact = rows.sub_(q[:, None, :]).square_().sum(-1).neg_()
        else:
            exact = rows.mul_(q[:, None, :]).sum(-1)
        del rows
        exact.masked_fill_(~cvalid, -math.inf)
        s, pos = torch.topk(exact, min(k, c), dim=1)
        miss = ~torch.isfinite(s)
        out_slots = cslots.gather(1, pos).masked_fill_(miss, -1)
        dist = (s.neg() if metric in ("l2sq", "dot") else 1.0 - s).masked_fill_(miss, math.inf)
    return out_slots.to(torch.int32), dist


def ivf_pq_search(
    queries,
    index: IvfPqArrays,
    k: int,
    *,
    nprobe: int | None = None,
    candidates: int | None = None,
    metric: str = "cos",
):
    """Functional entry point. `index` should come from
    `arrays_from_numpy` (resident tensors); numpy members are carried to
    `full`'s device on every call. Returns (slots [B, k] int32, distances
    [B, k] f32) on that device."""
    if not all(isinstance(a, torch.Tensor) for a in index):
        dev = index.full.device if isinstance(index.full, torch.Tensor) else None
        index = arrays_from_numpy(index, dev)
    L = index.centroids.shape[0]
    nprobe = nprobe or auto_nprobe(L)
    # floor the rescore budget at one full list: a clustered query's
    # near-ties are mostly one list's fill, and ADC noise alone must not
    # cut within that set
    candidates = candidates or max(auto_candidates(k), index.codes.shape[1])
    if not isinstance(queries, torch.Tensor):
        queries = torch.from_numpy(np.asarray(queries, np.float32))
    q = queries.to(index.full.device, torch.float32)
    if q.ndim == 1:
        q = q[None, :]
    return _ivf_pq_search_fn(
        q,
        index.centroids,
        index.codes,
        index.valid,
        index.slots,
        index.codebooks,
        index.full,
        k=k,
        nprobe=nprobe,
        candidates=candidates,
        metric=metric,
    )


def sub_arrays(index: IvfPqArrays, lists, codes=None) -> IvfPqArrays:
    """Restrict the layout to a subset of routing lists (host-side).

    `slots` keep GLOBAL row ids and `full` passes through whole, so
    results over the sub-layout are directly comparable to the full
    index's — and each query's top-nprobe WITHIN a subset that contains
    its global top-nprobe lists is exactly its global top-nprobe (they
    dominate every other member). `codes` optionally overrides the code
    slices."""
    lists = np.asarray(lists, np.int64)
    return IvfPqArrays(
        centroids=_to_numpy(index.centroids).astype(np.float32, copy=False)[lists],
        codes=_to_numpy(index.codes)[lists] if codes is None else codes,
        valid=_to_numpy(index.valid)[lists],
        slots=_to_numpy(index.slots)[lists],
        codebooks=index.codebooks,
        full=index.full,
    )


class ShardedIvfPq(NamedTuple):
    """The IVF-PQ layout sharded by routing list over a mesh axis.

    Each shard holds L/shards whole lists: its block of the code cube, of
    the validity and slot maps, and a list-local copy of the exact rescore
    rows in cell layout (``cells[l, p] = full[slots[l, p]]``), so probe,
    ADC scan and rescore never read another shard's memory. Centroids and
    codebooks are small and replicated; ``slots`` keep global row ids, so
    merged results read like the unsharded index's. Every array member is
    a :class:`~pathway_tpu_torch.parallel.mesh.Sharded`."""

    centroids: Sharded  # [Lp, d] f32, replicated (pad lists masked)
    codes: Sharded  # [Lp, cap, m] uint8, sharded over `axis`
    valid: Sharded  # [Lp, cap] bool, sharded
    slots: Sharded  # [Lp, cap] int32 global row ids, sharded
    codebooks: Sharded  # [m, 256, d/m] f32, replicated
    cells: Sharded  # [Lp, cap, d] f32 list-local rescore rows, sharded
    n_lists: int  # real (unpadded) list count
    mesh: object
    axis: str


def shard_ivf_pq(index: IvfPqArrays, mesh, axis: str = "data") -> ShardedIvfPq:
    """Place an IvfPqArrays layout (numpy or tensors) onto `mesh`, sharded
    by routing list over `axis`: the list dimension is padded to a
    multiple of the shard count (pad lists are all-invalid and never
    probed) and the rescore rows are laid out per list cell."""
    s = mesh.shape[axis]
    centroids = _to_numpy(index.centroids).astype(np.float32, copy=False)
    codes = _to_numpy(index.codes)
    valid = _to_numpy(index.valid).astype(bool, copy=False)
    slots = _to_numpy(index.slots).astype(np.int32, copy=False)
    full = _to_numpy(index.full).astype(np.float32, copy=False)
    L, cap, m = codes.shape
    d = centroids.shape[1]
    if slots.size and int(slots.max()) >= full.shape[0]:
        raise ValueError(
            f"the cube names slot {int(slots.max())} but `full` has only {full.shape[0]} rows"
        )
    Lp = -(-L // s) * s
    if Lp != L:
        pad = Lp - L
        centroids = np.concatenate([centroids, np.zeros((pad, d), np.float32)])
        codes = np.concatenate([codes, np.zeros((pad, cap, m), np.uint8)])
        valid = np.concatenate([valid, np.zeros((pad, cap), bool)])
        slots = np.concatenate([slots, np.full((pad, cap), -1, np.int32)])
    cells = np.zeros((Lp, cap, d), np.float32)
    cells[valid] = full[slots[valid]]

    def put(x: np.ndarray, spec) -> Sharded:
        return Sharded.from_global(torch.from_numpy(np.ascontiguousarray(x)), mesh, spec)

    return ShardedIvfPq(
        centroids=put(centroids, P()),
        codes=put(codes, P(axis, None, None)),
        valid=put(valid, P(axis, None)),
        slots=put(slots, P(axis, None)),
        codebooks=put(_to_numpy(index.codebooks).astype(np.float32, copy=False), P()),
        cells=put(cells, P(axis, None, None)),
        n_lists=L,
        mesh=mesh,
        axis=axis,
    )


def _sharded_search_fn(q, centroids, codes, valid, slots, codebooks, cells, *, k: int,
                       nprobe: int, candidates: int, metric: str, n_lists: int, axis: str):
    """One shard's probe -> ADC -> rescore over the probed lists it owns,
    then the cross-shard merge of every shard's top-k. The probe is the
    same computation on every shard (replicated query and centroids), so
    all shards agree on the probed global lists."""
    shard = spmd.axis_index(axis)
    n_shards = spmd.axis_size(axis)
    Ls, cap, m = codes.shape
    B, d = q.shape
    dsub = d // m
    q = q.float()
    if metric in ("cos", "cosine"):
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=1, keepdim=True), min=1e-12)
    csim = _f32_product(q, centroids.t())
    if metric == "l2sq":
        csim = -((q * q).sum(1, keepdim=True) - 2.0 * csim + (centroids * centroids).sum(1)[None, :])
    csim[:, n_lists:] = -math.inf  # pad lists never win a probe slot
    Pn = min(nprobe, n_lists)
    probe = torch.topk(csim, Pn, dim=1).indices  # [B, Pn] global list ids
    local_id = probe - shard * Ls
    owned = (local_id >= 0) & (local_id < Ls)
    lidx = local_id.clamp(0, Ls - 1)
    qs = q.view(B, m, dsub)
    lut = _f32_product(qs.transpose(0, 1), codebooks.transpose(1, 2)).transpose(0, 1)
    if metric == "l2sq":
        lut = -((qs * qs).sum(-1)[:, :, None] - 2.0 * lut + (codebooks * codebooks).sum(-1)[None, :, :])
    adc = _adc_scores(lut.contiguous(), codes, lidx)
    pvalid = (valid[lidx] & owned[:, :, None]).view(B, Pn * cap)
    adc.masked_fill_(~pvalid, -math.inf)
    c = min(candidates, Pn * cap)
    cand = torch.topk(adc, c, dim=1).indices
    cslots = slots[lidx].view(B, Pn * cap).gather(1, cand)
    cvalid = pvalid.gather(1, cand)
    # rescore rows from this shard's cell layout: (probed row, cell) ->
    # its [Ls * cap, d] flat rows
    cand_list = lidx.gather(1, cand // cap)
    flat = cand_list * cap + cand % cap
    rows = cells.view(Ls * cap, d).index_select(0, flat.view(-1)).view(B, c, d)
    if metric == "l2sq":
        exact = rows.sub_(q[:, None, :]).square_().sum(-1).neg_()
    else:
        exact = rows.mul_(q[:, None, :]).sum(-1)
    del rows
    exact.masked_fill_(~cvalid, -math.inf)
    kk = min(k, c)
    s_loc, pos = torch.topk(exact, kk, dim=1)
    slots_loc = cslots.gather(1, pos)
    # the merge: k slots and k scores of every shard
    cand_s = torch.cat(list(spmd.all_gather(s_loc, axis)), dim=1)
    cand_slots = torch.cat(list(spmd.all_gather(slots_loc, axis)), dim=1)
    ms, mpos = torch.topk(cand_s, min(k, n_shards * kk), dim=1)
    mslots = cand_slots.gather(1, mpos)
    miss = ~torch.isfinite(ms)
    dist = (ms.neg() if metric in ("l2sq", "dot") else 1.0 - ms).masked_fill_(miss, math.inf)
    return mslots.masked_fill_(miss, -1).to(torch.int32), dist


def ivf_pq_search_sharded(
    queries,
    sindex: ShardedIvfPq,
    k: int,
    *,
    nprobe: int | None = None,
    candidates: int | None = None,
    metric: str = "cos",
):
    """Search a list-sharded index: each shard probes, scans and rescores
    its own lists, and the shards' top-k merge. Returns (global slot ids
    [B, k] int32, distances [B, k] f32) on the mesh's first device, with
    `ivf_pq_search`'s -1/+inf empty ranks. Each shard rescores its own
    top-`candidates`, a superset of the unsharded search's candidates
    among its lists, so recall can only match or improve on it."""
    L = sindex.n_lists
    cap = sindex.codes.shape[1]
    nprobe = nprobe or auto_nprobe(L)
    candidates = candidates or max(auto_candidates(k), cap)
    if not isinstance(queries, torch.Tensor):
        queries = torch.from_numpy(np.asarray(queries, np.float32))
    q = queries.float()
    if q.ndim == 1:
        q = q[None, :]
    fn = spmd.shard_map(
        functools.partial(
            _sharded_search_fn, k=k, nprobe=min(nprobe, L), candidates=candidates,
            metric="cos" if metric == "cosine" else metric, n_lists=L, axis=sindex.axis,
        ),
        sindex.mesh,
        in_specs=(P(),) * 7,
        out_specs=(P(), P()),
    )
    return fn(q, sindex.centroids, sindex.codes, sindex.valid, sindex.slots, sindex.codebooks, sindex.cells)


def ivf_pq_search_host(
    queries: np.ndarray,
    index: IvfPqArrays,
    k: int,
    *,
    nprobe: int | None = None,
    candidates: int | None = None,
    metric: str = "cos",
) -> tuple[np.ndarray, np.ndarray]:
    """Pure-numpy mirror of the device program: the oracle the tests hold
    the torch search to, and the incremental index's `device=False` path.
    Same probe/ADC/rescore structure, so the candidate sets match the
    device path up to float associativity."""
    index = IvfPqArrays(*(_to_numpy(a) for a in index))
    full = index.full.astype(np.float32, copy=False)
    q = np.asarray(queries, np.float32)
    if q.ndim == 1:
        q = q[None, :]
    if metric in ("cos", "cosine"):
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    B, d = q.shape
    L, cap, m = index.codes.shape
    dsub = d // m
    P = min(nprobe or auto_nprobe(L), L)
    c_budget = candidates or max(auto_candidates(k), cap)
    if metric == "l2sq":
        csim = -(
            (q * q).sum(1, keepdims=True)
            - 2.0 * q @ index.centroids.T
            + (index.centroids * index.centroids).sum(1)[None, :]
        )
    else:
        csim = q @ index.centroids.T
    out_slots = np.full((B, k), -1, np.int32)
    out_dist = np.full((B, k), np.inf, np.float32)
    for b in range(B):
        probe = np.argpartition(-csim[b], min(P, L) - 1)[:P]
        pcodes = index.codes[probe].reshape(P * cap, m)
        pvalid = index.valid[probe].reshape(P * cap)
        pslots = index.slots[probe].reshape(P * cap)
        qs = q[b].reshape(m, dsub)
        if metric == "l2sq":
            lut = -(
                (qs * qs).sum(-1)[:, None]
                - 2.0 * np.einsum("ms,mcs->mc", qs, index.codebooks)
                + (index.codebooks * index.codebooks).sum(-1)
            )
        else:
            lut = np.einsum("ms,mcs->mc", qs, index.codebooks)
        adc = lut[np.arange(m)[None, :], pcodes.astype(np.int64)].sum(1)
        adc[~pvalid] = -np.inf
        c = min(c_budget, adc.shape[0])
        cand = np.argpartition(-adc, c - 1)[:c]
        cand = cand[pvalid[cand]]
        if cand.size == 0:
            continue
        cslots = pslots[cand]
        rows = full[cslots]
        if metric == "l2sq":
            diff = q[b][None, :] - rows
            exact = -np.sum(diff * diff, axis=-1)
        else:
            exact = rows @ q[b]
        kk = min(k, exact.shape[0])
        top = np.argpartition(-exact, kk - 1)[:kk]
        top = top[np.argsort(-exact[top], kind="stable")]
        out_slots[b, :kk] = cslots[top]
        out_dist[b, :kk] = (
            -exact[top] if metric in ("l2sq", "dot") else 1.0 - exact[top]
        )
    return out_slots, out_dist
