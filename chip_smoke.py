#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pathway_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``pathway_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card (timed at the main
path's two shapes, checked at every tiling and at ragged lengths), then drives the
live-RAG embed -> index -> retrieve path at the flagship encoder's full
width (vocab 32768, d_model 384, 6 heads, 6 layers, d_ff 1536, seq 64,
embed_dim 384; random weights from a seed): 1,048,576 docs encoded in
16384-row batches into a ``VectorSlabIndex`` on the card, a few thousand
texts of the repo's own documentation through ``TorchEmbedder`` (bulk and
coalesced), self-retrieval over the 1M-doc slab, exact and int8 search
timed. The approximate tier follows: bench.py's 1M x 64 ANN corpus built
into an IVF-PQ index and searched at bench.py's operating point (against
exact search and the numpy oracle, split by stage against its bound), then
``IvfPqIndex`` over a quarter million flagship-width rows (retrain, search,
churn in waves, the reranked nprobe-1 wrapper), and the same index with
its lists in RAM/disk tiers over 65,536 of those rows (the hot route on
the card, cold lists read from disk, churn, the tier contract). Between
the RAG phases and the approximate tier, ``VectorStoreServer`` serves the
texts over REST with its default embedder, held to a direct slab search,
and ``EncoderReranker`` is held to the CPU; then ``python -m
pathway_tpu_torch spawn -n 1`` and ``-n 2`` run an ingest pipeline over
131,072 documents, each process embedding its share with the default
embedder on the card, the two runs held to each other. After the tiers,
``pw.ml.index.KNNIndex`` answers 256 queries over the tiered rows in one
run, held to a direct slab search. Then it generates with bench.py's
Gemma-2B-shaped decoder at full width (vocab 256128, d_model 2048, 8
heads, 18 layers, d_ff 16384, max_len 1024; random bf16 weights from a
seed): ``generate_serving`` at batch 32 (decode step against its bound, a
profile by class), continuous batching of 96 requests through
``TorchLMChat``, and the slot and wave paths held byte-equal at f32 on
JaxLMChat's default model. Each phase prints one JSON line; the line
before the last is the kernel table, the last is the result. Any failure
exits non-zero. Without a CUDA device, or without the package beside it,
it exits non-zero too.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate, dense bf16 tensor-core rate and
# the f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

FLAGSHIP = dict(
    vocab_size=32768, d_model=384, n_heads=6, n_layers=6, d_ff=1536,
    max_len=64, embed_dim=384,
)
N_DOCS = 1 << 20  # the 1M-doc scale of the KNN target
DOC_BATCH, DOC_SEQ = 16384, 64  # bench.py's encoder batch
N_QUERIES, TOP_K = 16, 10
# (label, b, s, d, n_heads), timed: the flagship encoder's embed batch, the
# default TorchEmbedder's widest bucket and the bucket its RAG phases fill
# (s 32: documents and questions of at most 32 tokens), and the flagship
# width at the short buckets (s 16 and 32) that the texts phase's chunks
# fall into
ATTENTION_SHAPES = [
    ("flagship", 16384, 64, 384, 6),
    ("embedder_default", 4096, 128, 256, 8),
    ("embedder_default_s32", 4096, 32, 256, 8),
    ("flagship_s32", 16384, 32, 384, 6),
    ("flagship_s16", 16384, 16, 384, 6),
]
# checked, not timed: the other tilings of the kernel (s 16 and 32 with a
# batch that is not a multiple of 4, s 128 at dh 64 is its largest tile) and
# ragged s at both head dims
ATTENTION_CHECK_SHAPES = [
    ("s16_dh64", 4097, 16, 384, 6),
    ("s32_dh64", 4097, 32, 384, 6),
    ("s128_dh64", 2048, 128, 384, 6),
    ("s40_dh64", 2048, 40, 384, 6),
    ("s40_dh32", 2048, 40, 256, 8),
    ("s100_dh64", 2048, 100, 384, 6),
    ("s100_dh32", 2048, 100, 256, 8),
]
# every shape is checked on this many seeded inputs, the first one timed
ATTENTION_SEEDS = 3
# kernel vs plain: the same bf16 inputs and f32 sums; a sum in another
# order can flip one bf16 rounding of a probability or of ctx, so the
# bound is one bf16 ulp at |ctx| < 8 (unit-normal qkv keeps |ctx| < 8)
ATTENTION_ATOL = 2.0**-5
TEXT_FILES = ["docs/*.md", "SURVEY.md", "PAPER.md", "VERDICT.md", "BASELINE.md"]

# the host engine: bench.py's wordcount rung (WORDCOUNT_ROWS, bench.py:50;
# the generator at bench.py:925-940)
WORDCOUNT_ROWS, WORDCOUNT_SEED = 5_000_000, 7
# the live-RAG pipeline through pw.run: bench.py's config-4 on-chip RAG rung
# at its own sizes (bench.py:724-779), the default TorchEmbedder and
# TorchLMChat (JaxEmbedder's and JaxLMChat's defaults)
EMBEDDER_DEFAULT = dict(
    vocab_size=32768, d_model=256, n_heads=8, n_layers=4, d_ff=1024, max_len=128, embed_dim=256,
)
RAG_DOCS, RAG_QUESTIONS, RAG_WAVES, RAG_SEED, RAG_TOPK, RAG_NEW = 512, 128, 8, 4, 4, 32
# a live document store at a deployment's size: documents drawn from the
# texts phase's chunks, streamed in waves, then questions retrieved
INGEST_DOCS, INGEST_WAVES, INGEST_QUESTIONS, INGEST_K = 131_072, 16, 64, 4
# engine vs direct build: the engine embeds each chunk in another wave
# (another row mix and sequence bucket) than the direct build, so the
# same chunk's bf16 embedding may differ by a few bf16 ulps, and its
# score against the bf16 slab mirror by up to 2^-6 (unit vectors)
INGEST_SCORE_ATOL = 2.0**-6

# the approximate tier: bench.py's bench_ann corpus and operating point
# (bench.py:1468-1488; d 64, 1M rows over 1000 gaussian topics, seed 7)
ANN_ROWS, ANN_DIM, ANN_SEED = 1_000_000, 64, 7
ANN_BATCH, ANN_K, ANN_NPROBE, ANN_CANDIDATES = 32, 10, 16, 1024
ANN_FRONTIER = (4, 16, 64)  # bench.py's bench_ann_frontier
ANN_MIN_RECALL = 0.93  # the JAX package's 1-CPU run recorded 0.941 on these bytes
# the incremental index runs over a quarter of the slab's random-token rows
# plus all its text rows: its host retrain took 193-312 s over all 1,050,705
# rows and 187-267 s over half of them, the larger part of the script's time
ANN_INDEX_DOCS = N_DOCS // 4
# churn of the incremental index: waves of removes and fresh adds, a search after each
CHURN_WAVES, CHURN_WAVE = 16, 256
# the tiered index: the same rows cut to 65,536 (all text rows, the rest
# random-token rows): its host numpy retrain took 149 s at 131,072 rows on
# the 8 host CPUs of an H100 machine; m 48 as the flagship width's
# auto_subvectors; 4 churn waves, a rebalance after each
TIERED_ROWS, TIERED_SUBVECTORS, TIERED_CHURN_WAVES = 65_536, 48, 4
# the vector store: the texts phase's chunks behind VectorStoreServer's
# default embedder, 32 REST queries at k 4
VS_QUERIES, VS_K = 32, 4
# EncoderReranker's scores on the card against the CPU's (same weights):
# the two devices round the bf16 activations at other points
RERANK_ATOL = 2.0**-6

# generation: bench.py's Gemma-2B-shaped decoder ("config 5", bench.py:297-304)
# at its full width and depth, random bf16 weights from seed 0
GEMMA_2B = dict(
    vocab_size=256_128, d_model=2048, n_heads=8, n_layers=18, d_ff=16384, max_len=1024,
)
GEN_BATCH, GEN_PROMPT, GEN_NEW = 32, 64, 64  # bench.py's decode rung
CB_REQUESTS, CB_NEW, CB_SLOTS = 96, 32, 32  # continuous batching through TorchLMChat
# JaxLMChat's default model (pathway_tpu/xpacks/llm/llms.py:218-221), run at
# f32 for the slot-vs-wave equality check
CHAT_DEFAULT = dict(
    vocab_size=32768, d_model=256, n_heads=8, n_layers=4, d_ff=1024, max_len=512,
)
EQ_PROMPTS, EQ_BATCH = 48, 16
# bf16 decode logits against a full causal forward over the same tokens:
# the two round at other points (cached K/V vs recomputed, other matmul
# shapes) on logits of |l| < 8
DECODE_VS_FORWARD_ATOL = 0.125


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median device time of one call, over `reps` calls timed one by one
    with CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int) -> float:
    """Median host time of one call that ends in a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def attention_bound(b: int, s: int, d: int, h: int) -> tuple[float, str, int, int]:
    """Least time the card could take for the kernel's work, in ms: qkv
    and the mask read once, ctx written once, over the HBM rate; against
    4*b*h*s*s*dh flops (q.k^T and p.v) over the bf16 tensor-core rate."""
    nbytes = b * s * 3 * d * 2 + b * s * 4 + b * s * d * 2
    flops = 4 * b * h * s * s * (d // h)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, bound_by, nbytes, flops


# ------------------------------------------------------------ phase 1


def attention_case(b: int, s: int, d: int, seed: int):
    """Seeded unit-normal bf16 qkv and a mask with random lengths, every
    97th row all padding (as bucket padding makes)."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, s, 3 * d), generator=gen, device=dev).to(torch.bfloat16)
    lens = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
    lens[::97] = 0
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None]).to(torch.int32)
    return qkv, mask, lens


def check_attention(label: str, b: int, s: int, d: int, h: int, seed: int, timed: bool) -> dict:
    """The kernel against its plain version on ATTENTION_SEEDS seeded bf16
    inputs with random padding and all-padding rows; with `timed`, also the
    times of the kernel, the plain version and SDPA on the first."""
    import torch
    import torch.nn.functional as F

    from pathway_tpu_torch.ops.attention import fused_qkv_attention, reference_attention

    errs, pad_errs, finite, ref_max, n_pad = [], [], True, 0.0, 0
    for i in range(ATTENTION_SEEDS):
        qkv, mask, lens = attention_case(b, s, d, seed + 1000 * i)
        out = fused_qkv_attention(qkv, mask, h)
        torch.cuda.synchronize()
        ref = reference_attention(qkv, mask, h)
        errs.append((out.float() - ref.float()).abs().max().item())
        finite = finite and bool(torch.isfinite(out.float()).all())
        ref_max = max(ref_max, ref.float().abs().max().item())
        # all-padding rows attend uniformly: ctx is the mean of v
        pad_rows = (lens == 0).nonzero().flatten()
        v_mean = qkv[pad_rows, :, 2 * d:].float().mean(dim=1, keepdim=True)
        pad_errs.append((out[pad_rows].float() - v_mean).abs().max().item())
        n_pad += int(pad_rows.numel())
        del qkv, mask, out, ref
    err, pad_err = max(errs), max(pad_errs)

    row = dict(
        phase="attention" if timed else "attention_check", shape=label, b=b, s=s, d=d,
        n_heads=h, max_abs_err=err, max_abs_err_by_seed=errs, atol=ATTENTION_ATOL,
        finite=finite, all_padding_rows=n_pad, all_padding_err=pad_err,
    )
    if timed:
        # timed on the first seed's inputs
        qkv, mask, _ = attention_case(b, s, d, seed)
        ref = reference_attention(qkv, mask, h)
        # one PyTorch call for the same function, timed as a yardstick only
        q, k, v = (t.transpose(1, 2) for t in qkv.view(b, s, 3, h, d // h).unbind(2))
        bias = torch.zeros((b, 1, 1, s), dtype=qkv.dtype, device=qkv.device)
        bias.masked_fill_(mask[:, None, None, :] == 0, -1e30)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)

        lib_err = (library().transpose(1, 2).reshape(b, s, d).float() - ref.float()).abs().max().item()
        ms = cuda_ms(lambda: fused_qkv_attention(qkv, mask, h), 30)
        plain_ms = cuda_ms(lambda: reference_attention(qkv, mask, h), 20)
        library_ms = cuda_ms(library, 20)
        bound_ms, bound_by, nbytes, flops = attention_bound(b, s, d, h)
        row.update(
            library_err=lib_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
            achieved_gb_s=nbytes / (ms * 1e-3) / 1e9,
        )
        del qkv, mask, ref, q, k, v, bias
    emit(row)
    if not finite or ref_max >= 8 or err > ATTENTION_ATOL or pad_err > ATTENTION_ATOL:
        raise AssertionError(f"attention kernel disagrees with its plain version: {row}")
    torch.cuda.empty_cache()
    return row


# ------------------------------------------------------------ phase 2


def load_texts(root: Path, seed: int = 0) -> list[str]:
    """A few thousand text chunks (6-20 words) of the repo's own docs."""
    import numpy as np

    words: list[str] = []
    for pattern in TEXT_FILES:
        for path in sorted(root.glob(pattern)):
            words += path.read_text(encoding="utf-8").split()
    rng = np.random.default_rng(seed)
    texts, i = [], 0
    while i < len(words):
        n = int(rng.integers(6, 21))
        texts.append(" ".join(words[i:i + n]))
        i += n
    return texts


def profile_encode(emb, ids, mask) -> dict:
    """Device time by kernel over two encode batches (torch.profiler),
    against the host time of the same two batches (profiler start-up
    excluded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            emb.encode_tokens(ids, mask)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.self_device_time_total and str(ev.device_type).endswith("CUDA"):
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + ev.self_device_time_total / 1e3
    busy = sum(by_kernel.values())
    if not busy:
        return dict(window_ms=wall_ms, device_busy_ms="not measured")
    by_class = {"attention_kernel": 0.0, "matmul": 0.0, "elementwise_and_reductions": 0.0}
    for name, ms in by_kernel.items():
        if "fused_qkv_attention" in name:
            by_class["attention_kernel"] += ms
        elif any(t in name for t in ("nvjet", "gemm", "cutlass", "sm90_xmma")):
            by_class["matmul"] += ms
        else:
            by_class["elementwise_and_reductions"] += ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return dict(
        window_ms=wall_ms, device_busy_ms=busy, device_idle_share=1 - busy / wall_ms,
        share_by_class={k: v / busy for k, v in by_class.items()},
        top_kernels_ms=[[name[:90], ms] for name, ms in top],
    )


def run_slice(device, cfg_kw: dict, n_docs: int, batch: int, seq: int, root: Path) -> dict:
    """The port's main path: encode `n_docs` seeded token rows and a few
    thousand texts, index them, retrieve. Returns the numbers it read, the
    indexed (unit-norm) rows and the text queries with their keys. Runs on
    the CPU too (at a small size), for a rehearsal."""
    import numpy as np
    import torch

    from pathway_tpu_torch import TorchEmbedder, VectorSlabIndex
    from pathway_tpu_torch.models.transformer import embedder_config
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.attention import KERNEL
    from pathway_tpu_torch.ops.topk import knn_search, knn_search_masked, knn_search_quantized, quantize_docs

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg = embedder_config(**cfg_kw)
    emb = TorchEmbedder(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    ids = torch.randint(
        2, cfg.vocab_size, (n_docs, seq), generator=torch.Generator(device=dev).manual_seed(1),
        device=dev, dtype=torch.int32,
    )
    mask = torch.ones((batch, seq), dtype=torch.int32, device=dev)
    vecs = torch.empty((n_docs, cfg.embed_dim), dtype=torch.float32, device=dev)

    # -- the main path, with the launch counts read across it
    _build.reset_launch_counts()
    dispatches0 = emb.dispatches
    emb.encode_tokens(ids[:batch], mask)  # warm-up: cuBLAS handles, caches
    sync()
    t0 = time.perf_counter()
    for i in range(0, n_docs, batch):
        vecs[i:i + batch] = emb.encode_tokens(ids[i:i + batch], mask)
    sync()
    encode_s = time.perf_counter() - t0
    enc = dict(
        phase="encode", docs=n_docs, batch=batch, seq=seq, seconds=encode_s,
        embeddings_per_s=n_docs / encode_s,
        finite=bool(torch.isfinite(vecs).all()),
        norm_err=(torch.linalg.norm(vecs, dim=1) - 1).abs().max().item(),
    )
    if on_card:
        enc["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        enc["profile"] = profile_encode(emb, ids[:batch], mask)
    emit(enc)
    if not enc["finite"] or enc["norm_err"] > 1e-3:
        raise AssertionError(f"encoder output is not unit-norm and finite: {enc}")

    host_vecs = vecs.cpu().numpy()
    del vecs, ids
    texts_raw = load_texts(root)
    seen, texts = set(), []
    for t in texts_raw:  # texts that tokenize alike would retrieve each other
        tok = tuple(emb.tokenizer.tokenize(t))
        if tok not in seen:
            seen.add(tok)
            texts.append(t)
    index = VectorSlabIndex(dimensions=cfg.embed_dim, reserved_space=n_docs + len(texts), device=dev)
    t0 = time.perf_counter()
    for i in range(n_docs):
        index.add(i, host_vecs[i])
    add_s = time.perf_counter() - t0

    # texts: bulk, then coalesced copies of a sample as the queries
    t0 = time.perf_counter()
    cap = emb._plane.buckets.max_rows  # encode_many takes one row bucket
    text_vecs = []
    for j in range(0, len(texts), cap):
        text_vecs += emb.encode_many(texts[j:j + cap])
    sync()
    text_s = time.perf_counter() - t0
    for j, v in enumerate(text_vecs):
        index.add(n_docs + j, v, metadata={"text": j})
    sample = list(range(0, len(texts), max(1, len(texts) // 512)))[:512]
    flushes0 = emb._batcher.flushes

    async def embed_all():
        return await asyncio.gather(*(emb.__wrapped__(texts[j]) for j in sample))

    t0 = time.perf_counter()
    coalesced = asyncio.run(embed_all())
    embed_s = time.perf_counter() - t0
    flushes = emb._batcher.flushes - flushes0
    cos = [float(np.dot(coalesced[n], text_vecs[j])) for n, j in enumerate(sample)]

    hits = 0
    for g in range(0, len(sample), N_QUERIES):
        got = index.search_batch([(coalesced[n], TOP_K, None) for n in range(g, min(g + N_QUERIES, len(sample)))])
        hits += sum(m[0][0] == n_docs + sample[g + r] for r, m in enumerate(got))
    texts_row = dict(
        phase="texts", texts=len(texts), encode_many_s=text_s, add_docs_s=add_s,
        coalesced=len(sample), coalesced_flushes=flushes, coalesced_s=embed_s,
        coalesced_vs_bulk_min_cos=min(cos), self_top1=hits, indexed=len(index),
    )
    emit(texts_row)
    if hits != len(sample) or min(cos) < 0.999 or flushes != 1:
        raise AssertionError(f"self-retrieval or coalescing failed: {texts_row}")

    # -- retrieval over the slab: 16 text queries, exact and int8 layouts
    qsel = sample[:N_QUERIES]
    qvecs = np.stack([coalesced[n] for n in range(len(qsel))])
    items = [(q, TOP_K, None) for q in qvecs]
    docs_t, valid_t = index.device_docs()
    qt = torch.from_numpy(qvecs).to(dev)
    timer = host_ms if on_card else _cpu_ms
    search_batch_ms = timer(lambda: index.search_batch(items), 30)
    masked_ms = timer(lambda: knn_search_masked(qt, docs_t, valid_t, TOP_K, "cos"), 30)
    n_live = index.n_slots
    qdocs = quantize_docs(docs_t[:n_live])
    quant = knn_search_quantized(qt, qdocs, TOP_K)
    quant_ms = timer(lambda: knn_search_quantized(qt, qdocs, TOP_K), 30)
    exact = knn_search(qt, qdocs.full, TOP_K, "cos", normalized=True)
    qi, ei = quant.indices.cpu().numpy(), exact.indices.cpu().numpy()
    recall = float(np.mean([len(set(qi[r]) & set(ei[r])) / TOP_K for r in range(len(qsel))]))
    quant_self = int(sum(qi[r][0] == n_docs + j for r, j in enumerate(qsel)))
    sb = index.search_batch(items)
    exact_self = int(sum(m[0][0] == n_docs + j for m, j in zip(sb, qsel)))
    launches = _build.LAUNCHES.get(KERNEL, 0)
    dispatches = emb.dispatches - dispatches0
    knn = dict(
        phase="knn", slab_rows=int(docs_t.shape[0]), live=n_live, queries=len(qsel), k=TOP_K,
        search_batch_p50_ms=search_batch_ms, knn_search_masked_p50_ms=masked_ms,
        knn_search_quantized_p50_ms=quant_ms, quantized_recall_at_10=recall,
        exact_self_top1=exact_self, quantized_self_top1=quant_self,
        attention_launches=launches, encoder_dispatches=dispatches, n_layers=cfg.n_layers,
    )
    emit(knn)
    if exact_self != len(qsel) or quant_self != len(qsel):
        raise AssertionError(f"retrieval over the slab missed a self-query: {knn}")
    if on_card and (launches <= 0 or launches != cfg.n_layers * dispatches):
        raise AssertionError(
            f"the main path did not go through the attention kernel: {launches} launches "
            f"for {dispatches} encoder dispatches x {cfg.n_layers} layers"
        )
    # the ANN phases index the same rows and search with the same queries
    return dict(
        encode=enc, texts=texts_row, knn=knn, launches=launches,
        vectors=index.vectors[: index.n_slots], query_vecs=qvecs,
        query_keys=[n_docs + j for j in qsel], text_chunks=texts,
    )


def _cpu_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ------------------------------------------------------------ phase 2a
# the host dataflow engine and the live-RAG pipeline on it


def wordcount_input(path: Path, n: int) -> dict[str, int]:
    """bench.py's wordcount input (`_gen_wordcount_input`, seed 7): `n`
    jsonlines rows of one of 10,000 random 10-letter words. Returns the
    count of each word."""
    import numpy as np

    rng = np.random.default_rng(WORDCOUNT_SEED)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    dictionary = ["".join(rng.choice(letters, 10)) for _ in range(10_000)]
    idx = rng.integers(0, len(dictionary), n)
    with open(path, "w") as f:
        for s in range(0, n, 200_000):
            f.write("\n".join('{"word": "%s"}' % dictionary[i] for i in idx[s:s + 200_000]) + "\n")
    counts = np.bincount(idx, minlength=len(dictionary))
    return {dictionary[i]: int(c) for i, c in enumerate(counts) if c}


def run_engine_wordcount(n_rows: int, workdir: Path) -> dict:
    """bench.py's wordcount rung (`bench.py:363`) on `import
    pathway_tpu_torch as pw`: jsonlines -> groupby -> count -> csv, held to
    a count over the input. The host libraries build (or load) first, so
    the rate is the engine's."""
    import os

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import native
    from pathway_tpu_torch.internals.parse_graph import G

    planes = native.planes()
    src, out = workdir / "words.jsonl", workdir / "counts.csv"
    want = wordcount_input(src, n_rows)

    class S(pw.Schema):
        word: str

    G.clear()
    t0 = time.perf_counter()
    t = pw.io.fs.read(str(src), format="json", schema=S, mode="static")
    res = t.groupby(t.word).reduce(t.word, count=pw.reducers.count())
    pw.io.csv.write(res, str(out))
    pw.run()
    seconds = time.perf_counter() - t0
    G.clear()
    got: dict[str, int] = {}
    lines = out.read_text().splitlines()
    for ln in lines[1:]:
        word, count, _time, diff = ln.split(",")
        got[word] = got.get(word, 0) + int(count) * int(diff)
    row = dict(
        phase="engine_wordcount", rows=n_rows, seconds=seconds, rows_per_s=n_rows / seconds,
        words=len(got), header=lines[0], native_zset=planes["zset"],
        native_dataplane=planes["dataplane"], gpp_build_s=planes["build_seconds"],
        cpu_count=os.cpu_count(), equals_counter=got == want,
    )
    emit(row)
    if got != want:
        raise AssertionError(f"wordcount output differs from a count over the input: {row}")
    return row


def rag_corpus(n_docs: int, n_q: int, waves: int, seed: int):
    """bench.py's config-4 rung's documents and questions (`bench.py:724-
    735`): 24- and 6-word strings over six words, the questions streamed
    in `waves` waves."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
    doc_rows = [((" ".join(rng.choice(words, 24))).encode(), {"path": f"d{i}.txt"}) for i in range(n_docs)]
    per_wave = n_q // waves
    q_rows = [(" ".join(rng.choice(words, 6)), None, False, 2 * (i // per_wave) + 2, 1) for i in range(n_q)]
    return doc_rows, q_rows


class StageClock:
    """Seconds inside each device stage of a pipeline run, read as bench.py's
    `timed` wrappers read them (`bench.py:742-758`): embed inside the
    embedder's coalesced flushes, retrieve inside the slab's search_batch,
    generate inside the continuous batcher's prefill and step calls (its
    own host-clock counters; bench.py wrapped the wave path's flush)."""

    def __init__(self, emb, chat=None):
        import threading

        from pathway_tpu_torch.stdlib.indexing.host_indexes import VectorSlabIndex

        self.seconds = {"embed": 0.0, "retrieve": 0.0}
        self.embed_rows = 0
        self.indexes: list = []
        self._lock = threading.Lock()
        self._cls = VectorSlabIndex
        self._search = VectorSlabIndex.search_batch
        self._emb, self._flush = emb, emb._batcher.flush_fn
        self._cb = chat._cb if chat is not None else None
        self._cb0 = self._cb_seconds()
        clock = self

        def flush(items):
            t0 = time.perf_counter()
            try:
                return clock._flush(items)
            finally:
                with clock._lock:
                    clock.seconds["embed"] += time.perf_counter() - t0
                    clock.embed_rows += len(items)

        def search_batch(index, items, *a, **kw):
            t0 = time.perf_counter()
            try:
                return clock._search(index, items, *a, **kw)
            finally:
                with clock._lock:
                    clock.seconds["retrieve"] += time.perf_counter() - t0
                    if all(index is not i for i in clock.indexes):
                        clock.indexes.append(index)

        emb._batcher.flush_fn = flush
        VectorSlabIndex.search_batch = search_batch

    def _cb_seconds(self) -> float:
        return 0.0 if self._cb is None else self._cb.stats["prefill_seconds"] + self._cb.stats["step_seconds"]

    def close(self) -> dict:
        self._emb._batcher.flush_fn = self._flush
        self._cls.search_batch = self._search
        if self._cb is not None:
            self.seconds["generate"] = self._cb_seconds() - self._cb0
        return dict(self.seconds)


def run_window(fn, on_card: bool) -> dict:
    """Host seconds of `fn`; on the card also the device busy and idle
    share over the same window (torch.profiler, all threads)."""
    if on_card:
        prof = profile_window(fn)
        return dict(seconds=prof["window_ms"] / 1e3, device_busy_ms=prof["device_busy_ms"],
                    device_idle_share=prof["device_idle_share"])
    t0 = time.perf_counter()
    fn()
    return dict(seconds=time.perf_counter() - t0, device_busy_ms="not measured",
                device_idle_share="not measured")


def run_rag_pipeline(device, emb_kw: dict, chat_kw: dict, *, n_docs: int, n_q: int, waves: int,
                     topk: int, new_tokens: int, chat_f32: bool) -> dict:
    """bench.py's config-4 on-chip RAG rung (`bench.py:713-785`) through
    `pw.run()`: DocumentStore over BruteForceKnnFactory with the default
    TorchEmbedder, BaseRAGQuestionAnswerer over TorchLMChat, the
    questions streamed in waves. With `chat_f32` the chat runs at f32 and
    every answer the engine produced is held byte for byte to a direct
    call of the chat on the same prompt (phase `rag_f32_equality`)."""
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import TorchEmbedder, TorchLMChat
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.models.transformer import embedder_config, lm_config
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.attention import KERNEL
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
    from pathway_tpu_torch.xpacks.llm.question_answering import BaseRAGQuestionAnswerer

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg = embedder_config(**emb_kw)
    emb = TorchEmbedder(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    lcfg = lm_config(dtype=torch.float32 if chat_f32 else torch.bfloat16, **chat_kw)
    chat = TorchLMChat(lcfg, max_new_tokens=new_tokens, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))
    doc_rows, q_rows = rag_corpus(n_docs, n_q, waves, RAG_SEED)
    prompts: list = []
    submit = chat._cb.submit

    def recording_submit(prompt):
        fut = submit(prompt)
        prompts.append((prompt, fut))
        return fut

    # warm-up outside the timed run: first calls set up cuBLAS handles
    # and the chat's slot cache
    emb.encode_many(["warm-up"])
    submit("warm-up").result(timeout=600)
    chat._cb.drain()
    chat._cb.submit = recording_submit

    G.clear()
    docs = pw.debug.table_from_rows(pw.schema_from_types(data=bytes, _metadata=object), doc_rows)
    store = DocumentStore(docs, retriever_factory=BruteForceKnnFactory(
        dimensions=cfg.embed_dim, embedder=emb, device=dev))
    answerer = BaseRAGQuestionAnswerer(chat, store, search_topk=topk)
    queries = pw.debug.table_from_rows(answerer.AnswerQuerySchema, q_rows, is_stream=True)
    answers = answerer.answer_query(queries)
    got: list = []
    pw.io.subscribe(
        queries.join(answers, queries.id == answers.id).select(q=queries.prompt, a=answers.result),
        on_change=lambda key, row, time, is_addition: got.append((row["q"], row["a"].value["response"])),
    )
    clock = StageClock(emb, chat)
    dispatches0 = emb.dispatches
    _build.reset_launch_counts()
    try:
        window = run_window(pw.run, on_card)
    finally:
        stages = clock.close()
        chat._cb.submit = submit
        G.clear()
    launches = _build.LAUNCHES.get(KERNEL, 0)
    dispatches = emb.dispatches - dispatches0
    stage_sum = sum(stages.values())
    row = dict(
        phase="rag_f32_equality" if chat_f32 else "rag_pipeline", documents=n_docs, questions=n_q,
        waves=waves, search_topk=topk, new_tokens=new_tokens,
        chat_dtype="f32" if chat_f32 else "bf16", embedder_dtype="bf16",
        **window, questions_per_s=n_q / window["seconds"], stage_seconds=stages, stage_sum=stage_sum,
        overlap=1 - window["seconds"] / stage_sum if stage_sum else "not measured",
        answer_rows=len(got), answered_questions=len({q for q, _ in got}),
        attention_launches=launches, encoder_dispatches=dispatches, embedded_rows=clock.embed_rows,
        rows_per_dispatch=clock.embed_rows / dispatches if dispatches else 0.0,
        cb_stats=dict(chat._cb.stats),
    )
    ok = len(got) == n_q and row["answered_questions"] == len({r[0] for r in q_rows})
    if chat_f32:
        chat._cb.drain()

        async def direct():
            return await asyncio.gather(*(chat.__wrapped__(p) for p, _ in prompts))

        engine = [f.result(timeout=600) for _, f in prompts]
        direct_answers = asyncio.run(direct())
        equal = sum(a == b for a, b in zip(engine, direct_answers))
        row.update(prompts=len(prompts), equal_to_direct=equal,
                   engine_answers_are_the_rows=sorted(engine) == sorted(a for _, a in got))
        ok = ok and equal == len(prompts) == n_q and row["engine_answers_are_the_rows"]
    emit(row)
    if not ok:
        raise AssertionError(f"the RAG pipeline did not answer every question as asked: {row}")
    if on_card and (launches <= 0 or launches != cfg.n_layers * dispatches):
        raise AssertionError(
            f"the RAG pipeline's embeds did not go through the attention kernel: {launches} "
            f"launches for {dispatches} encoder dispatches x {cfg.n_layers} layers"
        )
    chat._cb.drain()
    return row


def ingest_corpus(texts: list[str], n_docs: int, seed: int) -> list[str]:
    """`n_docs` documents drawn with replacement from `texts`, each made
    unique by an id token of its own."""
    import numpy as np

    pick = np.random.default_rng(seed).integers(0, len(texts), n_docs)
    return [f"{texts[j]} doc{i:07d}" for i, j in enumerate(pick)]


def run_rag_ingest(device, emb_kw: dict, texts: list[str], *, n_docs: int, waves: int,
                   n_q: int, k: int) -> dict:
    """A live document store at a deployment's size: `n_docs` documents
    streamed in `waves` waves into DocumentStore with the app's
    TokenCountSplitter(50, 250) and the default TorchEmbedder, then `n_q`
    questions retrieved with `k`. Held to (i) a direct split of the same
    documents and (ii) a VectorSlabIndex built directly from
    `encode_many` over the same chunks on the same device, compared as
    (score, text) after the re-sort."""
    import numpy as np
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import TorchEmbedder, VectorSlabIndex
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.models.transformer import embedder_config
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.attention import KERNEL
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg = embedder_config(**emb_kw)
    emb = TorchEmbedder(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    emb.encode_many(["warm-up"])  # outside the timed run, as in rag_pipeline
    # word counts: tiktoken would fetch its encoding over the network on first use
    splitter = TokenCountSplitter(min_tokens=50, max_tokens=250, tokenize_fn=str.split)
    docs = ingest_corpus(texts, n_docs, seed=0)
    rng = np.random.default_rng(1)
    questions = [texts[j] for j in rng.choice(len(texts), n_q, replace=False)]
    per_wave = -(-n_docs // waves)
    doc_rows = [(d.encode(), {"path": f"doc{i}.txt"}, 2 * (i // per_wave) + 2, 1) for i, d in enumerate(docs)]
    q_time = 2 * waves + 2  # after the last document wave

    G.clear()
    table = pw.debug.table_from_rows(pw.schema_from_types(data=bytes, _metadata=object), doc_rows, is_stream=True)
    store = DocumentStore(table, retriever_factory=BruteForceKnnFactory(
        dimensions=cfg.embed_dim, embedder=emb, device=dev), splitter=splitter)
    rq = pw.debug.table_from_rows(
        DocumentStore.RetrieveQuerySchema, [(q, k, None, None, q_time, 1) for q in questions], is_stream=True,
    )
    retrieved = rq.select(query=rq.query).with_columns(result=store.retrieve_query(rq).result)
    chunks: dict[str, int] = {}
    results: dict[str, list] = {}

    def on_chunk(key, row, time, is_addition):
        chunks[row["text"]] = chunks.get(row["text"], 0) + (1 if is_addition else -1)

    def on_result(key, row, time, is_addition):
        if is_addition:
            res = row["result"].value
            results[row["query"]] = sorted((float(d["dist"]), d["text"]) for d in res)

    pw.io.subscribe(store.chunked_docs, on_change=on_chunk)
    pw.io.subscribe(retrieved, on_change=on_result)
    clock = StageClock(emb)
    dispatches0 = emb.dispatches
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    try:
        window = run_window(pw.run, on_card)
    finally:
        stages = clock.close()
        G.clear()
    launches = _build.LAUNCHES.get(KERNEL, 0)
    dispatches = emb.dispatches - dispatches0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else "not measured"
    (slab,) = clock.indexes
    docs_t, valid_t = slab.device_docs()

    # (i) the store holds exactly the direct split's chunks
    want_chunks: dict[str, int] = {}
    for d in docs:
        for c, _meta in splitter.chunk(d):
            want_chunks[c] = want_chunks.get(c, 0) + 1
    held = {c: n for c, n in chunks.items() if n}
    # (ii) top-k against a slab built directly on the same device
    direct_texts = list(want_chunks)
    direct = VectorSlabIndex(dimensions=cfg.embed_dim, reserved_space=len(direct_texts), device=dev)
    cap = emb._plane.buckets.max_rows
    t0 = time.perf_counter()
    for s in range(0, len(direct_texts), cap):
        for j, v in enumerate(emb.encode_many(direct_texts[s:s + cap])):
            direct.add(s + j, v)
    direct_build_s = time.perf_counter() - t0
    qvecs = emb.encode_many(questions)
    want = {
        q: sorted((d, direct_texts[key]) for key, d in m)
        for q, m in zip(questions, direct.search_batch([(v, k, None) for v in qvecs]))
    }
    mismatches, near_ties = [], 0
    for q in questions:
        got_q, want_q = results.get(q, []), want[q]
        if len(got_q) != len(want_q):
            mismatches.append((q, got_q, want_q))
            continue
        for (gd, gt), (wd, wt) in zip(got_q, want_q):
            if abs(gd - wd) > INGEST_SCORE_ATOL:
                mismatches.append((q, got_q, want_q))
                break
            near_ties += gt != wt
    row = dict(
        phase="rag_ingest", documents=n_docs, waves=waves, splitter="TokenCountSplitter(50, 250)",
        chunks=sum(held.values()), **window,
        documents_per_s=n_docs / window["seconds"], chunks_per_s=sum(held.values()) / window["seconds"],
        stage_seconds=stages, attention_launches=launches, encoder_dispatches=dispatches,
        embedded_rows=clock.embed_rows,
        rows_per_dispatch=clock.embed_rows / dispatches if dispatches else 0.0,
        slab_rows=len(slab), slab_slots=int(docs_t.shape[0]),
        slab_bytes=dict(host_f32=int(slab.vectors.nbytes),
                        device=int(docs_t.numel() * docs_t.element_size() + valid_t.numel())),
        peak_mem_gb=peak_gb, chunks_equal_direct_split=held == want_chunks,
        questions=n_q, k=k, answered=len(results), direct_build_s=direct_build_s,
        score_atol=INGEST_SCORE_ATOL, near_ties=near_ties, mismatches=len(mismatches),
        first_mismatch=str(mismatches[0])[:600] if mismatches else None,
    )
    emit(row)
    if not row["chunks_equal_direct_split"] or len(results) != n_q or mismatches:
        raise AssertionError(f"the ingested store disagrees with the direct build: {row}")
    if on_card and (launches <= 0 or launches != cfg.n_layers * dispatches):
        raise AssertionError(
            f"ingest did not embed through the attention kernel: {launches} launches for "
            f"{dispatches} encoder dispatches x {cfg.n_layers} layers"
        )
    return row


def run_host_engine(device, *, wordcount_rows: int, emb_kw: dict, chat_kw: dict, rag: dict,
                    ingest_texts: list[str], ingest: dict, workdir: Path) -> dict:
    """The four phases of the host-engine slice, in order. Returns their
    rows and the attention kernel's launches across the three RAG phases."""
    wc = run_engine_wordcount(wordcount_rows, workdir)
    pipe = run_rag_pipeline(device, emb_kw, chat_kw, chat_f32=False, **rag)
    ing = run_rag_ingest(device, emb_kw, ingest_texts, **ingest)
    eq = run_rag_pipeline(device, emb_kw, chat_kw, chat_f32=True, **rag)
    launches = sum(r["attention_launches"] for r in (pipe, ing, eq))
    return dict(wordcount=wc, rag_pipeline=pipe, rag_ingest=ing, rag_f32_equality=eq, launches=launches)


# ------------------------------------------------------------ spawn_embed


# The pipeline that `python -m pathway_tpu_torch spawn -n N` runs in each
# process: documents from jsonlines shards (one source per shard, so the
# sources split across the processes), chunked with rag_ingest's splitter,
# embedded by TorchEmbedder where they were read, then two mesh crossings
# (a groupby over documents, a join back to the chunks). Each process
# writes its share of the final table and its own counts.
SPAWN_EMBED_SCRIPT = """
import json, os, sys, threading, time

CFG = json.load(open(sys.argv[1]))
sys.path.insert(0, CFG["root"])
import numpy as np
import torch

import pathway_tpu_torch as pw
from pathway_tpu_torch import TorchEmbedder
from pathway_tpu_torch.models.convert import params_from_numpy
from pathway_tpu_torch.models.transformer import embedder_config
from pathway_tpu_torch.ops import _build
from pathway_tpu_torch.ops.attention import KERNEL
from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

PID = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
N = int(os.environ.get("PATHWAY_PROCESSES", "1"))

kw = {}
if CFG.get("embedder"):
    ekw = dict(CFG["embedder"])
    dtype = getattr(torch, ekw.pop("dtype", "bfloat16"))
    kw["config"] = embedder_config(dtype=dtype, **ekw)
if CFG.get("device"):
    kw["device"] = CFG["device"]
if CFG.get("params"):
    z = np.load(CFG["params"])
    tree = {k: z[k] for k in z.files if not k.startswith("blocks.")}
    tree["blocks"] = [
        {k.split(".")[2]: z[k] for k in z.files if k.startswith(f"blocks.{i}.")}
        for i in range(kw["config"].n_layers)
    ]
    kw["params"] = params_from_numpy(tree, kw["config"], device=kw.get("device"), dtype=kw["config"].dtype)
emb = TorchEmbedder(**kw)
embedded_rows = [0]
lock = threading.Lock()
flush = emb._batcher.flush_fn


def counted_flush(items):
    with lock:
        embedded_rows[0] += len(items)
    return flush(items)


emb._batcher.flush_fn = counted_flush
splitter = TokenCountSplitter(min_tokens=50, max_tokens=250, tokenize_fn=str.split)


@pw.udf
def split(text: str) -> list:
    return [(i, c) for i, (c, _meta) in enumerate(splitter.chunk(text))]


class Doc(pw.Schema):
    doc: int
    text: str


shards = [
    pw.io.jsonlines.read(path, schema=Doc, mode="streaming", autocommit_duration_ms=50, _single_pass=True)
    for path in CFG["shards"]
]
docs = shards[0].concat_reindex(*shards[1:]).with_id_from(pw.this.doc)
parts = docs.select(doc=pw.this.doc, part=split(pw.this.text)).flatten(pw.this.part)
chunks = parts.select(doc=pw.this.doc, idx=pw.this.part[0], text=pw.this.part[1]).with_id_from(
    pw.this.doc, pw.this.idx)
embedded = chunks.select(
    doc=pw.this.doc, idx=pw.this.idx, text=pw.this.text,
    chars=pw.apply_with_type(len, int, pw.this.text), vec=emb(pw.this.text),
)
per_doc = embedded.groupby(pw.this.doc).reduce(
    doc=pw.this.doc, n_chunks=pw.reducers.count(), doc_chars=pw.reducers.sum(pw.this.chars))
out = embedded.join(per_doc, embedded.doc == per_doc.doc).select(
    doc=embedded.doc, idx=embedded.idx, text=embedded.text, n_chunks=per_doc.n_chunks,
    doc_chars=per_doc.doc_chars, vec=embedded.vec,
)
rows = {}
retractions = [0]


def on_change(key, row, time, is_addition):
    # every chunk and every document total is final in the wave that
    # makes it: a retraction would be a fault, counted for the caller
    if is_addition:
        rows[key.value] = row
    else:
        retractions[0] += 1


pw.io.subscribe(out, on_change=on_change)
_build.reset_launch_counts()
t0 = time.perf_counter()
pw.run()
seconds = time.perf_counter() - t0
launches = _build.LAUNCHES.get(KERNEL, 0)
keys = sorted(rows)
e = emb.config.embed_dim
np.savez(
    CFG["out"] + f".{PID}.npz",
    key_hi=np.array([k >> 64 for k in keys], np.uint64),
    key_lo=np.array([k & ((1 << 64) - 1) for k in keys], np.uint64),
    doc=np.array([rows[k]["doc"] for k in keys], np.int64),
    idx=np.array([rows[k]["idx"] for k in keys], np.int64),
    n_chunks=np.array([rows[k]["n_chunks"] for k in keys], np.int64),
    doc_chars=np.array([rows[k]["doc_chars"] for k in keys], np.int64),
    text=np.array([rows[k]["text"] for k in keys], dtype=str),
    vec=np.stack([np.asarray(rows[k]["vec"], np.float32) for k in keys]) if keys
    else np.zeros((0, e), np.float32),
)
with open(CFG["out"] + f".{PID}.json", "w") as f:
    json.dump(dict(
        process=PID, processes=N, device=str(emb.device), attention_launches=launches,
        embedded_rows=embedded_rows[0], encoder_dispatches=emb.dispatches, output_rows=len(keys),
        retractions=retractions[0],
        run_seconds=seconds, device_idle_share="not measured",
    ), f)
"""
# the embeddings of -n 2 against -n 1: the same chunks embedded in other
# batches (another row bucket, another row order in a bucket), so a chunk's
# bf16 embedding may differ by a few bf16 ulps, as in rag_ingest
SPAWN_EMBED_ATOL = INGEST_SCORE_ATOL
SPAWN_SHARDS = 4


def save_params(tree: dict, path: Path) -> None:
    """A parameter tree (numpy leaves, the JAX package's layout) as one
    .npz that the spawned pipeline loads through models/convert.py."""
    import numpy as np

    flat = {k: np.asarray(v) for k, v in tree.items() if k != "blocks"}
    for i, blk in enumerate(tree["blocks"]):
        flat.update({f"blocks.{i}.{k}": np.asarray(v) for k, v in blk.items()})
    np.savez(path, **flat)


def free_port_base(n: int) -> int:
    """The first of `n * n` consecutive localhost ports free now (the
    process mesh listens on ports from PATHWAY_FIRST_PORT up)."""
    import socket

    for _ in range(60):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        try:
            for i in range(n * n):
                with socket.socket() as s2:
                    s2.bind(("127.0.0.1", base + i))
        except OSError:
            continue
        return base
    raise RuntimeError("no free range of localhost ports for the process mesh")


def read_spawn_output(outdir: Path) -> dict:
    """The processes' shares of one spawned run, merged and sorted by key."""
    import numpy as np

    parts = [np.load(p) for p in sorted(outdir.glob("out.*.npz"))]
    merged = {k: np.concatenate([z[k] for z in parts]) for k in parts[0].files}
    order = np.lexsort((merged["key_lo"], merged["key_hi"]))
    return {k: v[order] for k, v in merged.items()}


def run_spawn_embed(device, emb_kw: dict | None, texts: list[str], *, n_docs: int, shards: int,
                    processes: tuple[int, ...], workdir: Path, params: Path | None = None,
                    embed_atol: float = SPAWN_EMBED_ATOL, timeout_s: float = 600.0) -> dict:
    """rag_ingest's documents through `python -m pathway_tpu_torch spawn
    -n N` for each N in `processes` (SPAWN_EMBED_SCRIPT in each process;
    `device` None is the embedder's default, the card). Every run must
    exit 0 and every process must embed rows (and, on the card, launch the
    attention kernel); the runs must agree with the first run: keys, chunk
    counts and texts byte for byte, embeddings within `embed_atol`, and
    with a direct split of the documents."""
    import os
    import signal

    import numpy as np

    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    docs = ingest_corpus(texts, n_docs, seed=0)
    shard_dir = workdir / "shards"
    shard_dir.mkdir(parents=True, exist_ok=True)
    paths = [shard_dir / f"docs-{i}.jsonl" for i in range(shards)]
    for i, path in enumerate(paths):
        path.write_text("".join(json.dumps({"doc": j, "text": docs[j]}) + "\n" for j in range(i, n_docs, shards)))
    script = workdir / "spawn_embed_pipeline.py"
    script.write_text(SPAWN_EMBED_SCRIPT)
    on_card = device is None or str(device).startswith("cuda")
    runs: dict[int, dict] = {}
    outputs = {}
    for n in processes:
        outdir = workdir / f"n{n}"
        outdir.mkdir()
        cfg = dict(root=str(ROOT), shards=[str(p) for p in paths], out=str(outdir / "out"),
                   embedder=emb_kw, device=device, params=None if params is None else str(params))
        (outdir / "cfg.json").write_text(json.dumps(cfg))
        cmd = [sys.executable, "-m", "pathway_tpu_torch", "spawn", "-n", str(n),
               "--first-port", str(free_port_base(n)), "--", str(script), str(outdir / "cfg.json")]
        env = {**os.environ, "PYTHONPATH": str(ROOT)}
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, start_new_session=True)
        try:
            out, err = proc.communicate(timeout=timeout_s)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"spawn -n {n} exited {proc.returncode}:\n{out[-2000:]}\n{err[-4000:]}")
        stats = [json.loads((outdir / f"out.{p}.json").read_text()) for p in range(n)]
        run_s = max(st["run_seconds"] for st in stats)
        runs[n] = dict(processes=stats, wall_seconds=wall, run_seconds=run_s, documents_per_s=n_docs / run_s,
                       documents_per_wall_s=n_docs / wall)
        outputs[n] = read_spawn_output(outdir)
        for st in stats:
            if st["retractions"]:
                raise AssertionError(f"process {st['process']} of spawn -n {n} saw retractions: {st}")
            if st["embedded_rows"] <= 0 or (on_card and st["attention_launches"] <= 0):
                raise AssertionError(f"process {st['process']} of spawn -n {n} embedded nothing "
                                     f"on the attention kernel: {st}")
            if on_card and not st["device"].startswith("cuda"):
                raise AssertionError(f"process {st['process']} of spawn -n {n} ran on {st['device']}")

    splitter = TokenCountSplitter(min_tokens=50, max_tokens=250, tokenize_fn=str.split)
    want = sorted((j, i, c) for j, d in enumerate(docs) for i, (c, _m) in enumerate(splitter.chunk(d)))
    first = outputs[processes[0]]
    got = sorted(zip(first["doc"].tolist(), first["idx"].tolist(), first["text"].tolist()))
    per_doc = np.bincount(first["doc"], minlength=n_docs)
    exact = ("key_hi", "key_lo", "doc", "idx", "n_chunks", "doc_chars", "text")
    equal, max_err = True, 0.0
    for n in processes[1:]:
        other = outputs[n]
        equal &= all(np.array_equal(first[k], other[k]) for k in exact)
        if first["vec"].shape == other["vec"].shape:
            max_err = max(max_err, float(np.abs(first["vec"] - other["vec"]).max(initial=0.0)))
        else:
            equal = False
    row = dict(
        phase="spawn_embed", documents=n_docs, shards=shards, chunks=len(first["doc"]),
        splitter="TokenCountSplitter(50, 250)", runs=runs,
        equal_direct_split=got == want and bool(np.array_equal(per_doc[first["doc"]], first["n_chunks"])),
        equal_n1_n2=bool(equal), max_abs_err_n1_n2=max_err, embed_atol=embed_atol,
        attention_launches=sum(st["attention_launches"] for r in runs.values() for st in r["processes"]),
    )
    emit(row)
    if not row["equal_direct_split"] or not equal or max_err > embed_atol:
        raise AssertionError(f"the spawned runs disagree: {row}")
    return row


# ------------------------------------------------------------ ml_knn


ML_KNN_QUERIES, ML_KNN_K = 256, 10
# the same slab code on the same vectors, searched in another batch: a
# near-tie is two rows whose scores differ by less than this
ML_KNN_TIE_ATOL = 1e-4


def run_ml_knn(device, vectors, query_rows: list[int], *, k: int) -> dict:
    """`pw.ml.index.KNNIndex` (its default device, the card) over
    `vectors`, the `query_rows` of them as queries in one `pw.run()`,
    held to a direct `VectorSlabIndex.search_batch` over the same vectors
    on the same device: rows in order, apart from near-ties, which are
    counted."""
    import numpy as np
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.stdlib.indexing.host_indexes import VectorSlabIndex
    from pathway_tpu_torch.stdlib.ml.index import KNNIndex

    n, d = vectors.shape
    G.clear()
    t0 = time.perf_counter()
    data = pw.debug.table_from_rows(pw.schema_from_types(row=int, vec=np.ndarray),
                                    [(i, vectors[i]) for i in range(n)])
    qs = pw.debug.table_from_rows(pw.schema_from_types(q=int, qvec=np.ndarray),
                                  [(j, vectors[r]) for j, r in enumerate(query_rows)])
    kw = {} if device is None else {"device": device}
    index = KNNIndex(data.vec, data, n_dimensions=d, distance_type="cosine", **kw)
    res = index.get_nearest_items(qs.qvec, k=k, with_distances=True)
    joined = res.join(qs, res.id == qs.id).select(q=pw.right.q, rows=pw.left.row, dist=pw.left.dist)
    results: dict[int, tuple] = {}
    slabs: list = []
    search = VectorSlabIndex.search_batch

    def search_batch(self, items, *a, **kw):
        if all(self is not s for s in slabs):
            slabs.append(self)
        return search(self, items, *a, **kw)

    pw.io.subscribe(joined, on_change=lambda key, row, time, is_addition:
                    results.__setitem__(row["q"], (tuple(row["rows"]), tuple(row["dist"]))) if is_addition else None)
    VectorSlabIndex.search_batch = search_batch
    try:
        t1 = time.perf_counter()
        pw.run()
        run_s = time.perf_counter() - t1
    finally:
        VectorSlabIndex.search_batch = search
        G.clear()
    seconds = time.perf_counter() - t0
    (slab,) = slabs
    docs_t, _valid = slab.device_docs()
    direct = VectorSlabIndex(dimensions=d, reserved_space=n, metric="cos", **kw)
    for i in range(n):
        direct.add(i, vectors[i])
    want = direct.search_batch([(vectors[r], k, None) for r in query_rows])
    mismatches, near_ties = [], 0
    for j, w in enumerate(want):
        got_rows, got_dist = results.get(j, ((), ()))
        want_rows = [key for key, _s in w]
        want_dist = [s for _key, s in w]
        if len(got_rows) != len(want_rows) or any(
                abs(g - s) > ML_KNN_TIE_ATOL for g, s in zip(got_dist, want_dist)):
            mismatches.append((j, got_rows, want_rows))
            continue
        for pos, (g, wr) in enumerate(zip(got_rows, want_rows)):
            if g != wr:
                if abs(got_dist[pos] - want_dist[pos]) <= ML_KNN_TIE_ATOL:
                    near_ties += 1
                else:
                    mismatches.append((j, got_rows, want_rows))
                    break
    self_top1 = sum(results.get(j, ((None,),))[0][:1] == (r,) for j, r in enumerate(query_rows))
    row = dict(
        phase="ml_knn", rows=n, dim=d, queries=len(query_rows), k=k, answered=len(results),
        seconds=seconds, run_seconds=run_s, mirror_device=str(docs_t.device),
        mirror_rows=int(docs_t.shape[0]), tie_atol=ML_KNN_TIE_ATOL, near_ties=near_ties,
        mismatches=len(mismatches), self_top1=self_top1,
        first_mismatch=str(mismatches[0])[:600] if mismatches else None,
    )
    emit(row)
    on_card = device is None or str(device).startswith("cuda")
    if mismatches or len(results) != len(query_rows) or (on_card and docs_t.device.type != "cuda"):
        raise AssertionError(f"KNNIndex disagrees with the direct slab or left the card: {row}")
    return row


# ------------------------------------------------------------ phase 2b


IVF_STAGES = ("probe", "lut", "adc", "topc", "rescore")


def ivf_bound(B: int, P: int, cap: int, m: int, c: int, d: int, L: int, k: int) -> dict:
    """Least time the card could take for one IVF-PQ search, in ms. Bytes:
    the probed lists' codes (uint8), validity (bool) and slots (int32), the
    candidates' f32 rescore rows, the centroids and codebooks, the queries
    and the result, each once. Operations: the probe and LUT products, the
    ADC adds and the rescore products, at the f32 rate outside the tensor
    cores (the f64 tensor-core rate is the same)."""
    cells = B * P * cap
    parts = dict(
        codes=cells * m, valid=cells, slots=4 * cells, rescore_rows=4 * B * c * d,
        centroids=4 * L * d, codebooks=4 * 256 * d, queries=4 * B * d, result=8 * B * k,
    )
    nbytes = sum(parts.values())
    flops = 2 * B * L * d + 2 * B * 256 * d + cells * m + 2 * B * c * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return dict(
        bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, flops=flops,
        worked_out=(
            " + ".join(f"{name} {v / 1e6:.3f} MB" for name, v in parts.items())
            + f" = {nbytes / 1e6:.3f} MB over {HBM_BYTES_PER_S / 1e12} TB/s = {t_bytes * 1e3:.4f} ms;"
            f" {flops / 1e9:.3f} GFLOP over {F32_FLOPS / 1e12:.0f} TFLOP/s = {t_ops * 1e3:.4f} ms"
        ),
    )


def profile_stages(fn, n_calls: int) -> dict:
    """Device time of `n_calls` IVF-PQ searches split by stage (the
    `ivf_pq.<stage>` profiler ranges of the search; "outside" is what runs
    outside them: padding, copies in and out), kernel launches per call,
    and the idle share of the profiled window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    stage_ms = dict.fromkeys((*IVF_STAGES, "outside"), 0.0)
    launches = 0
    by_kernel: dict[str, float] = {}
    for ev in prof.events():
        if not ev.kernels:
            continue
        ms = sum(k.duration for k in ev.kernels) / 1e3
        launches += len(ev.kernels)
        stage, p = "outside", ev
        while p is not None:
            if p.name.startswith("ivf_pq."):
                stage = p.name.split(".", 1)[1]
                break
            p = p.cpu_parent
        stage_ms[stage] += ms
        for k in ev.kernels:
            by_kernel[k.name] = by_kernel.get(k.name, 0.0) + k.duration / 1e3
    busy = sum(stage_ms.values())
    if not busy:
        return dict(window_ms=wall_ms, kernel_ms_per_call="not measured")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        calls=n_calls, window_ms=wall_ms, kernel_ms_per_call=busy / n_calls,
        launches_per_call=launches / n_calls, device_idle_share=1 - busy / wall_ms,
        stage_ms_per_call={k: v / n_calls for k, v in stage_ms.items()},
        stage_share={k: v / busy for k, v in stage_ms.items()},
        top_kernels_ms_per_call=[[name[:80], ms / n_calls] for name, ms in top],
    )


def bench_ann_corpus(n: int, d: int = ANN_DIM, batch: int = ANN_BATCH):
    """bench.py's `bench_ann` corpus and queries, bit for bit
    (bench.py:1473-1486): gaussian topics, noise 0.15, unit rows; queries
    are rows plus noise 0.05."""
    import numpy as np

    rng = np.random.default_rng(ANN_SEED)
    kc = max(1000, n // 1000)
    centers = rng.standard_normal((kc, d), dtype=np.float32)
    docs = centers[rng.integers(0, kc, n)]
    docs += 0.15 * rng.standard_normal((n, d), dtype=np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q = docs[rng.choice(n, batch)] + 0.05 * rng.standard_normal((batch, d), dtype=np.float32)
    return docs, q


def _recall(got, want, k: int) -> float:
    return float(sum(len(set(g[:k]) & set(w[:k])) for g, w in zip(got, want)) / (k * len(want)))


def run_ann(device, *, ann_rows: int, vectors, query_vecs, query_keys, slab_p50_ms: float,
            churn_waves: int, churn_wave: int, reps: int) -> dict:
    """The port's approximate tier. (a) `ann_build` and `ann_search`:
    bench.py's 1M x 64 ANN corpus built by `build_ivf_pq(seed=0)` and
    searched at its operating point (B 32, k 10, nprobe 16, candidates
    1024), against exact `knn_search` and the numpy oracle, then the
    nprobe 4/16/64 frontier. (b) `ann_index`: `IvfPqIndex` over `vectors`
    (run_slice's rows at the flagship width) with one explicit retrain,
    searched with run_slice's text queries, churned in waves, and wrapped
    in `RerankedSlabIndex` at nprobe 1. Returns the rows it printed. Runs
    on the CPU too (at a small size), for a rehearsal."""
    import numpy as np
    import torch

    from pathway_tpu_torch.engine.device_plane import get_device_plane
    from pathway_tpu_torch.indexing import IvfPqIndex, RerankedSlabIndex
    from pathway_tpu_torch.ops import ivf
    from pathway_tpu_torch.ops.topk import knn_search

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    timer = host_ms if on_card else _cpu_ms
    k = ANN_K

    # -- (a) bench.py's corpus and operating point
    docs, q = bench_ann_corpus(ann_rows)
    t0 = time.perf_counter()
    host = ivf.build_ivf_pq(docs, seed=0, device=dev)
    build_s = time.perf_counter() - t0
    index = ivf.arrays_from_numpy(host, dev)
    L, cap, m = index.codes.shape
    build = dict(
        phase="ann_build", rows=ann_rows, dim=ANN_DIM, build_s=build_s, lists=L, cap=cap,
        subvectors=m, cube_bytes=index.codes.numel() + index.valid.numel() + 4 * index.slots.numel(),
        full_bytes=4 * index.full.numel(),
    )
    emit(build)

    qt = torch.from_numpy(q).to(dev)

    def search(nprobe: int = ANN_NPROBE):
        return ivf.ivf_pq_search(qt, index, k, nprobe=nprobe, candidates=ANN_CANDIDATES)

    transient = {}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    slots, dists = search()
    got = slots.cpu().numpy()
    if on_card:  # what one search allocates on top of the resident index
        transient["search_transient_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    exact = knn_search(qt, index.full, k, "cos", normalized=True)
    ei = exact.indices.cpu().numpy()
    # the f32 order: q.d in f32 (TF32 off), the order the rescore restores
    f32 = torch.topk(ivf._f32_product(torch.nn.functional.normalize(qt), index.full.t()), k).indices.cpu().numpy()
    oracle, _ = ivf.ivf_pq_search_host(q, host._replace(full=docs), k, nprobe=ANN_NPROBE,
                                        candidates=ANN_CANDIDATES)
    ann_p50 = timer(search, reps)
    exact_p50 = timer(lambda: knn_search(qt, index.full, k, "cos", normalized=True), reps)
    srch = dict(
        phase="ann_search", rows=ann_rows, batch=ANN_BATCH, k=k, nprobe=ANN_NPROBE,
        candidates=ANN_CANDIDATES, p50_ms=ann_p50, exact_knn_search_p50_ms=exact_p50,
        speedup=exact_p50 / ann_p50, recall_at_10=_recall(got, ei, k),
        recall_at_10_vs_f32=_recall(got, f32, k),
        oracle_sets_equal=int(sum(set(a) == set(b) for a, b in zip(got, oracle))),
        finite=bool(torch.isfinite(dists).all()), shape=list(slots.shape),
        **ivf_bound(ANN_BATCH, ANN_NPROBE, cap, m, ANN_CANDIDATES, ANN_DIM, L, k), **transient,
    )
    if on_card:
        srch["event_ms"] = cuda_ms(search, reps)
        srch["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        srch["profile"] = profile_stages(search, 10)
        srch["share_of_bound"] = srch["bound_ms"] / srch["profile"]["kernel_ms_per_call"]
        # the order-deciding products never take TF32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            s32, d32 = search()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        srch["tf32_on_identical"] = bool(torch.equal(s32, slots) and torch.equal(d32, dists))
    frontier = []
    for nprobe in ANN_FRONTIER:
        s_np = search(nprobe)[0].cpu().numpy()
        frontier.append(dict(nprobe=nprobe, recall_at_10=_recall(s_np, ei, k),
                             p50_ms=timer(lambda: search(nprobe), reps)))
    srch["frontier"] = frontier
    emit(srch)
    if (srch["shape"] != [ANN_BATCH, k] or not srch["finite"] or srch["recall_at_10"] < ANN_MIN_RECALL
            or srch["oracle_sets_equal"] < ANN_BATCH - 1 or not srch.get("tf32_on_identical", True)):
        raise AssertionError(f"the IVF-PQ search is wrong: {srch}")
    del index, host, docs, qt, exact
    if on_card:
        torch.cuda.empty_cache()

    # -- (b) the incremental index at the flagship width
    n, d = vectors.shape
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    # train_min past the row count: the adds never train, one explicit
    # retrain does, and churn later never schedules another
    ann = IvfPqIndex(dimensions=d, reserved_space=n, train_min=n + 1, background_retrain=False, device=dev)
    t0 = time.perf_counter()
    for i in range(n):
        ann.add(i, vectors[i])
    add_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ann.retrain_now()
    retrain_s = time.perf_counter() - t0
    gen = ann._gen
    items = [(v, k, None) for v in query_vecs]
    qmat = np.stack(query_vecs).astype(np.float32)

    def exact_keys(qs):
        out = []
        for slots_r, d_r in ann._topk_host(qs, k):
            order = np.lexsort((slots_r, d_r))[:k]
            out.append([ann.key_of[int(s)] for s in slots_r[order]])
        return out

    res = ann.search_batch(items)  # builds the device mirrors
    transient = {}
    if on_card:
        transient["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ann.search_batch(items)
        transient["search_transient_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    idx_p50 = timer(lambda: ann.search_batch(items), reps)
    keys_got = [[key for key, _ in r] for r in res]
    nprobe = ivf.auto_nprobe(gen.n_lists)
    cand = ann._candidates(k, gen)
    idx_row = dict(
        phase="ann_index", rows=n, dim=d, add_s=add_s, retrain_s=retrain_s, lists=gen.n_lists,
        cap=gen.cap, subvectors=gen.cube.shape[2], nprobe=nprobe, candidates=cand,
        list_fill_max=int(gen.fill.max()), list_fill_mean=float(gen.fill.mean()),
        queries=len(items), search_batch_p50_ms=idx_p50, exact_slab_search_batch_p50_ms=slab_p50_ms,
        self_top1=int(sum(r[0] == key for r, key in zip(keys_got, query_keys))),
        recall_at_10=_recall(keys_got, exact_keys(qmat), k),
        **ivf_bound(len(items), nprobe, gen.cap, gen.cube.shape[2], cand, d, gen.n_lists, k), **transient,
    )
    if on_card:
        idx_row["profile"] = profile_stages(lambda: ann.search_batch(items), 10)
        idx_row["share_of_bound"] = idx_row["bound_ms"] / idx_row["profile"]["kernel_ms_per_call"]
    emit(idx_row)
    if idx_row["self_top1"] != len(items):
        raise AssertionError(f"the IVF-PQ index missed a self-query: {idx_row}")

    # -- churn in waves: each removes and adds `churn_wave` rows, then searches
    rng = np.random.default_rng(3)
    protected = set(query_keys)
    before = dict(ann.counters)
    cap0 = gen.cap
    added: list[tuple[int, np.ndarray]] = []
    leaks, next_key = 0, n
    for _ in range(churn_waves):
        live = np.fromiter(ann.slot_of, np.int64, len(ann.slot_of))
        gone = [int(x) for x in rng.choice(live, churn_wave, replace=False) if int(x) not in protected]
        for key in gone:
            ann.remove(key)
        base = vectors[rng.integers(0, n, len(gone))]  # as many in as out
        fresh = base + 0.05 * rng.standard_normal(base.shape, dtype=np.float32)
        fresh /= np.linalg.norm(fresh, axis=1, keepdims=True)
        for vec in fresh:
            ann.add(next_key, vec)
            added.append((next_key, vec))
            protected.add(next_key)  # each added row stays, to find itself
            next_key += 1
        live_keys = set(ann.slot_of)
        wave_items = items + [(v, k, None) for _key, v in added[-len(items):]]
        leaks += sum(not {key for key, _ in r} <= live_keys for r in ann.search_batch(wave_items))
    found = top1 = 0
    for j in range(0, len(added), 32):
        chunk = added[j:j + 32]
        for (key, _v), r in zip(chunk, ann.search_batch([(v, k, None) for _key, v in chunk])):
            found += any(kk == key for kk, _ in r)
            top1 += bool(r) and r[0][0] == key
    delta = {name: ann.counters[name] - before[name]
             for name in ("cell_updates", "row_updates", "cube_rebuilds", "row_rebuilds", "spills", "retrains")}
    churn = dict(
        phase="ann_churn", waves=churn_waves, removed_and_added_per_wave=churn_wave, added=len(added),
        results_outside_live=leaks, added_found=found, added_top1=top1, cap_before=cap0,
        cap_after=ann._gen.cap, **delta,
    )
    emit(churn)
    if (leaks or found != len(added)
            or (ann._gen.cap == cap0 and (delta["cube_rebuilds"] or delta["row_rebuilds"]))):
        raise AssertionError(f"the index went wrong under churn: {churn}")

    # -- the two-stage wrapper over a crippled first stage (nprobe 1)
    want = exact_keys(qmat)
    plain = [[key for key, _ in r] for r in ann.search_batch(items, nprobe=1)]
    ann.nprobe = 1
    wrapped = RerankedSlabIndex(ann, expand=4)
    reranked = [[key for key, _ in r] for r in wrapped.search_batch(items)]
    rr = dict(
        phase="ann_rerank", base_nprobe=1, expand=4, plain_recall_at_10=_recall(plain, want, k),
        reranked_recall_at_10=_recall(reranked, want, k), **wrapped.counters,
        p50_ms=timer(lambda: wrapped.search_batch(items), max(3, reps // 3)),
    )
    # the reranker's own program at round 0's shape: the first stage's
    # k * expand candidates of each query, padded to the plane's buckets
    first = ann.search_batch([(v, k * 4, None) for v in query_vecs])
    C = max(len(c) for c in first)
    rc = np.zeros((len(items), C, d), np.float32)
    rv = np.zeros((len(items), C), bool)
    for b, cands in enumerate(first):
        for c, (key, _dist) in enumerate(cands):
            rc[b, c], rv[b, c] = ann.vectors[ann.slot_of[key]], True
    plane = get_device_plane()
    Bb, Cb = plane.buckets.rows_bucket(len(items)), plane.buckets.cap_bucket(C)
    nbytes = 4 * Bb * d + 4 * Bb * Cb * d + Bb * Cb + 4 * Bb * Cb  # q, rows, valid in; scores out
    flops = 6 * Bb * Cb * d  # the candidate norms and the products
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    rr.update(
        scores_shape=[Bb, Cb, d], scores_p50_ms=timer(lambda: wrapped.reranker.scores(qmat, rc, rv), reps),
        scores_bound_ms=max(t_bytes, t_ops) * 1e3, scores_bound_by="bytes" if t_bytes >= t_ops else "operations",
    )
    if on_card:
        prof = profile_stages(lambda: wrapped.reranker.scores(qmat, rc, rv), 10)
        rr.update(scores_kernel_ms=prof["kernel_ms_per_call"], scores_launches=prof["launches_per_call"])
    emit(rr)
    if rr["reranked_recall_at_10"] < rr["plain_recall_at_10"] or rr["rerank_expansions"] <= 0:
        raise AssertionError(f"reranking did not recover the probe misses: {rr}")
    del ann, wrapped
    if on_card:
        torch.cuda.empty_cache()
    return dict(build=build, search=srch, index=idx_row, churn=churn, rerank=rr)


# ------------------------------------------------------------ phase 2c


def run_ann_tiered(device, *, vectors, query_vecs, query_keys, churn_waves: int, churn_wave: int,
                   reps: int) -> dict:
    """`ann_tiered`: `IvfPqIndex(tiered=True)` over `vectors` at the
    flagship width with the auto budgets (a quarter of the lists hot, half
    in RAM, the rest sealed on disk), searched with run_slice's text
    queries. Before any migration the tiered search gives the all-resident
    search of the same generation byte for byte; after a rebalance a batch
    of repeated queries whose lists are all hot runs on the card over the
    hot sub-cube, and a batch that reaches cold lists streams them from
    disk into the numpy search. Then churn in waves with a rebalance
    between them, and the tier contract. Runs on the CPU too (at a small
    size), for a rehearsal."""
    import numpy as np
    import torch

    from pathway_tpu_torch.indexing import TIER_COLD, TIER_HOT, TIER_NAMES, IvfPqIndex, verify_tier_state
    from pathway_tpu_torch.ops import ivf

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    timer = host_ms if on_card else _cpu_ms
    n, d = vectors.shape
    k = TOP_K
    # train_min past the row count: one explicit retrain builds the generation
    ann = IvfPqIndex(
        dimensions=d, reserved_space=n, subvectors=TIERED_SUBVECTORS, train_min=n + 1,
        background_retrain=False, tiered=True, background_tiering=False, device=dev,
    )
    t0 = time.perf_counter()
    for i in range(n):
        ann.add(i, vectors[i])
    add_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ann.retrain_now()
    retrain_s = time.perf_counter() - t0
    gen, ts = ann._gen, ann._tiers
    nprobe = ivf.auto_nprobe(gen.n_lists)
    qmat = np.stack(query_vecs).astype(np.float32)
    items = [(v, k, None) for v in qmat]

    # -- before any migration: the same generation searched all-resident
    before_route = dict(ann.counters)
    got = ann._topk(qmat, k)
    want = ann._ann_topk_host(qmat, k, gen, nprobe)
    route0 = "device" if ann.counters["tier_device_searches"] > before_route["tier_device_searches"] else "host"
    if route0 == "host":
        equal_before = all(np.array_equal(gs, ws) and np.array_equal(gd, wd) for (gs, gd), (ws, wd) in zip(got, want))
    else:  # the card's f32 sums against numpy's: the same slots, distances within 1e-5
        equal_before = all(
            np.array_equal(np.sort(gs), np.sort(ws)) and np.allclose(np.sort(gd), np.sort(wd), atol=1e-5)
            for (gs, gd), (ws, wd) in zip(got, want)
        )

    def exact_keys(qs):
        out = []
        for slots_r, d_r in ann._topk_host(qs, k):
            order = np.lexsort((slots_r, d_r))[:k]
            out.append([ann.key_of[int(s)] for s in slots_r[order]])
        return out

    def probed_tiers(batch, **kw):
        """Search `batch` once; the lists it probed (their access counts
        rose), by tier, and the route it took."""
        acc0, c0 = ts.accesses.copy(), dict(ann.counters)
        res = ann.search_batch(batch, **kw)
        probed = np.flatnonzero(ts.accesses > acc0)
        route = "device" if ann.counters["tier_device_searches"] > c0["tier_device_searches"] else "host"
        counts = {name: int((ts.tier[probed] == ti).sum()) for ti, name in enumerate(TIER_NAMES)}
        return res, counts, route

    # -- the hot route: a few queries searched until their lists rank first
    hot_q: list[int] = []
    union: set[int] = set()
    for j in range(len(qmat)):
        lists = set(np.argsort(-(qmat[j] / np.linalg.norm(qmat[j])) @ gen.centroids.T)[:nprobe].tolist())
        if len(union | lists) <= ts.hot_budget:
            hot_q.append(j)
            union |= lists
    for _ in range(8):
        ann.search_batch([items[j] for j in hot_q])
    moved = ann.rebalance_tiers_now()
    hot_items = [items[hot_q[i % len(hot_q)]] for i in range(len(items))]  # repeated queries
    hot_res, hot_counts, hot_route = probed_tiers(hot_items)
    cold_lists = [lst for lst in np.flatnonzero(ts.tier == TIER_COLD) if gen.fill[lst] > 0]
    cold_slots = [int(gen.slots[lst][gen.valid[lst]][0]) for lst in cold_lists[: len(items)]]
    cold_items = [(ann.vectors[s].astype(np.float32), k, None) for s in cold_slots]
    cold_res, cold_counts, cold_route = probed_tiers(cold_items)
    text_res, text_counts, text_route = probed_tiers(items)
    c0 = dict(ann.counters)
    hot_p50 = timer(lambda: ann.search_batch(hot_items), reps)
    cold_p50 = timer(lambda: ann.search_batch(cold_items), max(3, reps // 3))
    text_p50 = timer(lambda: ann.search_batch(items), max(3, reps // 3))
    routes = {r: ann.counters[f"tier_{r}_searches"] - c0[f"tier_{r}_searches"] for r in ("device", "host")}
    keys_got = [[key for key, _ in r] for r in text_res]
    cold_self = sum(bool(r) and r[0][0] == ann.key_of[s] for r, s in zip(cold_res, cold_slots))
    per_tier = {}
    for ti, name in enumerate(TIER_NAMES):
        lists = np.flatnonzero(ts.tier == ti)
        per_tier[name] = dict(lists=int(lists.size), rows=int(gen.valid[lists].sum()),
                              code_bytes=int(lists.size * gen.cap * gen.cube.shape[2]))
    per_tier["cold"]["disk_bytes"] = ts.store.bytes_total
    whole = sum(a.nbytes for a in (gen.cube, gen.valid, gen.slots, gen.centroids, gen.codebooks))
    row = dict(
        phase="ann_tiered", rows=n, dim=d, subvectors=gen.cube.shape[2], lists=gen.n_lists, cap=gen.cap,
        nprobe=nprobe, hot_budget=ts.hot_budget, ram_budget=ts.ram_budget, add_s=add_s, retrain_s=retrain_s,
        route_before_migration=route0, equal_to_resident_before_migration=bool(equal_before),
        rebalance=moved, tiers=per_tier, hot_mirror_device_bytes=ann.tier_device_bytes(),
        whole_cube_device_bytes=int(whole), hot_queries=len(hot_q), hot_batch_route=hot_route,
        cold_batch_route=cold_route, text_batch_route=text_route,
        probed_lists_by_tier=dict(hot_batch=hot_counts, cold_batch=cold_counts, text_batch=text_counts),
        hot_p50_ms=hot_p50, cold_p50_ms=cold_p50, text_p50_ms=text_p50, timed_routes=routes,
        recall_at_10=_recall(keys_got, exact_keys(qmat), k),
        self_top1=int(sum(r[0] == key for r, key in zip(keys_got, query_keys))),
        cold_self_top1=int(cold_self), cold_queries=len(cold_items),
    )
    if on_card:
        row["hot_profile"] = profile_stages(lambda: ann.search_batch(hot_items), 10)
    if (not equal_before or hot_route != "device" or cold_route != "host" or cold_counts["cold"] == 0
            or hot_counts["warm"] or hot_counts["cold"] or row["self_top1"] != len(items)):
        emit(row)
        raise AssertionError(f"the tiered index took the wrong route or disagreed: {row}")

    # -- churn in waves, a rebalance between them
    rng = np.random.default_rng(4)
    protected = set(query_keys)
    leaks, next_key, added = 0, n, []
    t0 = time.perf_counter()
    for _ in range(churn_waves):
        live = np.fromiter(ann.slot_of, np.int64, len(ann.slot_of))
        gone = [int(x) for x in rng.choice(live, churn_wave, replace=False) if int(x) not in protected]
        for key in gone:
            ann.remove(key)
        base = vectors[rng.integers(0, n, churn_wave)]
        fresh = base + 0.05 * rng.standard_normal(base.shape, dtype=np.float32)
        fresh /= np.linalg.norm(fresh, axis=1, keepdims=True)
        for vec in fresh:
            ann.add(next_key, vec)
            added.append((next_key, vec))
            protected.add(next_key)
            next_key += 1
        live_keys = set(ann.slot_of)
        batch = items + [(v, k, None) for _key, v in added[-len(items):]] + cold_items
        leaks += sum(not {key for key, _ in r} <= live_keys for r in ann.search_batch(batch))
        ann.rebalance_tiers_now()
    churn_s = time.perf_counter() - t0
    verify_tier_state(ann)
    found = sum(
        any(kk == key for kk, _ in r)
        for j in range(0, len(added), 32)
        for (key, _v), r in zip(added[j:j + 32], ann.search_batch([(v, k, None) for _key, v in added[j:j + 32]]))
    )
    row.update(
        churn_waves=churn_waves, churn_wave=churn_wave, churn_s=churn_s, results_outside_live=leaks,
        added=len(added), added_found=found, promotions=ts.promotions, demotions=ts.demotions,
        runs=ts.store.run_count, verify_tier_state="passed",
        lists_per_tier_after=ann.stats()["tiers"]["lists_per_tier"],
        route_counts={r: ann.counters[f"tier_{r}_searches"] for r in ("device", "host")},
    )
    emit(row)
    if leaks or found != len(added):
        raise AssertionError(f"the tiered index went wrong under churn: {row}")
    del ann
    if on_card:
        torch.cuda.empty_cache()
    return row


def run_vector_store(device, emb_kw: dict, texts: list[str], *, n_queries: int, k: int) -> dict:
    """`vector_store`: `VectorStoreServer` over the texts phase's chunks
    with its default embedder (`TorchEmbedder`, on the card), served over
    REST on localhost and queried through `VectorStoreClient`. Held to a
    `VectorSlabIndex` built directly from the same embedder's embeddings,
    compared as (distance, text) after the re-sort; then `EncoderReranker`
    scores of the answers on the card against the same weights on the
    CPU. Runs on the CPU too (at a small size, the server given a CPU
    embedder and index), for a rehearsal."""
    import socket

    import numpy as np
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import TorchEmbedder, VectorSlabIndex
    from pathway_tpu_torch.internals import run as run_mod
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.models.transformer import embedder_config
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.attention import KERNEL
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory
    from pathway_tpu_torch.xpacks.llm.rerankers import EncoderReranker
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreClient, VectorStoreServer

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    G.clear()
    rows = [(t.encode(), {"path": f"chunk{i}"}) for i, t in enumerate(texts)]
    docs = pw.debug.table_from_rows(pw.schema_from_types(data=bytes, _metadata=object), rows)
    if on_card:
        server = VectorStoreServer(docs)  # the default TorchEmbedder and slab, on the card
        emb = server.embedder
        if dataclasses.asdict(emb.config) != dataclasses.asdict(embedder_config(**emb_kw)):
            raise AssertionError(f"the default embedder is not {emb_kw}: {emb.config}")
    else:
        emb = TorchEmbedder(embedder_config(**emb_kw), device=dev)
        server = VectorStoreServer(docs, embedder=emb, index_factory=BruteForceKnnFactory(
            dimensions=emb.config.embed_dim, embedder=emb, device=dev))
    _build.reset_launch_counts()  # after the factory's dimension probe
    dispatches0 = emb.dispatches
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    thread = server.run_server(host="127.0.0.1", port=port, threaded=True, with_cache=False)
    client = VectorStoreClient(host="127.0.0.1", port=port, timeout=60)
    try:
        stats = None
        while time.perf_counter() - t0 < 300:
            try:
                stats = client.get_vectorstore_statistics()
                if stats.get("file_count") == len(texts):
                    break
            except Exception:  # noqa: BLE001 — the server is still starting
                pass
            time.sleep(0.1)
        ready_s = time.perf_counter() - t0
        if not stats or stats.get("file_count") != len(texts):
            raise AssertionError(f"the vector store did not index {len(texts)} chunks: {stats}")
        rng = np.random.default_rng(2)
        queries = [texts[j] for j in rng.choice(len(texts), n_queries, replace=False)]
        client.query(queries[0], k=k)  # warm-up
        lat, answers = [], []
        for q in queries:
            t1 = time.perf_counter()
            answers.append(client.query(q, k=k))
            lat.append((time.perf_counter() - t1) * 1e3)
    finally:
        run_mod.stop_current_run()
        thread.join(timeout=60)
        G.clear()
    launches = _build.LAUNCHES.get(KERNEL, 0)
    dispatches = emb.dispatches - dispatches0

    # the same embeddings in a slab built directly on the same device; each
    # query alone, as the REST path embeds it
    direct = VectorSlabIndex(dimensions=emb.config.embed_dim, reserved_space=len(texts), device=dev)
    cap = emb._plane.buckets.max_rows
    for s in range(0, len(texts), cap):
        for j, v in enumerate(emb.encode_many(texts[s:s + cap])):
            direct.add(s + j, v)
    mismatches, near_ties, self_top1 = [], 0, 0
    for q, ans in zip(queries, answers):
        got_q = sorted((float(a["dist"]), a["text"]) for a in ans)
        want_q = sorted((dist, texts[key]) for key, dist in direct.search(emb.encode_many([q])[0], k))
        self_top1 += bool(got_q) and got_q[0][1] == q
        if len(got_q) != len(want_q):
            mismatches.append((q, got_q, want_q))
            continue
        for (gd, gt), (wd, wt) in zip(got_q, want_q):
            if abs(gd - wd) > INGEST_SCORE_ATOL:
                mismatches.append((q, got_q, want_q))
                break
            near_ties += gt != wt

    # the encoder reranker on the card against the same weights on the CPU
    pairs = [(a["text"], q) for q, ans in zip(queries[:8], answers[:8]) for a in ans]
    rr_launches0 = _build.LAUNCHES.get(KERNEL, 0)
    card_scores = [EncoderReranker(embedder=emb).__wrapped__(doc, q) for doc, q in pairs]
    rr_launches = _build.LAUNCHES.get(KERNEL, 0) - rr_launches0
    cpu_emb = TorchEmbedder(emb.config, device="cpu")
    cpu_scores = [EncoderReranker(embedder=cpu_emb).__wrapped__(doc, q) for doc, q in pairs]
    rr_err = float(np.max(np.abs(np.asarray(card_scores) - np.asarray(cpu_scores))))
    row = dict(
        phase="vector_store", chunks=len(texts), embedder=dataclasses.asdict(emb.config) | {"dtype": str(emb.config.dtype)},
        ready_s=ready_s, queries=n_queries, k=k, rest_p50_ms=statistics.median(lat),
        rest_max_ms=max(lat), attention_launches=launches, encoder_dispatches=dispatches,
        self_top1=self_top1, score_atol=INGEST_SCORE_ATOL, near_ties=near_ties, mismatches=len(mismatches),
        first_mismatch=str(mismatches[0])[:600] if mismatches else None,
        rerank_pairs=len(pairs), rerank_max_abs_err_vs_cpu=rr_err, rerank_atol=RERANK_ATOL,
        rerank_attention_launches=rr_launches,
    )
    emit(row)
    if mismatches or self_top1 != n_queries or rr_err > RERANK_ATOL:
        raise AssertionError(f"the vector store disagrees with the direct build: {row}")
    if on_card and (launches <= 0 or launches != emb.config.n_layers * dispatches or rr_launches <= 0):
        raise AssertionError(
            f"the vector store did not embed through the attention kernel: {launches} launches for "
            f"{dispatches} encoder dispatches x {emb.config.n_layers} layers"
        )
    return dict(row, launches=launches + rr_launches)


# ------------------------------------------------------------ phase 3


def decode_bound(cfg, batch: int) -> dict:
    """Least time the card could take for one decode step of `batch`
    rows, in ms. Bytes: every block weight and the tied `tok_embed` (the
    logits product) read once in bf16, and the whole max_len K and V
    cache of every layer read once, as the step attends over it under the
    mask. Operations: 2 per weight per row for the projections and the
    logits, and 4 * max_len * d_model per layer per row for q.k and p.v."""
    d, n_layers, s = cfg.d_model, cfg.n_layers, cfg.max_len
    item = cfg.dtype.itemsize
    block = n_layers * (4 * d * d + 2 * d * cfg.d_ff + 2 * d)
    embed = cfg.vocab_size * d
    cache = 2 * n_layers * batch * s * d
    nbytes = (block + embed + cache) * item
    flops = batch * (2 * (n_layers * (4 * d * d + 2 * d * cfg.d_ff) + embed) + n_layers * 4 * s * d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return dict(
        bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, block_weight_bytes=block * item, tok_embed_bytes=embed * item,
        kv_cache_bytes=cache * item, flops=flops, bytes_ms=t_bytes * 1e3, operations_ms=t_ops * 1e3,
        worked_out=(
            f"bytes: blocks {block * item / 1e9:.3f} GB + tok_embed {embed * item / 1e9:.3f} GB"
            f" + K/V cache {cache * item / 1e9:.3f} GB (2 x {n_layers} layers x {batch} rows x"
            f" {s} x {d}) = {nbytes / 1e9:.3f} GB over {HBM_BYTES_PER_S / 1e12} TB/s ="
            f" {t_bytes * 1e3:.3f} ms; operations: {flops / 1e9:.1f} GFLOP over"
            f" {BF16_FLOPS / 1e12:.0f} TFLOP/s = {t_ops * 1e3:.3f} ms"
        ),
    )


# kernel classes of the decode profile, told apart by op and shape: only
# attention runs batched products (aten::bmm) and ops on [b, h, 1, max_len]
# scores; only the logits product has a vocab-wide operand
_COPY_OPS = ("aten::copy_", "aten::index_put_", "aten::clone", "aten::contiguous", "aten::cat", "aten::stack")
_GEMM_KERNELS = ("nvjet", "gemm", "cutlass", "xmma", "sm90_", "cublas")


def profile_window(fn) -> dict:
    """Host time of `fn` (ending in a synchronize) and the device time of
    the kernels it ran (torch.profiler, all threads)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(
        ev.self_device_time_total for ev in prof.key_averages()
        if ev.self_device_time_total and str(ev.device_type).endswith("CUDA")
    ) / 1e3
    if not busy:
        return dict(window_ms=wall_ms, device_busy_ms="not measured", device_idle_share="not measured")
    return dict(window_ms=wall_ms, device_busy_ms=busy, device_idle_share=1 - busy / wall_ms)


def profile_decode(step, n_steps: int, cfg, batch: int) -> dict:
    """Device time of `n_steps` decode steps by class: the idle share from
    a plain trace, the classes from a second trace with shapes (which
    slows the host, not the kernels). Also the largest tensor any copy op
    moved, against the elements of one cache layer's K."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def steps():
        for _ in range(n_steps):
            step()

    out = profile_window(steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        steps()
        torch.cuda.synchronize()
    by_class = dict(matmul=0.0, attention=0.0, logits=0.0, elementwise_and_reductions=0.0, copies=0.0)
    by_kernel: dict[str, float] = {}
    largest_copy, copy_launches = 0, 0
    for ev in prof.events():
        if not ev.kernels:
            continue
        ms = sum(k.duration for k in ev.kernels) / 1e3
        chain, p = [ev], ev.cpu_parent
        while p is not None:
            chain.append(p)
            p = p.cpu_parent
        names = [e.name for e in chain]
        shapes = [s for e in chain for s in (e.input_shapes or []) if s]
        if "aten::bmm" in names or any(len(s) == 4 and s[-1] == cfg.max_len for s in shapes):
            cls = "attention"
        elif "aten::mm" in names and any(cfg.vocab_size in s for s in shapes):
            cls = "logits"
        elif any(t in k.name for k in ev.kernels for t in _GEMM_KERNELS):
            cls = "matmul"
        elif ev.name in _COPY_OPS and "aten::_to_copy" not in names:  # a cast is elementwise
            cls = "copies"
            copy_launches += len(ev.kernels)
            own = [s for s in (ev.input_shapes or []) if s]
            largest_copy = max([largest_copy] + [math.prod(s) for s in own])
        else:
            cls = "elementwise_and_reductions"
        by_class[cls] += ms
        for k in ev.kernels:
            by_kernel[k.name] = by_kernel.get(k.name, 0.0) + k.duration / 1e3
    total = sum(by_class.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    launches = sum(len(ev.kernels) for ev in prof.events())
    out.update(
        steps=n_steps, classified_ms=total, kernel_launches_per_step=launches / n_steps,
        ms_by_class={k: v / n_steps for k, v in by_class.items()},
        share_by_class={k: (v / total if total else "not measured") for k, v in by_class.items()},
        copy_launches_per_step=copy_launches / n_steps, largest_copy_elements=largest_copy,
        cache_layer_elements=batch * cfg.n_heads * cfg.max_len * cfg.head_dim,
        top_kernels_ms_per_step=[[name[:90], ms / n_steps] for name, ms in top],
    )
    return out


def run_generate(device, lm_kw: dict, chat_kw: dict, texts: list[str], *, batch: int,
                 prompt_len: int, new_tokens: int, cb_requests: int, cb_new: int,
                 cb_slots: int, eq_prompts: int, eq_batch: int) -> dict:
    """The port's generation path: (a) wave-aligned `generate_serving` at
    full width, (b) continuous batching through `TorchLMChat`, (c) the
    slot and wave paths byte-equal at f32 on JaxLMChat's default model.
    Returns the rows it printed. Runs on the CPU too (at a small size)."""
    import numpy as np
    import torch

    from pathway_tpu_torch import TorchLMChat
    from pathway_tpu_torch.models import transformer as tfm
    from pathway_tpu_torch.xpacks.llm.embedders import pad_left_rows

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # -- (a) wave-aligned generation at full width
    cfg = tfm.lm_config(dtype=torch.bfloat16, **lm_kw)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dtype=torch.bfloat16)
    prompt = torch.from_numpy(
        # ids 2..999 as bench.py:339-342 draws them
        np.random.default_rng(5).integers(2, min(1000, cfg.vocab_size), (batch, prompt_len))
    ).to(dev)
    cache = tfm.init_kv_cache(cfg, batch, dev)
    n_params = tfm.count_params(params)

    def generate():
        return tfm.generate_serving(params, prompt, cache, new_tokens, cfg)[0]

    with torch.no_grad():
        toks = generate()  # warm-up: cuBLAS handles and workspaces
        sync()
        runs_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            toks = generate()
            sync()
            runs_s.append(time.perf_counter() - t0)
        timer = cuda_ms if on_card else _cpu_ms
        prefill_ms = timer(lambda: tfm.prefill(params, prompt, cache, cfg), 5)
        last = toks[:, -2]  # decode at the last position the run wrote
        pos = prompt_len + new_tokens - 2
        step_ms = timer(lambda: tfm.decode_step(params, cache, last, pos, cfg), 20)
        # the cache path against a full causal forward over the same tokens
        k = min(batch, 4)
        fwd = tfm.logits(params, toks[:k, :pos + 1], torch.ones_like(toks[:k, :pos + 1]), cfg)[:, -1]
        dec, _ = tfm.decode_step(params, cache, last, pos, cfg)
        vs_fwd = (dec[:k] - fwd).abs().max().item()
        argmax_agree = float((dec[:k].argmax(-1) == fwd.argmax(-1)).float().mean())
        # how close greedy picks are: the gap between each row's top two logits
        top2 = dec.topk(2, dim=-1).values
        top2_gap_median = float((top2[:, 0] - top2[:, 1]).median())
        profile = None
        if on_card:
            profile = profile_decode(lambda: tfm.decode_step(params, cache, last, pos, cfg), 4, cfg, batch)
            # the profiler slows the host: the idle share at the step's own time
            profile["device_idle_share_at_step_ms"] = 1 - profile["device_busy_ms"] / 4 / step_ms
    bound = decode_bound(cfg, batch)
    gen_tokens = toks[:, prompt_len:]
    wave = dict(
        phase="generate_wave", config=lm_kw, params=n_params, dtype="bf16", batch=batch,
        prompt=prompt_len, new_tokens=new_tokens, runs_s=runs_s,
        tokens_per_s=batch * new_tokens / statistics.median(runs_s),
        decode_tokens_per_s=batch / (step_ms * 1e-3), prefill_ms=prefill_ms, decode_step_ms=step_ms,
        **bound, share_of_bound=bound["bound_ms"] / step_ms,
        tokens_shape=list(toks.shape), prompt_kept=bool(torch.equal(toks[:, :prompt_len], prompt)),
        tokens_in_vocab=bool(gen_tokens.min() >= 0 and gen_tokens.max() < cfg.vocab_size),
        decode_vs_forward_max_abs=vs_fwd, decode_vs_forward_atol=DECODE_VS_FORWARD_ATOL,
        decode_vs_forward_argmax_agree=argmax_agree, top2_logit_gap_median=top2_gap_median,
        profile=profile,
    )
    if on_card:
        wave["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit(wave)
    if (list(toks.shape) != [batch, prompt_len + new_tokens] or not wave["prompt_kept"]
            or not wave["tokens_in_vocab"] or not math.isfinite(vs_fwd) or vs_fwd > DECODE_VS_FORWARD_ATOL):
        raise AssertionError(f"wave-aligned generation is wrong: {wave}")
    if profile and profile["largest_copy_elements"] >= profile["cache_layer_elements"]:
        raise AssertionError(f"a decode step copies a cache layer: {profile}")
    del cache, toks, dec, fwd

    # -- (b) continuous batching through the chat entry point
    chat = TorchLMChat(cfg, params, max_new_tokens=cb_new, continuous_batching=True,
                       decode_slots=cb_slots, max_batch=cb_slots, device=dev)
    cb = chat._cb
    prompts = texts[:cb_requests]

    async def drive() -> list[tuple[str, float]]:
        async def one(p: str):
            t0 = time.perf_counter()
            out = await chat.__wrapped__([{"role": "user", "content": p}])
            return out, time.perf_counter() - t0

        half = len(prompts) // 2
        first = [asyncio.ensure_future(one(p)) for p in prompts[:half]]
        steps0 = cb.stats["decode_steps"]
        while cb.stats["decode_steps"] < steps0 + 3:  # the first half is mid-generation
            await asyncio.sleep(0.002)
        second = [asyncio.ensure_future(one(p)) for p in prompts[half:]]
        return await asyncio.gather(*first, *second)

    with torch.no_grad():
        asyncio.run(chat.__wrapped__(prompts[0]))  # warm-up: prefill buckets, step
        cb.drain()
        pool0, stats0 = cb.pool.snapshot(), dict(cb.stats)
        t0 = time.perf_counter()
        results = asyncio.run(drive())
        cb_s = time.perf_counter() - t0
        cb.drain()
        pool1, stats1 = cb.pool.snapshot(), dict(cb.stats)
        idle = profile_window(lambda: (asyncio.run(drive()), cb.drain())) if on_card else None
        wave_out = []
        for i in range(0, len(prompts), cb_slots):
            wave_out += chat._generate_batch(prompts[i:i + cb_slots])
        # the two calls the scheduler makes, alone: a b=1 prefill into a
        # slot and a step over every slot, each with its read-back
        slot_cache = tfm.init_kv_cache(cfg, cb_slots, dev)
        ids, mask = pad_left_rows([chat.tokenizer.tokenize(prompts[0])], cfg.max_len - cb_new, n_rows=1)
        ids_t, mask_t = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
        vec = torch.zeros((3, cb_slots), dtype=torch.long, device=dev)
        vec[1] = ids.shape[1]
        host_timer = host_ms if on_card else _cpu_ms
        slot_prefill_ms = host_timer(
            lambda: int(tfm.prefill_into_slot(params, ids_t, mask_t, slot_cache, 0, cfg)[0][0]), 10
        )
        slot_step_ms = host_timer(
            lambda: tfm.decode_step_slots(params, slot_cache, vec[0], vec[1], vec[2], cfg)[0].tolist(), 10
        )
        del slot_cache
    got = [r for r, _ in results]
    lat_ms = np.array([s for _, s in results]) * 1e3
    counts = [len(r.split()) for r in got]
    delta = {k: pool1[k] - pool0[k] for k in ("acquired_total", "refills", "joined_inflight")}
    cbrow = dict(
        phase="generate_continuous", requests=len(prompts), new_tokens=cb_new, slots=cb_slots,
        seconds=cb_s, tokens_per_s=sum(counts) / cb_s,
        latency_p50_ms=float(np.percentile(lat_ms, 50)), latency_p99_ms=float(np.percentile(lat_ms, 99)),
        prefills=stats1["prefills"] - stats0["prefills"],
        decode_steps=stats1["decode_steps"] - stats0["decode_steps"],
        **delta, high_water=pool1["high_water"], profile=idle,
        agree_with_wave=sum(a == b for a, b in zip(got, wave_out)) / len(got),
        agreeing_prefix_tokens_mean=statistics.mean(
            next((i for i, (x, y) in enumerate(zip(a.split(), b.split())) if x != y), cb_new)
            for a, b in zip(got, wave_out)
        ),
        slot_prefill_ms=slot_prefill_ms, slot_step_ms=slot_step_ms,
        host_s_in_prefills=stats1["prefill_seconds"] - stats0["prefill_seconds"],
        host_s_in_steps=stats1["step_seconds"] - stats0["step_seconds"],
    )
    emit(cbrow)
    if (len(got) != len(prompts) or any(c != cb_new for c in counts)
            or delta["joined_inflight"] <= 0 or delta["refills"] <= 0):
        raise AssertionError(f"continuous batching failed: {cbrow}")
    chat._finalizer()
    del chat, cb, params
    if on_card:
        torch.cuda.empty_cache()

    # -- (c) slot path == wave path, byte for byte, at f32
    small = tfm.lm_config(dtype=torch.float32, **chat_kw)
    eq = TorchLMChat(small, continuous_batching=True, decode_slots=eq_batch, max_batch=eq_batch, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(1))
    eq_prompts_l = texts[cb_requests:cb_requests + eq_prompts]
    with torch.no_grad():
        futs = [eq._cb.submit(p) for p in eq_prompts_l]
        slot_out = [f.result(timeout=600) for f in futs]
        eq._cb.drain()
        wave_eq = []
        for i in range(0, len(eq_prompts_l), eq_batch):
            wave_eq += eq._generate_batch(eq_prompts_l[i:i + eq_batch])
    differ = [i for i, (a, b) in enumerate(zip(slot_out, wave_eq)) if a != b]
    eqrow = dict(
        phase="generate_f32_equality", config=chat_kw, prompts=len(eq_prompts_l),
        new_tokens=eq.max_new_tokens, slots=eq_batch, wave_batch=eq_batch,
        tf32=bool(torch.backends.cuda.matmul.allow_tf32), equal=len(eq_prompts_l) - len(differ),
        differ=differ,
    )
    emit(eqrow)
    eq._finalizer()
    if differ or eqrow["tf32"]:
        raise AssertionError(f"the slot path and the wave path differ at f32: {eqrow}")
    return dict(wave=wave, continuous=cbrow, equality=eqrow)


# ------------------------------------------------------------------ main


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this run needs one NVIDIA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "pathway_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the pathway_tpu_torch package is not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from pathway_tpu_torch.ops import _build

    # f32 products in full f32: no TF32 anywhere in the comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = gpu_name_and_power()
    print(card, flush=True)
    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
               if "registers" in ln or "spill" in ln]
        for name, path in libs.items()
    }
    emit(dict(
        phase="device", card=card, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build_s, libraries={k: str(v.relative_to(ROOT)) for k, v in libs.items()},
        ptxas=ptxas,
    ))

    rows = [check_attention(label, b, s, d, h, seed=i, timed=True)
            for i, (label, b, s, d, h) in enumerate(ATTENTION_SHAPES)]
    rows += [check_attention(label, b, s, d, h, seed=100 + i, timed=False)
             for i, (label, b, s, d, h) in enumerate(ATTENTION_CHECK_SHAPES)]
    main_shape = rows[0]

    result = run_slice("cuda", FLAGSHIP, N_DOCS, DOC_BATCH, DOC_SEQ, ROOT)

    # the host engine and the live-RAG pipeline on it, each RAG phase's
    # launch count read across that phase alone
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        engine = run_host_engine(
            "cuda", wordcount_rows=WORDCOUNT_ROWS, emb_kw=EMBEDDER_DEFAULT, chat_kw=CHAT_DEFAULT,
            rag=dict(n_docs=RAG_DOCS, n_q=RAG_QUESTIONS, waves=RAG_WAVES, topk=RAG_TOPK,
                     new_tokens=RAG_NEW),
            ingest_texts=load_texts(ROOT),
            ingest=dict(n_docs=INGEST_DOCS, waves=INGEST_WAVES, n_q=INGEST_QUESTIONS, k=INGEST_K),
            workdir=Path(tmp),
        )

    # the vector-store server over the texts phase's chunks (its launch
    # count read across the phase alone)
    t0 = time.perf_counter()
    store = run_vector_store("cuda", EMBEDDER_DEFAULT, result["text_chunks"], n_queries=VS_QUERIES, k=VS_K)
    emit(dict(phase="vector_store_seconds", seconds=time.perf_counter() - t0))

    # the spawned mesh: rag_ingest's documents through `spawn -n 1` and
    # `-n 2`, each process embedding its share with the default
    # TorchEmbedder on the card (the children's launches are their own)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spawn = run_spawn_embed(None, None, load_texts(ROOT), n_docs=INGEST_DOCS, shards=SPAWN_SHARDS,
                                processes=(1, 2), workdir=Path(tmp))
    emit(dict(phase="spawn_embed_seconds", seconds=time.perf_counter() - t0))

    # the approximate tier runs no hand-written kernel (the IVF-PQ search
    # and the reranker are plain PyTorch, as the JAX package leaves them to
    # XLA): its launch counts are read across it all the same
    _build.reset_launch_counts()
    vectors = result.pop("vectors")
    n_text = vectors.shape[0] - N_DOCS
    ann_vectors = np.concatenate([vectors[:ANN_INDEX_DOCS], vectors[N_DOCS:]])
    tiered_vectors = np.concatenate([vectors[:TIERED_ROWS - n_text], vectors[N_DOCS:]])
    del vectors
    run_ann("cuda", ann_rows=ANN_ROWS, vectors=ann_vectors, query_vecs=result["query_vecs"],
            query_keys=[key - N_DOCS + ANN_INDEX_DOCS for key in result["query_keys"]],
            slab_p50_ms=result["knn"]["search_batch_p50_ms"],
            churn_waves=CHURN_WAVES, churn_wave=CHURN_WAVE, reps=30)
    del ann_vectors
    t0 = time.perf_counter()
    run_ann_tiered("cuda", vectors=tiered_vectors, query_vecs=result["query_vecs"],
                   query_keys=[key - N_DOCS + TIERED_ROWS - n_text for key in result["query_keys"]],
                   churn_waves=TIERED_CHURN_WAVES, churn_wave=CHURN_WAVE, reps=30)
    emit(dict(phase="ann_tiered_seconds", seconds=time.perf_counter() - t0))
    # pw.ml's KNNIndex over the same rows, queried by text rows in one run
    text_rows = range(TIERED_ROWS - n_text, TIERED_ROWS)
    run_ml_knn(None, tiered_vectors, [text_rows[i * len(text_rows) // ML_KNN_QUERIES]
                                      for i in range(ML_KNN_QUERIES)], k=ML_KNN_K)
    del tiered_vectors
    emit(dict(phase="ann_launches", kernel_launches=dict(_build.LAUNCHES)))

    # the generation path runs no hand-written kernel (its attention is
    # plain PyTorch, as the JAX package leaves it to XLA): its launch
    # counts are read across it all the same
    _build.reset_launch_counts()
    run_generate("cuda", GEMMA_2B, CHAT_DEFAULT, load_texts(ROOT, seed=1), batch=GEN_BATCH,
                 prompt_len=GEN_PROMPT, new_tokens=GEN_NEW, cb_requests=CB_REQUESTS,
                 cb_new=CB_NEW, cb_slots=CB_SLOTS, eq_prompts=EQ_PROMPTS, eq_batch=EQ_BATCH)
    emit(dict(phase="generate_launches", kernel_launches=dict(_build.LAUNCHES)))
    emit(dict(phase="total", seconds=time.perf_counter() - t_start, card=card))

    print(json.dumps({"kernels": [dict(
        name="fused_qkv_attention", route="cuda",
        source="pathway_tpu_torch/csrc/attention.cu",
        replaces="pathway_tpu/ops/attention.py:38",
        launches=result["launches"] + engine["launches"] + store["launches"] + spawn["attention_launches"],
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
        bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
        library_ms=main_shape["library_ms"],
    )]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
