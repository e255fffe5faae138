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
``IvfPqIndex`` over the 1M flagship-width rows (retrain, search, churn in
waves, the reranked nprobe-1 wrapper). Then it generates with bench.py's
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
# default TorchEmbedder's widest bucket, and the flagship width at the short
# buckets (s 16 and 32) that the texts phase's chunks fall into
ATTENTION_SHAPES = [
    ("flagship", 16384, 64, 384, 6),
    ("embedder_default", 4096, 128, 256, 8),
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

# the approximate tier: bench.py's bench_ann corpus and operating point
# (bench.py:1468-1488; d 64, 1M rows over 1000 gaussian topics, seed 7)
ANN_ROWS, ANN_DIM, ANN_SEED = 1_000_000, 64, 7
ANN_BATCH, ANN_K, ANN_NPROBE, ANN_CANDIDATES = 32, 10, 16, 1024
ANN_FRONTIER = (4, 16, 64)  # bench.py's bench_ann_frontier
ANN_MIN_RECALL = 0.93  # the JAX package's 1-CPU run recorded 0.941 on these bytes
# churn of the incremental index: waves of removes and fresh adds, a search after each
CHURN_WAVES, CHURN_WAVE = 16, 256

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
        return await asyncio.gather(*(emb.embed(texts[j]) for j in sample))

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
        query_keys=[n_docs + j for j in qsel],
    )


def _cpu_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


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

    # the approximate tier runs no hand-written kernel (the IVF-PQ search
    # and the reranker are plain PyTorch, as the JAX package leaves them to
    # XLA): its launch counts are read across it all the same
    _build.reset_launch_counts()
    run_ann("cuda", ann_rows=ANN_ROWS, vectors=result.pop("vectors"), query_vecs=result["query_vecs"],
            query_keys=result["query_keys"], slab_p50_ms=result["knn"]["search_batch_p50_ms"],
            churn_waves=CHURN_WAVES, churn_wave=CHURN_WAVE, reps=30)
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
        launches=result["launches"],
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
