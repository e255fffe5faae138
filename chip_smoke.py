#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pathway_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``pathway_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card (the attention
kernel timed at the main paths' shapes in bf16 and f32, checked at every
tiling, at ragged lengths, at sequences up to 2048, at head widths 1 to
1024 and in f16), then drives the
live-RAG embed -> index -> retrieve path at the flagship encoder's full
width (vocab 32768, d_model 384, 6 heads, 6 layers, d_ff 1536, seq 64,
embed_dim 384; random weights from a seed): 1,048,576 docs encoded in
16384-row batches into a ``VectorSlabIndex`` on the card, a few thousand
texts of the repo's own documentation through ``TorchEmbedder`` (bulk and
coalesced), self-retrieval over the 1M-doc slab, exact and int8 search
timed. The approximate tier follows: bench.py's 1M x 64 ANN corpus built
into an IVF-PQ index and searched at bench.py's operating point (against
exact search and the numpy oracle, split by stage against its bound), then
``IvfPqIndex`` over 18,513 flagship-width rows (retrain, search,
churn in waves, the reranked nprobe-1 wrapper), and the same index with
its lists in RAM/disk tiers over 16,384 of those rows (the hot route on
the card, cold lists read from disk, churn, the tier contract). Between
the RAG phases and the approximate tier, ``VectorStoreServer`` serves the
texts over REST with its default embedder, held to a direct slab search,
and ``EncoderReranker`` is held to the CPU; before them, ``long_embed``
streams 8,192 documents of the repo's texts through ``DocumentStore``
with the default ``TokenCountSplitter()`` (chunks of up to 500 tokens)
and the JAX package's default encoder width (``TransformerConfig()``: d
512, 8 heads, 6 layers, max_len 512) into the s 256 and s 512 buckets,
held to a direct slab, and that encoder at f32 is held to the plain
route and the CPU; then ``gateway_overload`` drives a
``rest_connector`` behind a ``ServingGateway``, in front of the default
embedder and a slab of the texts on the card, with
scripts/serving_loadgen.py's closed-loop rungs (100 and 1,000 clients, a
20 ms straggler with and without the gateway), every answer held to a
direct slab search; then ``python -m pathway_tpu_torch spawn -n 1`` and
``-n 2`` run an ingest pipeline over 8,192 documents, each process
embedding its share with the default embedder on the card, the two runs
held to each other; ``elastic_rescale`` runs the same pipeline under the
supervisor grown from 2 processes to 3 mid-run, held to both; and
``bluegreen_swap`` swaps a persisted pipeline that embeds on the card for
a green of the same plan while 50 clients query the gateway. After the tiers,
``pw.ml.index.KNNIndex`` answers 256 queries over the tiered rows in one
run, held to a direct slab search. Then it generates with bench.py's
Gemma-2B-shaped decoder at full width (vocab 256128, d_model 2048, 8
heads, 18 layers, d_ff 16384, max_len 1024; random bf16 weights from a
seed): ``generate_serving`` at batch 32 (decode step against its bound, a
profile by class), continuous batching of 96 requests through
``TorchLMChat``, and the slot and wave paths held byte-equal at f32 on
JaxLMChat's default model. The device mesh runs on 4 shards of the one
card (``PATHWAY_MESH_DEVICES=cuda:0*4``; one card gives no interconnect,
so these phases hold each sharded path to its unsharded one and time the
merges and copies): right after the slice, the sharded exact search over
its slab and the key-hash exchange of its embeddings (with a ``pw.run()``
groupby over the device wire against the host wire); inside the
approximate tier, the list-sharded IVF-PQ search and the sharded
``IvfPqIndex``; after generation, the tensor-parallel encoder and
decoder, the sequence-parallel encoder and ring attention at s 8192,
the training step on the Gemma-2B-shaped decoder (and the chat model at
f32 on the card against the CPU), ``segment_reduce`` over 16M values and
the mesh-spanning slot pool. Each phase prints one JSON line; the line
before the last is the kernel table, the last is the result. Any failure
exits non-zero. Without a CUDA device, or without the package beside it,
it exits non-zero too.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

from benchmark.roofline import (  # the benchmark's peaks and timers, one yardstick for both
    BF16_FLOPS,
    F32_FLOPS,
    HBM_BYTES_PER_S,
    attention_bound,
    cuda_ms,
    percentile_ms,
)

ROOT = Path(__file__).resolve().parent

# exp2 on the special-function units: 16 results a clock an SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0) x 132 SMs x the H100 SXM's 1980 MHz maximum boost clock; each
# attention score takes one exp2
SFU_EXP2_PER_S = 16 * 132 * 1.98e9

FLAGSHIP = dict(
    vocab_size=32768, d_model=384, n_heads=6, n_layers=6, d_ff=1536,
    max_len=64, embed_dim=384,
)
N_DOCS = 1 << 20  # the 1M-doc scale of the KNN target
DOC_BATCH, DOC_SEQ = 16384, 64  # bench.py's encoder batch
N_QUERIES, TOP_K = 16, 10
# (label, b, s, d, n_heads, dtype), timed: the flagship encoder's embed
# batch, the default TorchEmbedder's widest bucket and the bucket its RAG
# phases fill (s 32: documents and questions of at most 32 tokens), and the
# flagship width at the short buckets (s 16 and 32) that the texts phase's
# chunks fall into; then the JAX package's default encoder width
# (TransformerConfig(): d 512, 8 heads) at the s 512 and s 256 buckets that
# long_embed's 500-token chunks fill (b 1024 at s 512: the plain version's
# f32 scores are 8.6 GB), the flagship at f32, and head_dim 128; then the
# any-width kernel at two widths the JAX package's encoders take and the
# other kernels do not: d 384 over 32 heads (dh 12) and d 1280 over 4
# heads (dh 320)
ATTENTION_SHAPES = [
    ("flagship", 16384, 64, 384, 6, "bf16"),
    ("embedder_default", 4096, 128, 256, 8, "bf16"),
    ("embedder_default_s32", 4096, 32, 256, 8, "bf16"),
    ("flagship_s32", 16384, 32, 384, 6, "bf16"),
    ("flagship_s16", 16384, 16, 384, 6, "bf16"),
    ("long_s512", 1024, 512, 512, 8, "bf16"),
    ("long_s256", 2048, 256, 512, 8, "bf16"),
    ("flagship_f32", 16384, 64, 384, 6, "f32"),
    ("dh128", 4096, 128, 1024, 8, "bf16"),
    ("odd_dh12", 4096, 128, 384, 32, "bf16"),
    ("wide_dh320", 1024, 256, 1280, 4, "bf16"),
]
# checked, not timed: the other tilings of the short kernel (s 16 and 32
# with a batch that is not a multiple of 4, s 128 at dh 64 is its largest
# tile) and ragged s at both of its head dims; then the tiled kernels:
# sequences past 128 (one key past a tile, ragged, and long), every
# instantiated head width and one that zero-pads (dh 8 into 16), f16 at a
# ragged s, and f32 at s 512; then the edges of their 128-query work items
# and 128-key tiles at dh 64 (s 127 and 128 in f16, since bf16 takes the
# short kernel there; s 255 and 257), ragged s at dh 256 (64-key tiles)
# and dh 96 (three 32-column sub-tiles), f16 at s 512, and suffix masks
# (an optional seventh field; see attention_case) whose rows start with
# 64 or more padding keys, so that a first key tile of padding only must
# be wiped by the rescale; then the any-width kernel: head_dim 1, 4, 12,
# 20, 36, 100 (off the multiples of 8: heads at 2-byte offsets) and 264,
# 320, 512, 1024 (past 256: 1024 in four passes of 320 ctx columns), in
# bf16, f16 and f32, s from 1 to 600, suffix masks, batches that fill no
# tile evenly; then the edges of its branches: s 128 (the last that one
# pass holds in registers) and 129 at dh 12, 20 and 36, in all three
# dtypes; s 256 (the last whose scores a block holds in shared memory) and
# 257 at dh 320; head counts that its narrow blocks' 4 (dh 12) or 2 (dh
# 20) heads do not divide, the second with qkv rows of 600 bytes (not a
# multiple of 16); and past s 256 the wide heads' steps: dh 480 and 488
# (two key-tile stages beside 128 queries at 16 bits, then one), 640 and
# 648 (128 queries, then 64), and at f32 288 and 296, 352 and 360 (the
# same two steps); dh 2192 and 2200 at 16 bits, 1648 and 1656 at f32 (the
# widest heads whose q stays whole beside a key tile, then q.k^T in column
# chunks of q and k). At s 300 all of these take the one pass with the
# scores in shared memory for s <= 512 (64 queries a block, a row's keys
# over two warps); past s 512 the two passes, whose steps they are, take
# them: so a few again at s 600, and s 512 and 513 at dh 320
ATTENTION_CHECK_SHAPES = [
    ("s16_dh64", 4097, 16, 384, 6, "bf16"),
    ("s32_dh64", 4097, 32, 384, 6, "bf16"),
    ("s128_dh64", 2048, 128, 384, 6, "bf16"),
    ("s40_dh64", 2048, 40, 384, 6, "bf16"),
    ("s40_dh32", 2048, 40, 256, 8, "bf16"),
    ("s100_dh64", 2048, 100, 384, 6, "bf16"),
    ("s100_dh32", 2048, 100, 256, 8, "bf16"),
    ("s129", 64, 129, 512, 8, "bf16"),
    ("s200", 64, 200, 512, 8, "bf16"),
    ("s1000", 16, 1000, 512, 8, "bf16"),
    ("s2048", 8, 2048, 512, 8, "bf16"),
    ("dh8", 512, 100, 64, 8, "bf16"),
    ("dh16", 512, 100, 128, 8, "bf16"),
    ("dh96", 512, 200, 768, 8, "bf16"),
    ("dh256", 256, 300, 512, 2, "bf16"),
    ("f16_s77", 2048, 77, 384, 6, "f16"),
    ("f16_s300", 128, 300, 512, 8, "f16"),
    ("f32_s512", 128, 512, 512, 8, "f32"),
    ("f16_s127", 64, 127, 512, 8, "f16"),
    ("f16_s128", 64, 128, 512, 8, "f16"),
    ("s255", 64, 255, 512, 8, "bf16"),
    ("s257", 64, 257, 512, 8, "bf16"),
    ("dh256_s77", 256, 77, 512, 2, "bf16"),
    ("dh96_s131", 512, 131, 768, 8, "bf16"),
    ("f16_s512", 128, 512, 512, 8, "f16"),
    ("suffix_s300", 128, 300, 512, 8, "bf16", "suffix"),
    ("suffix_s512_f16", 64, 512, 512, 8, "f16", "suffix"),
    ("suffix_s200_f32", 64, 200, 512, 8, "f32", "suffix"),
    ("dh1_s1", 97, 1, 2, 2, "bf16"),
    ("dh4_s33_f16", 129, 33, 16, 4, "f16"),
    ("dh12_s77", 300, 77, 384, 32, "bf16"),
    ("dh12_s128_suffix", 101, 128, 36, 3, "bf16", "suffix"),
    ("dh20_s130_f32", 50, 130, 40, 2, "f32"),
    ("dh36_s257", 33, 257, 72, 2, "bf16"),
    ("dh100_s600_f16_suffix", 9, 600, 200, 2, "f16", "suffix"),
    ("dh264_s70_f32_suffix", 21, 70, 264, 1, "f32", "suffix"),
    ("dh320_s256", 65, 256, 1280, 4, "bf16"),
    ("dh512_s100", 17, 100, 1024, 2, "bf16"),
    ("dh1024_s64_f32", 7, 64, 2048, 2, "f32"),
    ("dh1024_s300_suffix", 5, 300, 1024, 1, "bf16", "suffix"),
    ("dh12_s128_f16", 2048, 128, 384, 32, "f16"),
    ("dh12_s129", 1024, 129, 384, 32, "bf16"),
    ("dh12_s128_f32_suffix", 512, 128, 384, 32, "f32", "suffix"),
    ("dh12_s129_f16_suffix", 512, 129, 384, 32, "f16", "suffix"),
    ("dh20_s128", 1024, 128, 640, 32, "bf16"),
    ("dh20_s129_f16", 512, 129, 640, 32, "f16"),
    ("dh20_s128_f32", 512, 128, 640, 32, "f32"),
    ("dh20_s129_f32_suffix", 256, 129, 640, 32, "f32", "suffix"),
    ("dh36_s128_f32", 256, 128, 72, 2, "f32"),
    ("dh36_s129_f16", 256, 129, 72, 2, "f16"),
    ("dh320_s257", 16, 257, 1280, 4, "bf16"),
    ("dh320_s256_f32_suffix", 16, 256, 640, 2, "f32", "suffix"),
    ("dh12_h6", 1024, 100, 72, 6, "bf16"),
    ("dh20_h5_row600", 1024, 77, 100, 5, "bf16"),
    ("dh20_h5_row600_s300_f16", 256, 300, 100, 5, "f16"),
    ("dh480", 16, 300, 480, 1, "bf16"),
    ("dh488_f16", 16, 300, 488, 1, "f16"),
    ("dh640", 16, 300, 640, 1, "bf16"),
    ("dh648_f16_suffix", 8, 300, 1296, 2, "f16", "suffix"),
    ("dh288_f32", 16, 300, 288, 1, "f32"),
    ("dh296_f32", 16, 300, 296, 1, "f32"),
    ("dh352_f32", 16, 300, 352, 1, "f32"),
    ("dh360_f32_suffix", 16, 300, 720, 2, "f32", "suffix"),
    ("dh2192", 4, 300, 2192, 1, "bf16"),
    ("dh2200_f16_suffix", 4, 300, 2200, 1, "f16", "suffix"),
    ("dh1648_f32", 4, 300, 1648, 1, "f32"),
    ("dh1656_f32_suffix", 4, 300, 1656, 1, "f32", "suffix"),
    ("dh320_s512", 16, 512, 1280, 4, "bf16"),
    ("dh320_s513_f16_suffix", 16, 513, 1280, 4, "f16", "suffix"),
    ("dh320_s512_f32", 8, 512, 640, 2, "f32"),
    ("dh488_s600", 16, 600, 488, 1, "bf16"),
    ("dh648_s600_f16_suffix", 8, 600, 1296, 2, "f16", "suffix"),
    ("dh296_s600_f32", 16, 600, 296, 1, "f32"),
    ("dh360_s600_f32_suffix", 16, 600, 720, 2, "f32", "suffix"),
    ("dh2200_s600", 4, 600, 2200, 1, "bf16"),
    ("dh1656_s600_f32", 4, 600, 1656, 1, "f32"),
]
# every shape is checked on this many seeded inputs, the first one timed
ATTENTION_SEEDS = 3
# kernel vs plain: the same bf16 (f16) inputs and f32 sums; a sum in
# another order can flip one bf16 rounding of a probability or of ctx, so
# the bound is one bf16 ulp at |ctx| < 8 (unit-normal qkv keeps |ctx| < 8)
ATTENTION_ATOL = 2.0**-5
# at f32, against the plain version at f32 with TF32 off: the kernel's
# 3xTF32 products leave ~2^-22 of each product out and sum in another
# order (at most 9.3e-6 read, at s 512)
ATTENTION_F32_ATOL = 1e-5
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
# (131,072 documents before long_embed joined the script, 65,536 before
# the gateway, swap and rescale phases did: cut for their time)
INGEST_DOCS, INGEST_WAVES, INGEST_QUESTIONS, INGEST_K = 32_768, 16, 64, 4
# long_embed: the JAX package's own encoder defaults (TransformerConfig(),
# pathway_tpu/models/transformer.py:40-58, through embedder_config; embed_dim
# 512) behind the default TokenCountSplitter() (50 to 500 tokens): what a RAG
# user with 500-token chunks runs, and the width at which the JAX package's
# Pallas kernel runs at the s 256 and s 512 buckets. Documents are windows of
# the repo's texts, in waves that alternate short documents (one chunk of at
# most 256 tokens) and long ones (chunks of up to 500 words, the s 512 bucket)
LONG_EMBEDDER = dict(
    vocab_size=32768, d_model=512, n_heads=8, n_layers=6, d_ff=2048, max_len=512, embed_dim=512,
)
# (16,384 documents, 63 s on a slow host, before the gateway, swap and
# rescale phases joined the script: cut for their time)
LONG_DOCS, LONG_WAVES, LONG_QUESTIONS, LONG_K = 8_192, 8, 64, 4
LONG_SHORT_WORDS, LONG_LONG_WORDS = (40, 120), (300, 900)
# the same encoder at f32 through the kernel: LONG_F32_CHUNKS of the
# store's chunks against the plain attention route on the card, and
# LONG_F32_CPU_CHUNKS of them against the CPU forward (at f32 the CPU takes
# ~0.27 s a 512-token chunk on 8 cores; all 1,024 would take minutes); unit
# vectors, f32 sums in another order
LONG_F32_CHUNKS, LONG_F32_CPU_CHUNKS, LONG_F32_ATOL = 1024, 64, 1e-4
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
# the incremental index runs over 1/64 of the slab's random-token rows plus
# all its text rows: its host retrain took 193-312 s over all 1,050,705
# rows, 187-267 s over half of them, 116-151 s over a quarter, 130 s over
# an eighth (its PQ codebooks train on at most 131,072 rows) and 29-35 s
# over 1/32, the larger part of the script's time
ANN_INDEX_DOCS = N_DOCS // 64
# churn of the incremental index: waves of removes and fresh adds, a search after each
CHURN_WAVES, CHURN_WAVE = 16, 256
# the tiered index: the same rows cut to 16,384 (all text rows, the rest
# random-token rows): its host numpy retrain took 149 s at 131,072 rows,
# 41-48 s at 65,536 and 26-31 s at 32,768 on the 8 host CPUs of an H100
# machine; m 48 as the flagship width's auto_subvectors; 4 churn waves, a
# rebalance after each
TIERED_ROWS, TIERED_SUBVECTORS, TIERED_CHURN_WAVES = 16_384, 48, 4
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
# the device mesh: MESH_SHARDS shards of the one card (PATHWAY_MESH_DEVICES
# = cuda:0*4 for the meshes the port builds itself); one card gives no
# interconnect, so these phases hold the sharded paths to the unsharded
# ones and time the merges and copies, never a scaling figure
MESH_SHARDS = 4
# mesh_knn: the sharded exact search against knn_search on the same f32 slab
MESH_KNN_ATOL = 1e-5
# mesh_exchange: the skewed mix sends half of the rows to shard 0; the
# engine groupby of tests/test_rescale_exchange.py at a deployment's size
EXCHANGE_SKEW = 0.5
# (131,072 groupby rows before long_embed joined the script, 65,536 before
# the gateway, swap and rescale phases did; halved for their time)
GROUPBY_ROWS, GROUPBY_GROUPS = 32_768, 64
# mesh_tp over (data 2, model 2): bf16 activations round at other points
# than the unsharded forward's (f32 partial sums added across the model
# shards, then rounded once), so unit-norm embeddings within 2^-6 and the
# decoder's argmax equal at 95% of positions at least
TP_MESH = (2, 2)
TP_ENC_ROWS, TP_LM_ROWS, TP_LM_SEQ = 16_384, 4, 64
TP_EMBED_ATOL, TP_ARGMAX_MIN = 2.0**-6, 0.95
# ring_encode: the sequence over MESH_SHARDS shards; ring attention keeps
# f32 probabilities where the reference attention rounds them to bf16
# (embeddings within 2^-6), and in f32 it sums 8192 keys in blocks (1e-4)
RING_ROWS, RING_ATTN = 4096, (4, 8192, 6, 64)
RING_EMBED_ATOL, RING_ATTN_ATOL = 2.0**-6, 1e-4
# train_step: the Gemma-2B-shaped LM at f32 parameters, bf16 compute;
# then JaxLMChat's default model at f32 on the card against the CPU (sums
# in another order: losses within 1e-5 relative, 99.9% of the parameters
# within 2e-5, all within 2 * lr * steps)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 256, 5, 3e-4
TRAIN_CHECK_STEPS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 3, 4, 128
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL = 1e-5, 2e-5
# segment_reduce: float sums through the card's atomics, in any order
SEGMENT_VALUES, SEGMENT_SEGMENTS, SEGMENT_RTOL = 1 << 24, 1 << 20, 1e-5
# mesh_slots: the slot pool over 2 shards against one pool of as many slots
SLOTS_SHARDS, SLOTS_PER_SHARD, SLOTS_REQUESTS, SLOTS_NEW = 2, 8, 32, 16
# bf16 decode logits against a full causal forward over the same tokens:
# the two round at other points (cached K/V vs recomputed, other matmul
# shapes) on logits of |l| < 8
DECODE_VS_FORWARD_ATOL = 0.125


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_report(log: str) -> dict:
    """`nvcc -Xptxas -v`'s log of a kernel source, by instantiation: its
    registers a thread, spill bytes and stack frame ("wgmma_attention_kernel
    <bf16, 64>": ...), and the compiler's advisories (a serialized wgmma
    pipeline, an injected wait)."""
    kernels, advisories, name = {}, [], None
    short = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}
    for ln in log.splitlines():
        if "Compiling entry function" in ln and "_kernelI" in ln:
            # the mangled name's last identifier is `<length><name>_kernel`
            end = ln.index("_kernelI") + len("_kernel")
            base = next(ln[end - n:end] for n in range(len("_kernel"), end)
                        if ln[end - n - len(str(n)):end - n] == str(n))
            args = re.findall(r"13__nv_bfloat16|6__half|(?<=I)f(?=[LE])|(?<=Li)\d+(?=E)", ln[end:].split("EEv")[0] + "E")
            name = f"{base}<{', '.join(short.get(a, a) for a in args)}>"
        elif "Potential Performance Loss" in ln or "is injected" in ln:
            advisories.append(ln.split("ptxas info    : ")[-1][:240])
        elif name and "bytes stack frame" in ln:
            kernels[name] = ln.strip()
        elif name and "Used" in ln and "registers" in ln:
            kernels[name] = re.search(r"Used \d+ registers", ln).group(0) + "; " + kernels.get(name, "")
    return {"kernels": kernels, "advisories": advisories}


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


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


def exp_floor_ms(b: int, s: int, h: int) -> float:
    """Least time the SFU takes for the b*h*s*s exp2 of the scores, in ms;
    shown beside `attention_bound`, which it does not change."""
    return b * h * s * s / SFU_EXP2_PER_S * 1e3


# ------------------------------------------------------------ phase 1


TORCH_DTYPES = {"bf16": "bfloat16", "f16": "float16", "f32": "float32"}
# the words of pathway_tpu_torch/models/tokenizer.py's HashTokenizer
WORD_RE = re.compile(r"[a-z0-9]+", re.IGNORECASE)


def attention_case(b: int, s: int, d: int, seed: int, dtype: str = "bf16", mask_kind: str = "prefix"):
    """Seeded unit-normal qkv in `dtype` and a mask with random lengths,
    every 97th row all padding (as bucket padding makes). A "prefix" mask
    holds each row's first `len` keys, a "suffix" mask its last `len`, so
    that most rows start with padding keys (a whole first key tile where
    len < s - 128)."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, s, 3 * d), generator=gen, device=dev).to(getattr(torch, TORCH_DTYPES[dtype]))
    lens = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
    lens[::97] = 0
    pos = torch.arange(s, device=dev)[None, :]
    if mask_kind == "suffix":
        mask = (pos >= s - lens[:, None]).to(torch.int32)
    else:
        mask = (pos < lens[:, None]).to(torch.int32)
    return qkv, mask, lens


def check_attention(label: str, b: int, s: int, d: int, h: int, dtype: str, mask_kind: str = "prefix", *,
                    seed: int, timed: bool) -> dict:
    """The kernel against its plain version on ATTENTION_SEEDS seeded
    inputs in `dtype` with random padding (a prefix or suffix mask) and
    all-padding rows; with `timed`, also the times of the kernel, the
    plain version and SDPA on the first, beside the bound and the exp2
    floor."""
    import torch
    import torch.nn.functional as F

    from pathway_tpu_torch.ops.attention import fused_qkv_attention, reference_attention

    errs, pad_errs, finite, ref_max, n_pad = [], [], True, 0.0, 0
    for i in range(ATTENTION_SEEDS):
        qkv, mask, lens = attention_case(b, s, d, seed + 1000 * i, dtype, mask_kind)
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
    atol = ATTENTION_F32_ATOL if dtype == "f32" else ATTENTION_ATOL

    row = dict(
        phase="attention" if timed else "attention_check", shape=label, b=b, s=s, d=d,
        n_heads=h, dtype=dtype, mask=mask_kind, max_abs_err=err, max_abs_err_by_seed=errs, atol=atol,
        finite=finite, all_padding_rows=n_pad, all_padding_err=pad_err,
    )
    if timed:
        # timed on the first seed's inputs
        qkv, mask, _ = attention_case(b, s, d, seed, dtype)
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
        bound_ms, bound_by, nbytes, flops = attention_bound(b, s, d, h, dtype)
        row.update(
            library_err=lib_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by, exp_floor_ms=exp_floor_ms(b, s, h), bytes=nbytes,
            flops=flops, achieved_gb_s=nbytes / (ms * 1e-3) / 1e9,
        )
        del qkv, mask, ref, q, k, v, bias
    emit(row)
    if not finite or ref_max >= 8 or err > atol or pad_err > atol:
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


def long_corpus(texts: list[str], n_docs: int, waves: int, seed: int) -> list[str]:
    """`n_docs` documents cut from the repo's texts as word windows, each
    made unique by an id token of its own: even waves LONG_SHORT_WORDS
    words long, odd waves LONG_LONG_WORDS."""
    import numpy as np

    words = " ".join(texts).split()
    rng = np.random.default_rng(seed)
    per_wave = -(-n_docs // waves)
    docs = []
    for i in range(n_docs):
        lo, hi = LONG_LONG_WORDS if (i // per_wave) % 2 else LONG_SHORT_WORDS
        n = int(rng.integers(lo, hi + 1))
        start = int(rng.integers(0, len(words) - n))
        docs.append(" ".join(words[start:start + n]) + f" doc{i:07d}")
    return docs


def run_rag_ingest(device, emb_kw: dict, texts: list[str], *, n_docs: int, waves: int,
                   n_q: int, k: int, phase: str = "rag_ingest", docs: list[str] | None = None,
                   splitter_kw: dict | None = None, keep_chunks: list | None = None) -> dict:
    """A live document store at a deployment's size: `n_docs` documents
    (`docs`, else drawn from `texts`) streamed in `waves` waves into
    DocumentStore with a TokenCountSplitter (`splitter_kw`, else the app's
    50 to 250 tokens) and a TorchEmbedder of `emb_kw`, then `n_q` questions
    retrieved with `k`. Held to (i) a direct split of the same documents
    and (ii) a VectorSlabIndex built directly from `encode_many` over the
    same chunks on the same device, compared as (score, text) after the
    re-sort. The chunks and their token counts go into `keep_chunks` when
    it is given."""
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
    from pathway_tpu_torch.xpacks.llm.embedders import bucket_len
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg = embedder_config(**emb_kw)
    emb = TorchEmbedder(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    emb.encode_many(["warm-up"])  # outside the timed run, as in rag_pipeline
    # word counts: tiktoken would fetch its encoding over the network on first use
    splitter_kw = dict(min_tokens=50, max_tokens=250) if splitter_kw is None else splitter_kw
    splitter = TokenCountSplitter(**splitter_kw, tokenize_fn=str.split)
    docs = ingest_corpus(texts, n_docs, seed=0) if docs is None else docs
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
    launches_by_seq = dict(sorted(_build.LAUNCH_TAGS.get(KERNEL, {}).items()))
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
    chunks_by_bucket: dict[int, int] = {}
    for c, n in want_chunks.items():
        # HashTokenizer.tokenize's length (the CLS id and one id a word, up
        # to max_len) without hashing the words
        tokens = min(1 + len(WORD_RE.findall(c.lower())), cfg.max_len)
        bucket = bucket_len(tokens, cfg.max_len)
        chunks_by_bucket[bucket] = chunks_by_bucket.get(bucket, 0) + n
        if keep_chunks is not None:
            keep_chunks.append((c, tokens))
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
        phase=phase, documents=n_docs, waves=waves,
        splitter=f"TokenCountSplitter({splitter.min_tokens}, {splitter.max_tokens})",
        embedder=dict(emb_kw, dtype="bf16"), chunks=sum(held.values()),
        chunks_by_bucket=dict(sorted(chunks_by_bucket.items())), **window,
        documents_per_s=n_docs / window["seconds"], chunks_per_s=sum(held.values()) / window["seconds"],
        stage_seconds=stages, attention_launches=launches, attention_launches_by_seq=launches_by_seq,
        encoder_dispatches=dispatches,
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


def run_long_embed(device, emb_kw: dict, texts: list[str], *, n_docs: int, waves: int, n_q: int,
                   k: int, f32_chunks: int, f32_cpu_chunks: int) -> dict:
    """Long-chunk live-RAG ingest (phase `long_embed`): `long_corpus`
    documents through `run_rag_ingest` with the default
    TokenCountSplitter() (50 to 500 tokens) and a TorchEmbedder of
    `emb_kw`; on the card the attention kernel must launch at the s 256
    and s 512 buckets. Then (phase `long_embed_f32`) the same encoder at
    f32 encodes `f32_chunks` of the store's chunks through the kernel,
    held to the plain attention route on the same device and, for
    `f32_cpu_chunks` of them, to the port's CPU forward of the same
    weights. Returns the ingest row with the launches of both phases."""
    import numpy as np
    import torch

    from pathway_tpu_torch.models.tokenizer import HashTokenizer
    from pathway_tpu_torch.models.transformer import TransformerEncoder, embedder_config
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.attention import KERNEL

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    chunks: list[tuple[str, int]] = []
    row = run_rag_ingest(device, emb_kw, texts, n_docs=n_docs, waves=waves, n_q=n_q, k=k,
                         phase="long_embed", docs=long_corpus(texts, n_docs, waves, seed=0),
                         splitter_kw={}, keep_chunks=chunks)
    by_seq = row["attention_launches_by_seq"]
    if on_card and not (by_seq.get(256, 0) > 0 and by_seq.get(512, 0) > 0):
        raise AssertionError(f"long_embed did not launch the attention kernel at s 256 and s 512: {by_seq}")

    # f32: chunks spread over the store's lengths, one batch padded to the longest
    cfg = embedder_config(dtype=torch.float32, **emb_kw)
    tok = HashTokenizer(vocab_size=cfg.vocab_size, max_len=cfg.max_len)
    order = np.argsort([n for _, n in chunks], kind="stable")
    picked = [chunks[i][0] for i in order[np.linspace(0, len(chunks) - 1, min(f32_chunks, len(chunks))).astype(int)]]
    ids, mask = tok.batch(picked)
    ids_t, mask_t = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    # the same weights on both devices: drawn by one CPU generator each
    draw = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    fused = TransformerEncoder(cfg, device=dev, generator=draw())
    plain = TransformerEncoder(dataclasses.replace(cfg, fused_attention=False), device=dev, generator=draw())
    launches0 = _build.LAUNCHES.get(KERNEL, 0)
    with torch.inference_mode():
        t0 = time.perf_counter()
        got = fused(ids_t.to(dev), mask_t.to(dev))
        if on_card:
            torch.cuda.synchronize()
        fused_s = time.perf_counter() - t0
        launches = _build.LAUNCHES.get(KERNEL, 0) - launches0
        want = plain(ids_t.to(dev), mask_t.to(dev)).cpu().numpy()
        got = got.cpu().numpy()
        del fused, plain
        sel = np.linspace(0, len(picked) - 1, min(f32_cpu_chunks, len(picked))).astype(int)
        cpu = TransformerEncoder(cfg, device="cpu", generator=draw())
        t0 = time.perf_counter()
        want_cpu = cpu(ids_t[sel], mask_t[sel]).numpy()
        cpu_s = time.perf_counter() - t0
    err_plain = float(np.abs(got - want).max())
    err_cpu = float(np.abs(got[sel] - want_cpu).max())
    f32_row = dict(
        phase="long_embed_f32", chunks=len(picked), seq=int(ids.shape[1]),
        tokens_min=int(mask.sum(1).min()), tokens_max=int(mask.sum(1).max()),
        fused_seconds=fused_s, attention_launches=launches, max_abs_err_vs_plain_route=err_plain,
        cpu_chunks=int(len(sel)), cpu_seconds=cpu_s, max_abs_err_vs_cpu=err_cpu, atol=LONG_F32_ATOL,
        finite=bool(np.isfinite(got).all()),
    )
    emit(f32_row)
    if not f32_row["finite"] or err_plain > LONG_F32_ATOL or err_cpu > LONG_F32_ATOL:
        raise AssertionError(f"the f32 encoder through the kernel disagrees: {f32_row}")
    if on_card and launches != cfg.n_layers:
        raise AssertionError(f"the f32 encoder did not go through the attention kernel: {f32_row}")
    row["f32"] = f32_row
    row["launches"] = row["attention_launches"] + launches
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
# writes its share of the final table and its own counts. With a shared
# persistence root (`pdir`, elastic_rescale under the supervisor) the
# shards are read as they grow, each process reports how many rows it
# has delivered every 0.1 s, a `stop` file ends the run, and every
# process of every generation writes what it delivered under its own OS
# pid when its run ends, by a rebalance too.
SPAWN_EMBED_SCRIPT = """
import json, os, sys, threading, time
from time import time as wall

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
ELASTIC = bool(CFG.get("pdir"))
TAG = f"{PID}.{os.getpid()}" if ELASTIC else str(PID)

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
    pw.io.jsonlines.read(path, schema=Doc, mode="streaming", autocommit_duration_ms=50, _single_pass=not ELASTIC)
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
stamps = []  # wall clock of the first and the last delivery


def on_change(key, row, time, is_addition):
    # every chunk and every document total is final in the wave that
    # makes it: a retraction would be a fault, counted for the caller
    if is_addition:
        rows[key.value] = row
        stamps[1:] = [wall()] if stamps else [wall(), wall()]
    else:
        retractions[0] += 1


def report_progress():
    path = CFG["out"] + f".{TAG}.progress"
    with open(path + ".tmp", "w") as f:
        json.dump(dict(process=PID, processes=N, rows=len(rows)), f)
    os.replace(path + ".tmp", path)


def watch():
    from pathway_tpu_torch.internals import run as run_mod

    while True:
        report_progress()
        if os.path.exists(CFG["stop"]):
            run_mod.stop_current_run()
        time.sleep(0.1)


pw.io.subscribe(out, on_change=on_change)
_build.reset_launch_counts()
persistence = None
if ELASTIC:
    persistence = pw.persistence.Config(pw.persistence.Backend.filesystem(CFG["pdir"]))
    threading.Thread(target=watch, daemon=True).start()


def write_output():
    seconds = time.perf_counter() - t0
    keys = sorted(rows)
    e = emb.config.embed_dim
    np.savez(
        CFG["out"] + f".{TAG}.npz",
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
    with open(CFG["out"] + f".{TAG}.json", "w") as f:
        json.dump(dict(
            process=PID, processes=N, device=str(emb.device), attention_launches=_build.LAUNCHES.get(KERNEL, 0),
            embedded_rows=embedded_rows[0], encoder_dispatches=emb.dispatches, output_rows=len(keys),
            retractions=retractions[0], run_seconds=seconds, device_idle_share="not measured",
            run_started_at=started, first_row_at=stamps[0] if stamps else None,
            last_row_at=stamps[-1] if stamps else None, exited_at=wall(),
        ), f)
    if ELASTIC:
        report_progress()


t0, started = time.perf_counter(), wall()
try:
    pw.run(persistence_config=persistence)
finally:
    write_output()
"""
# the embeddings of -n 2 against -n 1: the same chunks embedded in other
# batches (another row bucket, another row order in a bucket), so a chunk's
# bf16 embedding may differ by a few bf16 ulps, as in rag_ingest
SPAWN_EMBED_ATOL = INGEST_SCORE_ATOL
SPAWN_SHARDS = 4
# rag_ingest's documents were 131,072 before long_embed joined the script
# (121.6 s for both runs; 65,536 took 123.8 s, mostly process start-up and
# `-n 2`'s shared host), 16,384 before elastic_rescale ran them once more:
# cut for room in the script's time
SPAWN_DOCS = 8_192


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


# ------------------------------------------------------------ elastic_rescale


def _progress(outdir: Path) -> list[dict]:
    """The latest progress report of every process of every generation
    of an elastic run (SPAWN_EMBED_SCRIPT writes them whole)."""
    out = []
    for path in outdir.glob("out.*.progress"):
        with contextlib.suppress(OSError, ValueError):
            out.append(json.loads(path.read_text()))
    return out


def run_elastic_rescale(device, emb_kw: dict | None, texts: list[str], *, n_docs: int, shards: int,
                        workdir: Path, static: dict, embed_atol: float = SPAWN_EMBED_ATOL,
                        timeout_s: float = 600.0) -> dict:
    """`elastic_rescale`: spawn_embed's documents and pipeline under the
    port's supervisor (`parallel/supervisor.py:run_supervised`, elastic
    membership on a shared persistence root), started at 2 processes on
    the card. The first half of the documents is in the shards at the
    start; once process 0 delivers rows, a join intent
    (`parallel/membership.py:announce_join`) grows the mesh to 3 at a
    checkpoint fence; once the 3 are up, the second half is appended and
    the run ends when every chunk is delivered. Exactly one rebalance and
    3 members at the end; the delivered table equals `static`'s (spawn
    -n N outputs by N, from run_spawn_embed): keys, counts and texts
    exactly, embeddings within `embed_atol`. Documents/s are read by
    generation from the processes' own first and last deliveries."""
    import threading

    import numpy as np

    from pathway_tpu_torch.parallel import membership, supervisor
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    docs = ingest_corpus(texts, n_docs, seed=0)
    splitter = TokenCountSplitter(min_tokens=50, max_tokens=250, tokenize_fn=str.split)
    n_chunks = sum(len(splitter.chunk(d)) for d in docs)
    outdir = workdir / "elastic"
    outdir.mkdir(parents=True)
    paths = [outdir / f"docs-{i}.jsonl" for i in range(shards)]

    def write(first: bool) -> None:
        for i, path in enumerate(paths):
            with open(path, "a") as f:
                f.write("".join(json.dumps({"doc": j, "text": docs[j]}) + "\n"
                                for j in range(i, n_docs, shards) if (j < n_docs // 2) == first))

    write(first=True)
    script = outdir / "spawn_embed_pipeline.py"
    script.write_text(SPAWN_EMBED_SCRIPT)
    pdir, stop = outdir / "pstate", outdir / "STOP"
    cfg = dict(root=str(ROOT), shards=[str(p) for p in paths], out=str(outdir / "out"), embedder=emb_kw,
               device=device, pdir=str(pdir), stop=str(stop))
    (outdir / "cfg.json").write_text(json.dumps(cfg))
    supervised: dict = {}

    def supervise() -> None:
        try:
            supervised["result"] = supervisor.run_supervised(
                [sys.executable, str(script), str(outdir / "cfg.json")], 2, free_port_base(3),
                env={"PYTHONPATH": str(ROOT)}, timeout_s=timeout_s, state_dir=str(pdir))
        except Exception as e:  # noqa: BLE001 — re-raised below with what the run left
            supervised["error"] = e

    def wait_for(what: str, cond) -> float:
        deadline = time.perf_counter() + timeout_s
        while not cond():
            if not thread.is_alive():
                raise AssertionError(f"elastic_rescale: the mesh ended before {what}: {supervised}")
            if time.perf_counter() > deadline:
                stop.touch()
                raise AssertionError(f"elastic_rescale: no {what} within {timeout_s} s")
            time.sleep(0.05)
        return time.time()

    t0 = time.time()
    thread = threading.Thread(target=supervise, name="elastic-supervisor")
    thread.start()
    try:
        wait_for("delivery of 2 processes", lambda: any(
            p["processes"] == 2 and p["rows"] > 0 for p in _progress(outdir)))
        announced = time.time()
        membership.announce_join(str(pdir))
        grown = wait_for("generation of 3 processes", lambda: len(
            {p["process"] for p in _progress(outdir) if p["processes"] == 3}) == 3)
        write(first=False)
        wait_for("delivery of every chunk", lambda: sum(p["rows"] for p in _progress(outdir)) >= n_chunks)
        stop.touch()
    finally:
        stop.touch()
        thread.join(timeout=timeout_s)
    wall_s = time.time() - t0
    if "error" in supervised or "result" not in supervised:
        raise AssertionError(f"elastic_rescale: the supervised mesh failed: {supervised}")
    res = supervised["result"]

    stats = [json.loads(p.read_text()) for p in sorted(outdir.glob("out.*.json"))]
    out_doc_by_pid: dict[int, list] = {}  # the documents each generation delivered
    for st, z in zip(stats, [np.load(p) for p in sorted(outdir.glob("out.*.npz"))]):
        out_doc_by_pid.setdefault(st["processes"], []).extend(z["doc"].tolist())
    out = read_spawn_output(outdir)
    key = out["key_hi"].astype(object) * (1 << 64) + out["key_lo"].astype(object)
    _, first = np.unique(key, return_index=True)
    duplicates = len(key) - len(first)
    out = {k: v[first] for k, v in out.items()}  # sorted by key, one row a key
    exact = ("key_hi", "key_lo", "doc", "idx", "n_chunks", "doc_chars", "text")
    equal, max_err = {}, {}
    for n, other in static.items():
        equal[n] = all(np.array_equal(out[k], other[k]) for k in exact)
        max_err[n] = float(np.abs(out["vec"] - other["vec"]).max(initial=0.0)) if equal[n] else None

    by_gen = {}
    for st in stats:
        g = by_gen.setdefault(st["processes"], dict(processes=0, chunks=0, started=None, last=None, exited=None,
                                                    attention_launches=0, devices=set()))
        g["processes"] += 1
        g["chunks"] += st["output_rows"]
        g["attention_launches"] += st["attention_launches"]
        g["devices"].add(st["device"])
        for k, pick, v in (("started", min, st["run_started_at"]), ("last", max, st["last_row_at"]),
                           ("exited", max, st["exited_at"])):
            if v is not None:
                g[k] = v if g[k] is None else pick(g[k], v)
    # a generation's work runs from its pw.run() (the 3, from the append
    # of the second half) to its last delivery
    gens = {}
    for n, g in sorted(by_gen.items()):
        begin = grown if n == 3 else g["started"]
        span = g["last"] - begin if g["last"] is not None else None
        docs_n = len(set(out_doc_by_pid.get(n, ())))
        gens[n] = dict(processes=g["processes"], chunks=g["chunks"], documents=docs_n, seconds=span,
                       documents_per_s=docs_n / span if span else None,
                       chunks_per_s=g["chunks"] / span if span else None,
                       attention_launches=g["attention_launches"], devices=sorted(g["devices"]))
    on_card = device is None or str(device).startswith("cuda")
    row = dict(
        phase="elastic_rescale", card=gpu_name_and_power() if on_card else "cpu", documents=n_docs,
        chunks=n_chunks, shards=shards, rebalances=res["rebalances"],
        members=res["members"], generations=res["generations"], wall_s=wall_s,
        rebalance_s=grown - announced, quiesce_s=(by_gen.get(2, {}).get("exited") or announced) - announced,
        by_members=gens, delivered=len(out["doc"]), duplicates=duplicates, equal_static=equal,
        max_abs_err_static=max_err, embed_atol=embed_atol,
        retractions=sum(st["retractions"] for st in stats),
        attention_launches=sum(st["attention_launches"] for st in stats),
    )
    emit(row)
    faults_found = []
    if res["rebalances"] != 1 or res["members"] != 3 or set(gens) != {2, 3}:
        faults_found.append("not one rebalance from 2 to 3 members")
    if not all(equal.values()) or any(e is None or e > embed_atol for e in max_err.values()):
        faults_found.append("the delivered table differs from the static runs'")
    if row["retractions"] or len(out["doc"]) != n_chunks:
        faults_found.append("a retraction, or not every chunk once")
    if any(not g["chunks"] for g in gens.values()):
        faults_found.append("a generation delivered nothing")
    if on_card and any(g["attention_launches"] <= 0 or not all(d.startswith("cuda") for d in g["devices"])
                       for g in gens.values()):
        faults_found.append("a generation embedded off the attention kernel on the card")
    if faults_found:
        raise AssertionError(f"elastic_rescale: {faults_found}: {row}")
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
            churn_waves: int, churn_wave: int, reps: int, mesh_shards: int = 0) -> dict:
    """The port's approximate tier. (a) `ann_build` and `ann_search`:
    bench.py's 1M x 64 ANN corpus built by `build_ivf_pq(seed=0)` and
    searched at its operating point (B 32, k 10, nprobe 16, candidates
    1024), against exact `knn_search` and the numpy oracle, then the
    nprobe 4/16/64 frontier. (b) `ann_index`: `IvfPqIndex` over `vectors`
    (run_slice's rows at the flagship width) with one explicit retrain,
    searched with run_slice's text queries, churned in waves, and wrapped
    in `RerankedSlabIndex` at nprobe 1. With `mesh_shards`, `mesh_ivf`
    holds the list-sharded search over that many shards of `device` to
    the unsharded one on (a)'s index (recall at least its recall), and
    `mesh_ivf_index` the trained index of (b), restored with its sharded
    flag on (no second retrain), to the index's own results. Returns the
    rows it printed. Runs on the CPU too (at a small size), for a
    rehearsal."""
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
    if mesh_shards:
        from pathway_tpu_torch.parallel.mesh import make_mesh

        t_phase = time.perf_counter()
        t0 = time.perf_counter()
        sidx = ivf.shard_ivf_pq(host, make_mesh((mesh_shards,), ("data",), [dev] * mesh_shards))
        place_s = time.perf_counter() - t0

        def sharded_search():
            return ivf.ivf_pq_search_sharded(qt, sidx, k, nprobe=ANN_NPROBE, candidates=ANN_CANDIDATES)

        s_sh, d_sh = sharded_search()
        sgot = s_sh.cpu().numpy()
        mrow = dict(
            phase="mesh_ivf", shards=mesh_shards, rows=ann_rows, lists=L, padded_lists=int(sidx.codes.shape[0]),
            place_s=place_s, recall_at_10=_recall(sgot, ei, k), unsharded_recall_at_10=srch["recall_at_10"],
            sets_equal_to_unsharded=int(sum(set(a) == set(b) for a, b in zip(sgot, got))),
            queries=ANN_BATCH, p50_ms=timer(sharded_search, reps), unsharded_p50_ms=ann_p50,
            finite=bool(torch.isfinite(d_sh).all()), shape=list(s_sh.shape),
        )
        mrow["seconds"] = time.perf_counter() - t_phase
        emit(mrow)
        if (mrow["recall_at_10"] < mrow["unsharded_recall_at_10"] or not mrow["finite"]
                or mrow["shape"] != [ANN_BATCH, k]):
            raise AssertionError(f"the list-sharded search lost recall: {mrow}")
        del sidx, s_sh, d_sh
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
    if mesh_shards:
        # the trained index restored with its sharded flag on: the
        # checkpoint path, so the lists are not trained a second time
        t_phase = time.perf_counter()
        with _mesh_env(f"{dev}*{mesh_shards}"):
            sharded = IvfPqIndex.__new__(IvfPqIndex)
            sharded.__setstate__({**ann.__getstate__(), "_shard_search": True, "counters": dict(ann.counters)})
            t0 = time.perf_counter()
            res_sh = sharded.search_batch(items)  # places the view
            first_s = time.perf_counter() - t0
            sh_p50 = timer(lambda: sharded.search_batch(items), reps)
        keys_sh = [[key for key, _ in r] for r in res_sh]
        want = exact_keys(qmat)
        per_q = [(len(set(a) & set(w)), len(set(b) & set(w))) for a, b, w in zip(keys_sh, keys_got, want)]
        srow = dict(
            phase="mesh_ivf_index", shards=mesh_shards, rows=n, queries=len(items),
            placements=sharded.counters["sharded_placements"], sharded_searches=sharded.counters["sharded_searches"],
            first_search_s=first_s, search_batch_p50_ms=sh_p50, unsharded_p50_ms=idx_p50,
            sets_equal=int(sum(set(a) == set(b) for a, b in zip(keys_sh, keys_got))),
            recall_at_10=_recall(keys_sh, want, k), unsharded_recall_at_10=idx_row["recall_at_10"],
            queries_below_unsharded=int(sum(a < b for a, b in per_q)),
            self_top1=int(sum(r[0] == key for r, key in zip(keys_sh, query_keys))),
            seconds=time.perf_counter() - t_phase,
        )
        emit(srow)
        if srow["queries_below_unsharded"] or srow["self_top1"] != len(items) or srow["placements"] != 1:
            raise AssertionError(f"the sharded IvfPqIndex lost results of the unsharded one: {srow}")
        del sharded, res_sh
        if on_card:
            torch.cuda.empty_cache()

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
    from pathway_tpu_torch import TorchEmbedder
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
    direct = slab_of(emb, texts, dev)
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


# ------------------------------------------------------------ gateway_overload


# scripts/serving_loadgen.py's rungs as bench.py runs them (bench.py:2083-2110):
# (label, closed-loop clients, seconds, the gateway's max_queue or None for
# no gateway, ms of straggler on every request)
GATEWAY_RUNGS = (
    ("clients_100", 100, 5.0, 64, 0.0),
    ("clients_1000", 1000, 6.0, 256, 0.0),
    ("straggler_gateway", 100, 5.0, 16, 20.0),
    ("straggler_no_gateway", 100, 5.0, None, 20.0),
)
GATEWAY_K = 4
GATEWAY_RETRY_CAP_S = 0.25  # the loadgen's: a 429 waits out its Retry-After up to this
GATEWAY_TIMEOUT_S = 30.0  # the loadgen's rest_connector timeout


async def closed_loop(url: str, clients: int, seconds: float, texts: list[str]) -> dict:
    """scripts/serving_loadgen.py's client fleet: each client POSTs a text,
    awaits the answer and POSTs the next until `seconds` pass; a 429 waits
    out its Retry-After up to GATEWAY_RETRY_CAP_S. Every answer is kept
    beside the text that asked for it."""
    import aiohttp

    counts = {"ok": 0, "shed": 0, "shed_without_retry_after": 0, "timeout": 0, "error": 0}
    answers, latencies, stamps, errors = [], [], [], []
    stop_at = time.perf_counter() + seconds
    timeout = aiohttp.ClientTimeout(total=GATEWAY_TIMEOUT_S + 30)
    async with aiohttp.ClientSession(connector=aiohttp.TCPConnector(limit=0), timeout=timeout) as sess:

        async def client(i: int) -> None:
            n = 0
            while time.perf_counter() < stop_at:
                text = texts[(i * 7919 + n) % len(texts)]
                n += 1
                t0 = time.perf_counter()
                try:
                    async with sess.post(url, json={"query": text, "user": f"u{i}"}) as resp:
                        body = await resp.read()
                        if resp.status == 200:
                            counts["ok"] += 1
                            latencies.append(time.perf_counter() - t0)
                            stamps.append(time.perf_counter())
                            answers.append((text, json.loads(json.loads(body))))
                        elif resp.status == 429:
                            counts["shed"] += 1
                            retry_after = resp.headers.get("Retry-After")
                            counts["shed_without_retry_after"] += retry_after is None
                            await asyncio.sleep(min(float(retry_after or 1), GATEWAY_RETRY_CAP_S))
                        elif resp.status == 504:
                            counts["timeout"] += 1
                        else:
                            counts["error"] += 1
                            errors.append(f"HTTP {resp.status}: {body[:200]!r}")
                except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
                    counts["error"] += 1
                    errors.append(repr(e)[:200])
                    await asyncio.sleep(0.05)

        await asyncio.gather(*(client(i) for i in range(clients)))
    return dict(counts, answers=answers, latencies=latencies, stamps=stamps, errors=errors[:5])


def serve_retrieval(emb, index, k: int, max_queue: int | None, straggle_s: float):
    """scripts/serving_loadgen.py's server on the port: `rest_connector`
    (behind a `ServingGateway` of `max_queue` unless it is None) into a
    stage that embeds each wave's queries with `emb` (one coalesced
    dispatch) and answers each with its top-k of `index`, probing the
    `serving.straggler` fault point first (a hit sleeps `straggle_s`).
    `pw.run()` runs in a thread; returns (url, gateway, stop), once the
    route answers."""
    import socket
    import threading

    import numpy as np
    import requests

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import faults
    from pathway_tpu_torch.internals import run as run_mod
    from pathway_tpu_torch.internals.parse_graph import G

    G.clear()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    gateway = None if max_queue is None else pw.serving.ServingGateway(max_queue=max_queue)
    webserver = pw.io.http.PathwayWebserver(host="127.0.0.1", port=port)
    queries, writer = pw.io.http.rest_connector(
        webserver=webserver, route="/answer", schema=pw.schema_from_types(query=str, user=str),
        gateway=gateway, delete_completed_queries=True, timeout_s=GATEWAY_TIMEOUT_S,
    )

    @pw.udf
    def answer(query: str, vec) -> str:
        if faults.fire("serving.straggler"):
            time.sleep(straggle_s)
        hits = index.search(np.asarray(vec, np.float32), k)
        return json.dumps({"query": query, "hits": [[int(key), float(dist)] for key, dist in hits]})

    embedded = queries.select(query=pw.this.query, vec=emb(pw.this.query))
    writer(embedded.select(result=answer(pw.this.query, pw.this.vec)))
    thread = threading.Thread(target=pw.run, daemon=True, name="gateway-run")
    thread.start()
    url = f"http://127.0.0.1:{port}/answer"

    def stop() -> None:
        run_mod.stop_current_run()
        webserver.stop()
        thread.join(timeout=60)
        G.clear()

    deadline = time.perf_counter() + 120
    while True:
        try:
            if requests.post(url, json={"query": "warm-up", "user": "w"}, timeout=60).status_code == 200:
                return url, gateway, stop
        except requests.RequestException:
            pass
        if time.perf_counter() > deadline:
            stop()
            raise AssertionError(f"the gateway's pipeline did not answer on {url}")
        time.sleep(0.1)


def direct_answers(emb, index, texts: list[str], k: int) -> dict[str, list]:
    """Each text's top-k of `index`, the text embedded by `emb` outside
    any pipeline: the answer a served request must equal."""
    uniq = sorted(set(texts))
    cap = emb._plane.buckets.max_rows
    out = {}
    for s in range(0, len(uniq), cap):
        for text, vec in zip(uniq[s:s + cap], emb.encode_many(uniq[s:s + cap])):
            out[text] = [(int(key), float(dist)) for key, dist in index.search(vec, k)]
    return out


def compare_answers(answers: list, direct: dict[str, list]) -> tuple[list, int, int]:
    """Served answers against the direct ones, as (distance, key) after
    the sort: (mismatches, near ties, answers crossed with another
    request's). A near tie is another key at a distance within
    INGEST_SCORE_ATOL (the query embedded in another batch)."""
    mismatches, near_ties, crossed = [], 0, 0
    for text, ans in answers:
        if ans["query"] != text:
            crossed += 1
            continue
        got = sorted((dist, key) for key, dist in ans["hits"])
        want = sorted((dist, key) for key, dist in direct[text])
        if len(got) != len(want) or any(abs(g[0] - w[0]) > INGEST_SCORE_ATOL for g, w in zip(got, want)):
            mismatches.append((text, got, want))
            continue
        near_ties += sum(g[1] != w[1] for g, w in zip(got, want))
    return mismatches, near_ties, crossed


def slab_of(emb, texts: list[str], device):
    """A `VectorSlabIndex` on `device` holding `texts` (key i: text i) as
    `emb` embeds them in bulk."""
    from pathway_tpu_torch import VectorSlabIndex

    index = VectorSlabIndex(dimensions=emb.config.embed_dim, reserved_space=len(texts), device=device)
    cap = emb._plane.buckets.max_rows
    for s in range(0, len(texts), cap):
        for j, vec in enumerate(emb.encode_many(texts[s:s + cap])):
            index.add(s + j, vec)
    return index


def run_gateway_overload(device, emb_kw: dict, texts: list[str], *, rungs=GATEWAY_RUNGS,
                         k: int = GATEWAY_K) -> dict:
    """`gateway_overload`: scripts/serving_loadgen.py's closed-loop rungs
    against the port's server of its shape (`serve_retrieval`): the
    default `TorchEmbedder` and a `VectorSlabIndex` of `texts` on the
    card. For each rung: p50 and p99, goodput (200s a second), 429s, the
    gateway's counters, the pending high water, K1 launches and the
    device idle share. Every 200 must equal a direct slab query of its
    text, echo its own text (none crossed), and no request may fail but
    with a 429 that carries Retry-After; under the straggler the gateway
    must shed and hold its pending requests to max_queue, and the run
    without it must pile up every client. Runs on the CPU too (a CPU
    embedder and slab, small rungs), for a rehearsal."""
    import resource
    import threading

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import TorchEmbedder
    from pathway_tpu_torch.engine import faults
    from pathway_tpu_torch.models.transformer import embedder_config
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.attention import KERNEL

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    # a thousand clients and their server sockets in one process
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft != resource.RLIM_INFINITY and soft < 4096:
        resource.setrlimit(resource.RLIMIT_NOFILE, (min(4096, hard), hard))
    if on_card:
        emb = TorchEmbedder()  # the default embedder, on the card
        if dataclasses.asdict(emb.config) != dataclasses.asdict(embedder_config(**emb_kw)):
            raise AssertionError(f"the default embedder is not {emb_kw}: {emb.config}")
    else:
        emb = TorchEmbedder(embedder_config(**emb_kw), device=dev)
    t0 = time.perf_counter()
    index = slab_of(emb, texts, dev)
    index_s = time.perf_counter() - t0
    rows, all_answers = {}, []
    for label, clients, seconds, max_queue, straggle_ms in rungs:
        faults.install("serving.straggler@1+" if straggle_ms else None)
        url, gateway, stop = serve_retrieval(emb, index, k, max_queue, straggle_ms / 1e3)
        try:
            depth, sampling = [], threading.Event()

            def sample() -> None:
                while not sampling.is_set():
                    depth.append(int(pw.io.http.route_stats()["/answer"]["pending"]))
                    sampling.wait(0.05)

            sampler = threading.Thread(target=sample, daemon=True)
            sampler.start()
            _build.reset_launch_counts()
            raw: dict = {}
            window = run_window(lambda: raw.update(asyncio.run(closed_loop(url, clients, seconds, texts))),
                                on_card)
            sampling.set()
            sampler.join(timeout=5)
            launches = _build.LAUNCHES.get(KERNEL, 0)
            route = pw.io.http.route_stats()["/answer"]
            snap = gateway.snapshot()["/answer"] if gateway is not None else None
        finally:
            stop()
            faults.install(None)
        all_answers += raw["answers"]
        rows[label] = dict(
            clients=clients, seconds=seconds, gateway=gateway is not None, max_queue=max_queue,
            straggler_ms=straggle_ms, ok=raw["ok"], shed_429=raw["shed"],
            shed_without_retry_after=raw["shed_without_retry_after"], timeouts=raw["timeout"],
            errors=raw["error"], first_errors=raw["errors"],
            p50_ms=percentile_ms(raw["latencies"], 50), p99_ms=percentile_ms(raw["latencies"], 99),
            goodput_rps=raw["ok"] / window["seconds"], window_s=window["seconds"],
            max_pending=route["max_pending"], sampled_max_pending=max(depth, default=0),
            pending_after=route["pending"], gateway_stats=snap, attention_launches=launches,
            device_busy_ms=window["device_busy_ms"], device_idle_share=window["device_idle_share"],
        )
    direct = direct_answers(emb, index, [text for text, _ in all_answers], k)
    mismatches, near_ties, crossed = compare_answers(all_answers, direct)
    row = dict(
        phase="gateway_overload", card=gpu_name_and_power() if on_card else "cpu", chunks=len(texts), k=k,
        index_s=index_s, rungs=rows,
        answers_checked=len(all_answers), mismatches=len(mismatches), near_ties=near_ties,
        crossed=crossed, score_atol=INGEST_SCORE_ATOL,
        first_mismatch=str(mismatches[0])[:600] if mismatches else None,
    )
    emit(row)
    faults_found = []
    for label, r in rows.items():
        if r["errors"] or r["timeouts"] or r["shed_without_retry_after"] or r["pending_after"] or not r["ok"]:
            faults_found.append(f"{label}: a request failed other than by a 429 with Retry-After, or none answered")
        if r["gateway"] and r["max_pending"] > r["max_queue"]:
            faults_found.append(f"{label}: {r['max_pending']} pending past max_queue {r['max_queue']}")
        if r["straggler_ms"] and r["gateway"] and not (r["shed_429"] and r["gateway_stats"]["shed"]):
            faults_found.append(f"{label}: the gateway shed nothing under the straggler")
        if r["straggler_ms"] and not r["gateway"] and r["max_pending"] != r["clients"]:
            faults_found.append(f"{label}: {r['max_pending']} pending, not all {r['clients']} clients")
        if on_card and r["attention_launches"] <= 0:
            faults_found.append(f"{label}: no attention kernel launch")
    if mismatches or crossed:
        faults_found.append(f"{len(mismatches)} answers differ from a direct slab query, {crossed} crossed")
    if faults_found:
        raise AssertionError(f"gateway_overload: {faults_found}: {row}")
    return dict(row, launches=sum(r["attention_launches"] for r in rows.values()))


# ------------------------------------------------------------ bluegreen_swap


# scripts/serving_loadgen.py's --rolling-upgrade on the card: the paced
# groupby of its UPGRADE_SOLO, persisted with a jsonlines sink through the
# outbox, whose events also go through the default TorchEmbedder (each
# event's text embedded on the card; the sink keeps how many embeddings
# came out unit-norm, a count that does not move with the batch an event
# is embedded in). Blue runs `argv[3]` events, the green the same plan over
# a longer stream, each in a process of its own.
BLUEGREEN_SCRIPT = """
import json, sys, time

ROOT, OUT, N = sys.argv[1], sys.argv[2], int(sys.argv[3])
CFG = json.load(open(sys.argv[4]))
sys.path.insert(0, CFG["root"])
import numpy as np
import torch

import pathway_tpu_torch as pw
from pathway_tpu_torch import TorchEmbedder
from pathway_tpu_torch.io.python import ConnectorSubject
from pathway_tpu_torch.models.transformer import embedder_config
from pathway_tpu_torch.ops import _build
from pathway_tpu_torch.ops.attention import KERNEL

kw = {}
if CFG.get("embedder"):
    ekw = dict(CFG["embedder"])
    kw["config"] = embedder_config(dtype=getattr(torch, ekw.pop("dtype", "bfloat16")), **ekw)
if CFG.get("device"):
    kw["device"] = CFG["device"]
emb = TorchEmbedder(**kw)
TEXTS = CFG["texts"]


class Events(ConnectorSubject):
    def run(self):
        for i in range(N):
            self.next(g=f"g{i % 4}", v=i, text=TEXTS[i % len(TEXTS)])
            time.sleep(0.005)


@pw.udf
def unit(vec) -> int:
    return int(abs(float(np.linalg.norm(vec)) - 1.0) < 1e-2)


t = pw.io.python.read(Events(), schema=pw.schema_from_types(g=str, v=int, text=str), name="nums")
e = t.select(g=pw.this.g, v=pw.this.v, unit=unit(emb(pw.this.text)))
agg = e.groupby(e.g).reduce(e.g, total=pw.reducers.sum(e.v), n=pw.reducers.count(), unit=pw.reducers.sum(e.unit))
pw.io.jsonlines.write(agg, OUT)
_build.reset_launch_counts()
t0 = time.perf_counter()
pw.run(persistence_config=pw.persistence.Config(pw.persistence.Backend.filesystem(ROOT)))
with open(OUT + ".stats.json", "w") as f:
    json.dump(dict(device=str(emb.device), attention_launches=_build.LAUNCHES.get(KERNEL, 0),
                   run_seconds=time.perf_counter() - t0), f)
"""
BLUEGREEN_EVENTS = (40, 80)  # tests/test_torch_elastic.py's blue and green streams
BLUEGREEN_CLIENTS, BLUEGREEN_SECONDS, BLUEGREEN_MAX_QUEUE = 50, 6.0, 64  # bench.py's rung


def bluegreen_table(n: int) -> dict:
    """What BLUEGREEN_SCRIPT's sink holds after `n` events: {g: (total, n,
    unit-norm embeddings)}."""
    out: dict = {}
    for i in range(n):
        total, count, units = out.get(f"g{i % 4}", (0, 0, 0))
        out[f"g{i % 4}"] = (total + i, count + 1, units + 1)
    return out


def bluegreen_sink_state(path: str) -> dict:
    """The jsonlines sink's final table, {g: (total, n, unit)}."""
    state: dict = {}
    if os.path.exists(path):
        for line in open(path):
            rec = json.loads(line)
            if rec["diff"] > 0:
                state[rec["g"]] = (rec["total"], rec["n"], rec["unit"])
            elif state.get(rec["g"]) == (rec["total"], rec["n"], rec["unit"]):
                del state[rec["g"]]
    return state


def run_bluegreen_swap(device, emb_kw: dict, texts: list[str], *, workdir: Path,
                       clients: int = BLUEGREEN_CLIENTS, seconds: float = BLUEGREEN_SECONDS) -> dict:
    """`bluegreen_swap`: scripts/serving_loadgen.py's --rolling-upgrade on
    the port. A persisted root is written by BLUEGREEN_SCRIPT (blue,
    `BLUEGREEN_EVENTS[0]` events, embedding on the card); then, a third into
    `clients` closed-loop clients' `seconds` against the gateway-fronted
    retrieval server (`serve_retrieval`, the default embedder), a
    `parallel/bluegreen.py:swap_plan` runs the green (the same plan over
    `BLUEGREEN_EVENTS[1]` events, a process on the card) against a clone and
    commits. The swap must commit with the connector offset and the
    outbox watermark advanced and the green's output equal to the
    analytic table, and no request may fail but with a 429 while it runs;
    p99 is split into the swap's window and the rest. Runs on the CPU too
    (a CPU embedder, a small fleet), for a rehearsal."""
    import threading

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import TorchEmbedder
    from pathway_tpu_torch.models.transformer import embedder_config
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.attention import KERNEL
    from pathway_tpu_torch.parallel import bluegreen

    if (os.cpu_count() or 1) < 2:
        # the green process and the server would share one core: the p99
        # split would measure the scheduler (the loadgen skips; this raises)
        raise AssertionError(f"bluegreen_swap needs 2 CPUs or more, the host has {os.cpu_count()}")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        emb = TorchEmbedder()
        if dataclasses.asdict(emb.config) != dataclasses.asdict(embedder_config(**emb_kw)):
            raise AssertionError(f"the default embedder is not {emb_kw}: {emb.config}")
    else:
        emb = TorchEmbedder(embedder_config(**emb_kw), device=dev)
    index = slab_of(emb, texts, dev)
    script = workdir / "bluegreen_pipeline.py"
    script.write_text(BLUEGREEN_SCRIPT)
    cfg_path = workdir / "bluegreen_cfg.json"
    cfg_path.write_text(json.dumps(dict(
        root=str(ROOT), texts=texts[:64], embedder=None if on_card else dict(emb_kw, dtype="float32"),
        device=None if on_card else str(device))))

    def run_pipeline(root: str, out: str, n: int) -> dict:
        r = subprocess.run([sys.executable, str(script), root, out, str(n), str(cfg_path)], capture_output=True,
                           text=True, timeout=300, env={**os.environ, "PATHWAY_THREADS": "1", "PATHWAY_FAULTS": "0"})
        if r.returncode != 0:
            raise RuntimeError(f"the pipeline over {n} events exited {r.returncode}:\n{r.stderr[-3000:]}")
        return json.loads(Path(out + ".stats.json").read_text())

    blue = str(workdir / "blue")
    t0 = time.perf_counter()
    blue_stats = run_pipeline(blue, str(workdir / "blue.jsonl"), BLUEGREEN_EVENTS[0])
    blue_s = time.perf_counter() - t0
    blue_meta = pw.persistence.MetadataStore(blue).load() or {}
    blue_offset = int((blue_meta.get("offsets") or {}).get("nums", -1))
    blue_outbox = dict(blue_meta.get("outbox") or {})

    swap: dict = {}

    def green(stage: str) -> dict:
        out = str(workdir / "green.jsonl")
        swap["green_stats"] = run_pipeline(stage, out, BLUEGREEN_EVENTS[1])
        return bluegreen_sink_state(out)

    def swapper() -> None:
        time.sleep(seconds / 3.0)  # the fleet reaches its steady state first
        swap["t_start"] = time.perf_counter()
        try:
            swap["result"] = bluegreen.swap_plan(blue, green, baseline=bluegreen_table(BLUEGREEN_EVENTS[1]))
        finally:
            swap["t_end"] = time.perf_counter()

    url, _gateway, stop = serve_retrieval(emb, index, GATEWAY_K, BLUEGREEN_MAX_QUEUE, 0.0)
    swap_thread = threading.Thread(target=swapper, name="bluegreen-swap")
    try:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        swap_thread.start()
        raw = asyncio.run(closed_loop(url, clients, seconds, texts))
        wall = time.perf_counter() - t0
        swap_thread.join(timeout=300)
        launches = _build.LAUNCHES.get(KERNEL, 0)
        pending_after = pw.io.http.route_stats()["/answer"]["pending"]
    finally:
        stop()
    if swap_thread.is_alive() or "result" not in swap:
        raise AssertionError(f"the blue/green swap did not finish: {swap}")
    res = swap["result"]
    meta = pw.persistence.MetadataStore(blue).load() or {}
    offset = int((meta.get("offsets") or {}).get("nums", -1))
    outbox = dict(meta.get("outbox") or {})
    during, outside = [], []
    for stamp, lat in zip(raw["stamps"], raw["latencies"]):
        (during if swap["t_start"] <= stamp <= swap["t_end"] else outside).append(lat)
    mismatches, near_ties, crossed = compare_answers(
        raw["answers"], direct_answers(emb, index, [text for text, _ in raw["answers"]], GATEWAY_K))
    row = dict(
        phase="bluegreen_swap", card=gpu_name_and_power() if on_card else "cpu", events=list(BLUEGREEN_EVENTS),
        blue_s=blue_s, blue=blue_stats,
        green=swap.get("green_stats"), committed=res["committed"], reason=res["reason"],
        green_equals_baseline=res["output"] == bluegreen_table(BLUEGREEN_EVENTS[1]),
        swap_seconds=swap["t_end"] - swap["t_start"], offsets=dict(blue=blue_offset, after=offset),
        outbox=dict(blue=blue_outbox, after=outbox),
        blue_retired=os.path.isdir(blue + ".blue-retired"), marker_left=os.path.exists(blue + ".swap.commit"),
        clients=clients, seconds=seconds, max_queue=BLUEGREEN_MAX_QUEUE, ok=raw["ok"], shed_429=raw["shed"],
        shed_without_retry_after=raw["shed_without_retry_after"], timeouts=raw["timeout"], errors=raw["error"],
        first_errors=raw["errors"], goodput_rps=raw["ok"] / wall, p50_ms=percentile_ms(raw["latencies"], 50),
        p99_ms=percentile_ms(raw["latencies"], 99), ok_during_swap=len(during),
        p99_ms_during_swap=percentile_ms(during, 99), p99_ms_outside_swap=percentile_ms(outside, 99),
        pending_after=pending_after, attention_launches=launches, mismatches=len(mismatches),
        near_ties=near_ties, crossed=crossed, first_mismatch=str(mismatches[0])[:600] if mismatches else None,
    )
    emit(row)
    faults_found = []
    if not (row["committed"] and row["green_equals_baseline"] and row["blue_retired"]) or row["marker_left"]:
        faults_found.append("the swap did not commit the green's baseline output")
    if blue_offset != BLUEGREEN_EVENTS[0] or offset != BLUEGREEN_EVENTS[1] or not blue_outbox or any(
            int(outbox.get(sink, -1)) < int(off) for sink, off in blue_outbox.items()):
        faults_found.append("the connector offset or the outbox watermark did not advance")
    if row["errors"] or row["timeouts"] or row["shed_without_retry_after"] or pending_after or not row["ok"]:
        faults_found.append("a request failed other than by a 429 with Retry-After, or none answered")
    if not row["ok_during_swap"]:
        faults_found.append("no request was answered while the swap ran")
    if mismatches or crossed:
        faults_found.append(f"{len(mismatches)} answers differ from a direct slab query, {crossed} crossed")
    if on_card and min(launches, blue_stats["attention_launches"], (swap.get("green_stats") or {}).get(
            "attention_launches", 0)) <= 0:
        faults_found.append("the server, blue or the green launched no attention kernel")
    if faults_found:
        raise AssertionError(f"bluegreen_swap: {faults_found}: {row}")
    return dict(row, launches=launches + blue_stats["attention_launches"] + row["green"]["attention_launches"])
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


# ------------------------------------------------------------ phase 4
# the device mesh (shards of the one card, through PATHWAY_MESH_DEVICES)
# and the training step


@contextlib.contextmanager
def _mesh_env(devices: str):
    """PATHWAY_MESH_DEVICES for the meshes the port builds itself; the
    previous value comes back after."""
    old = os.environ.get("PATHWAY_MESH_DEVICES")
    os.environ["PATHWAY_MESH_DEVICES"] = devices
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PATHWAY_MESH_DEVICES", None)
        else:
            os.environ["PATHWAY_MESH_DEVICES"] = old


def _launches() -> int:
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.attention import KERNEL

    return _build.LAUNCHES.get(KERNEL, 0)


def run_mesh_knn(device, vectors, query_vecs, *, shards: int, k: int, reps: int) -> dict:
    """`mesh_knn`: `knn_search_sharded` and `make_knn_searcher(mesh=)`
    over `vectors` (run_slice's slab rows) cut into `shards` row blocks,
    with run_slice's text queries, against `knn_search` on the same slab:
    the same indices (a pair that differs must be a tie within
    MESH_KNN_ATOL) and distances within MESH_KNN_ATOL."""
    import numpy as np
    import torch

    from pathway_tpu_torch.ops.topk import knn_search, knn_search_sharded, make_knn_searcher
    from pathway_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    timer = host_ms if on_card else _cpu_ms
    mesh = make_mesh((shards,), ("data",), [dev] * shards)
    docs = torch.from_numpy(np.ascontiguousarray(vectors, np.float32)).to(dev)
    q = torch.from_numpy(np.asarray(query_vecs, np.float32)).to(dev)
    plain = knn_search(q, docs, k, "cos")
    sharded = knn_search_sharded(q, docs, k, "cos", mesh)
    searcher = make_knn_searcher(k, mesh=mesh)
    via = searcher(q, docs)
    pi, si, vi = (r.indices.cpu().numpy() for r in (plain, sharded, via))
    pd, sd = plain.distances.cpu().numpy(), sharded.distances.cpu().numpy()
    dist_err = float(np.abs(pd - sd).max())
    row = dict(
        phase="mesh_knn", shards=shards, rows=int(docs.shape[0]), dim=int(docs.shape[1]),
        queries=int(q.shape[0]), k=k, indices_equal=int((pi == si).sum()), of=int(pi.size),
        searcher_equal=int((si == vi).sum()), max_dist_err=dist_err, atol=MESH_KNN_ATOL,
        knn_search_p50_ms=timer(lambda: knn_search(q, docs, k, "cos"), reps),
        knn_search_sharded_p50_ms=timer(lambda: knn_search_sharded(q, docs, k, "cos", mesh), reps),
        searcher_p50_ms=timer(lambda: searcher(q, docs), reps),
        attention_launches=_launches(),
    )
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    # the distances are sorted on both sides, so a differing index is a
    # tie exactly when its distance still agrees
    if dist_err > MESH_KNN_ATOL or row["searcher_equal"] != row["of"]:
        raise AssertionError(f"the sharded KNN disagrees with knn_search: {row}")
    del docs
    if on_card:
        torch.cuda.empty_cache()
    return row


def _exchange_check(label, key_ids, payload, dests, mesh) -> dict:
    """One exchange_with_respill, held to the host routing: every row
    exactly once, at its shard, in src-major arrival order, bit-exact."""
    import numpy as np

    from pathway_tpu_torch.parallel import exchange as ex

    rounds = []
    orig = ex.exchange_by_key

    def counted(*args, **kwargs):
        rounds.append(kwargs.get("donate", False))
        return orig(*args, **kwargs)

    ex.exchange_by_key = counted
    try:
        t0 = time.perf_counter()
        keys, pays, srcs = ex.exchange_with_respill(key_ids, payload, dests, mesh)
        seconds = time.perf_counter() - t0
    finally:
        ex.exchange_by_key = orig
    ok = True
    for d in range(mesh.size):
        idx = np.flatnonzero(dests == d)
        ok = ok and np.array_equal(srcs[d], idx) and np.array_equal(keys[d], key_ids[idx])
        ok = ok and np.array_equal(pays[d].view(np.uint32), payload[idx].view(np.uint32))
    return dict(
        case=label, rows=int(len(key_ids)), rounds=len(rounds), single_round=rounds == [True],
        per_shard=[int((dests == d).sum()) for d in range(mesh.size)], seconds=seconds,
        payload_gb=payload.nbytes / 1e9, gb_per_s=payload.nbytes / seconds / 1e9, exact=bool(ok),
    )


def run_mesh_exchange(device, vectors, *, shards: int, groupby_rows: int, groupby_groups: int) -> dict:
    """`mesh_exchange`: (a) `exchange_with_respill` of `vectors` over
    `shards` shards, destinations from `route128` over seeded 128-bit
    keys, then a mix sending EXCHANGE_SKEW of the rows to shard 0; (b)
    `exchange_columns_with_respill` of u64/i64 columns, bit-exact; (c) a
    `pw.run()` groupby over `groupby_rows` rows with a vector column under
    PATHWAY_THREADS=4, with PATHWAY_DEVICE_EXCHANGE=1 and =0: equal
    outputs, and the device run went through the DeviceExchanger. The
    shards share one card, so GB/s is copies on it plus the host work
    around them, not an interconnect figure."""
    import numpy as np
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.parallel import device_exchange as dx
    from pathway_tpu_torch.parallel.exchange import exchange_columns_with_respill, route128
    from pathway_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    dev = torch.device(device)
    mesh = make_mesh((shards,), ("data",), [dev] * shards)
    rng = np.random.default_rng(11)
    n = len(vectors)
    lo = rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
    hi = rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
    routed = route128(lo, hi, shards)
    skewed = np.where(rng.random(n) < EXCHANGE_SKEW, 0, routed).astype(np.int64)
    ids = np.arange(n, dtype=np.int64)
    payload = np.ascontiguousarray(vectors, np.float32)
    cases = [_exchange_check("route128", ids, payload, routed, mesh),
             _exchange_check(f"{EXCHANGE_SKEW}_to_shard_0", ids, payload, skewed, mesh)]
    diff = rng.choice([-3, -1, 1, 2], n).astype(np.int64)
    tok = rng.integers(0, 1 << 40, n).astype(np.uint64)
    t0 = time.perf_counter()
    cols, srcs = exchange_columns_with_respill([lo, hi, tok, diff], routed, mesh)
    col_s = time.perf_counter() - t0
    col_exact = all(
        np.array_equal(srcs[d], np.flatnonzero(routed == d))
        and all(np.array_equal(got, src[routed == d]) for got, src in zip(cols[d], (lo, hi, tok, diff)))
        for d in range(shards)
    )
    del cols, srcs

    # (c) the engine's shuffle of rows with a vector column, device wire
    # against host wire
    grng = np.random.default_rng(12)
    emb = payload[grng.integers(0, n, groupby_rows)]
    rows = [(f"g{i % groupby_groups}", emb[i]) for i in range(groupby_rows)]

    def groupby_run(mode: str):
        G.clear()
        saved = {k: os.environ.get(k) for k in ("PATHWAY_THREADS", "PATHWAY_DEVICE_EXCHANGE")}
        os.environ.update(PATHWAY_THREADS="4", PATHWAY_DEVICE_EXCHANGE=mode)
        dx._ENGINE_EXCHANGER = None
        try:
            t = pw.Table.from_rows(pw.schema_from_types(g=str, emb=np.ndarray), rows)
            res = t.groupby(t.g).reduce(
                t.g, n=pw.reducers.count(),
                s=pw.reducers.sum(pw.apply_with_type(lambda v: float(v.astype(np.float64).sum()), float, t.emb)),
            )
            t0 = time.perf_counter()
            out = sorted(map(tuple, pw.debug.table_to_pandas(res).values.tolist()))
            return out, time.perf_counter() - t0, dx._ENGINE_EXCHANGER
        finally:
            for key, val in saved.items():
                if val is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = val
            G.clear()

    with _mesh_env(f"{dev}*{shards}"):
        dev_out, dev_s, ex = groupby_run("1")
        host_out, host_s, _ = groupby_run("0")
    dx._ENGINE_EXCHANGER = None
    row = dict(
        phase="mesh_exchange", shards=shards, dim=int(payload.shape[1]), exchanges=cases,
        columns=dict(rows=n, columns=4, seconds=col_s, exact=bool(col_exact)),
        groupby=dict(rows=groupby_rows, groups=groupby_groups, threads=4, device_wire_s=dev_s,
                     host_wire_s=host_s, equal=dev_out == host_out,
                     exchanger_invocations=ex.invocations if ex is not None else 0,
                     rows_exchanged=ex.rows_exchanged if ex is not None else 0),
        attention_launches=_launches(),
    )
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    if (not all(c["exact"] for c in cases) or not col_exact or not row["groupby"]["equal"]
            or row["groupby"]["exchanger_invocations"] <= 0 or cases[1]["rounds"] < 2):
        raise AssertionError(f"the mesh exchange is wrong: {row}")
    return row


def run_mesh_tp(device, enc_kw: dict, lm_kw: dict, *, mesh_shape: tuple, enc_rows: int, enc_seq: int,
                lm_rows: int, lm_seq: int) -> dict:
    """`mesh_tp`: `TransformerLM.shard` over a (data, model) mesh of the
    card: the flagship encoder encoding `enc_rows` x `enc_seq` tokens and
    the Gemma-2B-shaped decoder's logits for `lm_rows` x `lm_seq`, each
    against the unsharded fused_attention=False forward of the same bf16
    weights: embeddings within TP_EMBED_ATOL, the logits' argmax equal at
    TP_ARGMAX_MIN of the positions at least; the decoder's argmax of both
    is also read against an f32 forward of the same weights. Also each
    shard's bytes."""
    import torch

    from pathway_tpu_torch.models import transformer as tfm
    from pathway_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    n_dev = mesh_shape[0] * mesh_shape[1]
    timer = host_ms if on_card else _cpu_ms
    out = dict(phase="mesh_tp", mesh=dict(data=mesh_shape[0], model=mesh_shape[1]))
    for name, kw, rows, seq in (("encoder", enc_kw, enc_rows, enc_seq), ("decoder", lm_kw, lm_rows, lm_seq)):
        causal = name == "decoder"
        make = tfm.lm_config if causal else tfm.embedder_config
        cfg = make(dtype=torch.bfloat16, fused_attention=False, **kw)
        gen = torch.Generator(device=dev).manual_seed(3)
        model = tfm.TransformerLM(cfg, tfm.init_params(gen, cfg, dtype=torch.bfloat16), device=dev)
        ids = torch.randint(2, cfg.vocab_size, (rows, seq), generator=gen, device=dev)
        mask = torch.ones((rows, seq), dtype=torch.int32, device=dev)
        with torch.no_grad():
            fn = model.logits if causal else model.encode
            want = fn(ids, mask)
            plain_ms = timer(lambda: fn(ids, mask), 3)
            full_bytes = sum(t.numel() * t.element_size() for t in tfm._leaves(model.params))
            if causal:  # the same weights at f32: how far each bf16 forward is from it
                p32 = tfm.cast_params(model.params, torch.float32)
                top32 = tfm.logits(p32, ids, mask, dataclasses.replace(cfg, dtype=torch.float32)).argmax(-1)
                del p32
            model.shard(make_mesh(mesh_shape, ("data", "model"), [dev] * n_dev))
            fn = model.logits if causal else model.encode
            got = fn(ids, mask)
            sharded_ms = timer(lambda: fn(ids, mask), 3)
        part = dict(config=kw, rows=rows, seq=seq, params_bytes=full_bytes, shard_bytes=model.shard_bytes(),
                    plain_ms=plain_ms, sharded_ms=sharded_ms, fused_attention=model.cfg.fused_attention,
                    finite=bool(torch.isfinite(got).all()), shape=list(got.shape))
        if causal:
            part.update(argmax_agreement=(got.argmax(-1) == want.argmax(-1)).float().mean().item(),
                        argmax_min=TP_ARGMAX_MIN, max_logit_diff=(got - want).abs().max().item(),
                        logit_absmax=want.abs().max().item(),
                        unsharded_vs_f32_argmax=(want.argmax(-1) == top32).float().mean().item(),
                        sharded_vs_f32_argmax=(got.argmax(-1) == top32).float().mean().item())
        else:
            part.update(max_abs_diff=(got - want).abs().max().item(), atol=TP_EMBED_ATOL)
        out[name] = part
        del model, want, got
        if on_card:
            torch.cuda.empty_cache()
    out["attention_launches"] = _launches()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    enc, dec = out["encoder"], out["decoder"]
    if (not enc["finite"] or not dec["finite"] or enc["max_abs_diff"] > TP_EMBED_ATOL
            or dec["argmax_agreement"] < TP_ARGMAX_MIN
            or max(enc["shard_bytes"]) >= enc["params_bytes"] or max(dec["shard_bytes"]) >= dec["params_bytes"]):
        raise AssertionError(f"the tensor-parallel model disagrees with the unsharded one: {out}")
    return out


def run_ring(device, enc_kw: dict, *, shards: int, rows: int, seq: int, attn: tuple) -> dict:
    """`ring_encode`: (a) the flagship encoder with `seq_axis` over
    `shards` shards, `rows` x `seq` tokens of random lengths, against the
    unsharded reference-attention encode of the same bf16 weights (within
    RING_EMBED_ATOL); (b) `ring_attention` alone at `attn` = (b, s, h, dh)
    in f32, a padded tail of keys, against full f32 attention (within
    RING_ATTN_ATOL)."""
    import torch

    from pathway_tpu_torch.models import transformer as tfm
    from pathway_tpu_torch.ops.attention import ring_attention
    from pathway_tpu_torch.parallel import spmd
    from pathway_tpu_torch.parallel.mesh import P, make_mesh

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    timer = host_ms if on_card else _cpu_ms
    mesh = make_mesh((shards,), ("seq",), [dev] * shards)
    cfg = tfm.embedder_config(dtype=torch.bfloat16, fused_attention=False, **enc_kw)
    gen = torch.Generator(device=dev).manual_seed(4)
    params = tfm.init_params(gen, cfg, dtype=torch.bfloat16)
    ids = torch.randint(2, cfg.vocab_size, (rows, seq), generator=gen, device=dev)
    lens = torch.randint(seq // 4, seq + 1, (rows,), generator=gen, device=dev)
    mask = (torch.arange(seq, device=dev)[None, :] < lens[:, None]).to(torch.int32)
    sp = dataclasses.replace(cfg, seq_axis="seq")
    ring_encode = spmd.shard_map(
        lambda p, i, m: tfm.encode(p, i, m, sp), mesh,
        in_specs=(P(), P(None, "seq"), P(None, "seq")), out_specs=P(),
    )
    with torch.no_grad():
        want = tfm.encode(params, ids, mask, cfg)
        got = ring_encode(params, ids, mask)
        enc = dict(rows=rows, seq=seq, shards=shards, max_abs_diff=(got - want).abs().max().item(),
                   atol=RING_EMBED_ATOL, ring_ms=timer(lambda: ring_encode(params, ids, mask), 3),
                   plain_ms=timer(lambda: tfm.encode(params, ids, mask, cfg), 3))
    del params, ids, mask, want, got

    b, s, h, dh = attn
    q, k, v = (torch.randn((b, s, h, dh), generator=gen, device=dev) for _ in range(3))
    kv_mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    kv_mask[:, s - s // 8:] = 0
    ring = spmd.shard_map(
        lambda q_, k_, v_, m_: ring_attention(q_, k_, v_, "seq", kv_mask=m_), mesh,
        in_specs=(P(None, "seq"),) * 4, out_specs=P(None, "seq"),
    )

    def full():
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
        scores = scores.masked_fill(kv_mask[:, None, None, :] == 0, float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)

    with torch.no_grad():
        got = ring(q, k, v, kv_mask)
        ref = full()
        att = dict(b=b, s=s, h=h, dh=dh, shards=shards, max_abs_diff=(got - ref).abs().max().item(),
                   atol=RING_ATTN_ATOL, ring_ms=timer(lambda: ring(q, k, v, kv_mask), 3),
                   full_ms=timer(full, 3), tf32=bool(torch.backends.cuda.matmul.allow_tf32))
        del got, ref
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ring(q, k, v, kv_mask)
            att["ring_transient_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
            torch.cuda.reset_peak_memory_stats()
            full()
            att["full_transient_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    del q, k, v
    if on_card:
        torch.cuda.empty_cache()
    row = dict(phase="ring_encode", encode=enc, ring_attention=att, attention_launches=_launches(),
               seconds=time.perf_counter() - t_phase)
    emit(row)
    if enc["max_abs_diff"] > RING_EMBED_ATOL or att["max_abs_diff"] > RING_ATTN_ATOL:
        raise AssertionError(f"ring attention disagrees with full attention: {row}")
    return row


def train_bound(n_params: int, tokens: int) -> dict:
    """Least time of one train step, in ms: 6 flops a parameter a token
    (forward and backward) over the bf16 tensor-core rate, against AdamW's
    bytes (16 a parameter: the f32 parameter, its gradient and two
    moments) over the HBM rate."""
    flops = 6 * n_params * tokens
    nbytes = 16 * n_params
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3, bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes)


def run_train(device, lm_kw: dict, chat_kw: dict, *, batch: int, seq: int, steps: int, lr: float,
              check_steps: int, check_batch: int, check_seq: int) -> dict:
    """`train_step`: (a) `make_train_step` on the `lm_kw` causal LM, f32
    parameters and bf16 compute, `steps` AdamW steps on one fixed batch of
    `batch` x `seq` tokens: the loss must fall; step ms and tokens/s
    beside the bound. (b) `check_steps` steps of the `chat_kw` model at
    f32 on `device` against the same steps on the CPU from the same
    parameters: losses within TRAIN_LOSS_RTOL relative, 99.9% of the
    parameters within TRAIN_PARAM_ATOL and every one within 2 * lr * steps
    (Adam turns the noise of a gradient near 0 into up to 2 * lr a step,
    tests/test_torch_train.py)."""
    import numpy as np
    import torch

    from pathway_tpu_torch.models import transformer as tfm

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg = tfm.lm_config(dtype=torch.bfloat16, **lm_kw)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(5)
    params = tfm.init_params(gen, cfg, dtype=torch.float32)
    n_params = tfm.count_params(params)
    ids = torch.randint(2, cfg.vocab_size, (batch, seq), generator=gen, device=dev)
    mask = torch.ones((batch, seq), dtype=torch.int32, device=dev)
    init_opt, train_step = tfm.make_train_step(cfg, learning_rate=lr)
    opt = init_opt(params)
    losses, step_ms = [], []
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        params, opt, loss = train_step(params, opt, ids, mask)
        losses.append(float(loss))  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    big = dict(config=lm_kw, n_params=n_params, batch=batch, seq=seq, steps=steps, lr=lr, losses=losses,
               step_ms=step_ms, steady_step_ms=statistics.median(step_ms[1:] or step_ms),
               **train_bound(n_params, batch * seq))
    big["tokens_per_s"] = batch * seq / (big["steady_step_ms"] / 1e3)
    if on_card:
        big["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, opt, ids, mask
    if on_card:
        torch.cuda.empty_cache()

    # (b) the card against the CPU at f32, from the same parameters
    small = tfm.lm_config(dtype=torch.float32, **chat_kw)
    host = tfm.init_params(torch.Generator().manual_seed(6), small)
    on_dev = tfm.tree_map(lambda t: t.to(dev, copy=True), host)
    rng = np.random.default_rng(6)
    ids_h = torch.from_numpy(rng.integers(2, small.vocab_size, (check_batch, check_seq)))
    mask_h = torch.ones((check_batch, check_seq), dtype=torch.int32)
    mask_h[1, check_seq // 2:] = 0
    curves = {}
    for where, p, ids_, mask_ in (("card", on_dev, ids_h.to(dev), mask_h.to(dev)), ("cpu", host, ids_h, mask_h)):
        init_opt, train_step = tfm.make_train_step(small, learning_rate=lr)
        opt = init_opt(p)
        curve = []
        for _ in range(check_steps):
            p, opt, loss = train_step(p, opt, ids_, mask_)
            curve.append(float(loss))
        curves[where] = (curve, p)
    diff = np.concatenate([
        (a.detach().cpu() - b.detach()).abs().numpy().ravel()
        for a, b in zip(tfm._leaves(curves["card"][1]), tfm._leaves(curves["cpu"][1]))
    ])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(curves["card"][0], curves["cpu"][0]))
    check = dict(config=chat_kw, steps=check_steps, batch=check_batch, seq=check_seq, lr=lr,
                 card_losses=curves["card"][0], cpu_losses=curves["cpu"][0], loss_rel_diff=loss_rel,
                 loss_rtol=TRAIN_LOSS_RTOL, params=int(diff.size), max_param_diff=float(diff.max()),
                 within_atol_share=float((diff <= TRAIN_PARAM_ATOL).mean()), param_atol=TRAIN_PARAM_ATOL,
                 tf32=bool(torch.backends.cuda.matmul.allow_tf32))
    del curves, on_dev, host
    row = dict(phase="train_step", gemma=big, card_vs_cpu=check, attention_launches=_launches(),
               seconds=time.perf_counter() - t_phase)
    emit(row)
    if (not losses[-1] < losses[0] or not all(math.isfinite(x) for x in losses) or loss_rel > TRAIN_LOSS_RTOL
            or check["within_atol_share"] < 0.999 or check["max_param_diff"] > 2 * lr * check_steps):
        raise AssertionError(f"the train step is wrong: {row}")
    if on_card:
        torch.cuda.empty_cache()
    return row


def run_segment(device, *, n_values: int, n_segments: int, reps: int) -> dict:
    """`segment_reduce`: `n_values` seeded f32 and int32 values (ids over
    [-8, n_segments + 8), so some are dropped, and none 7 mod 1024, so
    those segments are empty)
    into `n_segments` segments, every op, on `device` against the port's
    CPU result: min, max, count, any and every integer result exact; f32
    sum and mean within SEGMENT_RTOL (relative, or absolute below 1: the
    card's atomics add in any order). Times beside a byte bound (values
    and ids read once, the result written once)."""
    import numpy as np
    import torch

    from pathway_tpu_torch.ops.segment import segment_reduce

    t_phase = time.perf_counter()
    dev = torch.device(device)
    timer = cuda_ms if dev.type == "cuda" else _cpu_ms
    rng = np.random.default_rng(8)
    ids = rng.integers(-8, n_segments + 8, n_values).astype(np.int32)
    ids[ids % 1024 == 7] += 1  # segments 7, 1031, ... stay empty
    ids = torch.from_numpy(ids)
    data = {
        "float32": torch.from_numpy(rng.normal(size=n_values).astype(np.float32)),
        "int32": torch.from_numpy(rng.integers(-1000, 1000, n_values).astype(np.int32)),
    }
    ids_d = ids.to(dev)
    cases, bad = [], []
    for dtype, vals in data.items():
        vals[::5] = 0
        vals_d = vals.to(dev)
        for op in ("sum", "min", "max", "count", "mean", "any"):
            got = segment_reduce(vals_d, ids_d, n_segments, op).cpu()
            t0 = time.perf_counter()
            ref = segment_reduce(vals, ids, n_segments, op)
            cpu_ms = (time.perf_counter() - t0) * 1e3
            exact = not (dtype == "float32" and op in ("sum", "mean"))
            if exact:
                ok = got.dtype == ref.dtype and torch.equal(got, ref)
                err = 0.0 if ok else float("inf")
            else:
                err = ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
                ok = got.dtype == ref.dtype and err <= SEGMENT_RTOL
            nbytes = vals.numel() * vals.element_size() + ids.numel() * 4 + n_segments * ref.element_size()
            case = dict(dtype=dtype, op=op, exact=exact, ok=bool(ok), rel_err=err,
                        ms=timer(lambda: segment_reduce(vals_d, ids_d, n_segments, op), reps), cpu_ms=cpu_ms,
                        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
            cases.append(case)
            if not ok:
                bad.append(case)
    inside = ids[(ids >= 0) & (ids < n_segments)]
    row = dict(phase="segment_reduce", values=n_values, segments=n_segments, rtol=SEGMENT_RTOL, cases=cases,
               empty_segments=int(n_segments - torch.unique(inside).numel()),
               dropped_ids=int(n_values - inside.numel()), seconds=time.perf_counter() - t_phase)
    emit(row)
    if bad or row["empty_segments"] == 0 or row["dropped_ids"] == 0:
        raise AssertionError(f"segment_reduce on the card disagrees with the CPU: {bad or row}")
    return row


def run_mesh_slots(device, chat_kw: dict, texts: list[str], *, shards: int, slots: int, requests: int,
                   new_tokens: int) -> dict:
    """`mesh_slots`: `ContinuousBatcher(mesh_span=True)` over `shards`
    shards of the card (`slots` a shard) against the single-device pool of
    `slots * shards` slots, at f32 on JaxLMChat's default model (TF32
    off): byte-identical tokens for every request."""
    import torch

    from pathway_tpu_torch.models import transformer as tfm
    from pathway_tpu_torch.models.tokenizer import HashTokenizer
    from pathway_tpu_torch.serving.continuous_batching import ContinuousBatcher

    t_phase = time.perf_counter()
    dev = torch.device(device)
    cfg = tfm.lm_config(dtype=torch.float32, **chat_kw)
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(7), cfg)
    tok = HashTokenizer(vocab_size=cfg.vocab_size, max_len=cfg.max_len)
    prompts = texts[:requests]
    outs, pools = {}, {}
    with _mesh_env(f"{dev}*{shards}"), torch.no_grad():
        for span in (False, True):
            cb = ContinuousBatcher(params=params, cfg=cfg, tokenizer=tok, n_steps=new_tokens,
                                   n_slots=slots if span else slots * shards, name=f"mesh-slots-{span}",
                                   mesh_span=span)
            t0 = time.perf_counter()
            futs = [cb.submit(p) for p in prompts]
            outs[span] = ([f.result(timeout=600) for f in futs], time.perf_counter() - t0)
            cb.drain()
            pools[span] = dict(n_slots=cb.n_slots, shards=cb.mesh.size if cb.mesh is not None else 1,
                               decode_steps=cb.stats["decode_steps"], prefills=cb.stats["prefills"])
    differ = [i for i, (a, b) in enumerate(zip(outs[False][0], outs[True][0])) if a != b]
    row = dict(phase="mesh_slots", config=chat_kw, requests=len(prompts), new_tokens=new_tokens,
               single=dict(**pools[False], seconds=outs[False][1]),
               spanning=dict(**pools[True], seconds=outs[True][1]),
               equal=len(prompts) - len(differ), differ=differ, tf32=bool(torch.backends.cuda.matmul.allow_tf32),
               attention_launches=_launches(), seconds=time.perf_counter() - t_phase)
    emit(row)
    if differ or pools[True]["shards"] != shards or pools[True]["n_slots"] != slots * shards or row["tf32"]:
        raise AssertionError(f"the mesh-spanning slot pool differs from the single-device pool: {row}")
    return row


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
    ptxas = {name: ptxas_report(path.with_suffix(".log").read_text()) for name, path in libs.items()}
    emit(dict(
        phase="device", card=card, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build_s, libraries={k: str(v.relative_to(ROOT)) for k, v in libs.items()},
        ptxas=ptxas,
    ))
    serialized = [a for r in ptxas.values() for a in r["advisories"] if "serialized" in a]
    if serialized:
        # the tiled kernel's products would wait for each other
        raise AssertionError(f"ptxas serializes a wgmma pipeline: {serialized[:3]}")

    rows = [check_attention(*shape, seed=i, timed=True) for i, shape in enumerate(ATTENTION_SHAPES)]
    rows += [check_attention(*shape, seed=100 + i, timed=False) for i, shape in enumerate(ATTENTION_CHECK_SHAPES)]
    main_shape = rows[0]

    result = run_slice("cuda", FLAGSHIP, N_DOCS, DOC_BATCH, DOC_SEQ, ROOT)

    # the device mesh over the slice's slab and embeddings (MESH_SHARDS
    # shards of the card), the attention kernel's launches read across it
    _build.reset_launch_counts()
    slab = result["vectors"][:N_DOCS]
    run_mesh_knn("cuda", slab, result["query_vecs"], shards=MESH_SHARDS, k=TOP_K, reps=30)
    run_mesh_exchange("cuda", slab, shards=MESH_SHARDS, groupby_rows=GROUPBY_ROWS, groupby_groups=GROUPBY_GROUPS)
    mesh_launches = _launches()
    del slab

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

    # long-chunk live-RAG ingest at the JAX package's default encoder width
    # (max_len 512, the default splitter's 500-token chunks), then that
    # encoder at f32 through the kernel (launches read across the phase)
    t0 = time.perf_counter()
    long_embed = run_long_embed("cuda", LONG_EMBEDDER, load_texts(ROOT), n_docs=LONG_DOCS, waves=LONG_WAVES,
                                n_q=LONG_QUESTIONS, k=LONG_K, f32_chunks=LONG_F32_CHUNKS,
                                f32_cpu_chunks=LONG_F32_CPU_CHUNKS)
    emit(dict(phase="long_embed_seconds", seconds=time.perf_counter() - t0))

    # the vector-store server over the texts phase's chunks (its launch
    # count read across the phase alone)
    t0 = time.perf_counter()
    store = run_vector_store("cuda", EMBEDDER_DEFAULT, result["text_chunks"], n_queries=VS_QUERIES, k=VS_K)
    emit(dict(phase="vector_store_seconds", seconds=time.perf_counter() - t0))

    # the serving gateway under the loadgen's closed-loop overload, in
    # front of the default embedder and a slab of the texts phase's chunks
    t0 = time.perf_counter()
    gateway = run_gateway_overload("cuda", EMBEDDER_DEFAULT, result["text_chunks"])
    emit(dict(phase="gateway_overload_seconds", seconds=time.perf_counter() - t0))

    # the spawned mesh: rag_ingest's documents through `spawn -n 1` and
    # `-n 2`, each process embedding its share with the default
    # TorchEmbedder on the card (the children's launches are their own);
    # then the same pipeline grown from 2 to 3 processes mid-run, held to
    # both; then a blue/green swap of a pipeline that embeds on the card
    # while clients query the gateway
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spawn = run_spawn_embed(None, None, load_texts(ROOT), n_docs=SPAWN_DOCS, shards=SPAWN_SHARDS,
                                processes=(1, 2), workdir=Path(tmp))
        emit(dict(phase="spawn_embed_seconds", seconds=time.perf_counter() - t0))
        t0 = time.perf_counter()
        elastic = run_elastic_rescale(None, None, load_texts(ROOT), n_docs=SPAWN_DOCS, shards=SPAWN_SHARDS,
                                      workdir=Path(tmp),
                                      static={n: read_spawn_output(Path(tmp) / f"n{n}") for n in (1, 2)})
        emit(dict(phase="elastic_rescale_seconds", seconds=time.perf_counter() - t0))
        t0 = time.perf_counter()
        bluegreen = run_bluegreen_swap("cuda", EMBEDDER_DEFAULT, result["text_chunks"], workdir=Path(tmp))
        emit(dict(phase="bluegreen_swap_seconds", seconds=time.perf_counter() - t0))

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
            churn_waves=CHURN_WAVES, churn_wave=CHURN_WAVE, reps=30, mesh_shards=MESH_SHARDS)
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

    # tensor- and sequence-parallel models, the training step, the
    # segment reductions and the mesh-spanning slot pool
    _build.reset_launch_counts()
    run_mesh_tp("cuda", FLAGSHIP, GEMMA_2B, mesh_shape=TP_MESH, enc_rows=TP_ENC_ROWS, enc_seq=DOC_SEQ,
                lm_rows=TP_LM_ROWS, lm_seq=TP_LM_SEQ)
    run_ring("cuda", FLAGSHIP, shards=MESH_SHARDS, rows=RING_ROWS, seq=DOC_SEQ, attn=RING_ATTN)
    run_train("cuda", GEMMA_2B, CHAT_DEFAULT, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS, lr=TRAIN_LR,
              check_steps=TRAIN_CHECK_STEPS, check_batch=TRAIN_CHECK_BATCH, check_seq=TRAIN_CHECK_SEQ)
    run_segment("cuda", n_values=SEGMENT_VALUES, n_segments=SEGMENT_SEGMENTS, reps=10)
    run_mesh_slots("cuda", CHAT_DEFAULT, load_texts(ROOT, seed=2), shards=SLOTS_SHARDS, slots=SLOTS_PER_SHARD,
                   requests=SLOTS_REQUESTS, new_tokens=SLOTS_NEW)
    mesh_launches += _launches()
    emit(dict(phase="mesh_launches", kernel_launches=mesh_launches))
    emit(dict(phase="total", seconds=time.perf_counter() - t_start, card=card))

    print(json.dumps({"kernels": [dict(
        name="fused_qkv_attention", route="cuda",
        source="pathway_tpu_torch/csrc/attention.cu",
        replaces="pathway_tpu/ops/attention.py:38",
        launches=(result["launches"] + engine["launches"] + long_embed["launches"] + store["launches"]
                  + gateway["launches"] + spawn["attention_launches"] + elastic["attention_launches"]
                  + bluegreen["launches"] + mesh_launches),
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
