"""Bulk embedding in a closed loop through ``TorchEmbedder.encode_many``.

One caller passes slices of ``slice_rows`` chunks in corpus order and
waits for each. The corpus is made in set-up: documents of Zipf words
cut into chunks of 50 to 500 words (``chunk_words``; the budget of the
port's ``TokenCountSplitter``) by the benchmark's own word-count
splitter (``benchmark/corpus.py``), the first ``chunks`` chunks kept and
cycled. The embedder has no cache, so every slice is real work. Its
tokenizer is the port's ``HashTokenizer`` inside a wrapper that records
the ``tokenize`` span and each slice's real token counts.

The window covers whole calls: it ends at the first call that completes
after ``--seconds``. After it, a sample of the embeddings the window
returned (``check.rows_per_call`` rows of each call, drawn from the
seed) is compared with the plain reference's in f32: ``embed_gap`` is
the largest L2 distance between the two unit vectors of a chunk.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import corpus, weights
from benchmark.reference import tokenizer as ref_tok
from benchmark.reference import transformer as ref


class TimedTokenizer:
    """The program's tokenizer, with a span around each batch and the
    real token count of each row of the last batch."""

    def __init__(self, inner, spans):
        self.inner = inner
        self.spans = spans
        self.last_lengths = np.zeros(0, np.int64)

    def batch(self, texts, pad_to=None):
        with self.spans.span("tokenize"):
            ids, mask = self.inner.batch(texts, pad_to)
        self.last_lengths = mask.sum(axis=1)
        return ids, mask

    def __getattr__(self, name):
        return getattr(self.inner, name)


class Run:
    def __init__(self, model: dict, traffic: dict, seed: int, device, spans):
        from pathway_tpu_torch.models import embedder_config
        from pathway_tpu_torch.models.tokenizer import HashTokenizer
        from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder

        self.model, self.traffic, self.seed, self.device = model, traffic, seed, device
        t = time.perf_counter()
        chunks = corpus.chunks(traffic, seed)
        self.setup_phases = {"inputs_s": time.perf_counter() - t}
        n = traffic["slice_rows"]
        self.slices = [chunks[i:i + n] for i in range(0, len(chunks), n)]
        kw = {k: model[k] for k in ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff", "max_len", "embed_dim")}
        cfg = embedder_config(dtype=weights.torch_dtype(model["dtype"]), **kw)
        self.tok = TimedTokenizer(HashTokenizer(vocab_size=cfg.vocab_size, max_len=cfg.max_len), spans)
        self.emb = TorchEmbedder(
            config=cfg, params=weights.make(model, seed, device), tokenizer=self.tok,
            max_batch=n, device=device,
        )
        self.spans = spans
        self.setup_phases["program_s"] = time.perf_counter() - t - self.setup_phases["inputs_s"]
        t = time.perf_counter()
        for sl in self.slices:  # every shape the window uses, once
            self.emb.encode_many(sl)
        self.setup_phases["warm_s"] = time.perf_counter() - t
        self.sample: list[tuple[str, np.ndarray]] = []

    def window(self, seconds: float, tracer) -> dict:
        spans = self.spans
        spans.active = True
        calls, chunks, failed = [], 0, 0
        per_call = self.traffic["check"]["rows_per_call"]
        if tracer is not None:
            tracer.start()
        t0 = time.perf_counter()
        i = 0
        while True:
            sl = self.slices[i % len(self.slices)]
            out = self.emb.encode_many(sl)
            calls.append(self.tok.last_lengths.copy())
            chunks += len(sl)
            failed += sum(not np.isfinite(v).all() for v in out)
            rng = np.random.default_rng([self.seed, 3, i])
            for j in rng.choice(len(sl), size=min(per_call, len(sl)), replace=False):
                self.sample.append((sl[j], np.array(out[j], np.float32)))
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        if tracer is not None:
            tracer.stop()
        spans.active = False
        return {
            "t0": t0,
            "e2e": {"embed_chunks_per_s": chunks / (t1 - t0)},
            "rec": {"window_s": t1 - t0, "calls": calls},
            "attempted": chunks,
            "failed": int(failed),
        }

    def release(self) -> None:
        del self.emb, self.tok

    def _reference(self, fp8: bool) -> torch.Tensor:
        if getattr(self, "_params", None) is None:
            ref.no_tf32()
            self._params = weights.to_f32(weights.make(self.model, self.seed, self.device))
            m = self.model
            self._rows = [ref_tok.tokenize(t, m["vocab_size"], m["max_len"]) for t, _ in self.sample]
        with torch.no_grad():
            return ref.encode(self._params, self._rows, self.model["n_heads"], fp8=fp8)

    def check(self) -> dict:
        """embed_gap: the largest L2 distance between a sampled chunk's
        embedding from the window and the reference's."""
        self._ref = self._reference(False)
        got = torch.from_numpy(np.stack([e for _, e in self.sample])).to(self._ref.device)
        return {"embed_gap": float(torch.linalg.vector_norm(got - self._ref, dim=-1).max())}

    def control(self) -> dict:
        """embed_gap of the reference computed with fp8 projections."""
        low = self._reference(True)
        return {"embed_gap": float(torch.linalg.vector_norm(low - self._ref, dim=-1).max())}
