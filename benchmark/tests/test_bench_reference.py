"""The plain reference against the port's plain CPU path at tiny widths,
in f32, and the frozen copies against what they were copied from."""

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import search
from benchmark.reference import tokenizer as ref_tok
from benchmark.reference import transformer as ref
from benchmark.tests import tiny


def _cfg(model: dict):
    from pathway_tpu_torch.models import embedder_config, lm_config

    kw = {k: model[k] for k in ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff", "max_len")}
    if model["kind"] == "encoder":
        return embedder_config(embed_dim=model["embed_dim"], dtype=torch.float32, **kw)
    return lm_config(dtype=torch.float32, **kw)


def _rows(rng, n: int, vocab: int, lo: int, hi: int) -> list[list[int]]:
    return [[1] + rng.integers(2, vocab, size=int(rng.integers(lo, hi))).tolist() for _ in range(n)]


@pytest.mark.parametrize("seed", [2**31 + 1, 7])
def test_bench_reference_encoder_matches_the_port(seed):
    from pathway_tpu_torch.models import transformer

    model = tiny.ENCODER
    params = weights.make(model, seed, "cpu", torch.float32)
    rows = _rows(np.random.default_rng(seed), 12, model["vocab_size"], 3, model["max_len"])
    s = max(len(r) for r in rows)
    ids = torch.zeros((len(rows), s), dtype=torch.long)
    mask = torch.zeros((len(rows), s), dtype=torch.int32)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = torch.tensor(r)
        mask[i, : len(r)] = 1
    got = transformer.encode(params, ids, mask, _cfg(model))
    want = ref.encode(params, rows, model["n_heads"], block=5)
    assert torch.allclose(got, want, atol=1e-5), float((got - want).abs().max())


@pytest.mark.parametrize("seed", [2**31 + 1, 7])
def test_bench_reference_decoder_matches_the_port(seed):
    from pathway_tpu_torch.models import transformer

    model = tiny.DECODER
    params = weights.make(model, seed, "cpu", torch.float32)
    row = _rows(np.random.default_rng(seed), 1, model["vocab_size"], 30, 40)[0]
    ids = torch.tensor([row])
    got = transformer.logits(params, ids, torch.ones_like(ids, dtype=torch.int32), _cfg(model))[0]
    want = ref.lm_logits(params, row, model["n_heads"])
    assert torch.allclose(got, want, atol=1e-4), float((got - want).abs().max())


def test_bench_reference_follows_the_served_path():
    """Prefill into a slot and decode through the KV cache (the path the
    answer cell times), in f32: each served token is the reference's
    best at its position."""
    from pathway_tpu_torch.models import transformer

    model = tiny.DECODER
    cfg = _cfg(model)
    params = weights.make(model, 3, "cpu", torch.float32)
    row = _rows(np.random.default_rng(3), 1, model["vocab_size"], 20, 21)[0]
    cache = transformer.init_kv_cache(cfg, 2, "cpu")
    ids = torch.tensor([[0] * 12 + row])
    mask = torch.tensor([[0] * 12 + [1] * len(row)])
    tok, cache = transformer.prefill_into_slot(params, ids, mask, cache, 1, cfg)
    served = [int(tok[0])]
    for i in range(10):
        t = torch.tensor([0, served[-1]])
        pos = torch.tensor([0, ids.shape[1] + i])
        pad = torch.tensor([0, 12])
        tok, cache = transformer.decode_step_slots(params, cache, t, pos, pad, cfg)
        served.append(int(tok[1]))
    lg = ref.lm_logits(params, row + served[:-1], model["n_heads"])[len(row) - 1:]
    assert lg.argmax(-1).tolist() == served


def test_bench_frozen_tokenizer_matches_the_port():
    from pathway_tpu_torch.models.tokenizer import HashTokenizer

    texts = ["Hello, World! 42 times", "", "ÄÖ naïve café x9y", "a " * 300]
    for vocab, max_len in ((30522, 256), (50257, 1024), (512, 8)):
        port = HashTokenizer(vocab_size=vocab, max_len=max_len)
        for t in texts:
            assert ref_tok.tokenize(t, vocab, max_len) == port.tokenize(t)


def test_bench_exact_search():
    rng = np.random.default_rng(0)
    docs = rng.normal(size=(50, 6))
    q = rng.normal(size=(4, 6))
    scores, idx = search.exact_topk(q, docs, 5)
    want = np.argsort(-(q @ docs.T), axis=1, kind="stable")[:, :5]
    assert (idx == want).all()
    assert np.allclose(scores, np.take_along_axis(q @ docs.T, want, axis=1))
