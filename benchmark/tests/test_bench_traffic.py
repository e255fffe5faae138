"""The traffic generators: the same seed gives the same inputs, every
seed the same set of sizes, and the sizes lie inside the stated ranges."""

import numpy as np
import pytest

from benchmark import corpus, harness
from benchmark.reference import tokenizer as ref_tok
from benchmark.tests import tiny

SEEDS = (2**31 + 5, 2**32 + 17)


def test_bench_vocabulary_is_one_token_a_word():
    words = corpus.vocabulary(2000)
    assert len(set(words)) == 2000
    assert all(len(ref_tok.tokenize(w, 30522, 8)) == 2 for w in words)


def test_bench_lognormal_quantiles():
    q = corpus.lognormal_quantiles(4096, 1000, 1.0, 20000)
    assert len(q) == 4096 and max(q) <= 20000 and min(q) >= 1
    assert abs(float(np.median(q)) - 1000) < 5


@pytest.mark.parametrize("seed", SEEDS)
def test_bench_prompts(seed):
    t = harness.traffic_of("rag-answer")
    t["count"] = 64
    a, b = corpus.prompts(t, seed), corpus.prompts(t, seed)
    assert a == b
    lo, hi = t["prompt_tokens"]["floor"], t["prompt_tokens"]["cap"]
    for text, n in a:
        assert lo <= n <= hi
        # the stated count is what the port's tokenizer will see
        assert len(ref_tok.tokenize(text, 50257, 1024)) == n
    # every seed has the same set of lengths, in another order
    other = corpus.prompts(t, seed + 1)
    assert sorted(n for _, n in a) == sorted(n for _, n in other)
    assert [x for x, _ in a] != [x for x, _ in other]


def test_bench_full_size_prompt_lengths():
    """The rag-answer mix's prompt lengths: lognormal at a median past
    the budget, so a little over half sit at the cap and the rest spread
    down to the floor."""
    t = harness.traffic_of("rag-answer")
    n = np.array([k for _, k in corpus.prompts(t, SEEDS[0])])
    pt = t["prompt_tokens"]
    assert n.min() >= pt["floor"] and n.max() == pt["cap"]
    assert 0.5 < (n == pt["cap"]).mean() < 0.6
    assert np.percentile(n, 5) < 256


@pytest.mark.parametrize("seed", SEEDS)
def test_bench_documents_and_chunks(seed):
    t = tiny.embed_traffic()
    chunks = corpus.chunks(t, seed)
    assert chunks == corpus.chunks(t, seed)
    assert chunks != corpus.chunks(t, seed + 1)
    assert len(chunks) == t["chunks"]
    lo, hi = t["sentence_words"]
    for c in chunks:
        assert 0 < len(c.split()) <= t["chunk_words"][1]
        for sentence in c.split(". "):
            assert len(sentence.split()) <= hi


@pytest.mark.parametrize(
    "sentences, lo, hi, want",
    [
        # closed before the sentence that would pass hi, once it holds lo
        (["a b c.", "d e.", "f g h i."], 2, 5, ["a b c. d e.", "f g h i."]),
        # under lo, a chunk takes the next sentence even past hi
        (["a.", "b c d."], 2, 3, ["a. b c d."]),
        # a sentence past hi is cut at hi words; the rest goes on
        (["a b.", "c d e f g h i."], 2, 3, ["a b.", "c d e", "f g h", "i."]),
        ([], 2, 3, []),
    ],
)
def test_bench_split_words_by_hand(sentences, lo, hi, want):
    assert corpus.split_words(sentences, lo, hi) == want


def test_bench_split_words_keeps_every_word_once():
    rng = np.random.default_rng(7)
    words = corpus.Words(500, 1.1, rng)
    for k in (1, 60, 700, 3000):
        doc = words.sentence_list(k, 5, 40)
        chunks = corpus.split_words(doc, 50, 500)
        assert " ".join(chunks).split() == " ".join(doc).split()
        assert all(0 < len(c.split()) <= 500 for c in chunks)
        assert all(len(c.split()) >= 50 for c in chunks[:-1])


def test_bench_full_size_corpus_reaches_its_chunks():
    t = harness.traffic_of("bulk-embed")
    t["chunks"] = 2048  # a quarter, to keep the test short
    chunks = corpus.chunks(t, SEEDS[0])
    words = np.array([len(c.split()) for c in chunks])
    assert len(chunks) == 2048
    # most chunks reach the embedder's 256-token cut; documents' last
    # chunks are shorter
    assert 0.6 < (words >= 255).mean() < 0.9
    assert words.max() <= 500
