"""Text traffic from a seed: the one generator every text mix reads.

A mix's data file gives the parameters; the seed draws the words and the
order. Sizes are drawn by stratified quantiles, so that every seed gets
the same set of document and prompt lengths in another order, and
runs on different seeds do the same amount of work.

Words are Zipf-distributed over a fixed vocabulary of alphanumeric
words (each one token to a word tokenizer and to the port's hash
tokenizer), in sentences that end in a period. Documents are cut into
chunks here, by a plain word-count splitter (:func:`split_words`), so
that the inputs both the program and the reference read are made by
neither.
"""

from __future__ import annotations

import statistics

import numpy as np


def vocabulary(n: int) -> list[str]:
    """`n` distinct lower-case words, the same for every seed: rank r
    written in bijective base 26 (a..z, aa, ab, ...), then "en"."""
    out = []
    for r in range(1, n + 1):
        s = ""
        while r:
            r, m = divmod(r - 1, 26)
            s = chr(97 + m) + s
        out.append(s + "en")
    return out


class Words:
    """Zipf(s) word draws over `n` ranked words."""

    def __init__(self, n: int, s: float, rng: np.random.Generator):
        self.words = np.array(vocabulary(n), dtype=object)
        p = np.arange(1, n + 1, dtype=np.float64) ** -s
        self.cdf = np.cumsum(p / p.sum())
        self.rng = rng

    def draw(self, k: int) -> list[str]:
        idx = np.searchsorted(self.cdf, self.rng.random(k), side="right")
        return list(self.words[np.minimum(idx, len(self.words) - 1)])

    def sentence_list(self, k: int, lo: int, hi: int) -> list[str]:
        """`k` words in sentences of lo..hi words (the last may be
        shorter), each ending in '.'."""
        words = self.draw(k)
        out, i = [], 0
        while i < k:
            n = int(self.rng.integers(lo, hi + 1))
            out.append(" ".join(words[i:i + n]) + ".")
            i += n
        return out

    def sentences(self, k: int, lo: int, hi: int) -> str:
        """`k` words in sentences of lo..hi words, as one text."""
        return " ".join(self.sentence_list(k, lo, hi))


def lognormal_quantiles(n: int, median: float, sigma: float, cap: int, floor: int = 1) -> list[int]:
    """The n stratified quantiles (i + 0.5) / n of a lognormal, capped."""
    nd = statistics.NormalDist()
    return [
        int(min(cap, max(floor, round(median * np.exp(sigma * nd.inv_cdf((i + 0.5) / n))))))
        for i in range(n)
    ]


def documents(t: dict, seed: int):
    """Documents in corpus order, each a list of sentences: the lengths of
    ``doc_words`` (stratified lognormal quantiles) shuffled by the seed,
    words of ``words``."""
    rng = np.random.default_rng([int(seed), 1])
    words = Words(t["words"]["vocabulary"], t["words"]["zipf"], rng)
    dw = t["doc_words"]
    lengths = lognormal_quantiles(dw["count"], dw["median"], dw["sigma"], dw["cap"])
    lo, hi = t["sentence_words"]
    for i in rng.permutation(len(lengths)):
        yield words.sentence_list(lengths[i], lo, hi)


def split_words(sentences: list[str], lo: int, hi: int) -> list[str]:
    """Greedy chunks of whole sentences, counted in words: a chunk is
    closed before the sentence that would take it past `hi` words, once
    it holds `lo` or more; a sentence longer than `hi` is cut at `hi`
    words; a document's last chunk may hold fewer than `lo`."""
    out: list[str] = []
    cur: list[str] = []
    n = 0
    for sent in sentences:
        w = sent.split()
        while len(w) > hi:
            if cur:
                out.append(" ".join(cur))
                cur, n = [], 0
            out.append(" ".join(w[:hi]))
            w = w[hi:]
        if n + len(w) > hi and n >= lo:
            out.append(" ".join(cur))
            cur, n = [], 0
        if w:
            cur.extend(w)
            n += len(w)
    if cur:
        out.append(" ".join(cur))
    return out


def chunks(t: dict, seed: int) -> list[str]:
    """The first ``chunks`` chunks of the corpus (:func:`documents` cut by
    :func:`split_words` at ``chunk_words``)."""
    lo, hi = t["chunk_words"]
    out: list[str] = []
    for doc in documents(t, seed):
        out.extend(split_words(doc, lo, hi))
        if len(out) >= t["chunks"]:
            return out[: t["chunks"]]
    raise ValueError(f"the corpus gives {len(out)} chunks, fewer than {t['chunks']}")


def prompts(t: dict, seed: int) -> list[tuple[str, int]]:
    """(prompt, tokens) pairs: ``count`` prompts whose token counts (a
    leading class token included) are the stratified lognormal quantiles
    of ``prompt_tokens``, held inside its floor and cap, shuffled by the
    seed. Each is the template around 2..4 retrieved chunks and a
    question of ``question_words`` words."""
    rng = np.random.default_rng([int(seed), 2])
    words = Words(t["words"]["vocabulary"], t["words"]["zipf"], rng)
    pt = t["prompt_tokens"]
    lengths = lognormal_quantiles(t["count"], pt["median"], pt["sigma"], pt["cap"], pt["floor"])
    head, tail = t["template"]
    fixed = len(head.split()) + len(tail.split())
    qlo, qhi = t["question_words"]
    clo, chi = t["chunks"]
    slo, shi = t["sentence_words"]
    out = []
    for i in rng.permutation(len(lengths)):
        n = lengths[i]
        q = int(rng.integers(qlo, qhi + 1))
        body = n - 1 - fixed - q  # words left for the chunks
        k = int(rng.integers(clo, chi + 1))
        cuts = np.sort(rng.integers(1, body, size=k - 1)) if k > 1 else np.array([], int)
        sizes = np.diff(np.concatenate([[0], cuts, [body]]))
        chunks = [words.sentences(int(m), slo, shi) for m in sizes if m > 0]
        text = head + " " + "\n\n".join(chunks) + " " + tail + " " + " ".join(words.draw(q)) + "?"
        out.append((text, n))
    return out
