"""The hash tokenizer's compiled pass against its Python path.

``HashTokenizer`` hashes ASCII rows in one compiled pass
(``models/hash_tokenizer.cpp``) and every other row in Python. Both give
the JAX package's ids: the cases below hold the compiled path to the
port's Python path and to ``pathway_tpu.models.tokenizer``, element for
element and in dtype, for ``batch`` and ``tokenize``. The compiled-path
cases skip only where no compiler builds the pass.
"""

import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from pathway_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from pathway_tpu_torch.internals import observability as obs
from pathway_tpu_torch.models import tokenizer
from pathway_tpu_torch.models.tokenizer import HashTokenizer

REPO = Path(__file__).resolve().parent.parent

TEXTS = {
    "case_digits_punctuation": [
        "Hello, World! 42 times", "MiXeD CaSe 0xDEADbeef", "e.g. 3.14-pi; a_b/c~d", "UPPER lower 123",
    ],
    "separator_runs": ["  ,,;; ..\t\n--", "a,,,,b   c...d", "...", " ", "x"],
    "word_over_4kb": ["x" * 5000, "pre " + "Ab1" * 1500 + " post", "short"],
    "more_words_than_max_len": [" ".join(f"w{i}" for i in range(400)), "a " * 300, "B" * 7 + " c" * 260],
    "empty_strings": ["", "", "word"],
    "empty_list": [],
}
NON_ASCII = [
    "über Straße",  # ü and ß
    "ſtop ſ long s",  # U+017F matches [a-z] under IGNORECASE
    "ıi İI dotless and dotted",  # U+0131, U+0130 (lower() gives two characters)
    "K kelvin KK",  # the Kelvin sign
    "plain ASCII row, 7 words here",
    "ü",
    "",
]


@pytest.fixture
def native():
    """The compiled pass, or a skip where no compiler builds it."""
    if tokenizer._load() is None:
        pytest.skip("build_library found no compiler (or PATHWAY_TPU_NATIVE=0): no compiled pass")


@pytest.fixture
def plane():
    """The observability plane on for the test, as it was after."""
    before = obs.PLANE
    obs.disable()
    obs.enable()
    yield obs.PLANE.metrics
    obs.PLANE = before


def _python_path(monkeypatch, tok, texts, pad_to):
    with monkeypatch.context() as m:
        m.setattr(tokenizer, "_load", lambda: None)
        return tok.batch(texts, pad_to), [tok.tokenize(t) for t in texts]


def _pad_to(kind: str, longest: int):
    return {"none": None, "zero": 0, "smaller": max(longest - 1, 1), "larger": longest + 5}[kind]


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("vocab", [30522, 1024])
@pytest.mark.parametrize("pad", ["none", "zero", "smaller", "larger"])
@pytest.mark.parametrize("max_len", [1, 2, 3, 256])
@pytest.mark.parametrize("case", sorted(TEXTS))
def test_compiled_path_is_the_python_path_and_the_jax_tokenizer(native, monkeypatch, case, max_len, pad, vocab):
    texts = TEXTS[case]
    tok = HashTokenizer(vocab_size=vocab, max_len=max_len)
    ref = JaxHashTokenizer(vocab_size=vocab, max_len=max_len)
    pad_to = _pad_to(pad, max((len(ref.tokenize(t)) for t in texts), default=1))
    python, python_rows = _python_path(monkeypatch, tok, texts, pad_to)
    got = tok.batch(texts, pad_to)
    _assert_same(got, ref.batch(texts, pad_to))
    _assert_same(got, python)
    rows = [tok.tokenize(t) for t in texts]
    assert rows == python_rows == [ref.tokenize(t) for t in texts]
    assert all(type(i) is int for row in rows for i in row)


@pytest.mark.parametrize("max_len", [1, 3, 256])
def test_corpus_chunks_of_the_embed_cell(native, monkeypatch, max_len):
    """256 chunks of the bulk-embed mix: the benchmark's own inputs."""
    from benchmark import corpus

    traffic = json.loads((REPO / "benchmark/traffic/bulk-embed.json").read_text())
    texts = corpus.chunks(traffic, 2**31 + 11)[:256]
    assert all(t.isascii() for t in texts)
    tok = HashTokenizer(vocab_size=30522, max_len=max_len)
    ref = JaxHashTokenizer(vocab_size=30522, max_len=max_len)
    got = tok.batch(texts)
    _assert_same(got, ref.batch(texts))
    _assert_same(got, _python_path(monkeypatch, tok, texts, None)[0])


@pytest.mark.parametrize("max_len", [2, 256])
@pytest.mark.parametrize("pad_to", [None, 3])
def test_non_ascii_rows_keep_the_python_path_row_for_row(native, monkeypatch, plane, max_len, pad_to):
    tok = HashTokenizer(vocab_size=1024, max_len=max_len)
    python, python_rows = _python_path(monkeypatch, tok, NON_ASCII, pad_to)
    before = {p: plane.counter_value("pathway_tokenizer_rows_total", {"path": p}) for p in ("native", "python")}
    got = tok.batch(NON_ASCII, pad_to)
    _assert_same(got, python)
    _assert_same(got, JaxHashTokenizer(vocab_size=1024, max_len=max_len).batch(NON_ASCII, pad_to))
    assert [tok.tokenize(t) for t in NON_ASCII] == python_rows
    n_ascii = sum(t.isascii() for t in NON_ASCII)
    after = {p: plane.counter_value("pathway_tokenizer_rows_total", {"path": p}) for p in ("native", "python")}
    # the batch, then one tokenize a row
    assert after["native"] - before["native"] == 2 * n_ascii
    assert after["python"] - before["python"] == 2 * (len(NON_ASCII) - n_ascii)


def test_counter_counts_each_path_only_with_the_plane_on(native, monkeypatch):
    before = obs.PLANE
    obs.disable()
    try:
        tok = HashTokenizer(vocab_size=1024, max_len=8)
        tok.batch(NON_ASCII)  # plane off: nothing to count into
        obs.enable()
        m = obs.PLANE.metrics
        tok.batch(["abc", "ü"])
        tok.tokenize("only ascii")
        assert m.counter_value("pathway_tokenizer_rows_total", {"path": "native"}) == 2
        assert m.counter_value("pathway_tokenizer_rows_total", {"path": "python"}) == 1
        _python_path(monkeypatch, tok, ["abc", "def"], None)  # the batch and two tokenize calls
        assert m.counter_value("pathway_tokenizer_rows_total", {"path": "python"}) == 5
    finally:
        obs.PLANE = before


def test_native_planes_off_gives_the_same_arrays(native, monkeypatch, plane):
    texts = TEXTS["case_digits_punctuation"] + NON_ASCII
    tok = HashTokenizer(vocab_size=30522, max_len=16)
    want = tok.batch(texts, None)
    monkeypatch.setenv("PATHWAY_TPU_NATIVE", "0")
    monkeypatch.setattr(tokenizer, "_TRIED", False)
    monkeypatch.setattr(tokenizer, "_LIB", None)
    native_rows = plane.counter_value("pathway_tokenizer_rows_total", {"path": "native"})
    _assert_same(tok.batch(texts, None), want)
    assert tokenizer._load() is None
    assert plane.counter_value("pathway_tokenizer_rows_total", {"path": "native"}) == native_rows
    assert [tok.tokenize(t) for t in texts] == [JaxHashTokenizer(30522, 16).tokenize(t) for t in texts]


@pytest.mark.parametrize("vocab", [2, 1, 0])
def test_vocab_of_two_or_less_keeps_the_python_behaviour(vocab):
    """Python's `%` raises at a vocab of 2 and wraps below it; the compiled
    pass takes no such row."""
    tok = HashTokenizer(vocab_size=vocab, max_len=8)
    ref = JaxHashTokenizer(vocab_size=vocab, max_len=8)
    if vocab == 2:
        with pytest.raises(ZeroDivisionError):
            tok.batch(["a word"])
        with pytest.raises(ZeroDivisionError):
            tok.tokenize("a word")
        assert tok.batch([""])[0].tolist() == [[1]]
    else:
        _assert_same(tok.batch(["a word", "x"]), ref.batch(["a word", "x"]))
        assert tok.tokenize("a word") == ref.tokenize("a word")


def test_a_long_batch_leaves_the_interpreter_lock_to_other_threads(native, monkeypatch):
    """A counting thread advances while the compiled pass hashes a
    4,096-row batch: the call runs without the interpreter lock."""
    lib = tokenizer._load()
    ticks: list[float] = []
    during: list[int] = []
    stop = threading.Event()

    class Spy:
        def ht_rows(self, *args):
            before = len(ticks)
            lib.ht_rows(*args)
            during.append(len(ticks) - before)

    def count():
        while not stop.is_set():
            ticks.append(time.perf_counter())
            time.sleep(0.0002)

    monkeypatch.setattr(tokenizer, "_LIB", Spy())
    texts = [" ".join(["Abcdefghijkl"] * 400)] * 4096  # 5 KB a row, 400 words
    counter = threading.Thread(target=count, daemon=True)
    counter.start()
    try:
        ids, mask = HashTokenizer(vocab_size=30522, max_len=512).batch(texts)
    finally:
        stop.set()
        counter.join(timeout=10)
    assert not counter.is_alive()
    assert ids.shape == (4096, 401) and int(mask.sum()) == 4096 * 401
    # holding the lock, the call would leave at most a tick or two at its edges
    assert len(during) == 1 and during[0] >= 5, during
