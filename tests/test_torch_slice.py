"""The port's embed -> index -> retrieve slice against the JAX package, and
the port's isolation from JAX.

Texts go through ``TorchEmbedder`` and ``JaxEmbedder`` with the same
parameters (drawn once by ``jax.random``, carried across with
``params_from_numpy``); vectors and queries through both packages'
``VectorSlabIndex``. Everything runs on the CPU at a small size.
"""

import ast
import asyncio
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pathway_tpu.internals.keys import key_for_values
from pathway_tpu.models import transformer as jtfm
from pathway_tpu.stdlib.indexing.host_indexes import VectorSlabIndex as JaxSlab
from pathway_tpu.xpacks.llm.embedders import JaxEmbedder
from pathway_tpu.xpacks.llm.embedders import pad_left_rows as jax_pad_left_rows
from pathway_tpu_torch.models import convert
from pathway_tpu_torch.models import transformer as ttfm
from pathway_tpu_torch.stdlib.indexing.host_indexes import VectorSlabIndex
from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder, bucket_len, pad_left_rows

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(vocab_size=512, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=32, embed_dim=32)

TEXTS = [
    "live data frameworks keep indexes fresh",
    "a vector index answers nearest neighbour queries",
    "",
    "the encoder mean-pools its hidden states and normalizes them",
    "short",
    "tokens beyond the bucket are padded with a zero mask " * 2,
    "retrieval augmented generation reads the top documents",
    "embeddings land in a device resident slab",
    "queries are batched into one masked distance and top-k",
    "bf16 rows, f32 sums",
]


def _pair(dtype: str):
    """(JaxEmbedder, TorchEmbedder) with the same parameters."""
    jd, td = (jax.numpy.float32, torch.float32) if dtype == "f32" else (jax.numpy.bfloat16, torch.bfloat16)
    jcfg = jtfm.embedder_config(dtype=jd, **SMALL)
    tcfg = ttfm.embedder_config(dtype=td, **SMALL)
    jp = jtfm.init_params(jax.random.PRNGKey(4), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return JaxEmbedder(config=jcfg, params=jp), TorchEmbedder(tcfg, tp, device="cpu")


# -------------------------------------------------------------- embedder


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encode_many_matches_jax_embedder(dtype):
    """f32: the same products in another order, atol 1e-4 on unit-norm
    embeddings. bf16: the rounding points differ where
    test_torch_models' bf16 encoder test says (GELU input, pool order),
    so cosine >= 0.999 per row and atol 2e-2 per component."""
    jemb, temb = _pair(dtype)
    ref = np.stack(jemb.encode_many(TEXTS))
    got = np.stack(temb.encode_many(TEXTS))
    assert got.shape == ref.shape == (len(TEXTS), 32) and got.dtype == np.float32
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, atol=1e-4)
    else:
        assert np.sum(got * ref, axis=1).min() >= 0.999
        np.testing.assert_allclose(got, ref, atol=2e-2)


def test_embedder_buckets_rows_and_sequence_like_jax():
    """Ragged waves pad to the plane's row and sequence buckets: every
    wave inside one bucket dispatches one shape, as the JAX embedder
    compiles one program per bucket."""
    _jemb, temb = _pair("f32")
    for texts in (["a"], ["a b", "c"], ["d e f"] * 7, ["x"] * 8):
        temb.encode_many(texts)
    assert temb._encode.total_shapes == 1 and temb.dispatches == 4
    temb.encode_many(["y"] * 9)  # next row bucket: one more shape
    assert temb._encode.shape_counts == {(8, 16): 1, (16, 16): 1}
    # padded rows never leak: each text alone gives the same vector
    got = temb.encode_many(TEXTS[:3])
    for t, v in zip(TEXTS[:3], got):
        np.testing.assert_allclose(v, temb.encode_many([t])[0], atol=1e-5)


def test_pad_helpers_match_jax():
    rows = [[5, 6, 7], [8], list(range(2, 40))]
    assert bucket_len(17, 128) == 32 and bucket_len(200, 128) == 128
    for kw in ({}, {"pad_rows_to": 4}, {"n_rows": 5}):
        pi, pm = pad_left_rows(rows, 64, **kw)
        ri, rm = jax_pad_left_rows(rows, 64, **kw)
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(pm, rm)


def test_embed_coalesces_concurrent_calls_into_one_flush():
    _jemb, temb = _pair("f32")
    want = temb.encode_many(TEXTS)
    before = temb.dispatches

    async def run():
        return await asyncio.gather(*(temb.embed(t) for t in TEXTS))

    got = asyncio.run(run())
    assert temb._batcher.flushes == 1 and temb.dispatches == before + 1
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-6)


def test_embedder_without_a_gpu_raises(monkeypatch):
    """No device and no card: an error, never a quiet move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEmbedder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VectorSlabIndex(dimensions=8)


# ------------------------------------------------------------ slab index


def _drive_stream(port: VectorSlabIndex, ref: JaxSlab, dim: int, seed: int):
    """One stream of add / remove / re-add / search_batch through both
    indexes; yields both result lists after every search."""
    rng = np.random.default_rng(seed)
    keys = [key_for_values(i) for i in range(300)]

    def both(fn, *args):
        getattr(port, fn)(*args)
        getattr(ref, fn)(*args)

    def search(n_q: int, k: int):
        qs = [(rng.normal(size=dim).astype(np.float32), k, None) for _ in range(n_q)]
        return port.search_batch(qs), ref.search_batch(qs)

    for i in range(100):  # mirror pads to 128 slots
        both("add", keys[i], rng.normal(size=dim).astype(np.float32))
    yield search(5, 10)
    for i in range(0, 100, 7):  # tombstones
        both("remove", keys[i])
    for i in (3, 5, 8):  # upserts in place
        both("add", keys[i], rng.normal(size=dim).astype(np.float32))
    yield search(3, 5)  # small delta: written into the mirror in place
    for i in (0, 7, 14):  # re-add of removed keys into free slots
        both("add", keys[i], rng.normal(size=dim).astype(np.float32))
    for i in range(100, 300):  # growth: the mirror is rebuilt at 512
        both("add", keys[i], rng.normal(size=dim).astype(np.float32))
    yield search(9, 20)
    yield search(1, 400)  # k past the live rows


@pytest.mark.parametrize("metric", ["cos", "l2sq", "dot"])
@pytest.mark.parametrize("device", ["cpu", False])
def test_slab_index_stream_matches_jax(metric, device):
    """Keys equal after the (score, key) re-sort; scores to 1e-4 (the
    device mirrors hold the same bf16 rows in both packages and sum in
    f32; the host scans are both f32 numpy)."""
    dim = 16
    port = VectorSlabIndex(dimensions=dim, metric=metric, device=device, reserved_space=64)
    ref = JaxSlab(dimensions=dim, metric=metric, device=device is not False, reserved_space=64)
    n_searches = 0
    for got, want in _drive_stream(port, ref, dim, seed=11):
        n_searches += 1
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert [k for k, _ in g] == [k for k, _ in w]
            np.testing.assert_allclose([d for _, d in g], [d for _, d in w], rtol=1e-5, atol=1e-4)
    assert n_searches == 4
    assert len(port) == len(ref) == 300 - 15 + 3


def test_slab_mirror_takes_small_deltas_in_place():
    idx = VectorSlabIndex(dimensions=8, device="cpu")
    rng = np.random.default_rng(2)
    for i in range(80):
        idx.add(i, rng.normal(size=8))
    idx.search(rng.normal(size=8), 3)
    docs, _valid = idx.device_docs()
    assert docs.shape == (128, 8) and docs.dtype == torch.bfloat16
    ptr = docs.data_ptr()
    idx.add(3, rng.normal(size=8))
    idx.remove(11)
    docs, valid = idx.device_docs()
    assert docs.data_ptr() == ptr and not bool(valid[11])
    np.testing.assert_array_equal(
        docs[3].float().numpy(), torch.from_numpy(idx.vectors[3]).bfloat16().float().numpy()
    )
    assert [k for k, _ in idx.search(idx.vectors[3], 1)] == [3]


def test_slab_filtered_search_waits_for_the_filters_module():
    idx = VectorSlabIndex(dimensions=4, device="cpu")
    idx.add(1, [1.0, 0, 0, 0], metadata={"a": 1})
    with pytest.raises(NotImplementedError, match="filters"):
        idx.search([1.0, 0, 0, 0], 1, metadata_filter="a == `1`")
    assert VectorSlabIndex(dimensions=4, device="cpu").search([1.0, 0, 0, 0], 3) == []


def test_embed_index_retrieve_matches_jax():
    """The slice end to end: texts -> embedder -> slab -> search in both
    packages; the same keys come back, and each text finds itself."""
    jemb, temb = _pair("f32")
    port = VectorSlabIndex(dimensions=32, device="cpu")
    ref = JaxSlab(dimensions=32)
    texts = [t for t in TEXTS if t]
    keys = [key_for_values("doc", i) for i in range(len(texts))]
    for k, v in zip(keys, temb.encode_many(texts)):
        port.add(k, v)
    for k, v in zip(keys, jemb.encode_many(texts)):
        ref.add(k, v)
    queries = temb.encode_many(texts)
    got = port.search_batch([(q, 3, None) for q in queries])
    want = ref.search_batch([(q, 3, None) for q in queries])
    for i, (g, w) in enumerate(zip(got, want)):
        assert [k for k, _ in g] == [k for k, _ in w]
        assert g[0][0] == keys[i]
        np.testing.assert_allclose([d for _, d in g], [d for _, d in w], atol=1e-4)


# ------------------------------------------------------------- isolation


def _port_sources() -> list[Path]:
    return sorted((REPO / "pathway_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            names = [getattr(a, "value", "") for a in node.args[:1]]
        else:
            continue
        for name in names:
            top = str(name).split(".")[0]
            assert top not in ("jax", "jaxlib", "pathway_tpu"), (path, name)


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pathway_tpu_torch, pathway_tpu_torch.ops, pathway_tpu_torch.models, "
        "pathway_tpu_torch.models.convert, pathway_tpu_torch.xpacks.llm, "
        "pathway_tpu_torch.stdlib.indexing, pathway_tpu_torch.indexing\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pathway_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_chip_smoke_fails_without_a_card_and_without_the_repo(tmp_path):
    """No CUDA device: a non-zero exit and no result line. A directory
    holding chip_smoke.py alone: the same."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        proc = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0, proc.stdout
        assert '"ok": true' not in proc.stdout
