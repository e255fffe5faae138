"""Parity of the port's ops (pathway_tpu_torch.ops) with the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and
its PyTorch counterpart on the CPU. The CUDA kernel itself cannot run
here: ``tests/test_torch_kernels.py`` holds it against the plain version
on a card and ``chip_smoke.py`` does so at the main path's shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import attention as jattn
from pathway_tpu.ops import distances as jdist
from pathway_tpu.ops import topk as jtopk
from pathway_tpu_torch.ops import attention as tattn
from pathway_tpu_torch.ops import distances as tdist
from pathway_tpu_torch.ops import topk as ttopk


def _bf16_np(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 and back, so both frameworks see the same values."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _qkv_case(seed: int, b: int, s: int, d: int):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, s, 3 * d)).astype(np.float32)
    lens = rng.integers(1, s + 1, b)
    lens[0] = 0  # one row whose keys are all padding (bucket padding makes these)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    return qkv, mask


# ------------------------------------------------------------- attention


# (b, s, d, h): the kernel's tilings at both head dims (s 16 to 128, 16 rows
# a warp) and a ragged s (40) whose keys past s the kernel must drop; row 0
# of every case is all padding
ATTENTION_SHAPES = [
    (8, 16, 32, 4), (4, 32, 64, 2), (6, 16, 64, 1),
    (4, 64, 256, 4), (4, 64, 128, 4), (2, 128, 128, 2), (2, 128, 64, 2),
    (4, 40, 128, 2), (4, 40, 64, 2),
]


@pytest.mark.parametrize("b,s,d,h", ATTENTION_SHAPES)
def test_reference_attention_f32_matches_jax(b, s, d, h):
    """f32: the port's plain attention equals JAX's reference and the
    Pallas kernel in interpret mode to atol 1e-5 (f32 sums in another
    order)."""
    qkv, mask = _qkv_case(0, b, s, d)
    port = tattn.reference_attention(torch.from_numpy(qkv), torch.from_numpy(mask), h)
    ref = jattn.reference_attention(jnp.asarray(qkv), jnp.asarray(mask), h)
    pallas = jattn.fused_qkv_attention(
        jnp.asarray(qkv), jnp.asarray(mask), h, block_b=2, interpret=True
    )
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(port.numpy(), np.asarray(pallas), atol=1e-5)


@pytest.mark.parametrize(
    "b,s,d,h", [(8, 32, 64, 2), (4, 16, 128, 2), (2, 128, 64, 2), (4, 40, 128, 2), (2, 100, 64, 2)]
)
def test_reference_attention_bf16_matches_jax(b, s, d, h):
    """bf16: probabilities and ctx round to bf16 in both frameworks at
    the same points; an f32 sum in another order can flip one rounding,
    so the bound is one bf16 ulp at |ctx| < 4 (2**-6)."""
    qkv, mask = _qkv_case(1, b, s, d)
    qkv = _bf16_np(qkv)
    port = tattn.reference_attention(
        torch.from_numpy(qkv).bfloat16(), torch.from_numpy(mask), h
    )
    ref = jattn.reference_attention(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(mask), h)
    assert port.dtype == torch.bfloat16
    assert np.abs(np.asarray(ref, np.float32)).max() < 4
    np.testing.assert_allclose(
        port.float().numpy(), np.asarray(ref, np.float32), atol=2.0**-6
    )


@pytest.mark.parametrize("s,d,h", [(16, 32, 4), (40, 128, 2), (100, 64, 2)])
def test_all_padding_row_is_uniform_mean_of_v(s, d, h):
    """-1e30 on every key gives equal scores: the row attends uniformly
    (the mean of its s keys of v, at a ragged s too), with no NaN, as the
    JAX reference and the kernel."""
    b = 2
    qkv, _ = _qkv_case(2, b, s, d)
    mask = np.zeros((b, s), np.int32)
    mask[1] = 1
    out = tattn.reference_attention(torch.from_numpy(qkv), torch.from_numpy(mask), h)
    assert torch.isfinite(out).all()
    v_mean = qkv[0, :, 2 * d:].mean(axis=0)
    np.testing.assert_allclose(out[0].numpy(), np.broadcast_to(v_mean, (s, d)), atol=1e-5)


# ------------------------------------------------------------- distances


def _docs_queries(seed: int, n: int = 300, q: int = 6, dim: int = 32):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(q, dim)).astype(np.float32),
        rng.normal(size=(n, dim)).astype(np.float32),
    )


def test_normalize_matches_jax():
    x, _ = _docs_queries(0)
    x[0] = 0.0  # a zero row stays zero (eps floor)
    np.testing.assert_allclose(
        tdist.normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jdist.normalize(jnp.asarray(x))), atol=1e-6,
    )


@pytest.mark.parametrize("metric", ["cos", "cosine", "l2", "l2sq", "dot"])
def test_metrics_match_jax(metric):
    """bf16-rounded inputs, f32 sums in both: agreement to f32 rounding
    of the sums (atol 1e-4 at |distance| up to ~100 for l2)."""
    q, d = _docs_queries(1)
    port = tdist.metric_fn(metric)(torch.from_numpy(q), torch.from_numpy(d))
    ref = jdist.metric_fn(metric)(jnp.asarray(q), jnp.asarray(d))
    assert port.dtype == torch.float32 and port.shape == (6, 300)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_unknown_metric_raises():
    with pytest.raises(ValueError, match="unknown metric"):
        tdist.metric_fn("hamming")


# ----------------------------------------------------------------- top-k


def _same_topk(port: ttopk.TopKResult, ref, atol: float) -> None:
    # raw index order may differ on ties: compare per-row sets and the
    # sorted distances
    pi, ri = port.indices.numpy(), np.asarray(ref.indices)
    for r in range(pi.shape[0]):
        assert set(pi[r].tolist()) == set(ri[r].tolist())
    np.testing.assert_allclose(
        np.sort(port.distances.numpy(), 1), np.sort(np.asarray(ref.distances), 1),
        atol=atol,
    )
    assert port.indices.dtype == torch.int32


@pytest.mark.parametrize("metric,normalized", [("cos", False), ("cos", True), ("dot", False), ("l2", False)])
def test_knn_search_matches_jax(metric, normalized):
    q, d = _docs_queries(2)
    if normalized:
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    port = ttopk.knn_search(torch.from_numpy(q), torch.from_numpy(d), 10, metric, normalized=normalized)
    ref = jtopk.knn_search(jnp.asarray(q), jnp.asarray(d), 10, metric, normalized=normalized)
    _same_topk(port, ref, atol=1e-4)


@pytest.mark.parametrize("metric", ["cos", "l2sq", "dot"])
def test_knn_search_masked_matches_jax(metric):
    q, d = _docs_queries(3)
    valid = np.random.default_rng(3).random(300) > 0.3
    port = ttopk.knn_search_masked(
        torch.from_numpy(q), torch.from_numpy(d), torch.from_numpy(valid), 10, metric
    )
    ref = jtopk.knn_search_masked(jnp.asarray(q), jnp.asarray(d), jnp.asarray(valid), 10, metric)
    _same_topk(port, ref, atol=1e-4)
    assert valid[port.indices.numpy()].all()


def test_quantize_docs_matches_jax():
    """int8 values equal (half-to-even rounding in both), scales to f32
    rounding, rescore rows identical."""
    _, d = _docs_queries(4, n=500)
    d = _bf16_np(d / np.linalg.norm(d, axis=1, keepdims=True))
    port = ttopk.quantize_docs(torch.from_numpy(d).bfloat16())
    ref = jtopk.quantize_docs(jnp.asarray(d, jnp.bfloat16))
    np.testing.assert_array_equal(port.values.numpy(), np.asarray(ref.values))
    np.testing.assert_allclose(port.scale.numpy(), np.asarray(ref.scale), rtol=1e-6)
    np.testing.assert_array_equal(port.full.float().numpy(), np.asarray(ref.full, np.float32))


def test_update_quantized_docs_matches_jax_and_writes_in_place():
    _, d = _docs_queries(5, n=200)
    d = _bf16_np(d / np.linalg.norm(d, axis=1, keepdims=True))
    rows = _bf16_np(np.random.default_rng(5).normal(size=(8, 32)).astype(np.float32))
    idx = np.array([3, 7, 7, 150, 0, 199, 3, 42], np.int32)
    rows[2] = rows[1]  # a repeated (idx, row) pair is idempotent
    rows[6] = rows[0]
    port = ttopk.quantize_docs(torch.from_numpy(d).bfloat16())
    before = port.values.data_ptr()
    port = ttopk.update_quantized_docs(port, torch.from_numpy(idx), torch.from_numpy(rows))
    assert port.values.data_ptr() == before
    ref = jtopk.update_quantized_docs(
        jtopk.quantize_docs(jnp.asarray(d, jnp.bfloat16)), jnp.asarray(idx), jnp.asarray(rows)
    )
    np.testing.assert_array_equal(port.values.numpy(), np.asarray(ref.values))
    np.testing.assert_allclose(port.scale.numpy(), np.asarray(ref.scale), rtol=1e-6)
    np.testing.assert_array_equal(port.full.float().numpy(), np.asarray(ref.full, np.float32))


def test_knn_search_quantized_matches_jax_and_recall():
    """Same top-k set as JAX on a seeded corpus; recall@10 against exact
    search at least JAX's (the JAX package's own bar is 0.9)."""
    rng = np.random.default_rng(7)
    docs = rng.normal(size=(5000, 64)).astype(np.float32)
    docs = _bf16_np(docs / np.linalg.norm(docs, axis=1, keepdims=True))
    q = rng.normal(size=(8, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)

    tdocs = torch.from_numpy(docs).bfloat16()
    port = ttopk.knn_search_quantized(torch.from_numpy(q), ttopk.quantize_docs(tdocs), 10)
    jdocs = jnp.asarray(docs, jnp.bfloat16)
    ref = jtopk.knn_search_quantized(jnp.asarray(q), jtopk.quantize_docs(jdocs), 10)
    _same_topk(port, ref, atol=1e-5)

    exact = ttopk.knn_search(torch.from_numpy(q), tdocs, 10, "cos", normalized=True).indices.numpy()
    jexact = np.asarray(jtopk.knn_search(jnp.asarray(q), jdocs, 10, "cos", normalized=True).indices)

    def recall(a, b):
        return np.mean([len(set(a[i]) & set(b[i])) / 10 for i in range(len(a))])

    assert recall(exact, port.indices.numpy()) >= recall(jexact, np.asarray(ref.indices))
    assert recall(exact, port.indices.numpy()) >= 0.9


def test_int8_scan_pads_small_shapes():
    """The int8 product equals the exact integer product for query counts
    that are not multiples of 8 and for doc sets of 16 rows or fewer."""
    rng = np.random.default_rng(8)
    for q, n in [(3, 5), (16, 16), (9, 40)]:
        qi = torch.from_numpy(rng.integers(-127, 128, (q, 32)).astype(np.int8))
        vi = torch.from_numpy(rng.integers(-127, 128, (n, 32)).astype(np.int8))
        got = ttopk._int8_scan(qi, vi)
        assert got.shape == (q, n)
        np.testing.assert_array_equal(
            got.numpy(), qi.numpy().astype(np.int64) @ vi.numpy().astype(np.int64).T
        )
