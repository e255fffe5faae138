"""The encoder's two attention routes and the encoder reranker on the
card, held to the same computation on the CPU.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_encoder_cuda.py -q

Without a card every test skips. ``fused_attention=True`` (the default)
launches the attention kernel, which takes bf16, f16 and f32, any s and
every head width that is a multiple of 8 up to 256 (ROADMAP C6: before,
it took bf16, head_dim 32 or 64 and s <= 128 and raised outside them);
``fused_attention=False`` runs the plain attention on the card at any
dtype and length (ROADMAP C1). Tolerances: at f32 the card's and the
CPU's embeddings agree within 1e-4 (unit vectors; TF32 is off, so only
the order of f32 sums differs); at bf16 within 2^-6, as the RAG pipeline's
scores in ``tests/test_torch_rag_cuda.py`` (the two devices round the
bf16 activations at other points).
"""

import numpy as np
import pytest
import torch

from pathway_tpu_torch import TorchEmbedder
from pathway_tpu_torch.models.transformer import TransformerEncoder, embedder_config
from pathway_tpu_torch.ops import _build
from pathway_tpu_torch.ops.attention import KERNEL

pytestmark = pytest.mark.cuda
EMB = dict(vocab_size=512, d_model=64, n_heads=2, n_layers=2, d_ff=128, embed_dim=32)
F32_ATOL = 1e-4
BF16_ATOL = 2.0**-6


@pytest.fixture
def cuda_device():
    # decided when the test runs, never at import: every xdist worker
    # must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: these tests hold the card's encoder to the CPU's")
    return torch.device("cuda")


def _tokens(s: int, seed: int = 0, b: int = 8):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, EMB["vocab_size"], (b, s))
    mask = (np.arange(s)[None, :] < rng.integers(1, s + 1, b)[:, None]).astype(np.int32)
    return torch.as_tensor(ids), torch.as_tensor(mask)


def _card_and_cpu(cfg, cuda_device):
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731 — the same draws on both
    return (
        TransformerEncoder(cfg, device=cuda_device, generator=gen()),
        TransformerEncoder(cfg, device="cpu", generator=gen()),
    )


def test_f32_encoder_launches_the_kernel_and_matches_the_cpu(cuda_device):
    """An f32 encoder: the kernel serves it (it raised before C6) and
    agrees with the CPU; the unfused route launches nothing and agrees
    too."""
    ids, mask = _tokens(32)
    fused, cpu = _card_and_cpu(embedder_config(max_len=32, dtype=torch.float32, **EMB), cuda_device)
    _build.reset_launch_counts()
    got = fused(ids.to(cuda_device), mask.to(cuda_device))
    assert got.dtype == torch.float32 and _build.LAUNCHES.get(KERNEL, 0) == EMB["n_layers"]
    np.testing.assert_allclose(got.cpu().numpy(), cpu(ids, mask).numpy(), atol=F32_ATOL)
    cfg = embedder_config(max_len=32, dtype=torch.float32, fused_attention=False, **EMB)
    card, cpu = _card_and_cpu(cfg, cuda_device)
    _build.reset_launch_counts()
    got = card(ids.to(cuda_device), mask.to(cuda_device))
    assert got.dtype == torch.float32 and _build.LAUNCHES.get(KERNEL, 0) == 0
    np.testing.assert_allclose(got.cpu().numpy(), cpu(ids, mask).numpy(), atol=F32_ATOL)


def test_bf16_unfused_encoder_matches_the_cpu(cuda_device):
    ids, mask = _tokens(64, seed=1)
    card, cpu = _card_and_cpu(embedder_config(max_len=64, fused_attention=False, **EMB), cuda_device)
    np.testing.assert_allclose(
        card(ids.to(cuda_device), mask.to(cuda_device)).cpu().numpy(), cpu(ids, mask).numpy(), atol=BF16_ATOL
    )


def test_long_sequences_launch_the_tiled_kernel_and_match_the_cpu(cuda_device):
    """s 256 and 512, past the short kernel's 128 (where the default
    raised before C6): the default config launches the tiled kernel at
    that s and agrees with the CPU, and so does the unfused config."""
    for s in (256, 512):
        ids, mask = _tokens(s, seed=2, b=4)
        fused, cpu = _card_and_cpu(embedder_config(max_len=512, **EMB), cuda_device)
        _build.reset_launch_counts()
        got = fused(ids.to(cuda_device), mask.to(cuda_device))
        assert _build.LAUNCH_TAGS[KERNEL] == {s: EMB["n_layers"]}
        np.testing.assert_allclose(got.cpu().numpy(), cpu(ids, mask).numpy(), atol=BF16_ATOL)
    card, cpu = _card_and_cpu(embedder_config(max_len=512, fused_attention=False, **EMB), cuda_device)
    np.testing.assert_allclose(
        card(ids.to(cuda_device), mask.to(cuda_device)).cpu().numpy(), cpu(ids, mask).numpy(), atol=BF16_ATOL
    )


def test_encoder_reranker_on_the_card_matches_the_cpu(cuda_device):
    """EncoderReranker's scores (the inner product of the query's and the
    doc's embeddings) from a TorchEmbedder on the card and one on the CPU
    with the same weights; the card's launches the attention kernel."""
    from pathway_tpu_torch.xpacks.llm.rerankers import EncoderReranker

    cfg = embedder_config(max_len=32, **EMB)
    rows = [
        ("alpha beta gamma", "alpha beta gamma"),
        ("totally unrelated words xyz", "alpha beta gamma"),
        ("alpha beta", "alpha beta gamma delta"),
    ]
    card = EncoderReranker(embedder=TorchEmbedder(cfg, device=cuda_device))
    cpu = EncoderReranker(embedder=TorchEmbedder(cfg, device="cpu"))
    _build.reset_launch_counts()
    got = [card.__wrapped__(d, q) for d, q in rows]
    assert _build.LAUNCHES.get(KERNEL, 0) == len(rows) * EMB["n_layers"]
    want = [cpu.__wrapped__(d, q) for d, q in rows]
    np.testing.assert_allclose(got, want, atol=BF16_ATOL)
    assert got[0] > got[1]
