"""The port's hand-written CUDA kernels: their wrappers, their build, and,
on a card, each kernel against its plain PyTorch version.

This file imports neither JAX nor the JAX package, so the tests marked
``cuda`` run on a machine with a card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

Without a card they skip; the rest run on the CPU.
"""

import numpy as np
import pytest
import torch

from pathway_tpu_torch.ops import _build
from pathway_tpu_torch.ops import attention as tattn


@pytest.fixture
def cuda_device():
    # decided when the test runs, never at import: every xdist worker
    # must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _qkv_case(seed: int, b: int, s: int, d: int):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, s, 3 * d)).astype(np.float32)
    lens = rng.integers(1, s + 1, b)
    lens[0] = 0  # one row whose keys are all padding (bucket padding makes these)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    return qkv, mask


def test_wrapper_on_cpu_runs_plain_version_and_counts_no_launch():
    qkv, mask = _qkv_case(3, 4, 16, 32)
    _build.reset_launch_counts()
    out = tattn.fused_qkv_attention(torch.from_numpy(qkv), torch.from_numpy(mask), 4)
    ref = tattn.reference_attention(torch.from_numpy(qkv), torch.from_numpy(mask), 4)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert _build.LAUNCHES.get(tattn.KERNEL, 0) == 0


def test_build_without_nvcc_names_the_tool(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_build_key_covers_source_and_flags():
    assert _build.sources() == ["attention"]
    p = _build.library_path("attention")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("attention-")
    assert p == _build.library_path("attention")  # stable for unchanged input


# (b, s, d, h): the two main-path shapes cut in batch, s 16 and 32, s 128 at
# dh 64, ragged s at both head dims, and odd batch and head counts
CARD_SHAPES = [
    (64, 64, 384, 6), (32, 128, 256, 8), (8, 16, 64, 2),
    (5, 16, 192, 3), (7, 32, 128, 2), (16, 128, 384, 6),
    (16, 40, 384, 6), (16, 40, 256, 8), (9, 100, 384, 6), (9, 100, 256, 8),
    (3, 1, 64, 2), (4, 17, 96, 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [4, 5, 6])
@pytest.mark.parametrize("b,s,d,h", CARD_SHAPES)
def test_kernel_matches_plain_on_card(cuda_device, b, s, d, h, seed):
    """On the card: the kernel against the plain version, bf16, with
    random padding and an all-padding row; one bf16 ulp at |ctx| < 4."""
    qkv, mask = _qkv_case(seed, b, s, d)
    q = torch.from_numpy(qkv).to(cuda_device, torch.bfloat16)
    m = torch.from_numpy(mask).to(cuda_device)
    _build.reset_launch_counts()
    out = tattn.fused_qkv_attention(q, m, h)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[tattn.KERNEL] == 1
    ref = tattn.reference_attention(q, m, h)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2.0**-6
    # row 0 is all padding: the mean of its s keys of v
    v_mean = q[0, :, 2 * d:].float().mean(dim=0)
    assert (out[0].float() - v_mean).abs().max().item() <= 2.0**-6


@pytest.mark.cuda
@pytest.mark.parametrize("s,d,h", [(64, 384, 6), (128, 256, 8), (40, 128, 2)])
def test_kernel_all_padding_batch_has_no_nan(cuda_device, s, d, h):
    """Every row all padding: each row of ctx is the mean of its s keys
    of v, with no NaN and nothing from keys past s."""
    qkv, _ = _qkv_case(5, 6, s, d)
    q = torch.from_numpy(qkv).to(cuda_device, torch.bfloat16)
    m = torch.zeros((6, s), dtype=torch.int32, device=cuda_device)
    out = tattn.fused_qkv_attention(q, m, h)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    v_mean = q[:, :, 2 * d:].float().mean(dim=1, keepdim=True)
    assert (out.float() - v_mean).abs().max().item() <= 2.0**-6
    torch.testing.assert_close(out, tattn.reference_attention(q, m, h), rtol=0, atol=2.0**-6)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_cannot_take(cuda_device):
    qkv = torch.zeros(2, 16, 3 * 96, device=cuda_device, dtype=torch.bfloat16)
    mask = torch.ones(2, 16, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.fused_qkv_attention(qkv, mask, 1)  # dh = 96
    with pytest.raises(TypeError, match="bf16"):
        tattn.fused_qkv_attention(qkv.float(), mask, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tattn.fused_qkv_attention(qkv.transpose(0, 1), mask.t(), 3)
    long = torch.zeros(1, 256, 3 * 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="s <="):
        tattn.fused_qkv_attention(long, torch.ones(1, 256, device=cuda_device), 1)
