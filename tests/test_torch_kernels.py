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


def _qkv_case(seed: int, b: int, s: int, d: int, suffix: bool = False):
    """Unit-normal qkv and random lengths: each row's first `len` keys
    valid, or with `suffix` its last `len` (rows that start with padding,
    a whole first key tile of it where len < s - 128)."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, s, 3 * d)).astype(np.float32)
    lens = rng.integers(1, s + 1, b)
    lens[0] = 0  # one row whose keys are all padding (bucket padding makes these)
    pos = np.arange(s)[None, :]
    mask = (pos >= s - lens[:, None]) if suffix else (pos < lens[:, None])
    return qkv, mask.astype(np.int32)


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
# dh 64, ragged s at both head dims, and odd batch and head counts; then the
# tiled kernels: s past 128 (one key past two tiles, the s 256 and s 512
# buckets, a long ragged s), and head_dim 8 (zero-padded into 16), 96, 128
# and 256; then the edges of their 128-query work items and 128-key tiles
# at dh 64 (s 127, 128, 255, 257; bf16 takes the short kernel at s <= 128,
# f16 and f32 the tiled ones), a ragged s at dh 256 (64-key tiles) and at
# dh 96 (three 32-column sub-tiles); then the any-width kernel: head_dim
# 1, 4, 12, 20 (off the multiples of 8: heads at 2-byte offsets), 264 and
# 320 (past 256), at ragged s and odd batches; then the edges of its
# branches (tests/test_torch_ops.py's ODD_SHAPES): s 128 and 129 at dh 12,
# 20 and 36 (one pass with the scores in registers, then not), s 256 and
# 257 at dh 320 (one pass with the scores in shared memory, then two);
# narrow blocks whose 4 or 2 heads do not divide the row's 6 or 5 (the
# second with rows of 600 bytes, not a multiple of 16); and past s 256, dh
# 480 and 488, 640 and 648, 288 and 296, 352 and 360, where the wide
# heads' key-tile stages or queries a block step down; and batches of 200
# to 600 rows at dh 12, 20 and 36 and s <= 128, where each block of the
# persistent one-pass grid takes several items through both its buffers;
# and dh 2192 and 2200, 1648 and 1656, the widest heads whose q stays
# whole beside a key tile at 16 bits and at f32, and one step past each,
# where q.k^T takes q and k in column chunks; the wide heads' steps at s
# 300 take the one pass with the scores in shared memory for s <= 512 (64
# queries a block, a row's keys split over two warps), so they are here
# again at s 600, where the two passes take them; and s 512 and 513 at dh
# 320 (the last that the one pass takes, then two)
CARD_SHAPES = [
    (64, 64, 384, 6), (32, 128, 256, 8), (8, 16, 64, 2),
    (5, 16, 192, 3), (7, 32, 128, 2), (16, 128, 384, 6),
    (16, 40, 384, 6), (16, 40, 256, 8), (9, 100, 384, 6), (9, 100, 256, 8),
    (3, 1, 64, 2), (4, 17, 96, 3),
    (8, 129, 512, 8), (4, 256, 512, 8), (4, 512, 512, 8), (2, 1000, 384, 6),
    (8, 100, 16, 2), (8, 100, 96, 1), (8, 200, 256, 2), (4, 300, 512, 2),
    (4, 127, 512, 8), (4, 128, 512, 8), (4, 255, 512, 8), (4, 257, 512, 8),
    (4, 77, 512, 2), (4, 131, 768, 8),
    (5, 20, 2, 2), (5, 33, 8, 2), (6, 77, 36, 3), (4, 130, 40, 2), (3, 70, 264, 1), (2, 200, 640, 2),
    (4, 128, 96, 8), (4, 129, 96, 8), (4, 128, 160, 8), (4, 129, 160, 8), (3, 128, 72, 2), (3, 129, 72, 2),
    (2, 256, 320, 1), (2, 257, 320, 1), (3, 50, 72, 6), (3, 77, 100, 5),
    (2, 300, 480, 1), (2, 300, 488, 1), (2, 300, 640, 1), (2, 300, 648, 1),
    (2, 300, 288, 1), (2, 300, 296, 1), (2, 300, 352, 1), (2, 300, 360, 1),
    (600, 100, 96, 8), (300, 128, 160, 8), (200, 120, 72, 2),
    (2, 300, 2192, 1), (2, 300, 2200, 1), (2, 300, 1648, 1), (2, 300, 1656, 1),
    (2, 600, 480, 1), (2, 600, 488, 1), (2, 600, 640, 1), (2, 600, 648, 1),
    (2, 600, 288, 1), (2, 600, 296, 1), (2, 600, 352, 1), (2, 600, 360, 1),
    (2, 600, 2192, 1), (2, 600, 2200, 1), (2, 600, 1648, 1), (2, 600, 1656, 1),
    (3, 512, 640, 2), (3, 513, 640, 2),
]
# every dtype the kernel takes, and its bound against the plain version:
# one bf16 ulp at |ctx| < 4 for the 16-bit types (a flipped rounding), the
# f32 sums in another order at f32 (TF32 off in the plain version)
CARD_DTYPES = {"bf16": (torch.bfloat16, 2.0**-6), "f16": (torch.float16, 2.0**-6), "f32": (torch.float32, 1e-5)}


def _check_on_card(cuda_device, b, s, d, h, seed, dtype, suffix=False):
    torch_dtype, atol = CARD_DTYPES[dtype]
    qkv, mask = _qkv_case(seed, b, s, d, suffix)
    q = torch.from_numpy(qkv).to(cuda_device, torch_dtype)
    m = torch.from_numpy(mask).to(cuda_device)
    _build.reset_launch_counts()
    out = tattn.fused_qkv_attention(q, m, h)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[tattn.KERNEL] == 1 and out.dtype == torch_dtype
    ref = tattn.reference_attention(q, m, h)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= atol
    # row 0 is all padding: the mean of its s keys of v
    v_mean = q[0, :, 2 * d:].float().mean(dim=0)
    assert (out[0].float() - v_mean).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [4, 5, 6])
@pytest.mark.parametrize("b,s,d,h", CARD_SHAPES)
def test_kernel_matches_plain_on_card(cuda_device, b, s, d, h, seed):
    """On the card: the kernel against the plain version, bf16, with
    random padding and an all-padding row; one bf16 ulp at |ctx| < 4."""
    _check_on_card(cuda_device, b, s, d, h, seed, "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f16", "f32"])
@pytest.mark.parametrize("b,s,d,h", CARD_SHAPES)
def test_kernel_matches_plain_on_card_in_f16_and_f32(cuda_device, b, s, d, h, dtype):
    """The same in f16 and f32: the kernel takes qkv's dtype and writes
    ctx in it, as the TPU kernel does."""
    _check_on_card(cuda_device, b, s, d, h, 7, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f16", "f32"])
@pytest.mark.parametrize(
    "b,s,d,h",
    [(8, 100, 384, 6), (8, 300, 512, 8), (4, 512, 512, 8), (4, 200, 512, 2), (4, 200, 36, 3),
     (4, 128, 96, 8), (4, 129, 160, 8), (2, 300, 648, 1)],
)
def test_kernel_matches_plain_on_card_with_suffix_masks(cuda_device, b, s, d, h, dtype):
    """Masks that hold each row's last keys: rows start with padding, a
    whole first key tile of it at s 300 and 512 (the tiled kernels'
    running max starts at -1e30 there and must be wiped by the rescale
    once a valid key arrives, not averaged in)."""
    _check_on_card(cuda_device, b, s, d, h, 8, dtype, suffix=True)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "s,d,h",
    [(64, 384, 6), (128, 256, 8), (40, 128, 2), (256, 512, 8), (1000, 64, 2), (128, 96, 8), (129, 160, 8),
     (100, 648, 1)],
)
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
    """What the kernel does not take raises, naming the plain route where
    there is one: a dtype other than bf16, f16 and f32, a strided qkv, a
    base pointer off the 16-byte grid, a mask on another device. dh 96,
    f32 and s 256, which raised before the tiled kernel, and dh 12 and
    264, which raised before the any-width kernel, are served (the
    matches above at their widths)."""
    mask = torch.ones(2, 16, dtype=torch.int32, device=cuda_device)
    wide = torch.zeros(2, 16, 3 * 264, device=cuda_device, dtype=torch.bfloat16)
    odd = torch.zeros(2, 16, 3 * 36, device=cuda_device, dtype=torch.bfloat16)
    qkv = torch.zeros(2, 16, 3 * 96, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16, f16 or f32.*fused_attention=False"):
        tattn.fused_qkv_attention(qkv.double(), mask, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tattn.fused_qkv_attention(qkv.transpose(0, 1), mask.t(), 3)
    shifted = torch.zeros(qkv.numel() + 1, device=cuda_device, dtype=torch.bfloat16)[1:].view(qkv.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn.fused_qkv_attention(shifted, mask, 3)
    with pytest.raises(ValueError, match="token_mask"):
        tattn.fused_qkv_attention(qkv, mask.cpu(), 3)
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.fused_qkv_attention(qkv.to("meta"), mask.to("meta"), 3)
    long = torch.zeros(1, 256, 3 * 64, device=cuda_device, dtype=torch.float16)
    _build.reset_launch_counts()
    for served, heads in ((qkv, 1), (qkv.float(), 3), (long, 2), (wide, 1), (odd, 3)):
        out = tattn.fused_qkv_attention(served, torch.ones(served.shape[:2], device=cuda_device), heads)
        assert out.dtype == served.dtype
    torch.cuda.synchronize()
    assert _build.LAUNCHES[tattn.KERNEL] == 5
