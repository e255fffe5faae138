"""The tiled attention kernels' arithmetic, emulated in plain PyTorch on the
CPU, against the Pallas kernel in interpret mode and the JAX reference.

``pathway_tpu_torch/csrc/attention.cu``'s tiled kernels (every call
outside the short kernel's bf16, head_dim 32 or 64, s <= 128) run one
online softmax: they walk the keys in tiles with a running max and sum a
row, round the probabilities exp2(score - running max) to qkv's dtype
before p.v, rescale ctx in f32 when the max rises, and divide by the sum
once at the end. The TPU kernel (``pathway_tpu/ops/attention.py``
``_attn_kernel``) rounds the normalised probabilities instead. The CUDA
kernel cannot run here, so ``_tiled_attention`` below repeats its
arithmetic step by step (tile sizes, running max, rounding point, the
-1e30 and -inf biases) and is held to the TPU kernel at the kernel's own
tolerances: 2^-6 at 16 bits (one bf16 ulp at |ctx| < 4, a flipped
rounding; as tests/test_torch_ops.py), 1e-5 at f32 (sums in another
order). The emulation is used by this file only.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import attention as jattn

ATOL_16 = 2.0**-6
ATOL_F32 = 1e-5
DTYPES = {
    "bf16": (torch.bfloat16, jnp.bfloat16),
    "f16": (torch.float16, jnp.float16),
    "f32": (torch.float32, jnp.float32),
}


def _tile_keys(dtype: torch.dtype, dh: int) -> int:
    """Keys a tile, as csrc/attention.cu picks them: the 16-bit kernel's
    Wg<DHP>::BK (64 at DHP 256, else 128) and the f32 kernel's
    TiledF32<DHP>::BK (16 at DHP 256, else 32); DHP is the least of 16,
    32, 64, 96, 128, 256 that holds dh."""
    dhp = next(w for w in (16, 32, 64, 96, 128, 256) if dh <= w)
    if dtype == torch.float32:
        return 16 if dhp >= 256 else 32
    return 64 if dhp >= 256 else 128


def _tiled_attention(qkv: torch.Tensor, token_mask: torch.Tensor, n_heads: int) -> torch.Tensor:
    """The tiled kernels' online softmax in plain PyTorch: f32 products of
    qkv's values, the log2 domain, bias 0 / -1e30 (padding) / -inf (keys
    past s in the last tile), probabilities relative to the running max
    rounded to qkv's dtype before p.v (not at f32), f32 sums of the
    unrounded probabilities, ctx rescaled by exp2(old max - new max) and
    divided by the sum at the end, then rounded to qkv's dtype."""
    b, s, d3 = qkv.shape
    d = d3 // 3
    dh = d // n_heads
    bk = _tile_keys(qkv.dtype, dh)
    n_kt = -(-s // bk)
    sp = n_kt * bk
    q, k, v = (t.reshape(b, s, n_heads, dh).transpose(1, 2) for t in qkv.float().split(d, dim=-1))
    pad = (0, 0, 0, sp - s)
    k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    bias = torch.full((b, sp), -math.inf)
    bias[:, :s] = torch.where(token_mask != 0, 0.0, -1e30)
    scale_log2 = (1.0 / math.sqrt(dh)) * math.log2(math.e)
    m = torch.full((b, n_heads, s, 1), -math.inf)
    l = torch.zeros((b, n_heads, s, 1))
    o = torch.zeros((b, n_heads, s, dh))
    for t in range(n_kt):
        keys = slice(t * bk, (t + 1) * bk)
        x = (q @ k[:, :, keys].transpose(-1, -2)) * scale_log2 + bias[:, None, None, keys]
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        c = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * c + p.sum(dim=-1, keepdim=True)
        o = o * c + p.to(qkv.dtype).float() @ v[:, :, keys]
        m = m_new
    ctx = (o * (1.0 / l)).to(qkv.dtype)
    return ctx.transpose(1, 2).reshape(b, s, d)


def _case(seed: int, b: int, s: int, d: int, dtype: str):
    """Seeded unit-normal qkv (rounded to `dtype`) and a mask: random
    prefix lengths, row 0 all padding, and the last row valid only from
    key 150 on, so that its first key tile (128 keys at 16 bits) is all
    padding and is wiped by the rescale once a valid key arrives."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(b, s, 3 * d)).astype(np.float32))
    qkv = qkv.to(DTYPES[dtype][0]).float().numpy()
    lens = rng.integers(1, s + 1, b)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    mask[0] = 0
    mask[-1] = (np.arange(s) >= min(150, s - 1)).astype(np.int32)
    return qkv, mask


def _against_the_tpu_kernel(qkv, mask, h, dtype):
    tdt, jdt = DTYPES[dtype]
    atol = ATOL_F32 if dtype == "f32" else ATOL_16
    emul = _tiled_attention(torch.from_numpy(qkv).to(tdt), torch.from_numpy(mask), h)
    pallas = jattn.fused_qkv_attention(jnp.asarray(qkv, jdt), jnp.asarray(mask), h, block_b=2, interpret=True)
    ref = jattn.reference_attention(jnp.asarray(qkv, jdt), jnp.asarray(mask), h)
    assert emul.dtype == tdt and torch.isfinite(emul.float()).all()
    assert np.abs(np.asarray(ref, np.float32)).max() < 4
    np.testing.assert_allclose(emul.float().numpy(), np.asarray(pallas, np.float32), atol=atol)
    np.testing.assert_allclose(emul.float().numpy(), np.asarray(ref, np.float32), atol=atol)
    return emul


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("s", [129, 256, 300, 512])
@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_rounding_relative_to_the_running_max_holds_the_tolerance(dtype, s, dh):
    """bf16 and f16: probabilities rounded relative to the running max,
    then divided by the sum, agree with the TPU kernel's normalised
    rounding within 2^-6, across 2 to 5 key tiles, random prefix masks,
    an all-padding row and a first tile of padding only."""
    h = 2
    qkv, mask = _case(10 + s + dh, 4, s, dh * h, dtype)
    emul = _against_the_tpu_kernel(qkv, mask, h, dtype)
    # the all-padding row attends uniformly: the mean of its s keys of v
    v_mean = qkv[0, :, 2 * dh * h:].mean(axis=0)
    np.testing.assert_allclose(emul[0].float().numpy(), np.broadcast_to(v_mean, (s, dh * h)), atol=ATOL_16)


@pytest.mark.parametrize("dh", [64, 128])
def test_f32_tiled_softmax_is_the_same_function(dh):
    """f32, s 512 (16 key tiles of 32): nothing is rounded, so the online
    softmax computes the TPU kernel's function within f32 sums in another
    order (1e-5)."""
    h = 2
    qkv, mask = _case(7 + dh, 3, 512, dh * h, "f32")
    _against_the_tpu_kernel(qkv, mask, h, "f32")


def test_first_tile_of_padding_is_wiped_not_averaged():
    """A row whose first key tile is padding only: the running max starts
    at -1e30 and every padding key weighs 1 until the first valid key
    rescales them by exp2(-1e30 - max) = 0; the row then equals the
    softmax over its valid keys alone (the keys before 150 drop out)."""
    s, dh, h = 300, 64, 1
    qkv, mask = _case(3, 2, s, dh * h, "bf16")
    got = _tiled_attention(torch.from_numpy(qkv).bfloat16(), torch.from_numpy(mask), h)[-1]
    valid = torch.from_numpy(qkv[-1, 150:])
    _, k, v = valid.split(dh * h, dim=-1)
    full_q = torch.from_numpy(qkv[-1, :, : dh * h])
    probs = torch.softmax(full_q @ k.T / math.sqrt(dh), dim=-1)
    want = probs @ v
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=ATOL_16)
