"""Fused multi-head attention over the fused qkv projection.

Counterpart of ``pathway_tpu/ops/attention.py``. The flagship embedder
runs many short sequences (RAG chunks, s <= 128) at large batch; the
attention of each encoder layer takes the fused projection qkv
[b, s, 3d] and returns ctx [b, s, d].

``fused_qkv_attention`` launches the hand-written Hopper kernel
``pathway_tpu_torch/csrc/attention.cu`` on a CUDA tensor. It replaces the
TPU kernel ``pathway_tpu/ops/attention.py:_attn_kernel`` and keeps its
device-memory contract: qkv is read once, ctx written once, and no
[b, h, s, s] tensor reaches device memory. The kernel is bound by bytes
on the H100 (PERF.md gives the bound per shape); the source's header
says what its design does about that. On a CPU tensor the wrapper runs
``reference_attention``, the plain version the tests and
``chip_smoke.py`` hold the kernel against.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pathway_tpu_torch.ops import _build

KERNEL = "fused_qkv_attention"
MAX_SEQ = 128  # csrc/attention.cu kMaxSeq
HEAD_DIMS = (32, 64)  # the kernel's instantiations

_lib: ctypes.CDLL | None = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("attention")
        fn = lib.pw_fused_qkv_attention_bf16
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def fused_qkv_attention(
    qkv: torch.Tensor,  # [b, s, 3*d] fused projection output
    token_mask: torch.Tensor,  # [b, s] 1/0
    n_heads: int,
) -> torch.Tensor:
    """Bidirectional MHA over a fused qkv tensor; returns ctx [b, s, d].

    A CUDA tensor launches the kernel (bf16, contiguous, s <= 128,
    head_dim 32 or 64; anything else raises). A CPU tensor runs
    :func:`reference_attention`.
    """
    if qkv.device.type == "cpu":
        return reference_attention(qkv, token_mask, n_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention: unsupported device {qkv.device}")
    if qkv.dim() != 3 or qkv.shape[2] % 3 != 0:
        raise ValueError(f"qkv must be [b, s, 3*d], got {tuple(qkv.shape)}")
    b, s, d3 = qkv.shape
    d = d3 // 3
    if d % n_heads != 0:
        raise ValueError(f"d_model {d} is not divisible by n_heads {n_heads}")
    dh = d // n_heads
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the attention kernel takes bf16 qkv, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("the attention kernel takes a contiguous qkv")
    if qkv.data_ptr() % 16 != 0:
        raise ValueError("the attention kernel needs a 16-byte aligned qkv")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes head_dim in {HEAD_DIMS}, got {dh}")
    if not 1 <= s <= MAX_SEQ:
        raise ValueError(f"the attention kernel takes 1 <= s <= {MAX_SEQ}, got {s}")
    if b * n_heads >= 2**31:
        raise ValueError(f"batch {b} x {n_heads} heads exceeds the kernel's grid")
    if tuple(token_mask.shape) != (b, s) or token_mask.device != qkv.device:
        raise ValueError(
            f"token_mask must be [{b}, {s}] on {qkv.device}, got "
            f"{tuple(token_mask.shape)} on {token_mask.device}"
        )
    mask = token_mask.to(torch.int32).contiguous()
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    lib = _kernel_lib()
    with torch.cuda.device(qkv.device):
        rc = lib.pw_fused_qkv_attention_bf16(
            qkv.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, s, d, n_heads, 1.0 / math.sqrt(dh),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"attention kernel launch failed with CUDA error {rc} "
            f"(b={b}, s={s}, d={d}, n_heads={n_heads})"
        )
    _build.count_launch(KERNEL)
    return out


def reference_attention(
    qkv: torch.Tensor, token_mask: torch.Tensor, n_heads: int
) -> torch.Tensor:
    """Plain PyTorch attention over the same fused-qkv contract.

    Same rounding points as the JAX reference: scores and the value
    contraction accumulate in f32 (bf16 products are exact in f32),
    padding keys get -1e30, the softmax is f32, and the probabilities
    and ctx round to qkv's dtype.
    """
    b, s, d3 = qkv.shape
    d = d3 // 3
    dh = d // n_heads
    q, k, v = (t.reshape(b, s, n_heads, dh) for t in qkv.float().split(d, dim=-1))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    scores = scores.masked_fill(token_mask[:, None, None, :] == 0, -1e30)
    probs = torch.softmax(scores, dim=-1).to(qkv.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v).to(qkv.dtype)
    return ctx.reshape(b, s, d)
