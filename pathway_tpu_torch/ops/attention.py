"""Fused multi-head attention over the fused qkv projection.

Counterpart of ``pathway_tpu/ops/attention.py``. An encoder's attention
takes the fused projection qkv [b, s, 3d] and returns ctx [b, s, d]: the
flagship embedder at many short sequences (RAG chunks, s <= 128) and
large batch, a RAG ingest of 500-token chunks at s 256 and 512.

``fused_qkv_attention`` launches the hand-written Hopper kernel
``pathway_tpu_torch/csrc/attention.cu`` on a CUDA tensor. It replaces the
TPU kernel ``pathway_tpu/ops/attention.py:_attn_kernel`` over that
kernel's whole contract (qkv in bf16, f16 or f32, its probabilities
rounded to qkv's dtype; any s; any head width) and keeps its
device-memory contract: qkv is read once, ctx written once, and no
[b, h, s, s] tensor reaches device memory. Four kernels sit behind the
one entry point: a short kernel that holds a whole row of keys (bf16,
head_dim 32 or 64, s <= 128); for the other head widths that are
multiples of 8 up to 256, two tiled kernels that take 128 queries a
block and stream the head's keys once in tiles with an online softmax
(one exp2 and one q.k^T a score): ``wgmma`` products fed by TMA copies
for bf16 and f16, and 3xTF32 ``mma.sync`` products for f32; and for
every other head width (dh 12, dh 320) an any-width family at the TPU
kernel's rounding point (the exact row max and sum, then the normalised
probabilities rounded to qkv's dtype): one pass with the scores in
registers (s <= 128, dh <= 128; narrow heads share a block), one pass
with the probabilities in shared memory (s <= 512), two passes past
that; bf16/f16 ``mma.sync`` products, heads copied by ``cp.async`` in
the widest copy their width allows. The tiled kernels round the
probabilities to qkv's dtype relative to the running max, before the
division by the row sum, where the TPU kernel rounds the normalised
probabilities; the two agree to the order of one flipped rounding
(``tests/test_torch_attention_tiling.py``). The kernel is bound by bytes
at the encoders' shapes, and by bytes and exponentials together at s 512
(PERF.md gives the bound per shape); the source's header says what its
design does about that. On a CPU tensor the wrapper runs ``reference_attention``, the
plain version the tests and ``chip_smoke.py`` hold the kernel against.

``ring_attention`` is the sequence-parallel attention of the JAX
package's ``seq_axis`` encoders: an XLA program there, plain PyTorch
here, run inside ``parallel/spmd.py:shard_map`` with the sequence cut
over a mesh axis.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pathway_tpu_torch.ops import _build

KERNEL = "fused_qkv_attention"
# qkv dtypes the kernel takes, by the code its C entry point reads
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_BLOCK_QUERIES = 128  # queries a work item (a block) of the tiled kernels
# what an encoder outside the kernel's envelope sets instead
_PLAIN_ROUTE = "; set fused_attention=False in the TransformerConfig to run the plain attention"

_lib: ctypes.CDLL | None = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("attention")
        fn = lib.pw_fused_qkv_attention
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
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
    """Bidirectional MHA over a fused qkv tensor; returns ctx [b, s, d]
    in qkv's dtype.

    A CUDA tensor launches the kernel: qkv bf16, f16 or f32, contiguous
    and 16-byte aligned, any s >= 1, any head_dim; anything else raises.
    A CPU tensor runs :func:`reference_attention`.
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
    if qkv.dtype not in _DTYPES:
        raise TypeError(
            f"the attention kernel takes bf16, f16 or f32 qkv, got {qkv.dtype}{_PLAIN_ROUTE}"
        )
    if not qkv.is_contiguous():
        raise ValueError("the attention kernel takes a contiguous qkv")
    if qkv.data_ptr() % 16 != 0:
        raise ValueError("the attention kernel needs a 16-byte aligned qkv")
    if b < 1 or s < 1:
        raise ValueError(f"the attention kernel takes b >= 1 and s >= 1, got b={b}, s={s}")
    if b * n_heads * -(-s // _BLOCK_QUERIES) >= 2**31:
        # the tiled kernels' work items (row, head, 128 queries) are counted in 32 bits
        raise ValueError(f"batch {b} x {n_heads} heads x s {s} exceeds the kernel's grid")
    if tuple(token_mask.shape) != (b, s) or token_mask.device != qkv.device:
        raise ValueError(
            f"token_mask must be [{b}, {s}] on {qkv.device}, got "
            f"{tuple(token_mask.shape)} on {token_mask.device}"
        )
    mask = token_mask.to(torch.int32).contiguous()
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    lib = _kernel_lib()
    with torch.cuda.device(qkv.device):
        rc = lib.pw_fused_qkv_attention(
            qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), _DTYPES[qkv.dtype],
            b, s, d, n_heads, 1.0 / math.sqrt(dh),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"attention kernel launch failed with {_launch_error(rc)} "
            f"(b={b}, s={s}, d={d}, n_heads={n_heads}, {qkv.dtype})"
        )
    _build.count_launch(KERNEL, s)
    return out


# the C entry point's codes past CUDA's own (csrc/attention.cu)
_NO_ENCODER, _TENSOR_MAP_ERROR = 999, 1000


def _launch_error(rc: int) -> str:
    if rc == _NO_ENCODER:
        return "no tensor-map encoder in the CUDA driver"
    if rc >= _TENSOR_MAP_ERROR:
        return f"a tensor map the driver refused (CUresult {rc - _TENSOR_MAP_ERROR})"
    return f"CUDA error {rc}"


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


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name: str,
    *,
    causal: bool = False,
    kv_mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Exact multi-head attention over a sequence sharded on `axis_name`.

    Call inside a ``shard_map`` body with q/k/v [b, s_local, h, dh]
    holding this shard's block of the sequence (the global sequence is
    the blocks in axis order). `kv_mask` [b, s_local] marks the valid keys
    of the local block and travels with its K/V. The K/V blocks rotate
    around the ring (``spmd.ppermute``, n - 1 rotations after the local
    block) while each shard folds them into a streaming softmax in f32:
    a running max `m`, normaliser `l` and unnormalised output `o`, so no
    shard holds more than [b, h, s_local, s_local] scores. Returns ctx
    [b, s_local, h, dh] in q's dtype. A query with no valid key at all
    gets zeros, as in the JAX package."""
    from pathway_tpu_torch.parallel import spmd

    n = spmd.axis_size(axis_name)
    my = spmd.axis_index(axis_name)
    b, s_loc, h, dh = q.shape
    sc = scale if scale is not None else 1.0 / math.sqrt(dh)
    qf = q.float()
    ar = torch.arange(s_loc, device=q.device)
    q_pos = my * s_loc + ar

    def accumulate(o, m, l, kblk, vblk, mblk, i):
        src = (my - i) % n  # the block currently held
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, kblk.float()) * sc
        valid = mblk[:, None, None, :].bool()
        if causal:
            k_pos = src * s_loc + ar
            valid = valid & (q_pos[:, None] >= k_pos[None, :])[None, None]
        scores = torch.where(valid, scores, -math.inf)
        new_m = torch.maximum(m, scores.amax(dim=-1))
        # a row with no valid key so far keeps m = -inf; exp(-inf - -inf)
        # would be NaN, so such rows contribute 0
        safe_m = torch.where(torch.isfinite(new_m), new_m, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        p = torch.where(torch.isfinite(scores), torch.exp(scores - safe_m[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vblk.float())
        return o, new_m, l

    o = qf.new_zeros((b, h, s_loc, dh))
    l = qf.new_zeros((b, h, s_loc))
    m = torch.full_like(l, -math.inf)
    mblk = kv_mask if kv_mask is not None else torch.ones((b, s_loc), dtype=torch.int32, device=q.device)
    o, m, l = accumulate(o, m, l, k, v, mblk, 0)  # the local block
    ring = [(j, (j + 1) % n) for j in range(n)]
    kblk, vblk = k, v
    for i in range(1, n):
        kblk = spmd.ppermute(kblk, axis_name, ring)
        vblk = spmd.ppermute(vblk, axis_name, ring)
        mblk = spmd.ppermute(mblk, axis_name, ring)
        o, m, l = accumulate(o, m, l, kblk, vblk, mblk, i)
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)
