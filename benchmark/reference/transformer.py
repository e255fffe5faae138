"""Plain forward passes of the two model families the cells run, in f32.

Written from the published descriptions as the port's configurations
state them (``benchmark/configs/*.json``, ``assumed``): a pre-norm block
of RMSNorm (eps 1e-6, a learned scale, no bias), full multi-head
attention through one fused qkv projection (q, k, v the first, second
and third d_model columns, heads of d_model / n_heads), a tanh-GELU
feed-forward, learned positions, and a final RMSNorm. The encoder
mean-pools its valid tokens, projects by ``head`` and L2-normalizes; the
decoder is causal and takes its logits from the tied token embedding.
The parameter tree is the one ``benchmark/weights.py`` makes.

Origin: the equations of ``pathway_tpu_torch/models/transformer.py`` at
commit a5f5f3e (``_rmsnorm`` :218, ``_attend`` :274, ``_ffn`` :329,
``forward`` :353, ``encode`` :380 with ``_pool`` :389, ``_tied_logits``
:412), written again in plain f32 without the port's rounding points,
kernels, cache or batching; no code is shared with it. They are held to
the port's CPU path at tiny widths in
``benchmark/tests/test_bench_reference.py``.

``fp8=True`` is the control: the operands of every product rounded to
float8 e4m3 under a scale that maps their largest magnitude to 448, the
products summed in f32, as fp8 GEMMs and an fp8 KV cache do: each
projection's weight (per tensor) and input (per row), and attention's q,
k, v and probabilities (per row of a head).
"""

from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def no_tf32() -> None:
    """f32 products in f32 on the card (TF32 is a lower precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: int | None) -> torch.Tensor:
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        return _fp8(x, -1) @ _fp8(w, None)
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6) * scale


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def attention(qkv: torch.Tensor, allowed: torch.Tensor, n_heads: int, fp8: bool = False) -> torch.Tensor:
    """qkv [b, s, 3d]; allowed [b, s, s] bool (query, key)."""
    b, s, d3 = qkv.shape
    d = d3 // 3
    dh = d // n_heads
    q, k, v = (t.reshape(b, s, n_heads, dh).transpose(1, 2) for t in qkv.split(d, dim=-1))
    if fp8:
        q, k, v = _fp8(q, -1), _fp8(k, -1), _fp8(v, -1)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
    scores = scores.masked_fill(~allowed[:, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    if fp8:
        probs = _fp8(probs, -1)
    return (probs @ v).transpose(1, 2).reshape(b, s, d)


def hidden(params: dict, ids: torch.Tensor, allowed: torch.Tensor, n_heads: int, fp8: bool) -> torch.Tensor:
    """Final-normed hidden states [b, s, d] for ids [b, s] (positions
    0..s-1) under the attention pattern `allowed`."""
    x = params["tok_embed"][ids] + params["pos_embed"][: ids.shape[1]][None]
    for blk in params["blocks"]:
        a = attention(linear(rmsnorm(x, blk["ln1_scale"]), blk["qkv"], fp8), allowed, n_heads, fp8)
        x = x + linear(a, blk["o"], fp8)
        h = gelu_tanh(linear(rmsnorm(x, blk["ln2_scale"]), blk["ff_in"], fp8))
        x = x + linear(h, blk["ff_out"], fp8)
    return rmsnorm(x, params["ln_f_scale"])


def encode(params: dict, rows: list[list[int]], n_heads: int, fp8: bool = False, block: int = 64) -> torch.Tensor:
    """Embeddings [n, embed_dim] of token rows of any lengths, in blocks
    of `block` rows padded to the block's longest (padding keys masked,
    padding positions left out of the mean)."""
    dev = params["tok_embed"].device
    out = []
    for i in range(0, len(rows), block):
        chunk = rows[i:i + block]
        s = max(len(r) for r in chunk)
        ids = torch.zeros((len(chunk), s), dtype=torch.long, device=dev)
        valid = torch.zeros((len(chunk), s), dtype=torch.bool, device=dev)
        for j, r in enumerate(chunk):
            ids[j, : len(r)] = torch.tensor(r, device=dev)
            valid[j, : len(r)] = True
        allowed = valid[:, None, :].expand(-1, s, -1)
        h = hidden(params, ids, allowed, n_heads, fp8)
        m = valid[..., None].float()
        pooled = (h * m).sum(1) / m.sum(1)
        e = linear(pooled, params["head"], fp8)
        out.append(e / torch.linalg.vector_norm(e, dim=-1, keepdim=True))
    return torch.cat(out)


def lm_logits(params: dict, ids: list[int], n_heads: int, fp8: bool = False) -> torch.Tensor:
    """Next-token logits [len(ids), vocab] of one sequence, causal."""
    dev = params["tok_embed"].device
    t = torch.tensor(ids, dtype=torch.long, device=dev)[None]
    s = t.shape[1]
    allowed = torch.ones((s, s), dtype=torch.bool, device=dev).tril()[None]
    h = hidden(params, t, allowed, n_heads, fp8)[0]
    return linear(h, params["tok_embed"].t(), fp8)
