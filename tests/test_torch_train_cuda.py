"""Training and the device mesh on the card, held to the same computation
on the CPU.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_train_cuda.py -q

Without a card every test skips. ``torch.mm``/``torch.bmm`` with
``out_dtype=torch.float32`` have no backward in torch 2.11 ("derivative for
aten::mm is not implemented"), so the model's f32-accumulated products
train through ``transformer._F32Matmul``; these tests hold its gradients,
a train step on the card, and the SPMD runner on shards of one card (its
streams, events and autograd through the collectives) to the CPU.
Tolerances: products and gradients within 1e-3 relative of the same f32
products on the CPU (bf16 operands are exact in f32; the sums run in
another order, and a gradient rounds to bf16 once); train steps at f32
as ``tests/test_torch_train.py`` holds them to the JAX package (losses
within 1e-5, 99.9% of the parameters within 2e-5, all within
2 * lr * steps); sharded results within 1e-5 of the unsharded ones.
"""

import numpy as np
import pytest
import torch

from pathway_tpu_torch.models import transformer as tfm
from pathway_tpu_torch.ops.attention import ring_attention
from pathway_tpu_torch.ops.topk import knn_search, knn_search_sharded
from pathway_tpu_torch.parallel import spmd
from pathway_tpu_torch.parallel.mesh import P, make_mesh

pytestmark = pytest.mark.cuda
LM = dict(vocab_size=512, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_len=64)


@pytest.fixture
def cuda_device():
    # decided when the test runs, never at import: every xdist worker
    # must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: these tests hold training and the mesh on the card to the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("batched", [False, True])
def test_f32_matmul_trains_on_the_card(cuda_device, batched):
    gen = torch.Generator().manual_seed(0)
    shape_a, shape_b = ((6, 32, 48), (6, 48, 40)) if batched else ((2, 32, 48), (48, 40))
    a = torch.randn(shape_a, generator=gen).to(torch.bfloat16)
    b = torch.randn(shape_b, generator=gen).to(torch.bfloat16)
    g = torch.randn(shape_a[:-1] + (40,), generator=gen)
    ta, tb = (t.to(cuda_device).requires_grad_() for t in (a, b))
    out = tfm._f32_matmul(ta, tb)
    assert out.dtype == torch.float32
    out.backward(g.to(cuda_device))
    ra, rb = (t.float().requires_grad_() for t in (a, b))
    ref = torch.matmul(ra, rb)
    ref.backward(g)
    torch.testing.assert_close(out.cpu(), ref.detach(), rtol=1e-3, atol=1e-3)
    assert ta.grad.dtype == tb.grad.dtype == torch.bfloat16
    torch.testing.assert_close(ta.grad.cpu().float(), ra.grad, rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(tb.grad.cpu().float(), rb.grad, rtol=1e-2, atol=1e-2)


def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    cfg = tfm.lm_config(dtype=torch.float32, **LM)
    host = tfm.init_params(torch.Generator().manual_seed(1), cfg)
    card = tfm.tree_map(lambda t: t.to(cuda_device, copy=True), host)
    ids = torch.from_numpy(np.random.default_rng(1).integers(2, cfg.vocab_size, (4, 32)))
    mask = torch.ones((4, 32), dtype=torch.int32)
    mask[1, 20:] = 0
    lr, steps = 1e-3, 3
    curves = {}
    for where, params, i, m in (("card", card, ids.to(cuda_device), mask.to(cuda_device)), ("cpu", host, ids, mask)):
        init_opt, train_step = tfm.make_train_step(cfg, learning_rate=lr)
        opt = init_opt(params)
        losses = []
        for _ in range(steps):
            params, opt, loss = train_step(params, opt, i, m)
            losses.append(float(loss))
        curves[where] = (losses, params)
    np.testing.assert_allclose(curves["card"][0], curves["cpu"][0], rtol=1e-5)
    diff = np.concatenate([
        (a.detach().cpu() - b.detach()).abs().numpy().ravel()
        for a, b in zip(tfm._leaves(curves["card"][1]), tfm._leaves(curves["cpu"][1]))
    ])
    assert (diff <= 2e-5).mean() >= 0.999 and diff.max() <= 2 * lr * steps
    # bf16 compute on f32 parameters trains through _F32Matmul
    bf = tfm.lm_config(dtype=torch.bfloat16, **LM)
    params = tfm.init_params(torch.Generator(device=cuda_device).manual_seed(2), bf)
    init_opt, train_step = tfm.make_train_step(bf, learning_rate=1e-3)
    opt = init_opt(params)
    losses = []
    for _ in range(5):
        params, opt, loss = train_step(params, opt, ids.to(cuda_device), mask.to(cuda_device))
        losses.append(float(loss))
    assert losses[-1] < losses[0] and all(np.isfinite(losses))


def test_spmd_on_shards_of_one_card(cuda_device):
    mesh = make_mesh((4,), ("seq",), [cuda_device] * 4)
    gen = torch.Generator().manual_seed(3)
    docs = torch.nn.functional.normalize(torch.randn((4096, 64), generator=gen))
    q = torch.randn((8, 64), generator=gen)
    rows = make_mesh((4,), ("data",), [cuda_device] * 4)
    want = knn_search(q.to(cuda_device), docs.to(cuda_device), 10)
    got = knn_search_sharded(q.to(cuda_device), docs.to(cuda_device), 10, "cos", rows)
    assert torch.equal(got.indices, want.indices)
    torch.testing.assert_close(got.distances, want.distances, rtol=0, atol=1e-5)
    # ring attention and its gradients through the collectives, on the
    # shards' streams, against the same computation on CPU shards
    qkv = [torch.randn((2, 64, 2, 16), generator=gen) for _ in range(3)]
    mask = torch.ones((2, 64), dtype=torch.int32)
    mask[1, 50:] = 0
    grads = {}
    for where, m in (("card", mesh), ("cpu", make_mesh((4,), ("seq",), ["cpu"] * 4))):
        dev = m.device(0)
        leaves = [t.to(dev).requires_grad_() for t in qkv]
        out = spmd.shard_map(
            lambda a, b, c, k: ring_attention(a, b, c, "seq", causal=True, kv_mask=k), m,
            in_specs=(P(None, "seq"),) * 4, out_specs=P(None, "seq"),
        )(*leaves, mask.to(dev))
        (out * out).sum().backward()
        grads[where] = [out.detach().cpu()] + [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["card"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
