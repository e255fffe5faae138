"""The port's training step, tensor-parallel model and sequence-parallel
(ring) attention, against the JAX package.

Parameters are drawn once by ``jax.random`` and carried to the port with
``models.convert.params_from_numpy``; each package then shards them with
its own ``shard_params``. Both sides run on 8 virtual CPU shards (the JAX
package's from ``tests/conftest.py``, the port's meshes built on
``["cpu"] * 8``), at f32. Tolerances: ``lm_loss`` within 1e-5 relative;
after 3 AdamW steps at learning rate 1e-2, 99.9% of the parameters
within 2e-5 and all within 2 * lr * steps (Adam turns the f32 noise of a
gradient near 0 into up to 2 * lr a step);
tensor-parallel embeddings and logits within 1e-5 of the unsharded
forward and of the JAX package's sharded model; ring attention within
2e-5 of full attention (gradients 5e-4, as tests/test_ring_attention.py
holds the JAX package), the sequence-parallel encoder within 2e-4.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as JP

from pathway_tpu.models import transformer as jtfm
from pathway_tpu.ops.attention import ring_attention as jax_ring_attention
from pathway_tpu_torch.models import transformer as ttfm
from pathway_tpu_torch.models.convert import params_from_numpy
from pathway_tpu_torch.ops.attention import ring_attention
from pathway_tpu_torch.parallel import spmd
from pathway_tpu_torch.parallel.mesh import P, make_mesh

N_DEV = 8
LM = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=12)
EMB = dict(vocab_size=128, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=64)


def _lm_pair(seed: int = 0):
    jcfg = jtfm.lm_config(dtype=jnp.float32, **LM)
    tcfg = ttfm.lm_config(dtype=torch.float32, **LM)
    jp = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _batch(seed: int = 0, b: int = 4, s: int = 12, vocab: int = 64, pad: bool = True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    if pad:
        mask[1, 9:] = 0
        mask[3, 5:] = 0
    return ids, mask


def _pairs(jtree, ttree):
    """(name, jax leaf, port leaf) over the shared tree layout."""
    for k in ttree:
        if k == "blocks":
            for i, (jb, tb) in enumerate(zip(jtree[k], ttree[k])):
                for kk in tb:
                    yield f"blocks[{i}].{kk}", np.asarray(jb[kk]), tb[kk]
        else:
            yield k, np.asarray(jtree[k]), ttree[k]


# ------------------------------------------------------------ train step


def test_lm_loss_matches_jax():
    jcfg, tcfg, jp, tp = _lm_pair()
    ids, mask = _batch()
    want = float(jtfm.lm_loss(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    got = float(ttfm.lm_loss(tp, torch.from_numpy(ids), torch.from_numpy(mask), tcfg))
    assert math.isclose(got, want, rel_tol=1e-5), (got, want)
    with pytest.raises(ValueError, match="causal"):
        ttfm.lm_loss(tp, torch.from_numpy(ids), torch.from_numpy(mask), dataclasses.replace(tcfg, causal=False))


def test_train_step_matches_jax_for_three_steps():
    """From the same carried parameters and a fresh optimizer state on
    both sides: losses within 1e-5 relative at each step, and after 3
    steps at least 99.9% of the parameters within 2e-5 and every one
    within 2 * lr * steps. Adam moves a parameter by about
    lr * m / (sqrt(v) + 1e-8) a step, so where m is near 0 the f32 noise
    of the gradient's sum (~1e-9 here, in another order on each side) is
    amplified up to 2 * lr (4 of the 20,000 parameters here, with
    gradients of 2e-9 to 6e-5). The LM's unused `head` only decays, on
    both sides."""
    jcfg, tcfg, jp, tp = _lm_pair()
    ids, mask = _batch()
    lr, steps = 1e-2, 3
    jinit, jstep = jtfm.make_train_step(jcfg, learning_rate=lr)
    tinit, tstep = ttfm.make_train_step(tcfg, learning_rate=lr)
    jopt, topt = jinit(jp), tinit(tp)
    jstep = jax.jit(jstep)
    for _ in range(steps):
        jp, jopt, jloss = jstep(jp, jopt, jnp.asarray(ids), jnp.asarray(mask))
        tp, topt, tloss = tstep(tp, topt, torch.from_numpy(ids), torch.from_numpy(mask))
        assert math.isclose(float(tloss), float(jloss), rel_tol=1e-5)
    diff = np.concatenate([np.abs(t.detach().numpy() - a).ravel() for _n, a, t in _pairs(jp, tp)])
    assert (diff <= 2e-5).mean() >= 0.999, np.sort(diff)[-10:]
    assert diff.max() <= 2 * lr * steps, diff.max()
    # a different tree passed back in is copied into the trained one
    fresh = _lm_pair()[3]
    tp2, _, _ = tstep(fresh, topt, torch.from_numpy(ids), torch.from_numpy(mask))
    assert tp2 is tp


def test_train_step_reduces_loss():
    tcfg = ttfm.lm_config(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=12)
    params = ttfm.init_params(torch.Generator().manual_seed(0), tcfg)
    init_opt, train_step = ttfm.make_train_step(tcfg, learning_rate=1e-2)
    opt = init_opt(params)
    ids = torch.from_numpy(np.random.default_rng(0).integers(2, 64, (4, 12)))
    mask = torch.ones((4, 12), dtype=torch.int32)
    losses = []
    for _ in range(5):
        params, opt, loss = train_step(params, opt, ids, mask)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in ttfm._leaves(params))  # f32 masters, bf16 compute


# ---------------------------------------------------- tensor parallelism


def test_param_specs_match_jax():
    jcfg = jtfm.embedder_config(**EMB)
    tcfg = ttfm.embedder_config(**EMB)
    jspecs, tspecs = jtfm.param_specs(jcfg), ttfm.param_specs(tcfg)
    assert set(jspecs) == set(tspecs) and len(jspecs["blocks"]) == len(tspecs["blocks"])
    for k in tspecs:
        if k == "blocks":
            for jb, tb in zip(jspecs[k], tspecs[k]):
                assert {kk: tuple(v) for kk, v in tb.items()} == {kk: tuple(v) for kk, v in jb.items()}
        else:
            assert tuple(tspecs[k]) == tuple(jspecs[k]), k


def _encoder_pair(seed: int = 1):
    jcfg = jtfm.embedder_config(dtype=jnp.float32, fused_attention=False, **EMB)
    tcfg = ttfm.embedder_config(dtype=torch.float32, **EMB)
    jp = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 8)])
def test_tensor_parallel_encoder_matches_unsharded_and_jax(shape):
    """TransformerLM.shard: every device holds only its blocks, the fused
    kernel is off, and the embeddings equal the unsharded
    fused_attention=False forward and the JAX package's sharded model."""
    jcfg, tcfg, jp, tp = _encoder_pair()
    ids, mask = _batch(1, b=8, s=16, vocab=128)
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    model = ttfm.TransformerLM(tcfg, tp, device="cpu")
    plain = ttfm.TransformerLM(dataclasses.replace(tcfg, fused_attention=False), tp, device="cpu")
    want = plain.encode(ids_t, mask_t)
    full_bytes = sum(t.numel() * 4 for t in ttfm._leaves(model.params))
    model.shard(make_mesh(shape, ("data", "model"), ["cpu"] * N_DEV))
    assert model.cfg.fused_attention is False and len(model.top) == 0
    got = model.encode(ids_t, mask_t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    per = model.shard_bytes()
    assert len(per) == N_DEV and max(per) < full_bytes
    jm = jtfm.TransformerLM(jcfg)
    jm.params = jp
    jm.shard(JaxMesh(np.asarray(jax.devices()[:N_DEV]).reshape(shape), ("data", "model")))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.encode(jnp.asarray(ids), jnp.asarray(mask))), atol=1e-5)


def test_tensor_parallel_logits_match_unsharded_and_jax():
    jcfg, tcfg, jp, tp = _lm_pair(2)
    ids, mask = _batch(2, b=4, s=12)
    model = ttfm.TransformerLM(tcfg, tp, device="cpu")
    want = model.logits(torch.from_numpy(ids), torch.from_numpy(mask))
    model.shard(make_mesh((2, 4), ("data", "model"), ["cpu"] * N_DEV))
    got = model.logits(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    jm = jtfm.TransformerLM(jcfg)
    jm.params = jp
    jm.shard(JaxMesh(np.asarray(jax.devices()[:N_DEV]).reshape(2, 4), ("data", "model")))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.logits(jnp.asarray(ids), jnp.asarray(mask))), atol=1e-5)


def test_shard_needs_a_model_axis_and_divisible_blocks():
    _, tcfg, _, tp = _encoder_pair()
    with pytest.raises(ValueError, match="'model' mesh axis"):
        ttfm.TransformerLM(tcfg, tp, device="cpu").shard(make_mesh((N_DEV,), ("data",), ["cpu"] * N_DEV))
    with pytest.raises(ValueError, match="does not split"):
        ttfm.shard_params(tp, make_mesh((1, 3), ("data", "model"), ["cpu"] * 3), tcfg)


# ------------------------------------------------------ ring attention


def _jax_mesh(n=N_DEV, axis="seq"):
    return JaxMesh(np.asarray(jax.devices()[:n]), (axis,))


def _full_attention(q, k, v, mask, causal):
    s = q.shape[1]
    scores = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    valid = mask[:, None, None, :].astype(bool)
    if causal:
        valid = valid & np.tril(np.ones((s, s), bool))[None, None]
    scores = np.where(valid, scores, -np.inf)
    mx = scores.max(-1, keepdims=True)
    p = np.where(valid, np.exp(scores - np.where(np.isfinite(mx), mx, 0)), 0.0)
    p = p / np.maximum(p.sum(-1, keepdims=True), 1e-30)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


def _qkvm(seed, b, s, h, dh):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, h, dh)).astype(np.float32) for _ in range(3))
    mask = rng.integers(0, 2, (b, s)).astype(np.int32)
    mask[:, 0] = 1
    return q, k, v, mask


@pytest.mark.parametrize("causal", [False, True])
def test_ring_equals_full(causal):
    q, k, v, mask = _qkvm(0, 2, 64, 4, 16)  # 8 blocks of 8
    mesh = make_mesh((N_DEV,), ("seq",), ["cpu"] * N_DEV)
    got = spmd.shard_map(
        lambda q_, k_, v_, m_: ring_attention(q_, k_, v_, "seq", causal=causal, kv_mask=m_),
        mesh, in_specs=(P(None, "seq"),) * 4, out_specs=P(None, "seq"),
    )(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), _full_attention(q, k, v, mask, causal), atol=2e-5)
    ref = jax.jit(jax.shard_map(
        lambda q_, k_, v_, m_: jax_ring_attention(q_, k_, v_, "seq", causal=causal, kv_mask=m_),
        mesh=_jax_mesh(), in_specs=(JP(None, "seq"),) * 4, out_specs=JP(None, "seq"),
    ))(q, k, v, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_ring_gradients_flow():
    q, k, v, _ = _qkvm(1, 1, 32, 2, 8)
    mask = np.ones((1, 32), np.int32)
    mesh = make_mesh((N_DEV,), ("seq",), ["cpu"] * N_DEV)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = spmd.shard_map(
        lambda a, b_, c, m: ring_attention(a, b_, c, "seq", kv_mask=m),
        mesh, in_specs=(P(None, "seq"),) * 4, out_specs=P(None, "seq"),
    )(tq, tk, tv, torch.from_numpy(mask))
    (out * out).sum().backward()

    def loss_full(q_, k_, v_):
        s = jnp.einsum("bqhd,bkhd->bhqk", q_, k_) / np.sqrt(q_.shape[-1])
        o = jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v_)
        return jnp.sum(o * o)

    want = jax.grad(loss_full, argnums=(0, 1, 2))(q, k, v)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4)


def test_sequence_parallel_encoder_matches_single_device():
    """encode() under shard_map with cfg.seq_axis equals the full-sequence
    encode, and the JAX package's sequence-parallel encode."""
    jcfg, tcfg, jp, tp = _encoder_pair(0)
    tcfg = dataclasses.replace(tcfg, fused_attention=False)
    ids = np.random.default_rng(2).integers(2, 128, (2, 64)).astype(np.int32)
    mask = np.ones((2, 64), np.int32)
    mask[1, 40:] = 0
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    want = ttfm.encode(tp, ids_t, mask_t, tcfg)
    sp = dataclasses.replace(tcfg, seq_axis="seq")
    mesh = make_mesh((N_DEV,), ("seq",), ["cpu"] * N_DEV)
    got = spmd.shard_map(
        lambda p, i, m: ttfm.encode(p, i, m, sp), mesh,
        in_specs=(P(), P(None, "seq"), P(None, "seq")), out_specs=P(),
    )(tp, ids_t, mask_t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4)
    jsp = dataclasses.replace(jcfg, seq_axis="seq")
    ref = jax.jit(jax.shard_map(
        lambda p, i, m: jtfm.encode(p, i, m, jsp), mesh=_jax_mesh(),
        in_specs=(JP(), JP(None, "seq"), JP(None, "seq")), out_specs=JP(),
    ))(jp, jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)


def test_sequence_parallel_guards():
    _, tcfg, _, tp = _encoder_pair(0)
    mesh = make_mesh((N_DEV,), ("seq",), ["cpu"] * N_DEV)
    ids = torch.ones((1, 128), dtype=torch.int64)  # 8 blocks x 16 > max_len 64
    sp = dataclasses.replace(tcfg, seq_axis="seq", fused_attention=False)
    with pytest.raises(ValueError, match="exceeds max_len"):
        spmd.shard_map(lambda p, i, m: ttfm.encode(p, i, m, sp), mesh,
                       in_specs=(P(), P(None, "seq"), P(None, "seq")), out_specs=P())(tp, ids, ids)
    with pytest.raises(NotImplementedError, match="mean pooling"):
        spmd.shard_map(lambda p, i, m: ttfm.encode(p, i, m, dataclasses.replace(sp, pool="cls")), mesh,
                       in_specs=(P(), P(None, "seq"), P(None, "seq")), out_specs=P())(tp, ids[:, :64], ids[:, :64])
