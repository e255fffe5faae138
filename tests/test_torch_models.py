"""Parity of the port's encoder, tokenizer, parameter bridge and device
plane with the JAX package, on the CPU at a small size.

Parameters are drawn once by ``jax.random`` and carried across with
``params_from_numpy``: a ``torch.Generator`` draws other numbers.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.engine import device_plane as jplane
from pathway_tpu.models import transformer as jtfm
from pathway_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from pathway_tpu_torch.engine import device_plane as tplane
from pathway_tpu_torch.models import convert
from pathway_tpu_torch.models import transformer as ttfm
from pathway_tpu_torch.models.tokenizer import HashTokenizer

SMALL = dict(vocab_size=128, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=32, embed_dim=48)


def _configs(pool: str = "mean", dtype: str = "f32"):
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    return (
        jtfm.embedder_config(pool=pool, dtype=jd, **SMALL),
        ttfm.embedder_config(pool=pool, dtype=td, **SMALL),
    )


def _inputs(seed: int, b: int = 6, s: int = 32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, SMALL["vocab_size"], (b, s)).astype(np.int32)
    lens = rng.integers(1, s + 1, b)
    lens[0] = s
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    return ids, mask


def _jax_params(jcfg, seed: int = 0):
    return jtfm.init_params(jax.random.PRNGKey(seed), jcfg)


def _port_encode(params, tcfg, ids, mask):
    return ttfm.encode(
        params, torch.from_numpy(ids).long(), torch.from_numpy(mask), tcfg
    ).numpy()


# ------------------------------------------------------------- tokenizer


def test_tokenizer_ids_and_masks_identical():
    texts = [
        "Hello, world!", "", "a b c d e f g h i j k l m n o p q r s t u v",
        "Pathway streams; TPUs & GPUs 2026", "ünïcödé wörds and ASCII",
    ]
    for vocab, max_len in [(32768, 128), (1024, 8)]:
        port = HashTokenizer(vocab_size=vocab, max_len=max_len)
        ref = JaxHashTokenizer(vocab_size=vocab, max_len=max_len)
        for pad_to in (None, 16):
            pi, pm = port.batch(texts, pad_to=pad_to)
            ri, rm = ref.batch(texts, pad_to=pad_to)
            np.testing.assert_array_equal(pi, ri)
            np.testing.assert_array_equal(pm, rm)
            assert pi.dtype == ri.dtype == np.int32


# --------------------------------------------------------------- encoder


@pytest.mark.parametrize("pool", ["mean", "cls", "last"])
def test_encode_f32_matches_jax(pool):
    """f32 end to end: the same products and sums in another order;
    atol 1e-4 on unit-norm embeddings."""
    jcfg, tcfg = _configs(pool)
    jp = _jax_params(jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    ids, mask = _inputs(0)
    ref = np.asarray(jtfm.encode(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    got = _port_encode(tp, tcfg, ids, mask)
    assert got.shape == (6, 48) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_forward_f32_matches_jax():
    jcfg, tcfg = _configs()
    jp = _jax_params(jcfg, seed=1)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    ids, mask = _inputs(1)
    ref = np.asarray(jtfm.forward(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    got = ttfm.forward(tp, torch.from_numpy(ids).long(), torch.from_numpy(mask), tcfg)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_encode_bf16_after_cast_params_matches_jax():
    """bf16 weights and activations: both round every product once, but
    the GELU sees the rounded product in the port (the f32 sum in JAX)
    and the mean-pool sums bf16 in another order. Bound: cosine >= 0.999
    per row and atol 2e-2 per component of the unit-norm embedding."""
    jcfg, tcfg = _configs(dtype="bf16")
    jp = jtfm.cast_params(_jax_params(jcfg, seed=2))
    tp = ttfm.cast_params(
        convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    )
    assert tp["blocks"][0]["qkv"].dtype == torch.bfloat16
    ids, mask = _inputs(2)
    ref = np.asarray(jtfm.encode(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    got = _port_encode(tp, tcfg, ids, mask)
    cos = np.sum(got * ref, axis=1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
    assert cos.min() >= 0.999, cos
    np.testing.assert_allclose(got, ref, atol=2e-2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encode_ignores_padding(dtype):
    """Tokens under a zero mask do not reach the embedding (cf. the JAX
    package's test_encoder_mask_ignores_padding); exact here, since the
    padded keys' probabilities are exactly 0."""
    _jcfg, tcfg = _configs(dtype=dtype)
    model = ttfm.TransformerEncoder(tcfg, device="cpu", generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    base = rng.integers(2, 128, (1, 32)).astype(np.int32)
    mask = np.ones((1, 32), np.int32)
    mask[0, 8:] = 0
    garbage = base.copy()
    garbage[0, 8:] = rng.integers(2, 128, 24)
    e1 = model(torch.from_numpy(base).long(), torch.from_numpy(mask))
    e2 = model(torch.from_numpy(garbage).long(), torch.from_numpy(mask))
    torch.testing.assert_close(e1, e2, rtol=0, atol=1e-6)
    np.testing.assert_allclose(torch.linalg.norm(e1, dim=1).numpy(), [1.0], atol=1e-5)


def test_encoder_module_matches_functional_encode():
    jcfg, tcfg = _configs()
    tp = convert.params_from_numpy(
        jax.tree.map(np.asarray, _jax_params(jcfg, 3)), tcfg, device="cpu"
    )
    model = ttfm.TransformerEncoder(tcfg, tp, device="cpu")
    ids, mask = _inputs(3)
    got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, _port_encode(tp, tcfg, ids, mask))
    assert model.device == torch.device("cpu")
    assert not any(p.requires_grad for p in model.parameters())


def test_init_params_shapes_and_determinism():
    _jcfg, tcfg = _configs()
    a = ttfm.init_params(torch.Generator().manual_seed(5), tcfg)
    b = ttfm.init_params(torch.Generator().manual_seed(5), tcfg)
    shapes = convert.param_shapes(tcfg)
    assert tuple(a["tok_embed"].shape) == shapes["tok_embed"]
    assert len(a["blocks"]) == tcfg.n_layers
    for blk, want in zip(a["blocks"], shapes["blocks"]):
        assert {k: tuple(v.shape) for k, v in blk.items()} == want
    torch.testing.assert_close(a["head"], b["head"], rtol=0, atol=0)
    # the same scales as the JAX package's initializer
    assert abs(float(a["tok_embed"].std()) - 0.02) < 0.002


def test_params_from_numpy_rejects_mismatched_trees():
    jcfg, tcfg = _configs()
    tree = jax.tree.map(np.asarray, _jax_params(jcfg))
    other = ttfm.embedder_config(**{**SMALL, "d_ff": 96})
    with pytest.raises(ValueError, match="ff_in"):
        convert.params_from_numpy(tree, other, device="cpu")
    short = {**tree, "blocks": tree["blocks"][:1]}
    with pytest.raises(ValueError, match="blocks"):
        convert.params_from_numpy(short, tcfg, device="cpu")
    extra = {**tree, "lm_head": tree["head"]}
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_numpy(extra, tcfg, device="cpu")


def test_config_guards():
    with pytest.raises(ValueError, match="pool"):
        ttfm.TransformerConfig(pool="menu")
    with pytest.raises(ValueError, match="divisible"):
        ttfm.TransformerConfig(d_model=30, n_heads=4)
    _jcfg, tcfg = _configs()
    model = ttfm.TransformerEncoder(tcfg, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        model(torch.ones((1, 40), dtype=torch.long), torch.ones((1, 40), dtype=torch.int32))


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _jcfg, tcfg = _configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttfm.TransformerEncoder(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy({}, tcfg)
    assert tplane.resolve_device("cpu") == torch.device("cpu")


# ----------------------------------------------------------- device plane


def test_bucket_policy_matches_jax():
    port, ref = tplane.BucketPolicy(), jplane.BucketPolicy()
    for n in [1, 7, 8, 9, 100, 1000, 4095, 4096]:
        assert port.rows_bucket(n) == ref.rows_bucket(n)
        assert port.cap_bucket(n) == ref.cap_bucket(n)
    for longest in [1, 15, 16, 17, 40, 64, 65, 200]:
        for cap in (64, 128):
            assert port.seq_bucket(longest, cap) == ref.seq_bucket(longest, cap)
    with pytest.raises(ValueError, match="bucket cap"):
        port.rows_bucket(5000)
    with pytest.raises(ValueError, match="bad row bucket"):
        tplane.BucketPolicy(min_rows=16, max_rows=8)


def test_pad_rows_matches_jax():
    a = np.arange(30, dtype=np.int32).reshape(10, 3)
    (pa,), pb = tplane.DevicePlane().pad_rows([a], 10)
    (ra,), rb = jplane.DevicePlane().pad_rows([a], 10)
    assert pb == rb == 16
    np.testing.assert_array_equal(pa, ra)


def test_program_ledger_counts_shapes_per_bucket():
    plane = tplane.DevicePlane()
    prog = plane.program("double", lambda x, k=1: x * 2 * k)
    assert plane.program("double") is prog
    for n in (3, 5, 7):  # ragged waves padded into one bucket: one shape
        (x,), bucket = plane.pad_rows([np.ones((n, 4), np.float32)], n)
        prog(torch.from_numpy(x), bucket=bucket)
    prog(torch.ones(16, 4), bucket=16)
    prog(torch.ones(8, 4), k=3, bucket=8)  # another static argument
    assert plane.shape_counts() == {("double", 8): 2, ("double", 16): 1}
    assert prog.dispatches == 5 and prog.total_shapes == 3
    with pytest.raises(KeyError):
        plane.program("missing")
    name = plane.unique_name("embed")
    assert name != plane.unique_name("embed")
    plane.drop_program("double")
    assert "double" not in plane.programs


def test_failed_dispatch_raises_with_no_host_path():
    plane = tplane.DevicePlane()

    def boom(x):
        raise RuntimeError("device fault")

    prog = plane.program("boom", boom)
    with pytest.raises(RuntimeError, match="device fault"):
        prog(torch.ones(8, 2), bucket=8)
    assert prog.dispatches == 1


def test_coalescer_folds_concurrent_submits_and_delivers_errors():
    plane = tplane.DevicePlane()
    seen = []

    def flush(items):
        seen.append(list(items))
        return [i * 10 for i in items]

    co = plane.coalescer(flush, max_batch=4)

    async def run():
        return await asyncio.gather(*(co.submit(i) for i in range(10)))

    assert asyncio.run(run()) == [i * 10 for i in range(10)]
    assert co.flushes == 3 and [len(s) for s in seen] == [4, 4, 2]

    bad = plane.coalescer(lambda items: items[:-1], inline=True)

    async def run_bad():
        return await asyncio.gather(bad.submit(1), bad.submit(2), return_exceptions=True)

    errs = asyncio.run(run_bad())
    assert all(isinstance(e, RuntimeError) for e in errs)


def test_stage_runs_prep_on_the_staging_thread():
    import threading

    plane = tplane.DevicePlane()
    fut = plane.stage(lambda a: (a, threading.current_thread().name), 7)
    value, thread = fut.result(timeout=10)
    assert value == 7 and thread.startswith("pw-device-staging")
    assert tplane.get_device_plane() is tplane.get_device_plane()
