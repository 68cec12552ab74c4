"""The port's dense model against the JAX ``Model`` on the same weights.

``Model.init(jax.random.key(0))`` makes the weights; ``params_from_jax``
copies them to torch through float32. Prefill logits and ragged decode
steps — plain, and over a slot arena with ``slots``/``ctx`` and a padding
row — must match the JAX model in float32 to ``rtol=atol=1e-4``: XLA and
torch order CPU matmul sums differently, so bit equality is not expected.
On the CPU the port's attention runs the kernels' plain versions, which
are the JAX model's chunked prefill and gathered decode. Mirrors
``tests/test_models_smoke.py::test_prefill_and_ragged_decode``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel, RuntimeFlags as JaxFlags  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import HybridConfig, ModelConfig, MoEConfig  # noqa: E402
from repro_torch.models import Model, RuntimeFlags, params_from_jax  # noqa: E402
from repro_torch.models import layers as TL, ssm as TSSM  # noqa: E402
from repro_torch.models.model import _gather_rows, _scatter_rows  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
_PAD_SLOT = 2 ** 30


def _tiny_pair():
    """``_tiny("llama3.2-1b")`` of tests/test_engine_arena.py, as the JAX
    package's config and as the port's own copy."""
    kw = dict(d_model=64, d_ff=128, vocab_size=128, num_prefix_embeddings=0)
    return (dataclasses.replace(jax_get_config("llama3.2-1b").reduced(), **kw),
            dataclasses.replace(get_config("llama3.2-1b").reduced(), **kw))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _tiny_pair()
    jm = JaxModel(jcfg, JaxFlags(dtype=jnp.float32, attn_chunk=8))
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    port = Model(tcfg, RuntimeFlags(dtype=torch.float32))
    return jm, jp, port, tp


def _np(x):
    return x.detach().to(torch.float32).numpy() if isinstance(
        x, torch.Tensor) else np.asarray(x, np.float32)


def test_weight_bridge_keeps_layout_and_values(models):
    jm, jp, _, tp = models
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jleaves:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        np.testing.assert_array_equal(_np(t), np.asarray(leaf, np.float32))


def test_init_mirrors_jax_shapes_dtypes_and_scales():
    """The port's seeded init has the JAX ``Model.init`` tree: same keys,
    shapes and dtypes (bf16 weights, f32 norm scales), N(0, 1/fan_in)."""
    jcfg, tcfg = _tiny_pair()
    shapes = jax.eval_shape(JaxModel(jcfg, JaxFlags()).init, jax.random.key(0))
    gen = torch.Generator().manual_seed(0)
    tp = Model(tcfg, RuntimeFlags()).init(gen)
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), path
    std = tp["blocks"]["attn"]["wq"].float().std().item()
    assert abs(std * np.sqrt(tcfg.d_model) - 1.0) < 0.1
    assert torch.all(tp["blocks"]["ln1"]["scale"] == 1)


def test_prefill_logits_and_cache_match_jax(models):
    jm, jp, port, tp = models
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jm.cfg.vocab_size, size=(2, 16)).astype(np.int32)
    jl, (jc, _) = jm.prefill(jp, jnp.asarray(tokens))
    tl_, (tc, _) = port.prefill(tp, torch.from_numpy(tokens))
    assert tuple(tl_.shape) == (2, jm.cfg.vocab_size)
    np.testing.assert_allclose(_np(tl_), _np(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL)


def test_ragged_decode_steps_match_jax(models):
    """Three decode steps with rows at different positions (a lazily
    merged batch) over a per-row cache, no slots."""
    jm, jp, port, tp = models
    B, max_len = 2, 32
    jcache = jm.init_cache(B, max_len)
    tcache = port.init_cache(B, max_len, device="cpu")
    pos = np.array([0, 5], np.int32)
    rng = np.random.default_rng(1)
    for step in range(3):
        tok = rng.integers(0, jm.cfg.vocab_size, size=B).astype(np.int32)
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos + step))
        tl_, tcache = port.decode_step(
            tp, tcache, torch.from_numpy(tok), torch.from_numpy(pos + step))
        np.testing.assert_allclose(_np(tl_), _np(jl), **TOL)
    np.testing.assert_allclose(_np(tcache[0]["k"]), _np(jcache[0]["k"]), **TOL)


@pytest.mark.parametrize("ctx", [None, 16])
def test_span_decode_over_slot_arena_matches_jax(models, ctx):
    """Decode through the whole layer span over a FLAT slot arena (layer k
    at ``slots + k * n_slots``), with a batch-bucket padding row at the
    out-of-range slot: live rows and every arena row must match JAX, whose
    padding scatter drops (the port skips it)."""
    jm, jp, port, tp = models
    cfg = jm.cfg
    n_slots, T, Lr = 4, 32, cfg.num_layers
    rng = np.random.default_rng(2)
    arena0 = rng.standard_normal(
        (Lr * n_slots, T, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
    jarena = {"k": jnp.asarray(arena0), "v": jnp.asarray(arena0 * 0.5)}
    tarena = {"k": torch.from_numpy(arena0.copy()),
              "v": torch.from_numpy(arena0 * 0.5)}
    slots = np.array([2, 0, _PAD_SLOT], np.int32)
    pos = np.array([3, 9, 0], np.int32)
    offs = [k * n_slots for k in range(Lr)]
    layer_bps = port.layer_params(tp)
    for step in range(3):
        x = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
        jx, jarena = jm.apply_span_decode(
            jp["blocks"], jnp.asarray(x), jarena, jnp.asarray(pos + step),
            "dense", offs=jnp.asarray(offs, jnp.int32),
            slots=jnp.asarray(slots), ctx=ctx)
        tx, tarena = port.apply_span_decode(
            layer_bps, torch.from_numpy(x), tarena,
            torch.from_numpy(pos + step), offs=offs,
            slots=torch.from_numpy(slots), ctx=ctx, live=2, kind="dense")
        np.testing.assert_allclose(_np(tx)[:2], _np(jx)[:2], **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tarena[key]), _np(jarena[key]), **TOL)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_rope_tables_rotate_like_jax_apply_rope(kind):
    """A span computes ``rope_tables`` once and rotates every layer's q/k
    by them: that equals the JAX ``apply_rope`` at prefill shapes
    (B, S, H, D) over positions (1, S) and at decode shapes (B, H, D) over
    ragged positions (B,)."""
    from repro.models.layers import apply_rope as jax_apply_rope
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(3)
    B, S, H, D, theta = 3, 12, 4, 16, 500000.0
    if kind == "prefill":
        x = rng.standard_normal((B, S, H, D)).astype(np.float32)
        pos = np.arange(S, dtype=np.int32)[None, :]
        want = jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    else:
        x = rng.standard_normal((B, H, D)).astype(np.float32)
        pos = np.array([0, 7, 1000], np.int32)
        want = jax_apply_rope(jnp.asarray(x)[:, None],
                              jnp.asarray(pos)[:, None], theta)[:, 0]
    got = TL.rotate(torch.from_numpy(x),
                    TL.rope_tables(torch.from_numpy(pos), D, theta))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_gather_clamps_and_scatter_skips_padding_rows():
    arena = {"s": torch.arange(12, dtype=torch.float32).reshape(4, 3)}
    slots = torch.tensor([3, 1, _PAD_SLOT])
    rows = _gather_rows(arena, slots)
    np.testing.assert_array_equal(_np(rows["s"]),
                                  _np(arena["s"][[3, 1, 3]]))
    new = {"s": -torch.ones(3, 3)}
    out = _scatter_rows(arena, new, slots, live=2)
    assert out["s"] is arena["s"]                    # updated in place
    np.testing.assert_array_equal(_np(arena["s"][[1, 3]]), -np.ones((2, 3)))
    np.testing.assert_array_equal(_np(arena["s"][[0, 2]]),
                                  [[0, 1, 2], [6, 7, 8]])
    assert _gather_rows(arena, None) is arena
    assert _scatter_rows(arena, new, None) is new


def test_unported_families_raise():
    """Every family of the JAX registry is ported — MoE and MLA
    (tests/test_torch_moe.py, tests/test_torch_mla.py) and the hybrid
    (tests/test_torch_rglru.py) build; an attention kind or a hybrid block
    the port has no layer for raises."""
    base = dict(name="x", num_layers=3, d_model=64, num_heads=4,
                num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=128)
    Model(ModelConfig(family="hybrid", hybrid=HybridConfig(), **base))
    Model(ModelConfig(family="moe", moe=MoEConfig(4, 2), **base))
    with pytest.raises(NotImplementedError, match="attention 'linear'"):
        Model(ModelConfig(family="dense", attention="linear", **base))
    odd = HybridConfig(block_pattern=("rec", "ssm"))
    with pytest.raises(NotImplementedError, match="pattern"):
        Model(ModelConfig(family="hybrid", hybrid=odd, **base))


@pytest.mark.parametrize("entry", ["params_from_jax", "init_cache",
                                   "init_rmsnorm", "rope_frequencies",
                                   "init_attention_cache", "init_ssm_cache"])
def test_entry_points_need_an_explicit_device(models, entry):
    """Nothing lands on the CPU unless the caller says so: the entry points
    and the helpers that make tensors take ``device`` as a required
    argument."""
    jm, jp, port, _ = models
    cfg = port.cfg
    calls = {
        "params_from_jax": lambda: params_from_jax(
            jax.tree.map(np.asarray, jp)),
        "init_cache": lambda: port.init_cache(2, 16),
        "init_rmsnorm": lambda: TL.init_rmsnorm(cfg.d_model),
        "rope_frequencies": lambda: TL.rope_frequencies(cfg.head_dim, 1e4),
        "init_attention_cache": lambda: TL.init_attention_cache(
            cfg, 2, 16, torch.float32),
        "init_ssm_cache": lambda: TSSM.init_ssm_cache(
            get_config("mamba2-2.7b").reduced(), 2, torch.float32),
    }
    with pytest.raises(TypeError, match="device"):
        calls[entry]()
