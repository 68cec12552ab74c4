"""The four dense GQA architectures of the port against the JAX package.

``qwen2.5-32b``, ``mistral-nemo-12b``, ``internvl2-26b`` and
``musicgen-large`` at 2 layers, d_model 64, d_ff 128 and vocab 128, each
with its own head structure (``reduced()`` would force MHA at head_dim
<= 64): qwen 5 q / 1 kv heads of 32 with QKV biases, nemo 4 / 1 of 128,
internvl2 6 / 1 of 128 (both ``num_heads * head_dim`` != d_model), musicgen
4 / 4 of 16. None ties its embeddings, so every one runs the untied head.
``Model.init`` zeroes the QKV biases, so qwen's are overwritten with
seeded non-zero values in both trees: a wrong bias add would otherwise
not show. Weights come from ``jax.random.key(0)`` through
``params_from_jax``; everything runs in float32 on the CPU, where the
port's attention takes the kernels' plain versions, and must match
``repro.models.Model`` to ``rtol=atol=1e-4``; the engine's tokens must
equal ``JaxEngine``'s under ``ServingSession`` + ``LazyBatching``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.policies import LazyBatching as JaxLazyBatching  # noqa: E402
from repro.core.slack import SlackPredictor as JaxSlackPredictor  # noqa: E402
from repro.models import Model as JaxModel, RuntimeFlags as JaxFlags  # noqa: E402
from repro.serving.engine import JaxEngine  # noqa: E402
from repro.serving.npu_model import NPUPerfModel as JaxNPU, TPU_V5E  # noqa: E402
from repro.serving.session import ServingSession as JaxSession  # noqa: E402
from repro.serving.workload import LengthDist as JaxLengthDist  # noqa: E402
from repro.serving.workload import from_model_config as jax_workload  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policies import LazyBatching  # noqa: E402
from repro_torch.core.slack import SlackPredictor  # noqa: E402
from repro_torch.models import Model, RuntimeFlags, params_from_jax  # noqa: E402
from repro_torch.serving import (H100_SXM, HandleState, LengthDist,  # noqa: E402
                                 NPUPerfModel, ServingSession, TorchEngine,
                                 from_model_config)
from test_torch_engine import _serve_session  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
_PAD_SLOT = 2 ** 30
_KW = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128,
           num_prefix_embeddings=0)
# each architecture's own head structure at the small width
HEADS = {
    "qwen2.5-32b": dict(num_heads=5, num_kv_heads=1, head_dim=32),
    "mistral-nemo-12b": dict(num_heads=4, num_kv_heads=1, head_dim=128),
    "internvl2-26b": dict(num_heads=6, num_kv_heads=1, head_dim=128),
    "musicgen-large": dict(num_heads=4, num_kv_heads=4, head_dim=16),
}
ARCHS = sorted(HEADS)


def _small(get, arch):
    return dataclasses.replace(get(arch), **_KW, **HEADS[arch])


def _biased(tree, cfg):
    """``tree`` with seeded non-zero QKV biases (same values for the JAX
    and the port's copy); unchanged without ``qkv_bias``."""
    if not cfg.qkv_bias:
        return tree
    rng = np.random.default_rng(11)
    attn = dict(tree["blocks"]["attn"])
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(
            0.5 * rng.standard_normal(attn[name].shape), attn[name].dtype)
    return {**tree, "blocks": {**tree["blocks"], "attn": attn}}


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jcfg, tcfg = _small(jax_get_config, arch), _small(get_config, arch)
    jm = JaxModel(jcfg, JaxFlags(dtype=jnp.float32, attn_chunk=8))
    jp = _biased(jm.init(jax.random.key(0)), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, Model(tcfg, RuntimeFlags(dtype=torch.float32)), tp


def _np(x):
    return x.detach().to(torch.float32).numpy() if isinstance(
        x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_config_equals_jax_config(arch):
    assert (dataclasses.asdict(get_config(arch))
            == dataclasses.asdict(jax_get_config(arch)))


def test_the_small_configs_keep_the_shapes_under_test():
    """Groups 1, 4, 5 and 6, head_dim 128, a q width other than d_model,
    QKV biases and an untied head are all covered."""
    cfgs = {a: _small(get_config, a) for a in ARCHS}
    assert {c.num_heads // c.num_kv_heads for c in cfgs.values()} \
        == {1, 4, 5, 6}
    assert any(c.head_dim == 128 for c in cfgs.values())
    assert any(c.q_dim != c.d_model for c in cfgs.values())
    assert any(c.qkv_bias for c in cfgs.values())
    assert not any(c.tie_embeddings for c in cfgs.values())


def test_weight_bridge_carries_biases_and_the_untied_head(models):
    jm, jp, _, tp = models
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        np.testing.assert_array_equal(_np(t), np.asarray(leaf, np.float32))
    assert tuple(tp["unembed"].shape) == (jm.cfg.d_model, jm.cfg.vocab_size)
    if jm.cfg.qkv_bias:
        for name in ("bq", "bk", "bv"):
            assert torch.count_nonzero(tp["blocks"]["attn"][name]) > 0


def test_prefill_logits_and_cache_match_jax(models):
    jm, jp, port, tp = models
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jm.cfg.vocab_size, size=(2, 16)).astype(np.int32)
    jl, (jc, _) = jm.prefill(jp, jnp.asarray(tokens))
    tl_, (tc, _) = port.prefill(tp, torch.from_numpy(tokens))
    assert tuple(tl_.shape) == (2, jm.cfg.vocab_size)
    np.testing.assert_allclose(_np(tl_), _np(jl), **TOL)
    for key in ("k", "v"):
        assert tc[key].shape[-2:] == (jm.cfg.num_kv_heads, jm.cfg.head_dim)
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
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[0][key]), _np(jcache[0][key]),
                                   **TOL)


@pytest.mark.parametrize("ctx", [None, 16])
def test_span_decode_over_slot_arena_matches_jax(models, ctx):
    """Decode through the layer span over a flat slot arena (layer k at
    ``slots + k * n_slots``) with a padding row at the out-of-range slot:
    live rows and every arena row must match JAX."""
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


# ---------------------------------------------------------------------------
# TorchEngine against JaxEngine (the nemo and qwen shapes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "qwen2.5-32b"])
def test_engine_tokens_equal_jax_engine(arch, fused):
    jcfg, tcfg = _small(jax_get_config, arch), _small(get_config, arch)
    jengine = JaxEngine(jcfg, max_len=32, pallas=False)
    jengine.params = _biased(jengine.params, jcfg)
    jengine._span_params = [jengine.params["blocks"]]
    jhandles, _ = _serve_session(jengine, jcfg, lazy=JaxLazyBatching,
                                 slack=JaxSlackPredictor, npu=JaxNPU,
                                 hw=TPU_V5E, session_cls=JaxSession,
                                 fmc=jax_workload, ld=JaxLengthDist)
    ref = [jengine.states[h.request.rid].generated for h in jhandles]
    params = params_from_jax(jax.tree.map(np.asarray, jengine.params),
                             device="cpu")
    engine = TorchEngine(tcfg, max_len=32, device="cpu", params=params,
                         fused=fused)
    handles, streamed = _serve_session(engine, tcfg, lazy=LazyBatching,
                                       slack=SlackPredictor, npu=NPUPerfModel,
                                       hw=H100_SXM,
                                       session_cls=ServingSession,
                                       fmc=from_model_config, ld=LengthDist)
    assert all(h.state is HandleState.DONE for h in handles)
    got = [engine.states[h.request.rid].generated for h in handles]
    assert got == ref
    for h in handles:
        assert streamed[h.request.rid] == h.tokens
    assert engine.slots_in_use == 0
    if fused:
        assert engine.runs_executed < engine.nodes_executed, \
            "no multi-node run was ever fused"
    assert engine.arenas[0]["k"].shape[-2:] == (tcfg.num_kv_heads,
                                                tcfg.head_dim)
