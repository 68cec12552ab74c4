"""The port's MoE (``granite-moe-3b-a800m``, ``grok-1-314b``) against the
JAX package.

``apply_moe`` at granite's routing (40 experts, top 8) and grok's (8, top
2) over a prefill block and a decode step with padding rows, with the
capacity bound overflowed (asserted: some pairs are dropped); then the
models at 2 layers, d_model 64, per-expert d_ff 32, vocab 128 and their
own attention heads — granite 6 q / 2 kv heads of 64 (G 3), grok 6 / 1 of
128 (G 6) — prefill logits and ragged decode steps; and ``TorchEngine``
tokens equal to ``JaxEngine``'s under ``ServingSession`` + ``LazyBatching``
for the granite shape, fused and node by node. Weights come from
``jax.random.key(0)`` through ``params_from_jax``; float32 on the CPU,
``rtol=atol=1e-4``.
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
from repro.models import moe as JMOE  # noqa: E402
from repro.serving.engine import JaxEngine  # noqa: E402
from repro.serving.npu_model import NPUPerfModel as JaxNPU, TPU_V5E  # noqa: E402
from repro.serving.session import ServingSession as JaxSession  # noqa: E402
from repro.serving.workload import LengthDist as JaxLengthDist  # noqa: E402
from repro.serving.workload import from_model_config as jax_workload  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policies import LazyBatching  # noqa: E402
from repro_torch.core.slack import SlackPredictor  # noqa: E402
from repro_torch.models import Model, RuntimeFlags, params_from_jax  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.serving import (H100_SXM, HandleState, LengthDist,  # noqa: E402
                                 NPUPerfModel, ServingSession, TorchEngine,
                                 from_model_config)
from test_torch_engine import _serve_session  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
_KW = dict(num_layers=2, d_model=64, d_ff=32, vocab_size=128)
# each architecture's own attention heads at the small width; the routing
# (experts, top-k, capacity factor) is the full config's
HEADS = {"granite-moe-3b-a800m": dict(num_heads=6, num_kv_heads=2,
                                      head_dim=64),
         "grok-1-314b": dict(num_heads=6, num_kv_heads=1, head_dim=128)}
ARCHS = sorted(HEADS)


def _small(get, arch):
    return dataclasses.replace(get(arch), **_KW, **HEADS[arch])


def _np(x):
    return x.detach().to(torch.float32).numpy() if isinstance(
        x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_config_equals_jax_config(arch):
    assert (dataclasses.asdict(get_config(arch))
            == dataclasses.asdict(jax_get_config(arch)))


def test_the_small_configs_keep_the_routing_and_heads_under_test():
    cfgs = {a: _small(get_config, a) for a in ARCHS}
    assert {(c.moe.num_experts, c.moe.experts_per_token)
            for c in cfgs.values()} == {(40, 8), (8, 2)}
    assert {(c.num_heads // c.num_kv_heads, c.head_dim)
            for c in cfgs.values()} == {(3, 64), (6, 128)}


def _moe_params(arch):
    cfg = _small(jax_get_config, arch)
    jp = JMOE.init_moe(jax.random.key(1), cfg, jnp.float32)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_prefill_matches_jax_and_overflows_capacity(arch):
    """A (2, 24) block: every group of 24 tokens routes its 24 k pairs
    into E buffers of C slots; at least one expert overflows (asserted)
    and its extra pairs are dropped exactly as in the reference."""
    jcfg, jp, tp = _moe_params(arch)
    tcfg = _small(get_config, arch)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    jy, _ = JMOE.apply_moe(jp, jnp.asarray(x), jcfg)
    ty = TMOE.apply_moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    # the routing the port ran drops pairs at the capacity bound
    m = tcfg.moe
    cap = TMOE.capacity(tcfg, 24)
    probs = torch.softmax(torch.from_numpy(x) @ tp["router"], dim=-1)
    top_e = torch.topk(probs, m.experts_per_token, dim=-1).indices
    _, _, slot, keep = TMOE._dispatch_indices(top_e.reshape(2, -1), cap)
    assert not bool(keep.all()), "no expert overflowed its capacity"
    assert bool((slot[~keep] == cap - 1).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_decode_rows_match_jax(arch):
    """A decode step: (B, 1, d) rows, each its own group of one token
    (capacity 1); zero padding rows route on their own and leave the
    live rows as they are."""
    jcfg, jp, tp = _moe_params(arch)
    tcfg = _small(get_config, arch)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 1, tcfg.d_model)).astype(np.float32)
    x[5:] = 0.0                                  # padding rows
    jy, _ = JMOE.apply_moe(jp, jnp.asarray(x), jcfg)
    ty = TMOE.apply_moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    assert TMOE.capacity(tcfg, 1) == 1
    alone = TMOE.apply_moe(tp, torch.from_numpy(x[:5]), tcfg)
    np.testing.assert_array_equal(_np(ty)[:5], _np(alone))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jcfg, tcfg = _small(jax_get_config, arch), _small(get_config, arch)
    jm = JaxModel(jcfg, JaxFlags(dtype=jnp.float32, attn_chunk=8))
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, Model(tcfg, RuntimeFlags(dtype=torch.float32)), tp


def test_prefill_logits_and_cache_match_jax(models):
    jm, jp, port, tp = models
    assert port.block_kind == "moe"
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jm.cfg.vocab_size, size=(2, 16)).astype(np.int32)
    jl, (jc, _) = jm.prefill(jp, jnp.asarray(tokens))
    tl_, (tc, _) = port.prefill(tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(tl_), _np(jl), **TOL)
    for key in ("k", "v"):
        assert tc[key].shape[-2:] == (jm.cfg.num_kv_heads, jm.cfg.head_dim)
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL)


def test_ragged_decode_steps_match_jax(models):
    jm, jp, port, tp = models
    B, max_len = 3, 32
    jcache = jm.init_cache(B, max_len)
    tcache = port.init_cache(B, max_len, device="cpu")
    pos = np.array([0, 5, 11], np.int32)
    rng = np.random.default_rng(3)
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


# ---------------------------------------------------------------------------
# TorchEngine against JaxEngine (granite's shape)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_engine_run():
    jcfg = _small(jax_get_config, "granite-moe-3b-a800m")
    jengine = JaxEngine(jcfg, max_len=32, pallas=False)
    jhandles, _ = _serve_session(jengine, jcfg, lazy=JaxLazyBatching,
                                 slack=JaxSlackPredictor, npu=JaxNPU,
                                 hw=TPU_V5E, session_cls=JaxSession,
                                 fmc=jax_workload, ld=JaxLengthDist)
    ref = [jengine.states[h.request.rid].generated for h in jhandles]
    return ref, params_from_jax(jax.tree.map(np.asarray, jengine.params),
                                device="cpu")


@pytest.mark.parametrize("fused", [True, False])
def test_engine_tokens_equal_jax_engine(jax_engine_run, fused):
    ref, params = jax_engine_run
    tcfg = _small(get_config, "granite-moe-3b-a800m")
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
    assert engine.kinds == ["moe"] * tcfg.num_layers
    if fused:
        assert engine.runs_executed < engine.nodes_executed, \
            "no multi-node run was ever fused"
