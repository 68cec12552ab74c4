"""The port's MLA (``minicpm3-4b``) against the JAX package.

Two small configs of 2 layers, d_model 64, d_ff 128, vocab 128 and 4
heads: one keeps MiniCPM3's head widths (qk_nope 64, qk_rope 32, v 64,
so q and k are 96 wide and v 64, the flash kernel's (96, 64) case), the
other ``reduced()``'s MLA widths (32 / 16 / 32: (48, 32)). Weights come
from ``jax.random.key(0)`` through ``params_from_jax``; everything runs
in float32 on the CPU, where prefill attention takes the flash kernel's
plain version, and must match ``repro.models.Model`` to
``rtol=atol=1e-4``: ``apply_mla_dense`` and its latent cache, prefill
logits, ragged decode steps, span decode over a slot arena with a padding
row, and ``TorchEngine`` tokens equal to ``JaxEngine``'s under
``ServingSession`` + ``LazyBatching``, fused and node by node.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import MLAConfig as JaxMLAConfig  # noqa: E402
from repro.core.policies import LazyBatching as JaxLazyBatching  # noqa: E402
from repro.core.slack import SlackPredictor as JaxSlackPredictor  # noqa: E402
from repro.models import Model as JaxModel, RuntimeFlags as JaxFlags  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.serving.engine import JaxEngine  # noqa: E402
from repro.serving.npu_model import NPUPerfModel as JaxNPU, TPU_V5E  # noqa: E402
from repro.serving.session import ServingSession as JaxSession  # noqa: E402
from repro.serving.workload import LengthDist as JaxLengthDist  # noqa: E402
from repro.serving.workload import from_model_config as jax_workload  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MLAConfig  # noqa: E402
from repro_torch.core.policies import LazyBatching  # noqa: E402
from repro_torch.core.slack import SlackPredictor  # noqa: E402
from repro_torch.models import Model, RuntimeFlags, params_from_jax  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.serving import (H100_SXM, HandleState, LengthDist,  # noqa: E402
                                 NPUPerfModel, ServingSession, TorchEngine,
                                 from_model_config)
from test_torch_engine import _serve_session  # noqa: E402

ARCH = "minicpm3-4b"
TOL = dict(rtol=1e-4, atol=1e-4)
_PAD_SLOT = 2 ** 30
_KW = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128)
# MiniCPM3's own head widths at small ranks, and reduced()'s MLA widths
WIDTHS = {"minicpm3": dict(q_lora_rank=48, kv_lora_rank=32,
                           qk_nope_head_dim=64, qk_rope_head_dim=32,
                           v_head_dim=64),
          "reduced": None}


def _small(get, mla_cls, which):
    cfg = dataclasses.replace(get(ARCH).reduced(), **_KW)
    if WIDTHS[which] is None:
        return cfg
    return dataclasses.replace(cfg, mla=mla_cls(**WIDTHS[which]))


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def models(request):
    jcfg = _small(jax_get_config, JaxMLAConfig, request.param)
    tcfg = _small(get_config, MLAConfig, request.param)
    jm = JaxModel(jcfg, JaxFlags(dtype=jnp.float32, attn_chunk=8))
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, Model(tcfg, RuntimeFlags(dtype=torch.float32)), tp


def _np(x):
    return x.detach().to(torch.float32).numpy() if isinstance(
        x, torch.Tensor) else np.asarray(x, np.float32)


def test_port_config_equals_jax_config():
    assert (dataclasses.asdict(get_config(ARCH))
            == dataclasses.asdict(jax_get_config(ARCH)))


def test_the_small_configs_keep_the_head_widths_under_test():
    """q/k at nope + rope and v: MiniCPM3's (96, 64) and reduced()'s (48,
    32); the rotated part is narrower than head_dim."""
    widths = set()
    for which in WIDTHS:
        m = _small(get_config, MLAConfig, which).mla
        widths.add((m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim))
        assert m.qk_rope_head_dim < get_config(ARCH).head_dim
    assert widths == {(96, 64), (48, 32)}


def test_apply_mla_dense_and_its_cache_match_jax(models):
    jm, jp, port, tp = models
    cfg = jm.cfg
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    bj = jax.tree.map(lambda a: a[1], jp["blocks"]["attn"])
    bt = {k: (v[1] if isinstance(v, torch.Tensor) else {"scale": v["scale"][1]})
          for k, v in tp["blocks"]["attn"].items()}
    jy, jc = JL.apply_mla_dense(bj, jnp.asarray(x), cfg, chunk=8)
    ty, tc = TL.apply_mla_dense(bt, torch.from_numpy(x), cfg)
    assert tuple(ty.shape) == (2, 24, cfg.d_model)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    m = cfg.mla
    assert tuple(tc["ckv"].shape) == (2, 24, m.kv_lora_rank)
    assert tuple(tc["krope"].shape) == (2, 24, m.qk_rope_head_dim)
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL)


def test_prefill_logits_and_cache_match_jax(models):
    jm, jp, port, tp = models
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jm.cfg.vocab_size, size=(2, 16)).astype(np.int32)
    jl, (jc, _) = jm.prefill(jp, jnp.asarray(tokens))
    tl_, (tc, _) = port.prefill(tp, torch.from_numpy(tokens))
    assert tuple(tl_.shape) == (2, jm.cfg.vocab_size)
    np.testing.assert_allclose(_np(tl_), _np(jl), **TOL)
    assert set(tc) == {"ckv", "krope"}
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL)


def test_ragged_decode_steps_match_jax(models):
    """Three decode steps with rows at different positions over a per-row
    latent cache, no slots."""
    jm, jp, port, tp = models
    B, max_len = 2, 32
    jcache = jm.init_cache(B, max_len)
    tcache = port.init_cache(B, max_len, device="cpu")
    pos = np.array([0, 5], np.int32)
    rng = np.random.default_rng(2)
    for step in range(3):
        tok = rng.integers(0, jm.cfg.vocab_size, size=B).astype(np.int32)
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos + step))
        tl_, tcache = port.decode_step(
            tp, tcache, torch.from_numpy(tok), torch.from_numpy(pos + step))
        np.testing.assert_allclose(_np(tl_), _np(jl), **TOL)
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(_np(tcache[0][key]), _np(jcache[0][key]),
                                   **TOL)


@pytest.mark.parametrize("ctx", [None, 16])
def test_span_decode_over_slot_arena_matches_jax(models, ctx):
    """Decode through the layer span over a flat latent arena (layer k at
    ``slots + k * n_slots``) with a padding row at the out-of-range slot:
    live rows and every arena row must match JAX."""
    jm, jp, port, tp = models
    cfg, m = jm.cfg, jm.cfg.mla
    n_slots, T, Lr = 4, 32, cfg.num_layers
    rng = np.random.default_rng(3)
    ckv0 = rng.standard_normal((Lr * n_slots, T, m.kv_lora_rank))
    kr0 = rng.standard_normal((Lr * n_slots, T, m.qk_rope_head_dim))
    ckv0, kr0 = ckv0.astype(np.float32), kr0.astype(np.float32)
    jarena = {"ckv": jnp.asarray(ckv0), "krope": jnp.asarray(kr0)}
    tarena = {"ckv": torch.from_numpy(ckv0.copy()),
              "krope": torch.from_numpy(kr0.copy())}
    slots = np.array([2, 0, _PAD_SLOT], np.int32)
    pos = np.array([3, 9, 0], np.int32)
    offs = [k * n_slots for k in range(Lr)]
    layer_bps = port.layer_params(tp)
    for step in range(3):
        x = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
        jx, jarena = jm.apply_span_decode(
            jp["blocks"], jnp.asarray(x), jarena, jnp.asarray(pos + step),
            "mla", offs=jnp.asarray(offs, jnp.int32),
            slots=jnp.asarray(slots), ctx=ctx)
        tx, tarena = port.apply_span_decode(
            layer_bps, torch.from_numpy(x), tarena,
            torch.from_numpy(pos + step), offs=offs,
            slots=torch.from_numpy(slots), ctx=ctx, live=2, kind="mla")
        np.testing.assert_allclose(_np(tx)[:2], _np(jx)[:2], **TOL)
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(_np(tarena[key]), _np(jarena[key]), **TOL)


def test_rope_tables_are_built_at_the_rotated_width(models):
    """MLA's step and prefill tables rotate qk_rope_head_dim columns (JAX
    rotates at the rotated slice's own width), not head_dim."""
    _, _, port, _ = models
    m = port.cfg.mla
    cos, _ = port._step_tables("mla", torch.tensor([3, 7]))[0]
    assert cos.shape[-1] == m.qk_rope_head_dim // 2
    cos, _ = port._prefill_rope("mla", torch.zeros((1, 5, 8)))
    assert cos.shape[-1] == m.qk_rope_head_dim // 2


# ---------------------------------------------------------------------------
# TorchEngine against JaxEngine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(WIDTHS))
def jax_engine_run(request):
    """JaxEngine's tokens for the trace, and its weights for the port."""
    jcfg = _small(jax_get_config, JaxMLAConfig, request.param)
    jengine = JaxEngine(jcfg, max_len=32, pallas=False)
    jhandles, _ = _serve_session(jengine, jcfg, lazy=JaxLazyBatching,
                                 slack=JaxSlackPredictor, npu=JaxNPU,
                                 hw=TPU_V5E, session_cls=JaxSession,
                                 fmc=jax_workload, ld=JaxLengthDist)
    ref = [jengine.states[h.request.rid].generated for h in jhandles]
    params = params_from_jax(jax.tree.map(np.asarray, jengine.params),
                             device="cpu")
    return request.param, ref, params


@pytest.mark.parametrize("fused", [True, False])
def test_engine_tokens_equal_jax_engine(jax_engine_run, fused):
    which, ref, params = jax_engine_run
    tcfg = _small(get_config, MLAConfig, which)
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
    m = tcfg.mla
    assert engine.kinds == ["mla"] * tcfg.num_layers
    assert engine.arenas[0]["ckv"].shape[-2:] == (32, m.kv_lora_rank)
    assert engine.arenas[0]["krope"].shape[-1] == m.qk_rope_head_dim
