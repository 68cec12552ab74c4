"""The port's RG-LRU block and hybrid stack against the JAX package.

The hybrid family is ``recurrentgemma-9b``: RG-LRU blocks ("rec") and
local attention ("attn", window ``local_window``) in the pattern (rec,
rec, attn), with the layers past the last whole group as a tail. Weights
come from the JAX ``init`` at ``jax.random.key(0)`` through
``params_from_jax``; everything runs in float32 and holds to 1e-4.

  * ``apply_rglru_dense`` (y and the ``state`` / ``conv`` cache) and
    ``apply_rglru_decode`` against ``repro.models.rglru``, at
    ``reduced()``'s widths and with ``lru_width`` != ``d_model`` (a
    transposed projection fails there);
  * the log-depth scan against a sequential recurrence;
  * ``Model.prefill`` logits and caches and ``decode_step`` against
    ``repro.models.Model`` at 5 layers (one group and a tail of two rec
    blocks), with an 80-token prompt past the window of 64 and decode
    from an empty cache past it, so the attention ring wraps;
  * ``TorchEngine`` tokens equal to ``JaxEngine``'s under ServingSession +
    LazyBatching, fused and node by node, with prompts inside and past
    the window: past it the engine's arena decode reads every earlier
    token, as the JAX engine's does;
  * 2- and 3-token prompts, whose prefill leaves fewer conv rows than the
    arena's W - 1, against the JAX model stepping from an empty cache.
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
from repro.models import rglru as JRG  # noqa: E402
from repro.serving.engine import JaxEngine  # noqa: E402
from repro.serving.npu_model import NPUPerfModel as JaxNPU, TPU_V5E  # noqa: E402
from repro.serving.session import ServingSession as JaxSession  # noqa: E402
from repro.serving.workload import LengthDist as JaxLengthDist  # noqa: E402
from repro.serving.workload import from_model_config as jax_workload  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policies import LazyBatching  # noqa: E402
from repro_torch.core.request import SubBatch  # noqa: E402
from repro_torch.core.slack import SlackPredictor  # noqa: E402
from repro_torch.models import Model, RuntimeFlags, params_from_jax  # noqa: E402
from repro_torch.models import rglru as RG  # noqa: E402
from repro_torch.serving import (H100_SXM, HandleState, LengthDist,  # noqa: E402
                                 NPUPerfModel, ServingSession, TorchEngine,
                                 from_model_config)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "recurrentgemma-9b"
# reduced(): 4 q heads and 1 kv head of 64, window 64, lru_width = d_model
_KW = dict(d_model=64, d_ff=128, vocab_size=128, num_layers=5)
PROMPTS = (30, 40, 70, 90)     # every position inside the window of 64, or not
N_REQ = 6
MAX_LEN = 128


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _cfgs(**kw):
    """(JAX config, port config) of the reduced hybrid with ``kw``."""
    kw = {**_KW, **kw}
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _wide_lru(cfg):
    return dataclasses.replace(cfg, hybrid=dataclasses.replace(
        cfg.hybrid, lru_width=96))


def _to_torch(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["reduced", "lru_width_96"])
def block(request):
    """(JAX config, port config, JAX block params, port block params)."""
    jcfg, cfg = _cfgs()
    if request.param == "lru_width_96":
        jcfg, cfg = _wide_lru(jcfg), _wide_lru(cfg)
    jp = JRG.init_rglru_block(jax.random.key(0), jcfg, jnp.float32)
    return jcfg, cfg, jp, _to_torch(jp)


def test_init_rglru_block_shapes_match_jax(block):
    jcfg, cfg, jp, _ = block
    gen = torch.Generator().manual_seed(0)
    ours = RG.init_rglru_block(gen, cfg, torch.float32, "cpu")
    assert set(ours) == set(jp)
    for k, v in ours.items():
        assert tuple(v.shape) == jp[k].shape, k
        assert v.dtype == torch.float32
    # lambda is the inverse softplus of -log(a) / 8, a in [0.81, 0.998]
    a = torch.exp(-8.0 * torch.nn.functional.softplus(ours["lambda"]))
    assert float(a.min()) >= 0.81 - 1e-5 and float(a.max()) <= 0.998 + 1e-5


@pytest.mark.parametrize("S", [1, 2, 3, 17, 64])
def test_rglru_dense_matches_jax(block, S):
    jcfg, cfg, jp, tp = block
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model))
    jy, jc = JRG.apply_rglru_dense(jp, jnp.asarray(x, jnp.float32), jcfg)
    ty, tc = RG.apply_rglru_dense(tp, torch.tensor(x, dtype=torch.float32),
                                  cfg)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    np.testing.assert_allclose(_np(tc["state"]), _np(jc["state"]), **TOL)
    W = cfg.hybrid.conv_width
    assert tuple(tc["conv"].shape) == (2, W - 1, jp["w_out"].shape[0])
    # the conv tail: the pre-conv rows, left-padded with zeros below W - 1
    n = min(S, W - 1)
    np.testing.assert_allclose(_np(tc["conv"][:, W - 1 - n:]),
                               _np(jc["conv"]), **TOL)
    assert torch.all(tc["conv"][:, :W - 1 - n] == 0)


def test_rglru_decode_matches_jax(block):
    jcfg, cfg, jp, tp = block
    rng = np.random.default_rng(3)
    w = jp["w_out"].shape[0]
    W = cfg.hybrid.conv_width
    state = rng.standard_normal((3, w)).astype(np.float32)
    conv = rng.standard_normal((3, W - 1, w)).astype(np.float32)
    jc = {"state": jnp.asarray(state), "conv": jnp.asarray(conv)}
    tc = {"state": torch.from_numpy(state), "conv": torch.from_numpy(conv)}
    for step in range(3):
        x = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
        jy, jc = JRG.apply_rglru_decode(jp, jnp.asarray(x), jc, jcfg)
        ty, tc = RG.apply_rglru_decode(tp, torch.from_numpy(x), tc, cfg)
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
        for k in ("state", "conv"):
            np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), **TOL)


def test_dense_then_decode_equals_dense_over_the_longer_sequence(block):
    """Prefill's cache carries on: dense over S tokens then a decode step
    is dense over S + 1 tokens."""
    _, cfg, _, tp = block
    x = torch.tensor(np.random.default_rng(5).standard_normal(
        (2, 10, cfg.d_model)), dtype=torch.float32)
    y_all, _ = RG.apply_rglru_dense(tp, x, cfg)
    _, cache = RG.apply_rglru_dense(tp, x[:, :9], cfg)
    y, _ = RG.apply_rglru_decode(tp, x[:, 9], cache, cfg)
    np.testing.assert_allclose(_np(y), _np(y_all[:, 9]), **TOL)


@pytest.mark.parametrize("S", [1, 2, 3, 63, 64])
def test_linear_scan_matches_the_sequential_recurrence(S):
    rng = np.random.default_rng(S)
    log_a = -np.abs(rng.standard_normal((2, S, 8))).astype(np.float32)
    x = rng.standard_normal((2, S, 8)).astype(np.float32)
    h, want = np.zeros((2, 8), np.float32), []
    for t in range(S):
        h = np.exp(log_a[:, t]) * h + x[:, t]
        want.append(h)
    got = RG.linear_scan(torch.from_numpy(log_a), torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.stack(want, axis=1), **TOL)


# ---------------------------------------------------------------------------
# the hybrid stack
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX params, port model, port params): 5 layers, one
    (rec, rec, attn) group and a tail of two rec blocks."""
    jcfg, cfg = _cfgs()
    jm = JaxModel(jcfg, JaxFlags(dtype=jnp.float32))
    jp = jm.init(jax.random.key(0))
    port = Model(cfg, RuntimeFlags(dtype=torch.float32))
    return jm, jp, port, _to_torch(jp)


def test_layout_groups_and_tail(models):
    jm, jp, port, tp = models
    assert (port.n_groups, port.n_tail) == (jm.n_groups, jm.n_tail) == (1, 2)
    assert port.layer_kinds() == ["rec", "rec", "attn", "rec", "rec"]
    # layer i's parameters are the JAX engine's _layer_params(i)
    layers = port.layer_params(tp)
    np.testing.assert_array_equal(
        _np(layers[2]["attn"]["wq"]), _np(jp["blocks"]["b2_attn"]["attn"]["wq"][0]))
    np.testing.assert_array_equal(
        _np(layers[4]["rec"]["w_out"]), _np(jp["tail"]["rec"]["w_out"][1]))
    gen = torch.Generator().manual_seed(0)
    ours = port.init(gen)
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(jax.tree.map(np.asarray, jp)) == shapes(
        jax.tree.map(lambda a: a.numpy(), ours))


def test_prefill_matches_jax_past_the_window(models):
    """An 80-token prompt, window 64: logits, the groups' stacked caches
    and the tail's, in the JAX layout."""
    jm, jp, port, tp = models
    toks = np.random.default_rng(0).integers(0, 128, (2, 80)).astype(np.int32)
    jl, (jg, jt) = jm.prefill(jp, jnp.asarray(toks))
    tl, (tg, tt) = port.prefill(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert set(tg) == set(jg) and len(tt) == len(jt) == 2
    for key in jg:
        for leaf in jg[key]:
            assert tuple(tg[key][leaf].shape) == jg[key][leaf].shape
            np.testing.assert_allclose(_np(tg[key][leaf]),
                                       _np(jg[key][leaf]), **TOL)
    for a, b in zip(tt, jt):
        for leaf in b:
            np.testing.assert_allclose(_np(a[leaf]), _np(b[leaf]), **TOL)


def test_decode_steps_match_jax_after_prefill(models):
    """Ragged decode steps from a prefill cache: the attention cache is a
    ring of the prompt's 80 rows, as the JAX model treats it."""
    jm, jp, port, tp = models
    toks = np.random.default_rng(1).integers(0, 128, (2, 80)).astype(np.int32)
    _, jc = jm.prefill(jp, jnp.asarray(toks))
    _, tc = port.prefill(tp, torch.from_numpy(toks))
    tok = np.array([5, 9], np.int32)
    pos = np.array([80, 80], np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = port.decode_step(tp, tc, torch.tensor(tok),
                                  torch.tensor(pos))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        pos = pos + 1


def test_decode_from_an_empty_cache_wraps_the_ring(models):
    """70 steps from ``init_cache``: the attention cache holds the window
    (64 rows), and past it each token overwrites row pos % 64, with
    ragged positions across the batch."""
    jm, jp, port, tp = models
    jc = jm.init_cache(2, MAX_LEN)
    tc = port.init_cache(2, MAX_LEN, device="cpu")
    assert tuple(tc[0]["b2_attn"]["k"].shape) == jc[0]["b2_attn"]["k"].shape \
        == (1, 2, 64, 1, 64)
    rng = np.random.default_rng(2)
    pos = np.array([0, 3], np.int32)
    step_fn = jax.jit(jm.decode_step)
    for step in range(70):
        tok = rng.integers(0, 128, (2,)).astype(np.int32)
        jl, jc = step_fn(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = port.decode_step(tp, tc, torch.tensor(tok),
                                  torch.tensor(pos))
        if step % 10 == 9 or step >= 60:
            np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        pos = pos + 1
    np.testing.assert_allclose(_np(tc[0]["b2_attn"]["k"]),
                               _np(jc[0]["b2_attn"]["k"]), **TOL)


# ---------------------------------------------------------------------------
# TorchEngine against JaxEngine
# ---------------------------------------------------------------------------

def _workload(cfg, fmc=from_model_config, ld=LengthDist):
    return fmc(cfg, prompt_dist=ld(PROMPTS, (0.25,) * 4),
               decode_dist=ld((2, 3, 5), (0.4, 0.3, 0.3)))


def _serve_session(engine, cfg, *, lazy, slack, npu, hw, session_cls, fmc,
                   ld, seed=0, n=N_REQ):
    """One seeded Poisson trace through ``session_cls`` + LazyBatching
    (max_batch=3); returns (handles, streamed tokens by rid)."""
    wl = _workload(cfg, fmc, ld)
    pred = slack.build([wl], npu(hw), 60.0)
    session = session_cls(lazy(pred, max_batch=3), engine, seed=seed)
    streamed = {}

    def on_token(handle, token):
        streamed.setdefault(handle.request.rid, []).append(token)

    rng = np.random.default_rng(seed)
    handles, t = [], 0.0
    for _ in range(n):
        t += rng.exponential(0.05)
        handles.append(session.submit(wl.sample_request(rng, t),
                                      on_token=on_token))
    session.duration = t
    session.drain()
    return handles, streamed


@pytest.fixture(scope="module")
def jax_run():
    """JaxEngine's tokens and prompts for the trace, and its weights."""
    jcfg, _ = _cfgs()
    engine = JaxEngine(jcfg, max_len=MAX_LEN, pallas=False)
    handles, _ = _serve_session(
        engine, jcfg, lazy=JaxLazyBatching, slack=JaxSlackPredictor,
        npu=JaxNPU, hw=TPU_V5E, session_cls=JaxSession, fmc=jax_workload,
        ld=JaxLengthDist)
    tokens = [engine.states[h.request.rid].generated for h in handles]
    prompts = sorted({len(engine.states[h.request.rid].prompt_np)
                      for h in handles})
    return tokens, prompts, jcfg, engine.params


@pytest.fixture(scope="module")
def params(jax_run):
    return _to_torch(jax_run[3])


@pytest.mark.parametrize("fused", [True, False])
def test_tokens_equal_jax_engine(jax_run, params, fused):
    ref, prompts, _, _ = jax_run
    assert min(prompts) < 64 < max(prompts), \
        "the trace misses a prompt inside or past the window"
    _, cfg = _cfgs()
    engine = TorchEngine(cfg, max_len=MAX_LEN, device="cpu", params=params,
                         fused=fused)
    handles, streamed = _serve_session(
        engine, cfg, lazy=LazyBatching, slack=SlackPredictor,
        npu=NPUPerfModel, hw=H100_SXM, session_cls=ServingSession,
        fmc=from_model_config, ld=LengthDist)
    assert all(h.state is HandleState.DONE for h in handles)
    assert [engine.states[h.request.rid].generated for h in handles] == ref
    for h in handles:
        assert streamed[h.request.rid] == h.tokens
    assert engine.slots_in_use == 0
    # spans by kind, one arena each: state/conv, then full-length K/V
    assert [s[0] for s in engine._spans] == ["rec", "attn", "rec"]
    assert set(engine.arenas[0]) == {"state", "conv"}
    assert engine.arenas[1]["k"].shape[1] == MAX_LEN
    if fused:
        assert engine.runs_executed < engine.nodes_executed, \
            "no multi-node run was ever fused"


def _mk_req(wl, rng, prompt_len, decode_len):
    r = wl.sample_request(rng, 0.0)
    seq, prefix_len, cycle_len = wl.build_sequence(prompt_len, decode_len)
    r.sequence, r.prefix_len, r.cycle_len = seq, prefix_len, cycle_len
    r.prompt_len, r.decode_len = prompt_len, decode_len
    return r


@pytest.mark.parametrize("prompt", [[17, 42], [17, 42, 99]])
def test_short_prompts_zero_pad_the_conv_tail(jax_run, params, prompt):
    """A prefill of 1 or 2 tokens leaves fewer conv rows than the arena's
    W - 1: the arena holds the causal conv's zero padding, then those
    tokens' projections, exactly the JAX model's cache after stepping the
    prefill tokens from an empty cache, and the generation follows the
    JAX model stepping token by token."""
    _, _, jcfg, jparams = jax_run
    _, cfg = _cfgs()
    jm = JaxModel(jcfg, JaxFlags(dtype=jnp.float32))
    prompt = np.array(prompt, np.int32)
    P = len(prompt) - 1
    engine = TorchEngine(cfg, max_len=MAX_LEN, device="cpu", params=params,
                         n_slots=2)
    r = _mk_req(_workload(cfg), np.random.default_rng(0), len(prompt), 4)
    engine.register(r, prompt)
    sb = SubBatch([r])
    run = sb.run_nodes(stop_before={"D0"})
    engine.execute_run("m", sb, run)
    sb.advance_n(len(run), 0.0)

    cache = jm.init_cache(1, MAX_LEN)
    for t in range(P):
        _, cache = jm.decode_step(jparams, cache, jnp.asarray(prompt[t:t + 1]),
                                  jnp.asarray([t], jnp.int32))
    slot, n = engine.slot_of(r), engine.n_slots
    W = cfg.hybrid.conv_width
    # rec layers 0, 1 (group 0, arena 0) and 3, 4 (the tail, arena 2)
    for layer, (si, k) in ((0, (0, 0)), (1, (0, 1)), (3, (2, 0)),
                           (4, (2, 1))):
        got = {key: engine.arenas[si][key][slot + k * n]
               for key in ("state", "conv")}
        want = (cache[0][f"b{layer}_rec"] if layer < 3
                else cache[1][layer - 3])
        want = {key: (want[key][0, 0] if layer < 3 else want[key][0])
                for key in ("state", "conv")}
        assert torch.all(got["conv"][:W - 1 - P] == 0)
        for key in ("state", "conv"):
            np.testing.assert_allclose(_np(got[key]), _np(want[key]), **TOL)

    while sb.size:
        run = sb.run_nodes(stop_after={"head"})
        engine.execute_run("m", sb, run)
        sb.advance_n(len(run), 0.0)
    want, tok = [], int(prompt[-1])
    for pos in range(P, P + 4):
        logits, cache = jm.decode_step(jparams, cache,
                                       jnp.asarray([tok], jnp.int32),
                                       jnp.asarray([pos], jnp.int32))
        tok = int(jnp.argmax(logits[0]))
        want.append(tok)
    assert engine.states[r.rid].generated == want
