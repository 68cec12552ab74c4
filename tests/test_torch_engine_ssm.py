"""TorchEngine on Mamba-2 against JaxEngine under ServingSession + LazyBatching.

The tiny Mamba-2 (``_tiny("mamba2-2.7b")`` of tests/test_engine.py) serves
one seeded Poisson trace through ``JaxEngine(pallas=False)`` and through
``TorchEngine(device="cpu")`` on the JAX engine's own weights
(``params_from_jax``). Prompt lengths 5, 9, 33 and 34 give prefill lengths
4, 8, 32 and 33, which the reference's halving rule runs at SSD chunks 4,
8, 32 and 1. Every generated token must be equal, fused and node by node;
batched generations must equal isolated ones; a grow/shrink pass over the
SSM state and conv leaves must keep tokens exact; and a 2-token prompt,
whose one-token prefill leaves a conv tail shorter than the arena's
W - 1 rows, must left-pad it with zeros — checked against the JAX model
stepping from an empty cache, since the JAX engine broadcasts that tail.
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
from repro_torch.core.request import SubBatch  # noqa: E402
from repro_torch.core.slack import SlackPredictor  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serving import (H100_SXM, HandleState, LengthDist,  # noqa: E402
                                 NPUPerfModel, ServingSession, TorchEngine,
                                 from_model_config)

_KW = dict(d_model=64, d_ff=128, vocab_size=128, num_prefix_embeddings=0)
PROMPTS = (5, 9, 33, 34)
N_REQ = 8
MAX_LEN = 64


def _tiny():
    return dataclasses.replace(get_config("mamba2-2.7b").reduced(), **_KW)


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
    jcfg = dataclasses.replace(jax_get_config("mamba2-2.7b").reduced(), **_KW)
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
    return params_from_jax(jax.tree.map(np.asarray, jax_run[3]),
                           device="cpu")


def _torch_serve(params, **engine_kw):
    cfg = _tiny()
    engine = TorchEngine(cfg, max_len=MAX_LEN, device="cpu", params=params,
                         **engine_kw)
    handles, streamed = _serve_session(
        engine, cfg, lazy=LazyBatching, slack=SlackPredictor,
        npu=NPUPerfModel, hw=H100_SXM, session_cls=ServingSession,
        fmc=from_model_config, ld=LengthDist)
    return engine, handles, streamed


def _mk_req(wl, rng, prompt_len, decode_len):
    r = wl.sample_request(rng, 0.0)
    seq, prefix_len, cycle_len = wl.build_sequence(prompt_len, decode_len)
    r.sequence, r.prefix_len, r.cycle_len = seq, prefix_len, cycle_len
    r.prompt_len, r.decode_len = prompt_len, decode_len
    return r


def _run_nodes(engine, req, n_nodes=None):
    sb = SubBatch([req])
    steps = 0
    while not req.done and (n_nodes is None or steps < n_nodes):
        engine.execute("m", sb, req.next_node_id)
        sb.advance(0.0)
        steps += 1


def _isolated(params, prompt, n_tok):
    """``prompt`` generated alone, node by node, in a fresh engine."""
    cfg = _tiny()
    engine = TorchEngine(cfg, max_len=MAX_LEN, device="cpu", params=params,
                         n_slots=2)
    r = _mk_req(_workload(cfg), np.random.default_rng(9), len(prompt), n_tok)
    engine.register(r, prompt)
    _run_nodes(engine, r)
    return engine.states[r.rid].generated


@pytest.mark.parametrize("fused", [True, False])
def test_tokens_equal_jax_engine(jax_run, params, fused):
    ref, prompts, _, _ = jax_run
    assert prompts == list(PROMPTS), "the trace misses a prefill chunk size"
    engine, handles, streamed = _torch_serve(params, fused=fused)
    assert all(h.state is HandleState.DONE for h in handles)
    got = [engine.states[h.request.rid].generated for h in handles]
    assert got == ref
    for h in handles:
        rid = h.request.rid
        assert streamed[rid] == engine.tokens("m", h.request) == h.tokens
    assert engine.slots_in_use == 0
    if fused:
        assert engine.runs_executed < engine.nodes_executed, \
            "no multi-node run was ever fused"


def test_batched_generations_equal_isolated(params):
    engine, handles, _ = _torch_serve(params)
    for h in handles:
        st = engine.states[h.request.rid]
        assert st.generated == _isolated(params, st.prompt_np,
                                         h.request.decode_len)


def test_ssm_prefill_runs_per_request_at_exact_length(params):
    """Members of one prefill run are not padded to a common bucket: each
    prefills alone at its own length (the sanitizer keys say so)."""
    cfg = _tiny()
    wl = _workload(cfg)
    rng = np.random.default_rng(3)
    engine = TorchEngine(cfg, max_len=MAX_LEN, device="cpu", params=params,
                         n_slots=4)
    reqs = []
    for pl in (9, 34):
        r = _mk_req(wl, rng, pl, 2)
        engine.register(r, rng.integers(2, cfg.vocab_size, size=pl))
        reqs.append(r)
    sb = SubBatch(reqs)
    run = sb.run_nodes(stop_before={"D0"})
    engine.execute_run("m", sb, run)
    keys = {k for k in engine._seen_keys if k[0] == "prefill_run"}
    assert keys == {("prefill_run", 0, cfg.num_layers - 1, True, 1, 8),
                    ("prefill_run", 0, cfg.num_layers - 1, True, 1, 33)}


def test_grow_shrink_keeps_ssm_leaves_exact(params):
    """Five live requests in an arena of 2 slots: two doublings move every
    state and conv row, the drain compacts and shrinks them back, and each
    request still generates its isolated tokens."""
    cfg = _tiny()
    wl = _workload(cfg)
    rng = np.random.default_rng(3)
    engine = TorchEngine(cfg, max_len=MAX_LEN, device="cpu", params=params,
                         min_slots=2)
    assert set(engine.arenas[0]) == {"state", "conv"}
    reqs, prompts = [], []
    for pl in (5, 9, 33, 34, 9):
        r = _mk_req(wl, rng, pl, 3)
        p = rng.integers(2, cfg.vocab_size, size=pl)
        engine.register(r, p)
        _run_nodes(engine, r, 1 + len(engine.kinds) + 2)   # prefill, D0, D1
        reqs.append(r)
        prompts.append(p)
    assert engine.n_grows == 2 and engine.n_slots == 8
    bytes8 = engine.memory_stats().bytes_resident
    for r, p in zip(reversed(reqs), reversed(prompts)):
        _run_nodes(engine, r)
        assert engine.states[r.rid].generated == _isolated(params, p, 3)
    assert engine.n_shrinks >= 1 and engine.slots_in_use == 0
    assert engine.n_slots == 2
    assert engine.memory_stats().bytes_resident == bytes8 // 4


def test_two_token_prompt_zero_pads_the_conv_tail(jax_run, params):
    """Prefill covers one token; the arena's conv rows are the causal
    conv's zero padding then that token's projections, exactly the JAX
    model's cache after one ``decode_step`` from an empty cache, and the
    generation follows the JAX model stepping token by token."""
    _, _, jcfg, jparams = jax_run
    cfg = _tiny()
    jm = JaxModel(jcfg, JaxFlags(dtype=jnp.float32))
    prompt = np.array([17, 42], np.int32)
    engine = TorchEngine(cfg, max_len=MAX_LEN, device="cpu", params=params,
                         n_slots=2)
    r = _mk_req(_workload(cfg), np.random.default_rng(0), 2, 4)
    engine.register(r, prompt)
    sb = SubBatch([r])
    run = sb.run_nodes(stop_before={"D0"})
    engine.execute_run("m", sb, run)
    sb.advance_n(len(run), 0.0)

    cache = jm.init_cache(1, MAX_LEN)
    _, cache = jm.decode_step(jparams, cache, jnp.asarray(prompt[:1]),
                              jnp.asarray([0], jnp.int32))
    slot, n = engine.slot_of(r), engine.n_slots
    for k in range(cfg.num_layers):
        conv = engine.arenas[0]["conv"][slot + k * n]
        assert torch.all(conv[:-1] == 0)
        for key in ("state", "conv"):
            np.testing.assert_allclose(
                engine.arenas[0][key][slot + k * n].numpy(),
                np.asarray(cache[0][key][k, 0]), rtol=1e-4, atol=1e-4)

    while sb.size:
        run = sb.run_nodes(stop_after={"head"})
        engine.execute_run("m", sb, run)
        sb.advance_n(len(run), 0.0)
    want, tok = [], int(prompt[1])
    for pos in range(1, 5):
        logits, cache = jm.decode_step(jparams, cache,
                                       jnp.asarray([tok], jnp.int32),
                                       jnp.asarray([pos], jnp.int32))
        tok = int(jnp.argmax(logits[0]))
        want.append(tok)
    assert engine.states[r.rid].generated == want
