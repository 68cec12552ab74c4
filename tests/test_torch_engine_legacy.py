"""TorchEngine's legacy cache mode against JaxEngine's, for every family.

``cache_mode="legacy"`` keeps per-request caches and restacks them at
every decode dispatch: the seed path that the JAX package keeps as its
exactness reference (``tests/test_engine_arena.py``). The same seeded
trace goes through ``InferenceServer`` + ``LazyBatching(max_batch=3)``
with ``JaxEngine(cache_mode="legacy")`` and with
``TorchEngine(device="cpu", cache_mode="legacy")`` on the JAX engine's
own weights (``params_from_jax``), at the tiny configs of
``test_engine_arena.py`` (d_model 64, d_ff 128, vocab 128, max_len 32),
in float32: every generated token must be equal, and equal to the port's
arena tokens, node by node and fused. The lifecycle hooks (reset,
release, memory accounting, shape keys, node-by-node dispatch) must
behave as JaxEngine's legacy mode does.
"""
import dataclasses
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.policies import LazyBatching as JaxLazyBatching  # noqa: E402
from repro.core.slack import SlackPredictor as JaxSlackPredictor  # noqa: E402
from repro.serving.engine import JaxEngine  # noqa: E402
from repro.serving.npu_model import NPUPerfModel as JaxNPU, TPU_V5E  # noqa: E402
from repro.serving.server import InferenceServer as JaxServer  # noqa: E402
from repro.serving.traffic import Trace as JaxTrace  # noqa: E402
from repro.serving.workload import LengthDist as JaxLengthDist  # noqa: E402
from repro.serving.workload import from_model_config as jax_workload  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policies import LazyBatching  # noqa: E402
from repro_torch.core.request import SubBatch  # noqa: E402
from repro_torch.core.slack import SlackPredictor  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serving import (H100_SXM, LengthDist, NPUPerfModel,  # noqa: E402
                                 TorchEngine, from_model_config)
from repro_torch.serving.server import InferenceServer  # noqa: E402
from repro_torch.serving.traffic import Trace  # noqa: E402

ARCHS = ["llama3.2-1b", "minicpm3-4b", "granite-moe-3b-a800m",
         "mamba2-2.7b", "recurrentgemma-9b"]
_KW = dict(d_model=64, d_ff=128, vocab_size=128, num_prefix_embeddings=0)
MAX_LEN = 32
N_REQ = 6
# a hybrid whose local window lies below max_len: prompts of 5 and 7
# tokens (prefill 4 and 6) decode at positions 4..8, across the window
WINDOW = 6


def _cfg(get, arch, window=None):
    cfg = dataclasses.replace(get(arch).reduced(), **_KW)
    if window is not None:
        cfg = dataclasses.replace(cfg, hybrid=dataclasses.replace(
            cfg.hybrid, local_window=window))
    return cfg


def _workload(cfg, fmc=from_model_config, ld=LengthDist):
    return fmc(cfg, prompt_dist=ld((5, 7), (0.5, 0.5)),
               decode_dist=ld((2, 3), (0.5, 0.5)))


def _serve(engine, cfg, *, lazy, slack, npu, hw, server, trace_cls, fmc, ld,
           seed=0, n=N_REQ):
    """The ``_serve`` trace of test_engine_arena.py: ``n`` Poisson arrivals
    with prompts drawn from one seeded rng, served to the end through
    ``server`` + LazyBatching(max_batch=3); returns the requests."""
    rng = np.random.default_rng(seed)
    wl = _workload(cfg, fmc, ld)
    reqs, t = [], 0.0
    for _ in range(n):
        t += rng.exponential(0.05)
        r = wl.sample_request(rng, t)
        engine.register(r, rng.integers(2, cfg.vocab_size, size=r.prompt_len))
        reqs.append(r)
    pred = slack.build([wl], npu(hw), 60.0)
    stats = server(lazy(pred, max_batch=3), engine).run(trace_cls(reqs, t))
    assert len(stats.finished) == n
    return reqs


def _jax_serve(engine, cfg, **kw):
    return _serve(engine, cfg, lazy=JaxLazyBatching, slack=JaxSlackPredictor,
                  npu=JaxNPU, hw=TPU_V5E, server=JaxServer,
                  trace_cls=JaxTrace, fmc=jax_workload, ld=JaxLengthDist, **kw)


def _torch_serve(engine, cfg, **kw):
    return _serve(engine, cfg, lazy=LazyBatching, slack=SlackPredictor,
                  npu=NPUPerfModel, hw=H100_SXM, server=InferenceServer,
                  trace_cls=Trace, fmc=from_model_config, ld=LengthDist, **kw)


def _tokens(engine, reqs):
    return [list(engine.states[r.rid].generated) for r in reqs]


_JAX_RUNS = {}


def _jax_run(arch, window=None):
    """(JaxEngine legacy tokens, port weights, the JAX engine) of the trace,
    once per (arch, window)."""
    key = (arch, window)
    if key not in _JAX_RUNS:
        jcfg = _cfg(jax_get_config, arch, window)
        engine = JaxEngine(jcfg, max_len=MAX_LEN, cache_mode="legacy",
                           n_slots=8)
        reqs = _jax_serve(engine, jcfg)
        params = params_from_jax(jax.tree.map(np.asarray, engine.params),
                                 device="cpu")
        _JAX_RUNS[key] = (_tokens(engine, reqs), params, engine)
    return _JAX_RUNS[key]


def _torch_engine(arch, params, window=None, cls=TorchEngine, **kw):
    cfg = _cfg(get_config, arch, window)
    kw.setdefault("n_slots", 8)
    return cfg, cls(cfg, max_len=MAX_LEN, device="cpu", params=params, **kw)


# ---------------------------------------------------------------------------
# tokens: port legacy == JAX legacy == port arena (node by node and fused)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_legacy_tokens_equal_jax_legacy(arch):
    ref, params, _ = _jax_run(arch)
    cfg, engine = _torch_engine(arch, params, cache_mode="legacy")
    reqs = _torch_serve(engine, cfg)
    assert _tokens(engine, reqs) == ref
    assert engine.arenas == [] and engine.fused is False
    assert engine.runs_executed == 0 and engine.nodes_executed > 0
    assert not any(k[0] in ("mega", "prefill_run", "decode_node")
                   for k in engine.shape_keys())


@pytest.mark.parametrize("arch", ARCHS)
def test_legacy_equals_arena_unfused_and_fused(arch):
    _, params, _ = _jax_run(arch)
    got = {}
    for mode, fused in (("legacy", None), ("arena", False), ("arena", True)):
        cfg, engine = _torch_engine(arch, params, cache_mode=mode,
                                    fused=fused)
        got[mode, fused] = _tokens(engine, _torch_serve(engine, cfg))
        assert engine.slots_in_use == 0
    assert got["legacy", None] == got["arena", False] == got["arena", True]


def test_hybrid_window_below_max_len_matches_jax_and_arena():
    """recurrentgemma's local window of 6 rows below max_len 32: the
    legacy cache is padded to max_len (not a ring of the window), so its
    decodes past the window read what JaxEngine's do, and the arena's."""
    arch = "recurrentgemma-9b"
    ref, params, _ = _jax_run(arch, WINDOW)
    cfg, engine = _torch_engine(arch, params, WINDOW, cache_mode="legacy")
    reqs = _torch_serve(engine, cfg)
    assert cfg.hybrid.local_window == WINDOW < MAX_LEN
    assert max(engine.states[r.rid].pos for r in reqs) > WINDOW
    assert _tokens(engine, reqs) == ref
    attn = engine.kinds.index("attn")
    for r in reqs:
        assert engine.states[r.rid].caches[attn]["k"].shape[0] == MAX_LEN
    for fused in (False, True):
        cfg, arena = _torch_engine(arch, params, WINDOW, fused=fused)
        assert _tokens(arena, _torch_serve(arena, cfg)) == ref


# ---------------------------------------------------------------------------
# per-request caches
# ---------------------------------------------------------------------------

def _mk_req(wl, rng, prompt_len, decode_len):
    r = wl.sample_request(rng, 0.0)
    seq, prefix_len, cycle_len = wl.build_sequence(prompt_len, decode_len)
    r.sequence, r.prefix_len, r.cycle_len = seq, prefix_len, cycle_len
    r.prompt_len, r.decode_len = prompt_len, decode_len
    return r


def _run_nodes(engine, req, n_nodes=None, request_cls=SubBatch):
    sb = request_cls([req])
    steps = 0
    while not req.done and (n_nodes is None or steps < n_nodes):
        engine.execute("m", sb, req.next_node_id)
        sb.advance(0.0)
        steps += 1


def _merged_three(engine, cfg, request_cls, wl):
    """Three requests (prompts 5, 6, 7) prefilled alone node by node, then
    decoded merged, B = 3, to the end; returns their tokens and prompts."""
    rng = np.random.default_rng(21)
    reqs, prompts = [], []
    for pl in (5, 6, 7):
        r = _mk_req(wl, rng, pl, 3)
        p = rng.integers(2, cfg.vocab_size, size=pl)
        engine.register(r, p)
        _run_nodes(engine, r, 1 + len(engine.kinds), request_cls)
        reqs.append(r)
        prompts.append(p)
    sb = request_cls(list(reqs))
    while sb.size:
        engine.execute("m", sb, sb.node_id)
        sb.advance(0.0)
    return _tokens(engine, reqs), prompts


@pytest.mark.parametrize("arch", ARCHS)
def test_merged_decode_at_three_rows_equals_jax_and_isolated(arch):
    """Decode at B = 3, a batch the arena would pad to 4: unpadded here, as
    in JaxEngine's legacy mode, on the same schedule; each row equal to
    the request generating alone."""
    from repro.core.request import SubBatch as JaxSubBatch
    _, params, _ = _jax_run(arch)
    jcfg = _cfg(jax_get_config, arch)
    jengine = JaxEngine(jcfg, max_len=MAX_LEN, cache_mode="legacy")
    ref, _ = _merged_three(jengine, jcfg, JaxSubBatch,
                           _workload(jcfg, jax_workload, JaxLengthDist))
    cfg, engine = _torch_engine(arch, params, cache_mode="legacy")
    wl = _workload(cfg)
    got, prompts = _merged_three(engine, cfg, SubBatch, wl)
    assert got == ref
    assert {k for k in engine.shape_keys() if k[0] == "legacy_decode"} == \
        {("legacy_decode", i, 3) for i in range(len(engine.kinds))}
    for toks, p in zip(got, prompts):
        _, alone = _torch_engine(arch, params, cache_mode="legacy")
        r = _mk_req(wl, np.random.default_rng(0), len(p), 3)
        alone.register(r, p)
        _run_nodes(alone, r)
        assert alone.states[r.rid].generated == toks


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b",
                                  "minicpm3-4b"])
def test_caches_are_padded_and_own_their_storage(arch):
    """After a merged decode each member's caches are tensors of their own
    (no view into the B-wide stack), time leaves max_len long, state and
    conv leaves of one request's shape."""
    _, params, _ = _jax_run(arch)
    cfg, engine = _torch_engine(arch, params, cache_mode="legacy")
    wl = _workload(cfg)
    rng = np.random.default_rng(11)
    reqs = [_mk_req(wl, rng, pl, 3) for pl in (5, 7)]
    for r in reqs:
        engine.register(r, rng.integers(2, cfg.vocab_size, size=r.prompt_len))
        _run_nodes(engine, r, 1 + len(engine.kinds))       # emb + prefill
    sb = SubBatch(reqs)
    for _ in range(len(engine.kinds)):                     # one decode cycle
        engine.execute("m", sb, sb.node_id)
        sb.advance(0.0)
    shapes = {k: tuple(v.shape) for k, v in engine.model._init_layer_cache(
        engine.kinds[0], 1, MAX_LEN, device="cpu").items()}
    for r in reqs:
        caches = engine.states[r.rid].caches
        assert sorted(caches) == list(range(len(engine.kinds)))
        for leaf_by_key in caches.values():
            assert {k: (1,) + tuple(v.shape)
                    for k, v in leaf_by_key.items()} == shapes
            for leaf in leaf_by_key.values():
                assert leaf.untyped_storage().nbytes() == \
                    leaf.numel() * leaf.element_size()
    assert engine.memory_stats().bytes_resident == 0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-9b"])
def test_reset_request_replays_identically(arch):
    _, params, _ = _jax_run(arch)
    cfg, engine = _torch_engine(arch, params, cache_mode="legacy")
    wl = _workload(cfg)
    rng = np.random.default_rng(4)
    r = _mk_req(wl, rng, 7, 3)
    p = rng.integers(2, cfg.vocab_size, size=7)
    engine.register(r, p)
    _run_nodes(engine, r, 2 + 2 * len(engine.kinds))      # to the 1st head
    first = list(engine.states[r.rid].generated)
    assert first and engine.states[r.rid].caches
    engine.reset_request("m", r)
    st = engine.states[r.rid]
    assert st.generated == [] and st.caches == {} and st.x is None
    assert st.pos == st.prefill_len
    r2 = _mk_req(wl, rng, 7, 3)
    engine.register(r2, p)
    _run_nodes(engine, r2)
    assert engine.states[r2.rid].generated[:len(first)] == first
    # the replay from node 0 regenerates the whole reference generation
    _, fresh = _torch_engine(arch, params, cache_mode="legacy")
    r3 = _mk_req(wl, rng, 7, 3)
    fresh.register(r3, p)
    _run_nodes(fresh, r3)
    assert engine.states[r2.rid].generated == fresh.states[r3.rid].generated


def test_release_request_drops_the_caches():
    _, params, _ = _jax_run("llama3.2-1b")
    cfg, engine = _torch_engine("llama3.2-1b", params, cache_mode="legacy")
    wl = _workload(cfg)
    rng = np.random.default_rng(2)
    r = _mk_req(wl, rng, 5, 2)
    engine.register(r, rng.integers(2, cfg.vocab_size, size=5))
    _run_nodes(engine, r)
    leaves = [weakref.ref(leaf) for c in engine.states[r.rid].caches.values()
              for leaf in c.values()]
    assert leaves and all(w() is not None for w in leaves)
    engine.release_request("m", r)
    gc.collect()
    assert r.rid not in engine.states
    assert all(w() is None for w in leaves)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b"])
def test_memory_stats_equal_jax_legacy(arch):
    _, params, jengine = _jax_run(arch)
    cfg, engine = _torch_engine(arch, params, cache_mode="legacy")
    _torch_serve(engine, cfg)
    got = dataclasses.asdict(engine.memory_stats())
    want = dataclasses.asdict(jengine.memory_stats())
    got.pop("pool")
    want.pop("pool")
    assert got == want
    assert got["bytes_resident"] == 0


class _FixedClockEngine(TorchEngine):
    """Reports 1 ms per node instead of the wall time, so serving one trace
    twice schedules, and so dispatches, the same shapes."""

    def execute(self, model, sb, node_id):
        super().execute(model, sb, node_id)
        return 1e-3


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-3b-a800m"])
def test_no_new_shape_key_on_a_repeat_pass(arch):
    _, params, _ = _jax_run(arch)
    cfg, engine = _torch_engine(arch, params, cls=_FixedClockEngine,
                                cache_mode="legacy")
    _torch_serve(engine, cfg)                                # warmup
    s0, keys0 = engine.sanitizer_stats(), engine.shape_keys()
    assert s0.retraces == len(keys0) > 0
    assert {k[0] for k in keys0} == {"legacy_prefill", "legacy_decode",
                                     "head_node"}
    _torch_serve(engine, cfg)
    assert engine.shape_keys() == keys0
    assert engine.sanitizer_stats().retraces == s0.retraces


def test_execute_run_goes_node_by_node_with_fused_true():
    ref, params, _ = _jax_run("granite-moe-3b-a800m")
    cfg, engine = _torch_engine("granite-moe-3b-a800m", params,
                                cache_mode="legacy", fused=True)
    assert engine.fused is True
    reqs = _torch_serve(engine, cfg)
    assert _tokens(engine, reqs) == ref
    stats = engine.sanitizer_stats()
    assert engine.runs_executed == 0 == stats.runs
    # one sync per node
    assert stats.host_syncs == engine.nodes_executed > 0
