"""TorchEngine against JaxEngine under ServingSession + LazyBatching.

The same seeded trace (the ``_serve`` pattern of tests/test_engine_arena.py,
driven through the online ``ServingSession`` front end) runs through
``JaxEngine(_tiny, max_len=32, pallas=False)`` and through
``TorchEngine(_tiny, max_len=32, device="cpu")`` on the JAX engine's own
weights (``params_from_jax``). Every generated token must be equal; the
port must also stay exact fused vs node-by-node, across a merge that
arrives mid-run, and keep its slot pool an exact partition through
growth, shrink and release. Synthetic prompts come from the session's
numpy rng in both engines, so both see the same prompts.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.policies import LazyBatching as JaxLazyBatching  # noqa: E402
from repro.core.slack import SlackPredictor as JaxSlackPredictor  # noqa: E402
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
                                 MultiBackend, NPUPerfModel, ServingSession,
                                 TorchEngine, from_model_config)
from repro_torch.serving.backend import BackendOOMError  # noqa: E402

_KW = dict(d_model=64, d_ff=128, vocab_size=128, num_prefix_embeddings=0)
N_REQ = 6


def _tiny():
    return dataclasses.replace(get_config("llama3.2-1b").reduced(), **_KW)


def _workload(cfg, fmc=from_model_config, ld=LengthDist):
    return fmc(cfg, prompt_dist=ld((5, 7, 11), (0.4, 0.3, 0.3)),
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
    """JaxEngine's tokens for the trace, and its weights for the port."""
    jcfg = dataclasses.replace(jax_get_config("llama3.2-1b").reduced(), **_KW)
    engine = JaxEngine(jcfg, max_len=32, pallas=False)
    handles, _ = _serve_session(
        engine, jcfg, lazy=JaxLazyBatching, slack=JaxSlackPredictor,
        npu=JaxNPU, hw=TPU_V5E, session_cls=JaxSession, fmc=jax_workload,
        ld=JaxLengthDist)
    tokens = [engine.states[h.request.rid].generated for h in handles]
    return tokens, params_from_jax(jax.tree.map(np.asarray, engine.params),
                                   device="cpu")


def _torch_serve(params, **engine_kw):
    cfg = _tiny()
    engine_kw.setdefault("max_len", 32)
    engine = TorchEngine(cfg, device="cpu", params=params, **engine_kw)
    handles, streamed = _serve_session(
        engine, cfg, lazy=LazyBatching, slack=SlackPredictor,
        npu=NPUPerfModel, hw=H100_SXM, session_cls=ServingSession,
        fmc=from_model_config, ld=LengthDist)
    return engine, handles, streamed


@pytest.mark.parametrize("fused", [True, False])
def test_tokens_equal_jax_engine(jax_run, fused):
    ref, params = jax_run
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


class _FixedClockEngine(TorchEngine):
    """Reports 1 ms per node instead of the measured wall time, so the
    session's clock, and with it the schedule, does not follow the host's
    load: serving one trace twice then dispatches the same shapes."""

    def execute_run(self, model, sb, node_ids):
        _, per_node = super().execute_run(model, sb, node_ids)
        n = len(node_ids)
        return 1e-3 * n, None if per_node is None else [1e-3] * n


def test_sanitizer_one_sync_per_run_and_no_new_keys_after_warmup(jax_run):
    _, params = jax_run
    engine = _FixedClockEngine(_tiny(), max_len=32, device="cpu",
                               params=params)
    _serve_session(engine, _tiny(), lazy=LazyBatching, slack=SlackPredictor,
                   npu=NPUPerfModel, hw=H100_SXM, session_cls=ServingSession,
                   fmc=from_model_config, ld=LengthDist)   # warmup trace
    s0 = engine.sanitizer_stats()
    assert s0.runs > 0 and s0.retraces > 0
    _serve_session(engine, _tiny(), lazy=LazyBatching, slack=SlackPredictor,
                   npu=NPUPerfModel, hw=H100_SXM, session_cls=ServingSession,
                   fmc=from_model_config, ld=LengthDist)
    s1 = engine.sanitizer_stats()
    assert s1.retraces == s0.retraces, "new dispatch shape keys after warmup"
    assert s1.host_syncs - s0.host_syncs <= s1.runs - s0.runs
    assert s1.max_syncs_per_run <= 1 and s1.ok


# ---------------------------------------------------------------------------
# direct schedules (the run-commit contract), port vs node-by-node port
# ---------------------------------------------------------------------------

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


def _isolated(params, wl, prompt, n_tok):
    engine = TorchEngine(_tiny(), max_len=32, device="cpu", params=params,
                         n_slots=4)
    ref = _mk_req(wl, np.random.default_rng(9), len(prompt), n_tok)
    engine.register(ref, prompt)
    _run_nodes(engine, ref)
    return engine.states[ref.rid].generated


def test_merge_mid_run_takes_effect_at_run_boundary(jax_run):
    """A merge candidate arriving while a run is committed joins at the
    boundary; the ragged merge stays exact vs the same schedule dispatched
    node by node."""
    _, params = jax_run
    cfg = _tiny()
    wl = _workload(cfg)
    rng = np.random.default_rng(5)
    engine = TorchEngine(cfg, max_len=32, device="cpu", params=params,
                         n_slots=8)
    r1, r2 = _mk_req(wl, rng, 7, 3), _mk_req(wl, rng, 5, 2)
    p1 = rng.integers(2, cfg.vocab_size, size=7)
    p2 = rng.integers(2, cfg.vocab_size, size=5)
    engine.register(r1, p1)
    engine.register(r2, p2)
    sb1 = SubBatch([r1])
    run = sb1.run_nodes(stop_after={"head"})
    assert run[0] == "emb" and run[-1] == "head" and len(run) > 2
    engine.execute_run("m", sb1, run)
    sb1.advance_n(len(run), 0.0)
    sb2 = SubBatch([r2])
    run2 = sb2.run_nodes(stop_before={"D0"})
    engine.execute_run("m", sb2, run2)
    sb2.advance_n(len(run2), 0.0)
    assert r1.next_node_id == r2.next_node_id == "D0"
    assert engine.states[r1.rid].pos != engine.states[r2.rid].pos
    sb = SubBatch([r1, r2])
    while sb.size:
        run = sb.run_nodes(stop_after={"head"})
        engine.execute_run("m", sb, run)
        sb.advance_n(len(run), 0.0)
    got = [engine.states[r.rid].generated for r in (r1, r2)]

    eng2 = TorchEngine(cfg, max_len=32, device="cpu", params=params,
                       n_slots=8)
    rng2 = np.random.default_rng(5)
    q1, q2 = _mk_req(wl, rng2, 7, 3), _mk_req(wl, rng2, 5, 2)
    eng2.register(q1, p1)
    eng2.register(q2, p2)
    n_prefill = 1 + len(eng2.kinds)
    _run_nodes(eng2, q1, n_prefill + len(wl.cycle_ids()))
    _run_nodes(eng2, q2, n_prefill)
    sb = SubBatch([q1, q2])
    while sb.size:
        eng2.execute("m", sb, sb.node_id)
        sb.advance(0.0)
    assert got == [eng2.states[r.rid].generated for r in (q1, q2)]
    assert engine.slots_in_use == 0


def test_bucketed_prefill_with_padding_row_stays_exact(jax_run):
    """Prefill lengths 5, 6, 9 go to buckets 8, 8, 16; the 3-member merge
    decodes at Bp=4 with one out-of-range padding row."""
    _, params = jax_run
    cfg = _tiny()
    wl = _workload(cfg)
    rng = np.random.default_rng(7)
    engine = TorchEngine(cfg, max_len=32, device="cpu", params=params,
                         n_slots=8)
    reqs, prompts = [], []
    for pl in (6, 7, 10):
        r = _mk_req(wl, rng, pl, 2)
        p = rng.integers(2, cfg.vocab_size, size=pl)
        engine.register(r, p)
        reqs.append(r)
        prompts.append(p)
    sb = SubBatch(list(reqs))
    while sb.size:
        run = sb.run_nodes(stop_after={"head"})
        engine.execute_run("m", sb, run)
        sb.advance_n(len(run), 0.0)
    for r, p in zip(reqs, prompts):
        assert engine.states[r.rid].generated == _isolated(params, wl, p, 2)


def test_run_continuing_past_head_and_parked_batch(jax_run):
    """A run shaped [..., head, D0] decodes past its own head (the ctx
    bucket must cover the fresh row), and a batch parked mid-cycle keeps
    its activations while another batch runs."""
    _, params = jax_run
    cfg = _tiny()
    wl = _workload(cfg)
    rng = np.random.default_rng(13)
    engine = TorchEngine(cfg, max_len=32, device="cpu", params=params,
                         n_slots=8)
    ra, rb = _mk_req(wl, rng, 7, 3), _mk_req(wl, rng, 5, 2)
    pa = rng.integers(2, cfg.vocab_size, size=7)
    pb = rng.integers(2, cfg.vocab_size, size=5)
    engine.register(ra, pa)
    engine.register(rb, pb)
    sba = SubBatch([ra])
    run = sba.run_nodes(stop_before={"D0"})
    engine.execute_run("m", sba, run)
    sba.advance_n(len(run), 0.0)
    run = sba.run_nodes(stop_before={"head"})         # A parked mid-cycle
    assert run[0] == "D0" and "head" not in run and len(run) > 1
    engine.execute_run("m", sba, run)
    sba.advance_n(len(run), 0.0)
    sbb = SubBatch([rb])                               # B runs meanwhile
    while sbb.size:
        run = sbb.run_nodes(stop_after={"head"})
        engine.execute_run("m", sbb, run)
        sbb.advance_n(len(run), 0.0)
    while sba.size:                                    # A: runs past heads
        run = sba.run_nodes(stop_before={"D1"})
        engine.execute_run("m", sba, run)
        sba.advance_n(len(run), 0.0)
    assert engine.states[ra.rid].generated == _isolated(params, wl, pa, 3)
    assert engine.states[rb.rid].generated == _isolated(params, wl, pb, 2)


# ---------------------------------------------------------------------------
# slot lifecycle
# ---------------------------------------------------------------------------

def _assert_partition(engine):
    free = list(engine._free_slots)
    live = list(engine._slot.values())
    assert len(set(free)) == len(free) and len(set(live)) == len(live)
    assert sorted(free + live) == list(range(engine.n_slots))
    assert engine.memory_stats().slots_total == engine.n_slots
    for span in engine.arenas:
        for leaf in span.values():
            assert leaf.shape[0] == len(engine.kinds) * engine.n_slots


def test_free_pool_is_a_partition_through_grow_shrink_release(jax_run):
    _, params = jax_run
    cfg = _tiny()
    wl = _workload(cfg)
    rng = np.random.default_rng(3)
    engine = TorchEngine(cfg, max_len=32, device="cpu", params=params,
                         min_slots=2)
    reqs, prompts = [], []
    n_prefill = 1 + len(engine.kinds)
    for _ in range(5):                               # 5 live > 2 slots
        r = _mk_req(wl, rng, 5, 2)
        p = rng.integers(2, cfg.vocab_size, size=5)
        engine.register(r, p)
        _run_nodes(engine, r, n_prefill)
        reqs.append(r)
        prompts.append(p)
        _assert_partition(engine)
    assert engine.n_grows == 2 and engine.n_slots == 8
    bytes8 = engine.memory_stats().bytes_resident
    for r, p in zip(reqs, prompts):                  # drain one by one
        _run_nodes(engine, r)
        _assert_partition(engine)
        assert engine.states[r.rid].generated == _isolated(params, wl, p, 2)
    assert engine.n_shrinks >= 1 and engine.slots_in_use == 0
    assert engine.n_slots == 2
    assert engine.memory_stats().bytes_resident == bytes8 // 4


def test_prefill_overwrites_the_whole_slot_row(jax_run):
    """A slot's earlier occupant must never stay readable: prefill writes
    the prompt's K/V and zeroes the rest of the row up to max_len, in every
    layer of the flat arena."""
    _, params = jax_run
    cfg = _tiny()
    wl = _workload(cfg)
    engine = TorchEngine(cfg, max_len=32, device="cpu", params=params,
                         n_slots=2)
    for leaf in engine.arenas[0].values():
        leaf.fill_(7.0)                          # stale rows everywhere
    r = _mk_req(wl, np.random.default_rng(1), 7, 2)
    engine.register(r, np.random.default_rng(2).integers(2, cfg.vocab_size,
                                                          size=7))
    sb = SubBatch([r])
    run = sb.run_nodes(stop_before={"D0"})
    engine.execute_run("m", sb, run)
    # prefill covers prompt[:-1] = 6 tokens, right-padded to the 8 bucket:
    # rows 6..7 hold the padding tokens' K/V (decode overwrites them before
    # any read), rows 8.. are zeroed
    slot, bucket = engine.slot_of(r), 8
    for leaf in engine.arenas[0].values():
        for k in range(len(engine.kinds)):
            row = leaf[slot + k * engine.n_slots]
            assert torch.all(row[bucket:] == 0)
            assert not torch.any(row == 7.0)
        other = leaf[1 - slot]                   # the unused slot is intact
        assert torch.all(other == 7.0)


def test_pinned_arena_raises_oom_and_release_request_frees(jax_run):
    _, params = jax_run
    cfg = _tiny()
    wl = _workload(cfg)
    rng = np.random.default_rng(0)
    engine = TorchEngine(cfg, max_len=32, device="cpu", params=params,
                         n_slots=1)
    ra, rb = _mk_req(wl, rng, 5, 2), _mk_req(wl, rng, 5, 2)
    for r in (ra, rb):
        engine.register(r, rng.integers(2, cfg.vocab_size, size=5))
    _run_nodes(engine, ra, 2)
    with pytest.raises(BackendOOMError, match="arena exhausted"):
        _run_nodes(engine, rb, 2)
    engine.release_request("m", ra)
    assert ra.rid not in engine.states and engine.slots_in_use == 0
    _assert_partition(engine)


def test_reset_request_replays_identically(jax_run):
    _, params = jax_run
    cfg = _tiny()
    wl = _workload(cfg)
    rng = np.random.default_rng(4)
    engine = TorchEngine(cfg, max_len=32, device="cpu", params=params,
                         n_slots=4)
    r = _mk_req(wl, rng, 7, 3)
    p = rng.integers(2, cfg.vocab_size, size=7)
    engine.register(r, p)
    sb = SubBatch([r])
    run = sb.run_nodes(stop_after={"head"})
    engine.execute_run("m", sb, run)
    first = list(engine.states[r.rid].generated)
    engine.reset_request("m", r)
    st = engine.states[r.rid]
    assert st.generated == [] and st.pos == st.prefill_len
    assert engine.slots_in_use == 0
    r2 = _mk_req(wl, rng, 7, 3)
    engine.register(r2, p)
    _run_nodes(engine, r2)
    assert engine.states[r2.rid].generated[:len(first)] == first


def test_multibackend_routes_to_torch_engines(jax_run):
    _, params = jax_run
    cfg = _tiny()
    a = TorchEngine(cfg, max_len=32, device="cpu", params=params, n_slots=2)
    b = TorchEngine(cfg, max_len=32, device="cpu", params=params, n_slots=4)
    mux = MultiBackend({"a": a, "b": b})
    assert mux.memory_stats("b").slots_total == 4
    agg = mux.memory_stats()
    assert agg.slots_total == 6
    assert agg.bytes_resident == (a.memory_stats().bytes_resident
                                  + b.memory_stats().bytes_resident)
    assert mux.sanitizer_stats().ok


def test_constructor_rejects_unported_modes():
    """Both of JaxEngine's cache modes are ported; any other raises with
    its message, and ``fused`` defaults to on in arena mode alone."""
    with pytest.raises(ValueError, match="cache_mode must be 'arena' or "
                                         "'legacy', got 'paged'"):
        TorchEngine(_tiny(), device="cpu", cache_mode="paged")
    assert TorchEngine(_tiny(), device="cpu").fused is True
    legacy = TorchEngine(_tiny(), device="cpu", cache_mode="legacy")
    assert legacy.fused is False and legacy.arenas == []
