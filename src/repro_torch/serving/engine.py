"""PyTorch node-level serving engine: slot-arena KV cache + fused node runs.

The port of ``repro.serving.engine.JaxEngine`` in arena mode. It executes
the SAME policies against the actual model: scheduling stays node-granular
— every ``(sub_batch, node_id)`` the scheduler emits is a valid dispatch —
and execution is run-granular: a committed run of consecutive nodes is
parsed into phase chunks that execute back to back on the device, with ONE
host synchronisation at the run boundary.

Node ids come from ``workload.from_model_config``:

  * ``emb``   — embed the prompt,
  * ``P<i>``  — prefill layer i over the prompt (writes the layer's cache —
               K/V, or the SSM or RG-LRU state and conv tail — directly
               into the request's arena slot),
  * ``D<i>``  — decode layer i for ONE token, batched with ragged per-row
               positions across the merged sub-batch,
  * ``head``  — final norm + unembed + greedy sample.

Cache arena: per-request caches live in a preallocated device arena; a
request owns a lazily assigned slot for its lifetime, and the arena doubles
on demand up to ``max_slots`` and shrinks back as occupancy drops (live
slots are compacted below the watermark). Storage is per span of same-kind
layers in FLAT layout: leaves are ``(span_len * n_slots, ...)`` —
``(…, max_len, KV, hd)`` K/V for GQA attention (dense and MoE blocks),
``(…, max_len, kv_lora)`` ``ckv`` and ``(…, max_len, rope)`` ``krope``
latents for MLA, ``(…, nh, hd, N)`` state and ``(…, W - 1, C)`` conv tail
for SSM, ``(…, w)`` state and ``(…, W - 1, w)`` conv tail for the hybrid's
RG-LRU blocks — and layer k's batch rows sit at ``slots + k * n_slots``.
A hybrid stack (recurrentgemma-9b: rec, rec, attn, ...) is a run of short
spans, one arena each. Its local-attention arena holds ``max_len`` rows,
as ``JaxEngine`` builds it: prefill honours the window, and decode reads
every earlier token of the request, which is what the JAX engine's arena
decode does past the window too (a ring of ``max_len`` rows never wraps).

Fused runs: a decode chunk ``D_i..D_j[+head]`` runs as one Python loop
over the span's layers with the head folded in; a multi-cycle run keeps
each cycle's sampled tokens on the device and feeds them to the next
cycle's embedding. Emb + prefill chunks of attention stacks (dense, MLA)
prefill all members together, right-padded to power-of-two length buckets
(causal attention never lets a valid row read a padded one); SSM and MoE
stacks, and hybrids, prefill each request at its exact length, since a
padded tail would run through the recurrence and change the state, or
take expert capacity and change the routing. Decode batches are padded to a power
of two; padding rows carry an out-of-range slot, their cache writes are
skipped (JAX drops them; torch's ``index_put_`` would raise, or assert on
the device) and their reads are clamped. Positions and last tokens of a stable
membership stay on the device across runs.

There is no compile step: ``sanitizer_stats().retraces`` counts the first
sight of each dispatch shape key — (chunk kind, lo, hi, with_head, padded
batch, ctx or length bucket) — so the JAX contract carries over: after
warmup, no new keys, and at most one host sync per run.

On a CUDA device GQA decode attention, prefill attention (GQA, local and
MLA), the SSM prefill scan and every RMSNorm go through the hand-written
kernels of ``repro_torch.kernels``; on the CPU (``device="cpu"``, as the
tests run it) they take their plain versions. MLA decode over the latent
cache, the MoE FFN and the RG-LRU are PyTorch ops, as the JAX model
computes them with jnp.

Legacy mode (``cache_mode="legacy"``): the seed's restacking path, kept
as the exactness reference and as the baseline the arena is timed
against. No arena is built; each request keeps its own caches
(``EngineState.caches``, layer -> cache), every dispatch goes node by
node whatever ``fused`` says, prefill runs each request alone at its
exact length and pads its time leaves (K/V, ``ckv``, ``krope``) to
``max_len``, and a decode node stacks the B members' caches of its
layer, steps them without slots or batch padding (B exactly), and
copies each row back into storage of the request's own. A hybrid's
local-attention cache is then a ring of ``max_len`` rows, as in
``JaxEngine``'s legacy mode, which never wraps. ``JaxEngine`` runs no
Pallas kernel in this mode; this one has no such switch, so on a CUDA
device its legacy decode goes through the ragged decode kernel (at any
B, over the contiguous stack) and its prefill through flash and RMSNorm,
and on the CPU through their plain versions.

Token semantics are exact: prefill covers ``prompt[:-1]`` and the prompt's
last token is the first decode input, so every token is processed once.
The ``RuntimeFlags`` variants are reached through the ``Model`` API alone:
the engine builds its model with ``dtype``, as ``JaxEngine`` does.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.request import Request, SubBatch
from ..models import layers as L
from ..models.cost import _layer_kinds
from ..models.model import Model, RuntimeFlags
from .backend import Backend, BackendOOMError, MemoryStats, SanitizerStats

# cache leaves whose leading (post-slot) axis is the KV time axis
_TIME_AXIS_KEYS = ("k", "v", "ckv", "krope")

# block kinds that read no context: their spans take no ctx bucket
_NO_CONTEXT = ("ssm", "rec")

# slot sentinel for batch-bucket padding rows: far out of range for any
# arena size; must never be reachable by arena growth
_PAD_SLOT = 2 ** 30


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class EngineState:
    """Mutable per-request execution state."""

    def __init__(self, prompt_tokens: np.ndarray):
        if len(prompt_tokens) < 2:
            raise ValueError(
                f"engine needs prompts of >= 2 tokens (teacher-forced "
                f"prefill predicts token i+1 from token i), got "
                f"{len(prompt_tokens)}")
        self.prompt_np = np.asarray(prompt_tokens, np.int32)
        self.prefill_len = int(len(prompt_tokens) - 1)
        self.x: Optional[torch.Tensor] = None     # activations in flight
        self.generated: List[int] = []
        self.next_token: int = int(prompt_tokens[-1])
        self.pos: int = self.prefill_len          # next KV slot to write
        self.caches: Dict[int, dict] = {}         # legacy mode: layer -> cache


class TorchEngine(Backend):
    """Executes workload nodes on a real model with PyTorch.

    One engine holds ONE model's parameters and KV arena; the ``model`` key
    of the Backend contract is accepted and ignored (multi-tenant sessions
    put one engine per model behind a ``MultiBackend``).

    ``device``: ``None`` means ``"cuda"`` — and raises when there is no
    CUDA device; the CPU runs only when asked for (``device="cpu"``).
    ``params``: a parameter dict in the port's layout (e.g. JAX weights
    through ``models.convert.params_from_jax``); by default the model is
    initialised from a ``torch.Generator`` seeded with ``seed``.
    ``cache_mode``: ``"arena"`` (default) keeps every request's caches in
    the slot arena; ``"legacy"`` keeps per-request caches and restacks
    them at every decode dispatch (see the module docstring).
    ``fused``: fuse committed multi-node runs (by default on in arena
    mode); ``False`` dispatches node by node, the exactness reference.
    Legacy mode always dispatches node by node.
    """

    def __init__(self, cfg: ModelConfig, *, max_len: int = 512, seed: int = 0,
                 dtype: torch.dtype = torch.float32, device=None,
                 n_slots: Optional[int] = None,
                 max_slots: Optional[int] = None,
                 min_slots: Optional[int] = None,
                 auto_shrink: Optional[bool] = None,
                 cache_mode: str = "arena", fused: Optional[bool] = None,
                 params: Optional[dict] = None):
        if cache_mode not in ("arena", "legacy"):
            raise ValueError(f"cache_mode must be 'arena' or 'legacy', "
                             f"got {cache_mode!r}")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchEngine: no CUDA device is available — pass "
                "device='cpu' to run the plain (non-kernel) CPU path")
        # arena sizing, as JaxEngine: explicit n_slots WITHOUT max_slots
        # pins the arena; otherwise it is paged (grows to max_slots,
        # shrinks back toward min_slots)
        pinned = n_slots is not None and max_slots is None
        if n_slots is None:
            n_slots = min_slots if min_slots is not None else 32
            if max_slots is not None:
                n_slots = min(n_slots, max_slots)
        if max_slots is not None and max_slots < n_slots:
            raise ValueError(
                f"max_slots ({max_slots}) must be >= the starting arena "
                f"size n_slots ({n_slots})")
        self.max_slots = max_slots
        self._min_slots = min_slots if min_slots is not None else n_slots
        self._auto_grow = not pinned
        self._auto_shrink = (not pinned) if auto_shrink is None else auto_shrink
        self.n_grows = 0
        self.n_shrinks = 0
        self.cfg = cfg
        self.model = Model(cfg, RuntimeFlags(dtype=dtype))
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = self.model.init(gen)
        self.params = _tree_to(params, self.device)
        self._layers = self.model.layer_params(self.params)
        self.kinds = _layer_kinds(cfg)
        self.max_len = max_len
        self.cache_mode = cache_mode
        self.fused = (cache_mode == "arena") if fused is None else fused
        self.states: Dict[int, EngineState] = {}
        self.nodes_executed = 0
        self.runs_executed = 0
        # layers stepped by batched decode, one per layer per decode step
        # (fused or not): the unit a profile's op count is read against
        self.decode_layer_steps = 0
        self._seen_keys: set = set()
        self._san_retraces = 0
        self._san_host_syncs = 0
        self._san_max_syncs_per_run = 0
        # membership-keyed device caches (see JaxEngine): batched decode
        # activations, the (Bp,) slot vector, and the device-carried
        # position / last-token vectors of a stable membership
        self._xbatch: Optional[tuple] = None
        self._slotbatch: Optional[tuple] = None
        self._posbatch: Optional[tuple] = None
        self._tokbatch: Optional[tuple] = None
        self._chunk_cache: Dict[tuple, tuple] = {}
        self.n_slots = n_slots
        self._free_slots: deque = deque(range(n_slots))
        self._slot: Dict[int, int] = {}          # rid -> slot
        # maximal same-kind layer spans (a dense stack is one span)
        spans: List[tuple] = []
        for i, kind in enumerate(self.kinds):
            if spans and spans[-1][0] == kind:
                spans[-1] = (kind, spans[-1][1], i)
            else:
                spans.append((kind, i, i))
        self._spans = spans
        self._layer_loc = {i: (si, i - lo)
                           for si, (_, lo, hi) in enumerate(spans)
                           for i in range(lo, hi + 1)}
        self.arenas: List[dict] = []
        for (kind, lo, hi) in (spans if cache_mode == "arena" else ()):
            one = self.model._init_layer_cache(kind, n_slots, max_len,
                                               device=self.device)
            span_len = hi - lo + 1
            self.arenas.append({
                k: torch.zeros((span_len * l.shape[0],) + tuple(l.shape[1:]),
                               dtype=l.dtype, device=self.device)
                for k, l in one.items()})

    # ------------------------------------------------------------------
    # Request registration / slot lifecycle
    # ------------------------------------------------------------------
    def register(self, req: Request, prompt_tokens: np.ndarray):
        self.states[req.rid] = EngineState(prompt_tokens)

    def prepare(self, model, req: Request, rng, prompt_tokens=None):
        """Backend-contract hook (ServingSession.submit): register the
        supplied prompt, or a synthetic one of ``req.prompt_len`` drawn
        from ``rng`` (the session's seeded generator — the same draws
        JaxEngine makes). Idempotent for pre-registered requests."""
        if req.rid in self.states:
            return
        if prompt_tokens is None:
            prompt_tokens = rng.integers(2, self.cfg.vocab_size,
                                         size=max(2, req.prompt_len))
        self.register(req, np.asarray(prompt_tokens))

    def token_count(self, model, req: Request) -> int:
        st = self.states.get(req.rid)
        return (len(st.generated) if st is not None
                else super().token_count(model, req))

    def tokens(self, model, req: Request):
        st = self.states.get(req.rid)
        return st.generated if st is not None else None

    def state(self, req: Request) -> EngineState:
        return self.states[req.rid]

    def slot_of(self, req: Request) -> int:
        """Arena slot owned by ``req`` (lazily assigned at first use)."""
        slot = self._slot.get(req.rid)
        if slot is None:
            if not self._free_slots:
                if not self._auto_grow:
                    raise BackendOOMError(
                        f"cache arena exhausted: {self.n_slots} slots all "
                        f"held by live requests — raise "
                        f"TorchEngine(n_slots=...) above the policy's max "
                        f"concurrent batch size")
                self._grow_arena()
            slot = self._free_slots.popleft()
            self._slot[req.rid] = slot
        return slot

    def _grow_arena(self):
        """Double the slot capacity (capped at ``max_slots``): unfold the
        layer axis, widen the slot axis with zero rows, refold. Existing
        rows keep their slot ids."""
        old = self.n_slots
        new = 2 * old if self.max_slots is None else min(2 * old,
                                                         self.max_slots)
        if new <= old:
            raise BackendOOMError(
                f"cache arena exhausted at its memory cap: all "
                f"{self.n_slots} slots (max_slots={self.max_slots}) held "
                f"by live requests — raise TorchEngine(max_slots=...) or "
                f"enable memory-aware admission so the scheduler defers "
                f"work instead of overcommitting device memory")
        if new >= _PAD_SLOT:
            raise RuntimeError(
                f"arena growth to {new} slots would reach the padded-row "
                f"sentinel (_PAD_SLOT={_PAD_SLOT})")

        def grow(l):
            span_len = l.shape[0] // old
            r = l.reshape(span_len, old, *l.shape[1:])
            z = torch.zeros((span_len, new - old) + tuple(l.shape[1:]),
                            dtype=l.dtype, device=l.device)
            return torch.cat([r, z], dim=1).reshape(span_len * new,
                                                    *l.shape[1:])

        self.arenas = [{k: grow(l) for k, l in span.items()}
                       for span in self.arenas]
        self.n_slots = new
        self.n_grows += 1
        self._free_slots.extend(range(old, self.n_slots))

    def _maybe_shrink(self):
        """Reclaim arena memory when occupancy has dropped: fires only when
        capacity exceeds twice the target ``max(pow2(2 * live),
        min_slots)``, so a stable working set never thrashes."""
        if not self._auto_shrink or not self.arenas:
            return
        live = len(self._slot)
        target = max(_pow2(2 * live) if live else 1, self._min_slots)
        if target * 2 <= self.n_slots:
            self._shrink_arena(target)

    def _shrink_arena(self, target: int):
        """Compact live slots below ``target`` (relocating their rows in
        every span arena, verbatim) and cut the arena to ``target`` slots.
        The cut copies into fresh storage, so the old arena is freed."""
        old = self.n_slots
        if not (target < old and len(self._slot) <= target):
            raise RuntimeError(
                f"_shrink_arena precondition violated: target={target} "
                f"must be < current {old} slots and hold all "
                f"{len(self._slot)} live slots")
        moving = sorted(s for s in self._slot.values() if s >= target)
        free_low = sorted(s for s in self._free_slots if s < target)
        dst_of = dict(zip(moving, free_low))
        for rid, s in self._slot.items():
            if s in dst_of:
                self._slot[rid] = dst_of[s]
        src_np = np.fromiter(dst_of.keys(), np.int64, len(dst_of))
        dst_np = np.fromiter(dst_of.values(), np.int64, len(dst_of))
        with torch.no_grad():
            for si, (_, lo, hi) in enumerate(self._spans):
                span_len = hi - lo + 1
                offs = np.arange(span_len, dtype=np.int64) * old
                src = self._upload((src_np[None, :] + offs[:, None]).ravel())
                dst = self._upload((dst_np[None, :] + offs[:, None]).ravel())

                def compact(l):
                    if len(src_np):
                        l[dst] = l[src]
                    r = l.reshape(span_len, old, *l.shape[1:])
                    return r[:, :target].reshape(
                        span_len * target, *l.shape[1:]).clone()

                self.arenas[si] = {k: compact(l)
                                   for k, l in self.arenas[si].items()}
        self.n_slots = target
        self.n_shrinks += 1
        used = set(self._slot.values())
        self._free_slots = deque(s for s in range(target) if s not in used)
        # slot ids moved: the membership-keyed slot vector is stale
        self._slotbatch = None

    def release_slot(self, req: Request):
        """Return ``req``'s slot to the free pool (idempotent)."""
        self._release_slots([req])

    def _release_slots(self, reqs: Sequence[Request]):
        """Release a batch of slots, then reclaim ONCE."""
        released = False
        for r in reqs:
            slot = self._slot.pop(r.rid, None)
            if slot is not None:
                self._free_slots.append(slot)
                released = True
        if released:
            self._maybe_shrink()

    @property
    def slots_in_use(self) -> int:
        return len(self._slot)

    def memory_stats(self, model=None):
        """Arena accounting: slots live/free at current capacity and the
        device-resident bytes of every span arena tensor. Legacy mode has
        no arena and reports 0 bytes, as ``JaxEngine`` does: its
        per-request caches are not counted."""
        total_bytes = sum(l.numel() * l.element_size()
                          for span in self.arenas for l in span.values())
        return MemoryStats(
            slots_total=self.n_slots,
            slots_live=len(self._slot),
            slots_free=len(self._free_slots),
            bytes_resident=int(total_bytes),
            bytes_per_slot=total_bytes / max(1, self.n_slots),
            max_slots=self.max_slots,
            pool=id(self))

    def sanitizer_stats(self, model=None):
        """Committed runs, run-boundary host sync events, and first
        sightings of dispatch shape keys (the eager counterpart of jit
        traces). Steady state must add no key and at most one sync per
        run."""
        return SanitizerStats(
            runs=self.runs_executed,
            host_syncs=self._san_host_syncs,
            retraces=self._san_retraces,
            max_syncs_per_run=self._san_max_syncs_per_run)

    def shape_keys(self) -> frozenset:
        """Every dispatch shape key seen so far (see sanitizer_stats)."""
        return frozenset(self._seen_keys)

    def _note_key(self, key: tuple):
        if key not in self._seen_keys:
            self._seen_keys.add(key)
            self._san_retraces += 1

    def on_finished(self, model, reqs: Sequence[Request]) -> None:
        self._release_slots(reqs)

    def reset_request(self, model, req: Request) -> None:
        """Fault recovery: drop the request's device-side progress. The
        membership-keyed device caches that hold it are invalidated
        without flushing, its slot returns to the pool, and its host state
        rewinds to the post-``prepare`` point so a retry replays prefill
        and regenerates the same tokens."""
        rid = req.rid
        if self._xbatch is not None and rid in self._xbatch[0]:
            self._xbatch = None
        if self._slotbatch is not None and rid in self._slotbatch[0]:
            self._slotbatch = None
        if self._posbatch is not None and rid in self._posbatch[0][0]:
            self._posbatch = None
        if self._tokbatch is not None and rid in self._tokbatch[0][0]:
            self._tokbatch = None
        self._release_slots([req])
        st = self.states.get(rid)
        if st is not None:
            st.x = None
            st.caches = {}
            st.generated = []
            st.next_token = int(st.prompt_np[-1])
            st.pos = st.prefill_len

    def release_request(self, model, req: Request) -> None:
        """Drop the request's state, its legacy-mode caches with it, once
        the caller is done with its results (``ServingSession.release``)."""
        self.release_slot(req)
        self.states.pop(req.rid, None)

    # ------------------------------------------------------------------
    # Host <-> device
    # ------------------------------------------------------------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without a host sync: on CUDA the
        copy goes from pinned memory and does not wait for the stream."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # Batched-activation cache
    # ------------------------------------------------------------------
    def _flush_xbatch(self):
        if self._xbatch is not None:
            rids, x = self._xbatch
            for bi, rid in enumerate(rids):
                st = self.states.get(rid)
                if st is not None:
                    st.x = x[bi]
            self._xbatch = None

    def _batched_x(self, reqs, sts, fresh=None):
        """(rids, (B, d) activations) for the current membership; ``fresh``
        (decode-cycle entry embeddings) bypasses both cache and stack."""
        rids = tuple(r.rid for r in reqs)
        if self._xbatch is not None and self._xbatch[0] != rids:
            self._flush_xbatch()                  # preserve ex-members' rows
        if fresh is not None:
            x = fresh
        elif self._xbatch is not None:
            x = self._xbatch[1]
        else:
            x = torch.stack([st.x for st in sts])
        return rids, x

    def _batched_slots(self, reqs, rids, padded_to: Optional[int] = None):
        """(B,)-or-(Bp,) int32 slot vector for the membership; padding rows
        get the out-of-range sentinel."""
        Bp = padded_to or len(reqs)
        if self._slotbatch is None or self._slotbatch[0] != rids \
                or self._slotbatch[1] != Bp:
            slots = [self.slot_of(r) for r in reqs]
            slots += [_PAD_SLOT] * (Bp - len(slots))
            # slot ids are host ints: an upload, not a sync
            # reprolint: disable=sync-point
            ids = self._upload(np.asarray(slots, np.int32))
            self._slotbatch = (rids, Bp, ids)
        return self._slotbatch[2]

    def _node_meta(self, wl, node_id: str):
        """(phase, layer) for a node: NodeDesc metadata when present,
        engine node-id convention as fallback."""
        nd = wl.nodes.get(node_id) if wl is not None else None
        if nd is not None and getattr(nd, "phase", ""):
            return nd.phase, nd.layer
        if node_id == "emb":
            return "emb", -1
        if node_id == "head":
            return "head", -1
        if node_id[:1] in ("P", "D") and node_id[1:].isdigit():
            return ("prefill" if node_id[0] == "P" else "decode",
                    int(node_id[1:]))
        raise KeyError(f"unknown node {node_id!r}")

    # ------------------------------------------------------------------
    # Device work
    # ------------------------------------------------------------------
    def _span_parts(self, lo: int, hi: int):
        """(span index, kind, layer params, row offsets k * n_slots) of
        every span overlapping layers [lo, hi]."""
        parts = []
        for si, (kind, slo, shi) in enumerate(self._spans):
            a, b = max(lo, slo), min(hi, shi)
            if a <= b:
                parts.append((si, kind, self._layers[a:b + 1],
                              [(i - slo) * self.n_slots
                               for i in range(a, b + 1)]))
        return parts

    def _head(self, x):
        h = L.rms_norm(x, self.params["final_norm"], self.cfg.norm_eps)
        return torch.argmax(self.model.unembed(self.params, h),
                            dim=-1).to(torch.int32)

    def _mega(self, lo: int, hi: int, with_head: bool, ctx: Optional[int],
              entry, pos, slots, live: int):
        """One fused decode chunk for layers [lo, hi] (+ folded head).
        ``lo == 0``: ``entry`` is the (Bp,) token vector and the decode
        cycle's embedding happens here; ``lo == -1``: bare head over the
        (Bp, d) activation. Only the first ``live`` rows write the arena."""
        self._note_key(("mega", lo, hi, with_head, int(slots.shape[0]), ctx))
        x = self.model.embed(self.params, entry) if lo == 0 else entry
        if lo >= 0:
            self.decode_layer_steps += hi - lo + 1
            for si, kind, bps, offs in self._span_parts(lo, hi):
                x, _ = self.model.apply_span_decode(
                    bps, x, self.arenas[si], pos, offs=offs, slots=slots,
                    ctx=ctx, live=live, kind=kind)
        return self._head(x) if with_head else x

    def _write_prefill(self, arena: dict, cache: dict, rows, n: int):
        """Store the first ``n`` members' prefill cache in arena ``rows``.
        Time-axis leaves (K/V) are zero-padded to ``max_len`` so an earlier
        occupant's stale K/V never stays readable; state and conv leaves
        have the arena's row shape and are written as they are. One write
        of a device tensor per leaf: assigning a Python scalar through a
        tensor index would copy it from the host and wait for the
        stream."""
        for key, a in arena.items():
            c = cache[key][:n].to(a.dtype)
            if key in _TIME_AXIS_KEYS:
                c = torch.nn.functional.pad(
                    c, (0, 0) * (c.dim() - 2) + (0, a.shape[1] - c.shape[1]))
            a[rows] = c

    def _prefill_run(self, lo: int, hi: int, embed: bool, entry,
                     live_slots: np.ndarray):
        """Prefill layers [lo, hi] over a (Bp, S) token bucket
        (``embed=True``) or a (B, S, d) activation batch; every live
        member's layer-k cache goes to arena rows ``slot + k * n_slots``."""
        Bp, S = int(entry.shape[0]), int(entry.shape[1])
        self._note_key(("prefill_run", lo, hi, embed, Bp, S))
        x = self.model.embed(self.params, entry) if embed else entry
        n = len(live_slots)
        slots = self._upload(np.asarray(live_slots, np.int64))
        for si, kind, bps, offs in self._span_parts(lo, hi):
            x, _ = self.model.apply_span_prefill(
                bps, self.arenas[si], x, offs=offs, kind=kind,
                write=lambda arena, cache, off: self._write_prefill(
                    arena, cache, slots + off, n))
        return x

    # ------------------------------------------------------------------
    # Fused run execution
    # ------------------------------------------------------------------
    def _chunk_run(self, wl, node_ids):
        """Split a committed run into fusable phase chunks:
        ("prefill", [(phase, layer), ...]) or ("decode", lo, hi, with_head)
        — a bare head is ("decode", -1, -1, True). Memoized per node-id
        tuple; the value pins the workload so its id() is not recycled."""
        ck = (id(wl), tuple(node_ids))
        cached = self._chunk_cache.get(ck)
        if cached is not None:
            return cached[1]
        metas = [self._node_meta(wl, nid) for nid in node_ids]
        chunks = []
        i = 0
        while i < len(metas):
            ph, layer = metas[i]
            if ph in ("emb", "prefill"):
                j = i
                while j < len(metas) and metas[j][0] in ("emb", "prefill"):
                    j += 1
                chunks.append(("prefill", metas[i:j]))
                i = j
            elif ph == "decode":
                lo = hi = layer
                j = i + 1
                while (j < len(metas) and metas[j][0] == "decode"
                       and metas[j][1] == hi + 1):
                    hi += 1
                    j += 1
                with_head = j < len(metas) and metas[j][0] == "head"
                if with_head:
                    j += 1
                chunks.append(("decode", lo, hi, with_head))
                i = j
            else:                                 # bare head
                chunks.append(("decode", -1, -1, True))
                i += 1
        self._chunk_cache[ck] = (wl, chunks)
        return chunks

    def _prefill_groups(self, reqs, sts):
        """Group members for batched prefill: ``[(members, length)]``.

        Attention stacks (dense/MLA) bucket by power-of-two padded prompt
        length (capped at ``max_len``). Other stacks prefill each request
        at its exact length, keyed ``(prefill_len, rid)``: a padded tail
        would run through the SSM or RG-LRU recurrence and change the
        state, or enter the MoE routing group, take expert capacity and
        change which pairs are dropped."""
        bucketable = set(self.kinds) <= {"dense", "mla"}
        groups: Dict[tuple, list] = {}
        for r, st in zip(reqs, sts):
            if bucketable:
                key = (min(_pow2(st.prefill_len), self.max_len),)
            else:
                key = (st.prefill_len, r.rid)
            groups.setdefault(key, []).append((r, st))
        return [(members, key[0]) for key, members in groups.items()]

    def _run_prefill_chunk(self, reqs, sts, metas):
        has_emb = metas[0][0] == "emb"
        layers = [l for ph, l in metas if ph == "prefill"]
        last = bool(layers) and layers[-1] == len(self.kinds) - 1
        if has_emb and not layers:
            for st in sts:                        # bare emb node
                st.x = self.model.embed(self.params, self._upload(
                    st.prompt_np[None, :st.prefill_len]))
            return
        if has_emb:
            for members, Lb in self._prefill_groups(reqs, sts):
                Bg = len(members)
                toks = np.zeros((_pow2(Bg), Lb), np.int32)
                slots = np.zeros((Bg,), np.int64)
                for bi, (r, st) in enumerate(members):
                    toks[bi, :st.prefill_len] = st.prompt_np[:st.prefill_len]
                    slots[bi] = self.slot_of(r)   # may grow the arena first
                x = self._prefill_run(0, layers[-1], True,
                                      self._upload(toks), slots)
                for bi, (r, st) in enumerate(members):
                    st.x = (None if last
                            else x[bi:bi + 1, :st.prefill_len])
        else:
            # resumed mid-prefill (st.x in flight): per-request span
            for r, st in zip(reqs, sts):
                # a host slot id, not a device value: no sync
                # reprolint: disable=sync-point
                slot = np.asarray([self.slot_of(r)], np.int64)
                st.x = self._prefill_run(layers[0], layers[-1], False,
                                         st.x, slot)
                if last:
                    st.x = None

    @torch.no_grad()
    def execute_run(self, model, sb: SubBatch, node_ids: Sequence[str]):
        """Execute a committed run; returns ``(latency, None)`` — per-node
        latency is unobservable inside a fused run, by design. Legacy
        mode always goes node by node."""
        if self.cache_mode != "arena" or not self.fused or len(node_ids) == 1:
            s0 = self._san_host_syncs
            out = super().execute_run(model, sb, node_ids)
            self._san_max_syncs_per_run = max(
                self._san_max_syncs_per_run, self._san_host_syncs - s0)
            return out
        t0 = time.perf_counter()
        reqs = sb.live_requests
        wl = reqs[0].workload
        sts = [self.states[r.rid] for r in reqs]
        rids = tuple(r.rid for r in reqs)
        if self._xbatch is not None and self._xbatch[0] != rids:
            # another sub-batch is parked mid-cycle: flush its rows to
            # per-request state before this run's epilogue clobbers them
            self._flush_xbatch()
        B = len(reqs)
        Bp = _pow2(B)
        pos0 = None
        slots = None
        toks_dev = None                           # device (Bp,) sampled toks
        x_dev = None                              # device (Bp, d) mid-cycle x
        head_toks: List[torch.Tensor] = []
        n_heads = 0
        chunks = self._chunk_run(wl, node_ids)
        # one context bucket covers every decode chunk of the run, from
        # host positions: the deepest read is pos0 + n_cycles - 1 when the
        # run ends on a head, pos0 + n_cycles with a trailing headless chunk.
        # An SSM stack reads no context: it takes none, and its dispatch
        # shape key does not change as the context grows. A hybrid's
        # recurrent spans ignore the bucket its attention spans read.
        n_cycles = sum(1 for ch in chunks if ch[0] == "decode" and ch[3])
        ctx = None
        if (any(ch[0] == "decode" for ch in chunks)
                and any(k not in _NO_CONTEXT for k in self.kinds)):
            trailing = chunks[-1][0] == "decode" and not chunks[-1][3]
            deepest = (max(st.pos for st in sts) + n_cycles
                       + (1 if trailing else 0))
            ctx = min(_pow2(deepest), self.max_len)
        bkey = (rids, Bp)
        for ch in chunks:
            if ch[0] == "prefill":
                self._run_prefill_chunk(reqs, sts, ch[1])
                continue
            _, lo, hi, with_head = ch
            if slots is None:
                slots = self._batched_slots(reqs, rids, padded_to=Bp)
                if self._posbatch is not None and self._posbatch[0] == bkey:
                    pos0 = self._posbatch[1]      # device-carried positions
                else:
                    # host positions: an upload, not a sync
                    # reprolint: disable=sync-point
                    pos0 = self._upload(np.asarray(
                        [st.pos for st in sts] + [0] * (Bp - B), np.int32))
            pos = pos0 if n_heads == 0 else pos0 + n_heads
            if lo == 0:
                if toks_dev is None and self._tokbatch is not None \
                        and self._tokbatch[0] == bkey:
                    toks_dev = self._tokbatch[1]  # device-carried tokens
                if toks_dev is not None:
                    entry = toks_dev
                else:
                    # host tokens: an upload, not a sync
                    # reprolint: disable=sync-point
                    entry = self._upload(np.asarray(
                        [st.next_token for st in sts] + [0] * (Bp - B),
                        np.int32))
            else:
                entry = x_dev if x_dev is not None \
                    else self._entry_x(reqs, sts, B, Bp)
            out = self._mega(lo, hi, with_head, ctx, entry, pos, slots, B)
            if with_head:
                head_toks.append(out)
                toks_dev = out
                x_dev = None
                n_heads += 1
            else:
                x_dev = out
        # ---- run boundary: the ONLY host sync ------------------------
        host = None
        if head_toks:
            host = torch.stack(head_toks).to("cpu", non_blocking=True)
        self._sync()
        if host is not None:
            for row in host.numpy():
                for bi, st in enumerate(sts):
                    # a numpy row, read after the run's one sync
                    # reprolint: disable=sync-point
                    st.next_token = int(row[bi])
                    st.generated.append(st.next_token)
                    st.pos += 1
        if n_heads and pos0 is not None:
            self._posbatch = (bkey, pos0 + n_heads)
            self._tokbatch = (bkey, toks_dev)
        self._xbatch = (rids, x_dev[:B]) if x_dev is not None else None
        self._san_host_syncs += 1
        self._san_max_syncs_per_run = max(self._san_max_syncs_per_run, 1)
        self.nodes_executed += len(node_ids)
        self.runs_executed += 1
        n = len(node_ids)
        self._release_slots([r for r in reqs
                             if r.idx + n >= len(r.sequence)])  # final node
        return time.perf_counter() - t0, None

    def _entry_x(self, reqs, sts, B, Bp):
        rids, x = self._batched_x(reqs, sts)
        self._xbatch = (rids, x)
        if Bp > B:
            x = torch.cat([x, x.new_zeros((Bp - B,) + tuple(x.shape[1:]))])
        return x

    # ------------------------------------------------------------------
    # Single-node dispatch (degenerate run; exactness reference)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def execute(self, model, sb: SubBatch, node_id: str) -> float:
        t0 = time.perf_counter()
        reqs = sb.live_requests
        phase, i = self._node_meta(reqs[0].workload, node_id)
        if phase == "emb":
            for r in reqs:
                st = self.state(r)
                st.x = self.model.embed(self.params, self._upload(
                    st.prompt_np[None, :st.prefill_len]))
        elif self.cache_mode == "legacy" and phase in ("prefill", "decode"):
            self._legacy_node(reqs, phase, i)
        elif phase == "prefill":
            si, k = self._layer_loc[i]
            last = i == len(self.kinds) - 1
            for r in reqs:
                st = self.state(r)
                slot = self.slot_of(r)            # may grow the arena
                S = st.x.shape[1]
                self._note_key(("prefill_node", si, S))
                st.x, cache = self.model.apply_block_dense(
                    self._layers[i], st.x, return_cache=True,
                    kind=self.kinds[i])
                row = self._upload(np.asarray([slot + k * self.n_slots],
                                              np.int64))
                self._write_prefill(self.arenas[si], cache, row, 1)
                if last:
                    st.x = None
        elif phase == "decode":
            sts = [self.state(r) for r in reqs]
            fresh = None
            if i == 0:
                fresh = self.model.embed(self.params, self._upload(
                    np.asarray([st.next_token for st in sts], np.int32)))
            pos = self._upload(np.asarray([st.pos for st in sts], np.int32))
            rids, x = self._batched_x(reqs, sts, fresh)
            si, k = self._layer_loc[i]
            slots = self._batched_slots(reqs, rids)
            self._note_key(("decode_node", si, len(reqs)))
            self.decode_layer_steps += 1
            x, _ = self.model.apply_block_decode(
                self._layers[i], x, self.arenas[si], pos,
                slots=slots + k * self.n_slots, kind=self.kinds[i])
            self._xbatch = (rids, x)
        elif phase == "head":
            sts = [self.state(r) for r in reqs]
            if self.cache_mode == "arena":
                rids, x = self._batched_x(reqs, sts)
                self._xbatch = (rids, x)
            else:
                x = torch.stack([st.x for st in sts])
            self._note_key(("head_node", len(reqs)))
            toks = self._head(x).cpu().numpy()
            for bi, st in enumerate(sts):
                st.next_token = int(toks[bi])
                st.generated.append(st.next_token)
                st.pos += 1
            # single-node head advanced host state: the device-carried
            # run vectors are stale now
            self._posbatch = self._tokbatch = None
        else:
            raise KeyError(f"unknown node {node_id!r}")
        self.nodes_executed += 1
        # per-node dispatch fences every node: one sync event per NODE
        self._sync()
        self._san_host_syncs += 1
        self._release_slots([r for r in reqs
                             if r.idx == len(r.sequence) - 1])
        return time.perf_counter() - t0

    # ------------------------------------------------------------------
    # Legacy mode: per-request caches, restacked at every decode dispatch
    # ------------------------------------------------------------------
    def _legacy_node(self, reqs, phase: str, i: int):
        """A prefill or decode node of layer ``i`` in legacy mode. Prefill
        runs each request alone at its exact length and keeps its padded
        cache; decode stacks the members' layer-``i`` caches, steps them
        without slots at B exactly, and gives each member a copy of its
        row (a view would keep the whole stack alive)."""
        sts = [self.state(r) for r in reqs]
        kind, bp = self.kinds[i], self._layers[i]
        if phase == "prefill":
            last = i == len(self.kinds) - 1
            for st in sts:
                self._note_key(("legacy_prefill", i, st.x.shape[1]))
                st.x, cache = self.model.apply_block_dense(
                    bp, st.x, return_cache=True, kind=kind)
                st.caches[i] = self._pad_cache(cache)
                if last:
                    st.x = None
            return
        if i == 0:
            fresh = self.model.embed(self.params, self._upload(
                np.asarray([st.next_token for st in sts], np.int32)))
            for st, row in zip(sts, fresh):
                st.x = row
        pos = self._upload(np.asarray([st.pos for st in sts], np.int32))
        x = torch.stack([st.x for st in sts])
        cache = {k: torch.stack([st.caches[i][k] for st in sts])
                 for k in sts[0].caches[i]}
        self._note_key(("legacy_decode", i, len(sts)))
        self.decode_layer_steps += 1
        x, cache = self.model.apply_block_decode(bp, x, cache, pos, kind=kind)
        for bi, st in enumerate(sts):
            st.caches[i] = {k: leaf[bi].clone() for k, leaf in cache.items()}
            st.x = x[bi]

    def _pad_cache(self, cache: dict) -> dict:
        """One request's prefill cache without its batch axis, in storage
        of its own: the time leaves (``_TIME_AXIS_KEYS``) zero-padded to
        ``max_len`` so that merged decode batches stack one shape, the
        state and conv leaves as they are."""
        out = {}
        for key, leaf in cache.items():
            leaf = leaf[0]
            if key in _TIME_AXIS_KEYS:
                pad_n = self.max_len - leaf.shape[0]
                if pad_n < 0:
                    raise ValueError(
                        f"cache leaf time-dim {tuple(leaf.shape)} exceeds "
                        f"engine max_len {self.max_len}")
                leaf = torch.nn.functional.pad(
                    leaf, (0, 0) * (leaf.dim() - 1) + (0, pad_n))
            else:
                leaf = leaf.clone(memory_format=torch.contiguous_format)
            out[key] = leaf
        return out
