"""Decoder model of the port: ``repro.models.model`` in PyTorch.

``Model`` consumes a ``ModelConfig`` and provides:

  * ``init(generator)``   — parameter dict on the generator's device, with
                             the JAX ``Model.init`` layout, shapes and scales
                             (blocks stacked on a leading layer axis),
  * ``loss(params, batch)`` — the training loss (cross-entropy plus 0.01
                             times the MoE load-balance loss), with its
                             parts; differentiable through the kernels,
  * ``prefill(params, tokens, prefix=None)`` — full-context forward,
                             returns (last-token logits, decode cache),
  * ``decode_step(params, cache, token, pos)`` — ONE token with ragged
                             per-row positions (lazily merged batches),
  * ``init_cache(batch, max_len, device=...)``,
  * per-block and per-span application for the LazyBatching engine.

Block kinds: ``"dense"`` (GQA attention + SwiGLU MLP), ``"mla"`` (MLA
attention + SwiGLU MLP, cache ``{"ckv", "krope"}``), ``"moe"`` (GQA
attention + the top-k MoE FFN of ``models/moe.py``), ``"ssm"`` (Mamba-2
mixer, ``models/ssm.py``), and the hybrid's ``"rec"`` (RG-LRU of
``models/rglru.py`` + SwiGLU MLP, cache ``{"state", "conv"}``) and
``"attn"`` (the dense block with the config's ``local_window``). A hybrid
stack repeats its ``block_pattern`` in groups, with the layers past the
last whole group as a tail: ``params["blocks"]`` holds one entry
``b{i}_{kind}`` per pattern position, stacked over the groups, and
``params["tail"]`` the tail's blocks, stacked — the JAX layout. The JAX
package scans homogeneous layer stacks with ``lax.scan``; here a span is
a Python loop over per-layer parameter views, and the flat slot arena is
updated in place. The ``RuntimeFlags`` variants that change what the JAX
model computes — ``window``, ``kv_quant``, ``mla_absorbed`` and
``moe_group_rows`` — are ported, and only the ``Model`` API reaches them:
the engine builds its model with ``dtype`` alone, as ``JaxEngine`` does.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from ..configs.base import ModelConfig
from ..sharding import is_dtensor, shard
from ..sharding import local as SL
from . import layers as L
from . import moe as MOE
from .cost import _layer_kinds
from . import rglru as RG
from . import ssm as SSM


@dataclass(frozen=True)
class RuntimeFlags:
    """The JAX ``RuntimeFlags`` that change the model's arithmetic, with
    their defaults:

      * ``window``: a sliding window for dense, MoE and MLA stacks —
        prefill attends keys > i - window, decode caches are rings of
        ``min(max_len, window)`` rows (the ``long_500k`` serve step). A
        hybrid keeps its ``local_window`` and ignores it, and ``loss``
        passes no window, as in JAX;
      * ``kv_quant``: int8 K/V caches for GQA blocks (dense, MoE and the
        hybrid's local attention) with a float32 scale per (token, kv
        head); a prefill cache stays unquantized;
      * ``mla_absorbed``: MLA prefill (and ``loss``) in the latent space;
      * ``moe_group_rows``: batch rows per MoE routing group;
      * ``remat`` / ``remat_policy``: rematerialise each block (each
        hybrid group) in the backward pass with
        ``torch.utils.checkpoint`` where the JAX model applies
        ``jax.checkpoint``: "full" recomputes everything, "dots" saves the
        matrix products' outputs (``checkpoint_dots``). Only a pass with
        grad enabled is affected.

    The JAX fields with no counterpart: ``grouped_decode`` and
    ``pallas_decode`` (this decode never repeats K/V heads and always
    takes the ragged-decode kernel on the card), ``attn_chunk`` (flash
    computes the same function unchunked; the absorbed MLA loop chunks at
    the JAX default 2048), ``use_scan`` and ``scan_unroll`` (XLA compile
    settings)."""
    dtype: torch.dtype = torch.bfloat16
    window: Optional[int] = None
    kv_quant: bool = False
    mla_absorbed: bool = False
    moe_group_rows: int = 1
    remat: bool = False
    remat_policy: str = "full"


# the ATen matrix products that ``x @ w``, ``torch.einsum`` and
# ``torch.matmul`` lower to
_DOT_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.baddbmm.default))


def _save_dots(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat_policy="dots"``: save
    every matrix product's output, recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _stack_into(stacked, tree, i: int, n: int):
    """Write layer ``i``'s ``tree`` into the stacked tree of ``n`` layers,
    allocating each stacked leaf at layer 0: the blocks are never held
    twice (``torch.stack`` of 40 float32 mistral-nemo-12b layers would
    need 96 GB at its peak)."""
    if isinstance(tree, dict):
        if stacked is None:
            stacked = {}
        for k, v in tree.items():
            stacked[k] = _stack_into(stacked.get(k), v, i, n)
        return stacked
    if stacked is None:
        stacked = tree.new_empty((n,) + tuple(tree.shape))
    stacked[i] = tree
    return stacked


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree) -> list:
    """Per-layer views of a stacked tree, one ``torch.unbind`` per leaf.
    Under autograd the views' gradients stack into the leaf in one op;
    indexing layer by layer would add a zero-filled copy of the whole
    stacked leaf per layer (at llama3.2-1b's width 16 x 4 GB a step)."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _gather_rows(tree, slots):
    """Select per-batch rows out of a slot arena (no-op without slots).
    Slot indices are clamped in range: batch-bucket padding rows carry an
    out-of-range slot, and the clamped gather reads some live row whose
    output is discarded downstream."""
    if slots is None:
        return tree
    if isinstance(tree, dict):
        return {k: _gather_rows(v, slots) for k, v in tree.items()}
    return tree[torch.clamp(slots, max=tree.shape[0] - 1)]


def _scatter_rows(arena, rows, slots, live: Optional[int] = None):
    """Write updated batch rows back into their arena slots, in place.
    Only the first ``live`` rows are written: padding rows (the tail) must
    never corrupt a live slot, and their out-of-range slot would make
    ``index_put_`` raise."""
    if slots is None:
        return rows
    if isinstance(arena, dict):
        return {k: _scatter_rows(arena[k], rows[k], slots, live)
                for k in arena}
    n = rows.shape[0] if live is None else live
    arena[slots[:n]] = rows[:n].to(arena.dtype)
    return arena


class Model:
    def __init__(self, cfg: ModelConfig, flags: RuntimeFlags = RuntimeFlags()):
        kinds = set(cfg.hybrid.block_pattern) if cfg.hybrid else set()
        if (cfg.family != "ssm" and cfg.attention not in ("gqa", "mla")) \
                or not kinds <= {"rec", "attn"}:
            raise NotImplementedError(
                f"{cfg.name}: the PyTorch port serves GQA and MLA attention, "
                f"SSM stacks and hybrid patterns of 'rec' and 'attn' blocks "
                f"(attention {cfg.attention!r}, pattern {sorted(kinds)})")
        self.cfg = cfg
        self.flags = flags
        if cfg.hybrid is not None:
            self.n_groups, self.n_tail = divmod(cfg.num_layers,
                                                len(cfg.hybrid.block_pattern))
        else:
            self.n_groups, self.n_tail = cfg.num_layers, 0

    @property
    def block_kind(self) -> str:
        c = self.cfg
        if c.family == "ssm":
            return "ssm"
        if c.moe is not None:
            return "moe"
        if c.attention == "mla":
            return "mla"
        return "dense"

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------
    def _init_block(self, gen: Optional[torch.Generator], kind: str,
                    dev) -> dict:
        cfg, dtype = self.cfg, self.flags.dtype
        d = cfg.d_model
        if kind == "ssm":
            return {"ln1": L.init_rmsnorm(d, dev),
                    "ssm": SSM.init_ssm(gen, cfg, dtype, dev)}
        if kind == "rec":
            return {"ln1": L.init_rmsnorm(d, dev),
                    "rec": RG.init_rglru_block(gen, cfg, dtype, dev),
                    "ln2": L.init_rmsnorm(d, dev),
                    "mlp": L.init_mlp(gen, d, cfg.d_ff, dtype, dev)}
        attn = (L.init_mla(gen, cfg, dtype, dev) if kind == "mla"
                else L.init_attention(gen, cfg, dtype, dev))
        ffn = ({"moe": MOE.init_moe(gen, cfg, dtype, dev)} if kind == "moe"
               else {"mlp": L.init_mlp(gen, d, cfg.d_ff, dtype, dev)})
        return {"ln1": L.init_rmsnorm(d, dev), "attn": attn,
                "ln2": L.init_rmsnorm(d, dev), **ffn}

    def init(self, gen: Optional[torch.Generator] = None, *,
             device=None) -> dict:
        """Seeded parameters on ``gen.device``: the shapes and scales of the
        JAX ``Model.init`` (normal draws in float32 cast to the model dtype,
        norm scales float32 ones). The numbers differ from JAX's: a torch
        generator is not a JAX key — load JAX weights through
        :func:`repro_torch.models.convert.params_from_jax` to match them.
        ``init(device="meta")`` without a generator gives the same tree of
        shapes and dtypes and allocates nothing (``jax.eval_shape`` of the
        JAX init: the spec derivation reads it)."""
        if gen is None:
            dev = torch.device("meta" if device is None else device)
            if dev.type != "meta":
                raise ValueError("Model.init: a generator is needed for "
                                 "weights on a real device")
        else:
            dev = gen.device
        cfg, dtype = self.cfg, self.flags.dtype
        d = cfg.d_model
        params = {
            "embed": {"tok": L._normal(gen, (cfg.vocab_size, d),
                                       1.0 / math.sqrt(d), dtype, dev)},
            "final_norm": L.init_rmsnorm(d, dev),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = L._normal(gen, (d, cfg.vocab_size),
                                          1.0 / math.sqrt(d), dtype, dev)
        if cfg.hybrid is not None:
            pat = cfg.hybrid.block_pattern
            blocks, tail = None, None
            for g in range(self.n_groups):
                group = {f"b{i}_{kind}": self._init_block(gen, kind, dev)
                         for i, kind in enumerate(pat)}
                blocks = _stack_into(blocks, group, g, self.n_groups)
            for i in range(self.n_tail):
                tail = _stack_into(tail, self._init_block(gen, pat[i], dev),
                                   i, self.n_tail)
            params["blocks"] = blocks
            if self.n_tail:
                params["tail"] = tail
            return params
        blocks = None
        for i in range(cfg.num_layers):
            blocks = _stack_into(blocks,
                                 self._init_block(gen, self.block_kind, dev),
                                 i, cfg.num_layers)
        params["blocks"] = blocks
        return params

    def layer_kinds(self) -> List[str]:
        """The block kind of every layer: the hybrid's pattern repeated
        (``"rec"`` / ``"attn"``), else ``block_kind`` throughout."""
        return _layer_kinds(self.cfg)

    def layer_params(self, params: dict) -> List[dict]:
        """Per-layer views into the stacked ``params["blocks"]`` (and, for
        a hybrid, ``params["tail"]``), as ``JaxEngine._layer_params``:
        hybrid layer i is pattern position i % P of group i // P, or tail
        block i - groups * P."""
        cfg = self.cfg
        if cfg.hybrid is None:
            return _unbind(params["blocks"])
        pat = cfg.hybrid.block_pattern
        groups = {k: _unbind(v) for k, v in params["blocks"].items()}
        tail = _unbind(params["tail"]) if self.n_tail else []
        out = []
        for i in range(cfg.num_layers):
            g, j = divmod(i, len(pat))
            out.append(groups[f"b{j}_{pat[j]}"][g] if g < self.n_groups
                       else tail[i - self.n_groups * len(pat)])
        return out

    def _window(self, kind: str) -> Optional[int]:
        """The sliding window of ``kind``'s attention: the hybrid's
        ``local_window`` for its ``"attn"`` blocks, ``flags.window`` for
        dense, MoE and MLA blocks, none for SSM and RG-LRU blocks."""
        if kind == "attn":
            return self.cfg.hybrid.local_window
        if kind in ("dense", "moe", "mla"):
            return self.flags.window
        return None

    # ------------------------------------------------------------------
    # Single-block application
    # ------------------------------------------------------------------
    def _rope(self, kind: str, positions):
        """The RoPE tables of ``positions`` for ``kind``'s attention: MLA
        rotates only its ``qk_rope_head_dim`` columns, GQA its whole
        heads."""
        if kind == "mla":
            return L.mla_rope_tables(positions, self.cfg)
        return L.rope_tables(positions, self.cfg.head_dim,
                             self.cfg.rope_theta)

    def _ffn(self, bp: dict, x, aux: Optional[list] = None):
        """ln2 and the block's FFN: the MoE on (B, S, d) rows (a decode
        row (B, d) is one token of S 1), routed in groups of
        ``flags.moe_group_rows`` rows, else the SwiGLU MLP. With an
        ``aux`` list, the MoE appends its load-balance loss to it."""
        h = L.rms_norm(x, bp["ln2"], self.cfg.norm_eps)
        if "moe" not in bp:
            return L.apply_mlp(bp["mlp"], h)
        rows = self.flags.moe_group_rows
        if h.dim() == 2:
            return MOE.apply_moe(bp["moe"], h[:, None, :], self.cfg,
                                 group_rows=rows)[:, 0]
        if aux is None:
            return MOE.apply_moe(bp["moe"], h, self.cfg, group_rows=rows)
        y, a = MOE.apply_moe(bp["moe"], h, self.cfg, with_aux=True,
                             group_rows=rows)
        aux.append(a)
        return y

    def apply_block_dense(self, bp: dict, x, *, kind: str,
                          return_cache: bool, rope=None,
                          aux: Optional[list] = None):
        """One prefill block of ``kind``; ``rope``: the RoPE tables of
        the positions (``_rope``), by default those of 0..S-1 (attention
        blocks only); ``aux``: a list that collects an MoE block's
        load-balance loss (training). Attention takes ``_window(kind)``,
        MLA ``flags.mla_absorbed``."""
        window = self._window(kind)
        cfg = self.cfg
        if kind == "ssm":
            h, cache = SSM.apply_ssm_dense(
                bp["ssm"], L.rms_norm(x, bp["ln1"], cfg.norm_eps), cfg,
                with_cache=return_cache)
            return x + h, cache
        xn = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
        if kind == "rec":
            h, cache = RG.apply_rglru_dense(bp["rec"], xn, cfg)
        elif kind == "mla":
            h, cache = L.apply_mla_dense(bp["attn"], xn, cfg, rope=rope,
                                         window=window,
                                         absorbed=self.flags.mla_absorbed)
        else:
            h, kv = L.apply_attention_dense(bp["attn"], xn, cfg, rope=rope,
                                            window=window)
            cache = {"k": kv[0], "v": kv[1]}
        x = x + h
        x = x + self._ffn(bp, x, aux)
        return x, (cache if return_cache else None)

    def apply_block_decode(self, bp: dict, x, cache, pos, *, kind: str,
                           slots=None, ctx=None, live=None, rope=None,
                           lengths=None):
        """One decode step for one block of ``kind``; the cache (a slot arena with ``slots``) is updated in
        place. ``live`` counts the real (non-padding) rows; for attention,
        ``ctx`` bounds plain-version reads to a context bucket and
        ``rope``/``lengths`` carry the step's per-position tensors — see
        ``layers.apply_attention_decode`` (an attention cache is a ring of
        its ``_window`` without ``slots``; the arena is not). SSM and
        RG-LRU blocks gather their rows, step the recurrence and write the
        live rows back."""
        cfg = self.cfg
        if kind in ("ssm", "rec"):
            xn = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
            rows_in = _gather_rows(cache, slots)
            if kind == "ssm":
                h, rows = SSM.apply_ssm_decode(bp["ssm"], xn, rows_in, cfg)
            else:
                h, rows = RG.apply_rglru_decode(bp["rec"], xn, rows_in, cfg)
            if slots is None:
                for k, leaf in cache.items():
                    leaf.copy_(rows[k])
            else:
                _scatter_rows(cache, rows, slots, live)
            x = x + h
            return (x if kind == "ssm" else x + self._ffn(bp, x)), cache
        xn = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
        if kind == "mla":
            h, cache = L.apply_mla_decode(
                bp["attn"], xn, cache, pos, cfg, slots=slots, ctx=ctx,
                live=live, rope=rope, window=self._window(kind))
        else:
            h, cache = L.apply_attention_decode(
                bp["attn"], xn, cache, pos, cfg, slots=slots, ctx=ctx,
                live=live, rope=rope, lengths=lengths,
                window=self._window(kind))
        x = x + h
        x = x + self._ffn(bp, x)
        return x, cache

    # ------------------------------------------------------------------
    # Span application (run-fused serving dispatch)
    # ------------------------------------------------------------------
    def _step_tables(self, kind: str, pos):
        """The RoPE tables and int32 lengths of a decode step over the slot
        arena, computed once per span; attention-free spans need
        neither."""
        if kind in ("ssm", "rec"):
            return None, None
        return self._rope(kind, pos), (pos + 1).to(torch.int32)

    def apply_span_decode(self, layer_bps: Sequence[dict], x, flat_arena,
                          pos, *, kind: str, offs: Sequence[int], slots,
                          ctx=None, live=None):
        """One decode step through a span of ``kind`` layers.
        ``flat_arena`` folds the layer axis into the slot
        axis — leaves are ``(span_len * n_slots, ...)`` and layer k's rows
        live at ``slots + offs[k]`` ((B,) int32) — and is updated in
        place."""
        rope, lengths = self._step_tables(kind, pos)
        for bp, off in zip(layer_bps, offs):
            x, _ = self.apply_block_decode(bp, x, flat_arena, pos,
                                           slots=slots + off, ctx=ctx,
                                           live=live, rope=rope,
                                           lengths=lengths, kind=kind)
        return x, flat_arena

    def _prefill_rope(self, kind: str, x):
        if kind in ("ssm", "rec"):
            return None
        return self._rope(kind,
                          torch.arange(x.shape[1], device=x.device)[None, :])

    def apply_span_prefill(self, layer_bps: Sequence[dict], flat_arena, x, *,
                           kind: str, offs: Sequence[int], write=None):
        """Full-prompt prefill (positions 0..S-1) through a span of
        ``kind`` layers (flat arena layout as in
        :meth:`apply_span_decode`). ``write(flat_arena, cache, off)``
        stores each layer's prefill cache into its members' arena rows."""
        rope = self._prefill_rope(kind, x)
        for bp, off in zip(layer_bps, offs):
            x, cache = self.apply_block_dense(bp, x, return_cache=True,
                                              rope=rope, kind=kind)
            if write is not None:
                write(flat_arena, cache, off)
        return x, flat_arena

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------
    def embed(self, params, tokens):
        table = params["embed"]["tok"]
        if is_dtensor(table):
            return SL.embedding(tokens, table).to(self.flags.dtype)
        return table[tokens].to(self.flags.dtype)

    def unembed(self, params, x):
        """x: (..., d) -> logits (..., V), sharded over vocab under rules."""
        if self.cfg.tie_embeddings:
            table = shard(params["embed"]["tok"], "vocab", None)
            return L.matmul(x, table.T)
        logits = L.matmul(x, params["unembed"])
        if logits.dim() == 3:
            logits = shard(logits, "batch", "seq", "vocab")
        return logits

    # ------------------------------------------------------------------
    # Public steps
    # ------------------------------------------------------------------
    def _layer_caches(self, cache) -> List[dict]:
        """Per-layer views into a cache in the JAX layout (see
        :meth:`prefill`), in layer order."""
        group, tail = cache
        cfg = self.cfg
        if cfg.hybrid is None:
            return [_index(group, i) for i in range(cfg.num_layers)]
        pat = cfg.hybrid.block_pattern
        return [_index(group[f"b{i % len(pat)}_{pat[i % len(pat)]}"],
                       i // len(pat)) for i in range(self.n_groups * len(pat))
                ] + list(tail)

    def _embed_with_prefix(self, params, tokens, prefix):
        """Token embeddings, after the ``prefix`` embeddings (B, P, d)
        when given (a VLM's patches, an audio prompt): positions 0..P+S-1
        run over both."""
        x = self.embed(params, tokens)
        if prefix is None:
            return x
        return torch.cat([prefix.to(x.dtype), x], dim=1)

    def _run_dense(self, params, x, *, return_cache: bool,
                   aux: Optional[list] = None):
        """Every layer over the full sequence x (B, S, d) at positions
        0..S-1: (x, the per-layer caches, or Nones without
        ``return_cache``)."""
        kinds = self.layer_kinds()
        ropes = {k: self._prefill_rope(k, x) for k in set(kinds)}
        layers = self.layer_params(params)
        remat = self.flags.remat and torch.is_grad_enabled()
        caches = []
        for lo, hi, rematted in self._remat_units():

            def run(x, lo=lo, hi=hi):
                cs, auxs = [], []
                for i in range(lo, hi):
                    x, c = self.apply_block_dense(
                        layers[i], x, kind=kinds[i],
                        return_cache=return_cache, rope=ropes[kinds[i]],
                        aux=auxs)
                    cs.append(c)
                return x, cs, auxs

            x, cs, auxs = (self._remat(run, x) if remat and rematted
                           else run(x))
            caches.extend(cs)
            if aux is not None:
                aux.extend(auxs)
        return x, caches

    def _remat_units(self) -> List[tuple]:
        """The layers as (first, end, rematerialised) runs, where the JAX
        model's ``_scan_blocks`` applies ``jax.checkpoint`` to its scan
        body: each block of a homogeneous stack; each whole pattern group
        of a hybrid, whose tail blocks run outside the scan without it."""
        if self.cfg.hybrid is None:
            return [(i, i + 1, True) for i in range(self.cfg.num_layers)]
        P = len(self.cfg.hybrid.block_pattern)
        n = self.n_groups * P
        return ([(g * P, (g + 1) * P, True) for g in range(self.n_groups)]
                + [(i, i + 1, False) for i in range(n, n + self.n_tail)])

    def _remat(self, fn, *args):
        """``fn(*args)`` rematerialised in the backward pass:
        ``remat_policy`` "dots" saves the outputs of the matrix products
        and recomputes the rest (``checkpoint_dots``), any other policy
        recomputes everything (JAX's ``jax.checkpoint`` without a
        policy)."""
        from torch.utils.checkpoint import checkpoint
        if self.flags.remat_policy == "dots":
            from torch.utils.checkpoint import (
                create_selective_checkpoint_contexts)
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=lambda:
                              create_selective_checkpoint_contexts(
                                  _save_dots))
        return checkpoint(fn, *args, use_reentrant=False)

    def loss(self, params, batch) -> tuple:
        """batch: {"tokens": (B, S), "targets": (B, S) int, optionally
        "prefix": (B, P, d)}. Returns (loss, {"ce", "aux"}), as the JAX
        ``Model.loss``: the prefix is prepended over positions 0..P+S-1
        and dropped before the head; float32 logits; ``ce`` the mean
        token cross-entropy, ``aux`` the MoE blocks' load-balance losses
        summed over layers (0 for other stacks); loss = ce + 0.01 * aux.
        No decode cache is built. ``flags.window`` does not apply (the
        JAX loss passes none); ``mla_absorbed`` and ``moe_group_rows``
        do."""
        cfg = self.cfg
        prefix = batch.get("prefix")
        x = self._embed_with_prefix(params, batch["tokens"], prefix)
        x = shard(x, "batch", "act_seq", "embed")
        auxs = []
        run = self if self.flags.window is None else Model(
            cfg, dataclasses.replace(self.flags, window=None))
        x, _ = run._run_dense(params, x, return_cache=False, aux=auxs)
        if prefix is not None:
            x = x[:, prefix.shape[1]:]
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        # the targets' gather takes whole rows of the vocab
        logits = shard(self.unembed(params, x).to(torch.float32),
                       "batch", "seq", None)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1,
                           batch["targets"].to(torch.int64)[..., None])[..., 0]
        ce = torch.mean(lse - tgt)
        aux = (torch.stack(auxs).sum() if auxs else
               torch.zeros((), dtype=torch.float32, device=ce.device))
        # under rules both scalars whole on every rank (sums done)
        ce, aux = shard(ce), shard(aux)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def prefill(self, params, tokens, prefix=None):
        """Returns (last-token logits (B, V), cache) with the cache in the
        JAX layout: ``({"k": (L, B, S, KV, hd), "v": ...}, [])`` for dense
        and MoE stacks, ``({"ckv": (L, B, S, kv_lora), "krope": (L, B, S,
        rope)}, [])`` for MLA stacks, ``({"state": (L, B, nh, hd, N),
        "conv": (L, B, W-1, C)}, [])`` for SSM stacks, and for a hybrid
        ``({"b{i}_{kind}": the layer cache stacked over the groups, ...},
        [the tail's layer caches])`` — RG-LRU ``{"state": (B, w), "conv":
        (B, W-1, w)}``, local attention ``{"k": (B, S, KV, hd), "v": ...}``
        (every prompt row, as the JAX model keeps them; so does a
        ``flags.window`` stack, whose attention is windowed). ``prefix``
        (B, P, d): embeddings before the tokens, as in :meth:`loss`; the
        cache then covers P + S positions."""
        cfg = self.cfg
        x = self._embed_with_prefix(params, tokens, prefix)
        x = shard(x, "batch", "act_seq", "embed")
        x, caches = self._run_dense(params, x, return_cache=True)
        x = L.rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
        stack = lambda cs: {k: torch.stack([c[k] for c in cs]) for k in cs[0]}
        if cfg.hybrid is None:
            return self.unembed(params, x), (stack(caches), [])
        pat = cfg.hybrid.block_pattern
        P, n = len(pat), self.n_groups * len(pat)
        group = {f"b{j}_{pat[j]}": stack(caches[j:n:P]) for j in range(P)}
        return self.unembed(params, x), (group, caches[n:])

    def decode_step(self, params, cache, token, pos):
        """token: (B,) int; pos: (B,) int ragged positions. Returns
        (logits (B, V), cache) — the cache is updated in place. A windowed
        attention cache (a hybrid's local attention, or any attention
        stack under ``flags.window``) is read as a ring of its time rows,
        as the JAX model does; an int8 cache (``flags.kv_quant``) is
        quantized on write and dequantized on read."""
        cfg = self.cfg
        x = shard(self.embed(params, token), "batch", "embed")
        kinds = self.layer_kinds()
        # a ring's lengths depend on its size: attention computes them
        tables = {k: (self._step_tables(k, pos) if self._window(k) is None
                      else (self._rope(k, pos), None)) for k in set(kinds)}
        for bp, c, kind in zip(self.layer_params(params),
                               self._layer_caches(cache), kinds):
            rope, lengths = tables[kind]
            x, _ = self.apply_block_decode(bp, x, c, pos, kind=kind,
                                           rope=rope, lengths=lengths)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self.unembed(params, x), cache

    # ------------------------------------------------------------------
    # Cache construction
    # ------------------------------------------------------------------
    def _init_layer_cache(self, kind: str, batch: int, max_len: int, *,
                          device, window: Optional[int] = None):
        """One layer's zeroed cache; ``window`` sizes an attention cache
        as a ring (the slot arena passes none). A GQA cache is int8 with
        scales under ``flags.kv_quant``; MLA's latent cache never is, as
        in JAX."""
        dtype = self.flags.dtype
        if kind == "ssm":
            return SSM.init_ssm_cache(self.cfg, batch, dtype, device=device)
        if kind == "rec":
            return RG.init_rglru_cache(self.cfg, batch, dtype, device=device)
        if kind == "mla":
            return L.init_mla_cache(self.cfg, batch, max_len, dtype,
                                    device=device, window=window)
        return L.init_attention_cache(self.cfg, batch, max_len, dtype,
                                      device=device, window=window,
                                      quant=self.flags.kv_quant)

    def init_cache(self, batch: int, max_len: int, *, device):
        """Zeroed decode caches of every layer on ``device`` (required:
        nothing lands on the CPU unless asked), in the JAX layout of
        :meth:`prefill`; a windowed attention cache (``_window``) gets a
        ring of ``min(max_len, window)`` rows."""
        def stacked(kind, n):
            one = self._init_layer_cache(kind, batch, max_len, device=device,
                                         window=self._window(kind))
            return {k: torch.zeros((n,) + v.shape, dtype=v.dtype,
                                   device=v.device) for k, v in one.items()}

        cfg = self.cfg
        if cfg.hybrid is None:
            return (stacked(self.block_kind, cfg.num_layers), [])
        pat = cfg.hybrid.block_pattern
        tail = [self._init_layer_cache(pat[i], batch, max_len, device=device,
                                       window=self._window(pat[i]))
                for i in range(self.n_tail)]
        return ({f"b{j}_{kind}": stacked(kind, self.n_groups)
                 for j, kind in enumerate(pat)}, tail)
