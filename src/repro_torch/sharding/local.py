"""The hand-written kernels under a mesh: each runs on its rank's local
shards.

The C++ entries of ``FlashAttention``, ``FusedRMSNorm`` and ``SSDChunked``
(and their plain versions on the CPU) see local tensors only. Each wrapper
here states the placements its kernel can compute locally, redistributes
its DTensor inputs to them, runs the kernel on the local tensors and wraps
the outputs back as DTensors:

  * RMSNorm needs its rows' last axis (``embed``) whole: x keeps a split
    of its leading (row) axes, the scale is gathered whole;
  * attention needs ``head_dim`` and the sequence whole; q keeps a split
    of batch and of heads. A rank's local query heads are the global
    heads ``[r·h/m, (r+1)·h/m)``, and its K/V must be exactly the heads
    that serve them: split with q when the model size divides the K/V
    heads, else gathered whole and sliced to the local group (the kernel
    infers its group as local q heads / local K/V heads, so replicated K/V
    beside split q would pair the wrong heads);
  * the SSD scan needs batch and ``ssm_heads`` local and the sequence and
    the state dim whole; B and C (shared by every head) are gathered over
    the heads' split;
  * ragged decode needs ``head_dim`` and the cache's time axis whole; q
    and the cache rows keep their batch split, the K/V heads follow q's
    heads as in attention. A cache split along ``head_dim`` (the baseline
    ``cache_pspecs(prefer="trailing")``) is gathered for it.

A decode step's cache writes (``write_rows``) also run on local shards:
each rank writes its own rows into its own shard, the new rows moved to
the cache's split, never the cache to theirs.

The embedding lookup runs on local shards too (DTensor's own rules for
``table[tokens]`` and ``F.embedding`` fail on a split batch beside a
split vocab, and the index's backward has no rule in every release): a
vocab split stays, each rank reading the rows it holds and zeros for
the rest (a pending sum over that mesh dim), a split of the width stays,
and the table is gathered over the mesh dims that split the batch.

A weight-like input gathered whole beside split rows gets its gradient as
a ``Partial`` sum over the mesh dims that split the rows (each rank's
local gradient covers its rows only), and so does a K/V slice.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from . import redistribute


def _placements():
    from torch.distributed.tensor import Partial, Replicate, Shard
    return Partial, Replicate, Shard


def _even(t, pl, i: int, dims=(0,)) -> bool:
    """Whether placement ``pl`` of DTensor ``t`` on mesh dim ``i`` splits
    one of ``dims`` into equal parts. A kernel keeps only such splits: a
    local shard of an uneven one would come back (``DTensor.from_local``)
    with a wrong global shape."""
    from torch.distributed.tensor import Shard
    return (isinstance(pl, Shard) and pl.dim in dims
            and t.shape[pl.dim] % t.device_mesh.size(i) == 0)


def settle(x):
    """A DTensor with every pending sum done and every split that does
    not divide its dim made whole (JAX pads such a split; DTensor's rules
    for an uneven split are partial: a reshape that merges it, for one,
    raises, and a reshape of a pending sum may split it unevenly)."""
    pl = tuple(p if p.is_replicate() or (p.is_shard()
                                         and _even(x, p, i, (p.dim,)))
               else _placements()[1]() for i, p in enumerate(x.placements))
    return redistribute(x, pl)


def local_call(fn: Callable, args: Sequence, in_placements: Sequence,
               grad_placements: Sequence, out_placements: Sequence, mesh):
    """``fn`` on the local shards of ``args`` redistributed to
    ``in_placements`` (None: passed as it is), with the gradients of the
    local tensors read as ``grad_placements``; the output(s) wrapped as
    DTensors of ``out_placements`` (one per output)."""
    from torch.distributed.tensor import DTensor
    local = []
    for a, pl, gpl in zip(args, in_placements, grad_placements):
        if pl is None:
            local.append(a)
            continue
        a = redistribute(a, pl)
        a = a.to_local(grad_placements=gpl)
        if a.requires_grad and torch.is_grad_enabled():
            # a kernel's backward may hand back a strided gradient, which
            # DTensor's view rules then read as if it were contiguous
            a = _MapGrad.apply(a, torch.Tensor.contiguous)
        local.append(a)
    outs = fn(*local)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    wrapped = tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                    for o, pl in zip(outs, out_placements))
    return wrapped[0] if single else wrapped


class _MapGrad(torch.autograd.Function):
    """The identity, whose backward hands on ``fn(gradient)``."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _as_dtensor(t, mesh):
    """A plain tensor (an implicitly replicated constant) as a replicated
    DTensor; a DTensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def rms_norm(x, scale, eps: float, kernel: Callable):
    """``kernel(x, scale, eps)`` (the fused RMSNorm) on x's local rows."""
    Partial, Replicate, Shard = _placements()
    mesh = x.device_mesh
    # rows keep their split; the last axis and pending sums go whole
    x_pl = tuple(pl if _even(x, pl, i, range(x.ndim - 1))
                 else Replicate() for i, pl in enumerate(x.placements))
    rep = (Replicate(),) * mesh.ndim
    s_grad = tuple(Partial() if isinstance(pl, Shard) else Replicate()
                   for pl in x_pl)
    return local_call(lambda xl, sl: kernel(xl, sl, eps),
                      (x, _as_dtensor(scale, mesh)), (x_pl, rep),
                      (x_pl, s_grad), (x_pl,), mesh)


def embedding(tokens, table):
    """``table[tokens]`` on local shards. tokens: (...) int DTensor split
    (if at all) along its first dim; table: (V, d) DTensor. Returns a
    DTensor (..., d): split as the tokens, a pending sum over a mesh dim
    that splits the vocab, split along d where the table's width is."""
    Partial, Replicate, Shard = _placements()
    mesh = table.device_mesh
    tokens = _as_dtensor(tokens, mesh)
    nd = tokens.ndim
    t_pl, w_pl, w_grad, out_pl = [], [], [], []
    vocab_dim = None
    for i, (tp, wp) in enumerate(zip(tokens.placements, table.placements)):
        if _even(tokens, tp, i):
            t_pl.append(tp)
            w_pl.append(Replicate())
            w_grad.append(Partial())
            out_pl.append(Shard(0))
        elif isinstance(wp, Shard) and wp.dim == 0 and vocab_dim is None \
                and table.shape[0] % mesh.size(i) == 0:
            vocab_dim = i
            t_pl.append(Replicate())
            w_pl.append(wp)
            w_grad.append(wp)
            out_pl.append(Partial())
        elif isinstance(wp, Shard) and wp.dim == 1 \
                and table.shape[1] % mesh.size(i) == 0:
            t_pl.append(Replicate())
            w_pl.append(wp)
            w_grad.append(wp)
            out_pl.append(Shard(nd))
        else:
            for lst in (t_pl, w_pl, w_grad, out_pl):
                lst.append(Replicate())
    lo = (0 if vocab_dim is None else
          mesh.get_local_rank(vocab_dim) * (table.shape[0]
                                            // mesh.size(vocab_dim)))

    def look(tl, wl):
        if vocab_dim is None:
            return wl[tl]
        rel = tl.to(torch.int64) - lo
        hit = (rel >= 0) & (rel < wl.shape[0])
        rows = wl[torch.where(hit, rel, torch.zeros_like(rel))]
        return rows * hit[..., None].to(rows.dtype)

    t_pl, w_pl = tuple(t_pl), tuple(w_pl)
    return local_call(look, (tokens, table), (t_pl, w_pl),
                      (None, tuple(w_grad)), (tuple(out_pl),), mesh)


def seq_split(x) -> bool:
    """Whether DTensor x (B, S, ..., K) is split along a dim between its
    first and its last (sequence parallelism's split of S)."""
    return x.ndim >= 3 and any(p.is_shard() and 0 < p.dim < x.ndim - 1
                               for p in x.placements)


def batch_only(x):
    """DTensor x with an even split of its first dim kept and every other
    mesh dim whole."""
    Partial, Replicate, Shard = _placements()
    return redistribute(x, tuple(p if _even(x, p, i) else Replicate()
                                 for i, p in enumerate(x.placements)))


def linear(x, w):
    """``x @ w`` (x (..., K), w (K, N)) on local shards. DTensor's matrix
    product merges x's leading dims into one; with the batch split over
    one mesh axis and the sequence over another (sequence parallelism)
    that dim is split twice, a strided split its rules do not follow.
    Per mesh dim: x's even split of a leading dim stays and w is gathered
    whole (its gradient a pending sum); else a split of w's output
    features stays and x is whole (x's gradient a pending sum); else a
    split of the contraction stays on both and the output is a pending
    sum; else both are whole."""
    Partial, Replicate, Shard = _placements()
    mesh = x.device_mesh
    w = _as_dtensor(w, mesh)
    last = x.ndim - 1
    x_pl, w_pl, x_g, w_g, o_pl = [], [], [], [], []
    for i, (xp, wp) in enumerate(zip(x.placements, w.placements)):
        if _even(x, xp, i, range(last)):
            plan = (xp, Replicate(), xp, Partial(), xp)
        elif _even(w, wp, i, (1,)):
            plan = (Replicate(), wp, Partial(), wp, Shard(last))
        elif _even(w, wp, i, (0,)) and x.shape[last] % mesh.size(i) == 0:
            plan = (Shard(last), wp, Shard(last), wp, Partial())
        else:
            plan = (Replicate(),) * 5
        for lst, p in zip((x_pl, w_pl, x_g, w_g, o_pl), plan):
            lst.append(p)
    x_pl, w_pl = tuple(x_pl), tuple(w_pl)
    return local_call(lambda a, b: a @ b, (x, w), (x_pl, w_pl),
                      (tuple(x_g), tuple(w_g)), (tuple(o_pl),), mesh)


def merge_ready(w, dims: Sequence[int]):
    """A DTensor weight with every split of ``dims`` (the inner dims of a
    reshape that merges them into the one before) made whole, so that
    the merge needs no redistribution that DTensor's view rule refuses."""
    Partial, Replicate, Shard = _placements()
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims else p
               for p in w.placements)
    return redistribute(w, pl)


def channelwise(fn: Callable, x, *params):
    """``fn(x, *params)`` on local shards, for an ``fn`` that works along
    the sequence of each channel (a causal depthwise conv). x: (B, S, C)
    DTensor keeping its batch and channel splits, the sequence whole;
    each param (..., C) split along C as x is, gathered elsewhere (its
    gradient a sum over the batch's split)."""
    Partial, Replicate, Shard = _placements()
    mesh = x.device_mesh
    c = x.ndim - 1
    x_pl, chan = [], []
    for i, pl in enumerate(x.placements):
        keep = _even(x, pl, i, (0, c))
        x_pl.append(pl if keep else Replicate())
        chan.append(keep and pl.dim == c)
    params = [_as_dtensor(p, mesh) for p in params]
    p_pl = [tuple(Shard(p.ndim - 1) if ch else Replicate() for ch in chan)
            for p in params]
    p_grad = [tuple(Shard(p.ndim - 1) if ch else
                    Partial() if isinstance(xp, Shard) else Replicate()
                    for ch, xp in zip(chan, x_pl)) for p in params]
    x_pl = tuple(x_pl)
    return local_call(fn, (x, *params), (x_pl, *p_pl), (x_pl, *p_grad),
                      (x_pl,), mesh)


def _kv_group(mesh, dim: int, H: int, KV: int):
    """How rank r of mesh dim ``dim`` (size m) serves its local q heads
    ``[r·H/m, (r+1)·H/m)``: ("shard", None) when m divides KV (the K/V
    split with q), ("slice", (lo, hi)) when the local q heads map onto
    the K/V heads lo..hi-1 in order, groups of equal size, or None when
    they do not (the heads stay whole on this mesh dim)."""
    m = mesh.size(dim)
    if H % m:
        return None
    if KV % m == 0:
        return ("shard", None)
    G, Hl = H // KV, H // m
    r = mesh.get_local_rank(dim)
    lo, hi = (r * Hl) // G, ((r + 1) * Hl - 1) // G + 1
    n = hi - lo
    if Hl % n or any((r * Hl + j) // G - lo != j // (Hl // n)
                     for j in range(Hl)):
        return None
    return ("slice", (lo, hi))


def flash_attention(q, k, v, *, window, kernel: Callable):
    """``kernel(q, k, v, window=window)`` (flash attention, GQA) on the
    local batch rows and query heads. q: (B, S, H, Dqk), k: (B, T, KV,
    Dqk), v: (B, T, KV, Dv) DTensors on one mesh."""
    Partial, Replicate, Shard = _placements()
    mesh = q.device_mesh
    k, v = _as_dtensor(k, mesh), _as_dtensor(v, mesh)
    H, KV = q.shape[2], k.shape[2]
    q_pl, kv_pl, kv_grad, slices = [], [], [], []
    for i, pl in enumerate(q.placements):
        if _even(q, pl, i):
            q_pl.append(pl)
            kv_pl.append(pl)
            kv_grad.append(pl)
            continue
        group = (_kv_group(mesh, i, H, KV)
                 if isinstance(pl, Shard) and pl.dim == 2 else None)
        if group is None:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
            kv_grad.append(Replicate())
        elif group[0] == "shard":
            q_pl.append(Shard(2))
            kv_pl.append(Shard(2))
            kv_grad.append(Shard(2))
        else:
            q_pl.append(Shard(2))
            kv_pl.append(Replicate())
            kv_grad.append(Partial())
            slices.append(group[1])
    if len(slices) > 1:
        raise ValueError("flash_attention under a mesh: query heads split "
                         "over more than one mesh dim with K/V sliced")

    def run(ql, kl, vl):
        if slices:
            lo, hi = slices[0]
            kl, vl = kl[:, :, lo:hi].contiguous(), vl[:, :, lo:hi].contiguous()
        return kernel(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                      window=window)

    if slices and torch.is_grad_enabled():
        # the sliced K/V's gradient is a pending sum over the heads' mesh
        # dim: sum it where it arrives, before the projection's backward
        # (DTensor would split the pending sum along the merged tokens,
        # already split over the batch, a split its rules cannot follow)
        k, v = _MapGrad.apply(k, settle), _MapGrad.apply(v, settle)

    q_pl, kv_pl, kv_grad = tuple(q_pl), tuple(kv_pl), tuple(kv_grad)
    return local_call(run, (q, k, v), (q_pl, kv_pl, kv_pl),
                      (q_pl, kv_grad, kv_grad), (q_pl,), mesh)


def ragged_decode_attention(q, k, v, lengths, *, kernel: Callable):
    """``kernel(q, k, v, lengths)`` (ragged decode, GQA, no slots) on the
    local batch rows and query heads. q: (B, H, D); k, v: (B, T, KV, D)
    DTensors (a cache, row i of the batch at cache row i); lengths: (B,).
    The kernel needs ``head_dim`` and the time axis whole: a cache split
    there is gathered (or, over the heads' mesh dim, moved to the K/V
    heads' split), and the dry run counts that collective."""
    Partial, Replicate, Shard = _placements()
    mesh = q.device_mesh
    H, KV = q.shape[1], k.shape[2]
    q_pl, kv_pl, len_pl, slices = [], [], [], []
    for i, pl in enumerate(q.placements):
        if _even(q, pl, i):
            q_pl.append(pl)
            kv_pl.append(pl)
            len_pl.append(pl)
            continue
        len_pl.append(Replicate())
        group = (_kv_group(mesh, i, H, KV)
                 if isinstance(pl, Shard) and pl.dim == 1 else None)
        if group is None:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
        elif group[0] == "shard":
            q_pl.append(Shard(1))
            kv_pl.append(Shard(2))
        else:
            q_pl.append(Shard(1))
            kv_pl.append(Replicate())
            slices.append(group[1])
    if len(slices) > 1:
        raise ValueError("ragged_decode_attention under a mesh: query heads "
                         "split over more than one mesh dim with K/V sliced")

    def run(ql, kl, vl, ll):
        if slices:
            lo, hi = slices[0]
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return kernel(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                      ll.to(torch.int32).contiguous())

    q_pl, kv_pl, len_pl = tuple(q_pl), tuple(kv_pl), tuple(len_pl)
    return local_call(run, (q, k, v, _as_dtensor(lengths, mesh)),
                      (q_pl, kv_pl, kv_pl, len_pl),
                      (None, None, None, None), (q_pl,), mesh)


def write_rows(dest, t_idx, values):
    """``dest[i, t_idx[i]] = values[i]`` for every batch row i, in place,
    each rank writing into its own shard of ``dest`` (a decode cache leaf
    (B, T, ...) DTensor, row i of the batch at cache row i): ``values``
    (B, ...) and ``t_idx`` (B,) are moved to the cache's split — the
    batch's split, the split of a trailing dim — and never the cache to
    theirs, so a write moves no cache-sized collective. A cache split over
    its time axis takes, on each rank, the rows whose time falls in its
    span."""
    Partial, Replicate, Shard = _placements()
    mesh = dest.device_mesh
    v_pl, t_pl, time_dims = [], [], []
    for i, pl in enumerate(dest.placements):
        if isinstance(pl, Shard) and pl.dim == 0:
            v_pl.append(Shard(0))
            t_pl.append(Shard(0))
            continue
        t_pl.append(Replicate())
        if isinstance(pl, Shard) and pl.dim == 1:
            time_dims.append(i)
        v_pl.append(Shard(pl.dim - 1) if isinstance(pl, Shard)
                    and pl.dim > 1 else Replicate())
    vals = redistribute(_as_dtensor(values, mesh), tuple(v_pl)).to_local()
    t = redistribute(_as_dtensor(t_idx, mesh), tuple(t_pl)).to_local()
    local = dest.to_local()
    rows = torch.arange(local.shape[0], device=local.device)
    vals = vals.to(local.dtype)
    if not time_dims:
        local[rows, t] = vals
        return dest
    # this rank's span of the time axis: DTensor's chunks, outer mesh dim
    # first
    lo, n = 0, dest.shape[1]
    for i in time_dims:
        size = -(-n // mesh.size(i))
        lo += mesh.get_local_rank(i) * size
        n = min(size, max(0, n - mesh.get_local_rank(i) * size))
    rel = t.to(torch.int64) - lo
    hit = (rel >= 0) & (rel < local.shape[1])
    rel = torch.where(hit, rel, torch.zeros_like(rel))
    keep = hit.reshape((-1,) + (1,) * (vals.dim() - 1))
    local[rows, rel] = torch.where(keep, vals, local[rows, rel])
    return dest


def ssd_chunked(x, dt, A, B_ssm, C_ssm, chunk: int, kernel: Callable):
    """``kernel(x, dt, A, B, C, chunk)`` (the SSD scan) on the local batch
    rows and SSM heads. x: (B, S, nh, hd), dt: (B, S, nh), A: (nh,), B,
    C: (B, S, N). Returns (y, final state (B, nh, hd, N)) as DTensors."""
    Partial, Replicate, Shard = _placements()
    mesh = x.device_mesh
    nh = x.shape[2]
    x_pl, a_pl, a_grad, bc_pl, bc_grad, st_pl = [], [], [], [], [], []
    for i, pl in enumerate(x.placements):
        if _even(x, pl, i):
            x_pl.append(pl)
            a_pl.append(Replicate())
            a_grad.append(Partial())
            bc_pl.append(pl)
            bc_grad.append(pl)
            st_pl.append(pl)
        elif isinstance(pl, Shard) and pl.dim == 2 \
                and nh % mesh.size(i) == 0:
            x_pl.append(pl)
            a_pl.append(Shard(0))
            a_grad.append(Shard(0))
            bc_pl.append(Replicate())
            bc_grad.append(Partial())
            st_pl.append(Shard(1))
        else:
            for lst in (x_pl, a_pl, a_grad, bc_pl, bc_grad, st_pl):
                lst.append(Replicate())
    x_pl, a_pl, a_grad = tuple(x_pl), tuple(a_pl), tuple(a_grad)
    bc_pl, bc_grad, st_pl = tuple(bc_pl), tuple(bc_grad), tuple(st_pl)
    return local_call(
        lambda *t: kernel(*t, chunk),
        (x, _as_dtensor(dt, mesh), _as_dtensor(A, mesh),
         _as_dtensor(B_ssm, mesh), _as_dtensor(C_ssm, mesh)),
        (x_pl, x_pl, a_pl, bc_pl, bc_pl),
        (x_pl, x_pl, a_grad, bc_grad, bc_grad), (x_pl, st_pl), mesh)
