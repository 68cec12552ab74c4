"""Top-k Mixture-of-Experts FFN of the port, with sort-based dispatch.

The port of ``repro.models.moe``. By default each batch row is one
routing group (the JAX model's ``group_rows = 1``, which its serving uses
and so does the port's engine), so a batch-bucket padding row is a group
of its own and takes no capacity from a live row; ``group_rows = g``
routes g rows together (``RuntimeFlags.moe_group_rows``). Per group of t
tokens:

  1. route: float32 router logits, softmax, top-k experts per token
     (``torch.topk``), weights renormalised over the k chosen,
  2. sort the (token, expert) pairs by expert id (stable argsort),
  3. each pair's rank within its expert's run (``torch.searchsorted`` on
     the sorted ids, side left),
  4. scatter-add the token vectors into an (E, C) capacity buffer with
     ``C = ceil(t * k / E * capacity_factor)``; a pair ranked C or later
     is dropped — it adds zeros at slot C - 1, as in the reference,
  5. one batched SwiGLU over all experts' buffers,
  6. gather each pair's output back, mask the dropped ones, and
     scatter-add it into its token weighted by its routing weight.

The scatter-adds are ``index_put_(accumulate=True)``, the counterpart of
JAX's ``.at[].add``. Nothing here reads a value back to the host (no
``.item()``, no ``nonzero()``): a serving run keeps its one host sync.
The Switch-style load-balance loss (training) is computed only when asked
for (``with_aux=True``), so the serving path's ops are unchanged.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..sharding import gather_fsdp, is_dtensor, redistribute, shard
from .layers import _normal


def init_moe(gen: torch.Generator, cfg, dtype, device) -> dict:
    """Seeded parameters with the JAX ``init_moe`` shapes, dtypes and
    scales: a float32 N(0, 1/d) router (d, E) and per-expert SwiGLU
    weights (E, d, ff), (E, d, ff), (E, ff, d)."""
    m = cfg.moe
    d, ff, e = cfg.d_model, cfg.d_ff, m.num_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    return {
        "router": _normal(gen, (d, e), s_in, torch.float32, device),
        "w_gate": _normal(gen, (e, d, ff), s_in, dtype, device),
        "w_up": _normal(gen, (e, d, ff), s_in, dtype, device),
        "w_down": _normal(gen, (e, ff, d), s_out, dtype, device),
    }


def capacity(cfg, t: int) -> int:
    """Slots per expert for a group of ``t`` tokens."""
    m = cfg.moe
    return max(1, math.ceil(t * m.experts_per_token / m.num_experts
                            * m.capacity_factor))


def _dispatch_indices(expert_ids: torch.Tensor, capacity: int):
    """expert_ids: (G, n) flat (token * k) expert assignments per group.

    Returns (order, sorted_eid, slot, keep), each (G, n): the pairs'
    order sorted by expert, their expert ids in that order, each pair's
    slot in its expert's capacity buffer, and whether it fits under the
    capacity bound (a dropped pair's slot is ``capacity - 1``)."""
    n = expert_ids.shape[-1]
    order = torch.argsort(expert_ids, dim=-1, stable=True)
    sorted_eid = torch.gather(expert_ids, -1, order)
    # rank of each pair within its expert's run
    first = torch.searchsorted(sorted_eid, sorted_eid, side="left")
    rank = torch.arange(n, device=expert_ids.device) - first
    keep = rank < capacity
    slot = torch.where(keep, rank, torch.full_like(rank, capacity - 1))
    return order, sorted_eid, slot, keep


def _route(x: torch.Tensor, router: torch.Tensor, cfg, cap: int,
           with_aux: bool):
    """Steps 1-4 on local groups x (G, t, d): (the capacity buffer (G, E,
    C, d), the pairs' routing (order, sorted_eid, slot, keep, src, g,
    top_w), the router probabilities and the one-hot first choices
    (None without ``with_aux``))."""
    m = cfg.moe
    G, t, d = x.shape
    e, k = m.num_experts, m.experts_per_token
    logits = x.to(torch.float32) @ router                  # (G, t, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)            # (G, t, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    order, sorted_eid, slot, keep = _dispatch_indices(top_e.reshape(G, t * k),
                                                      cap)
    src = order // k                                       # token of a pair
    g = torch.arange(G, device=x.device)[:, None].expand_as(src)
    rows = torch.gather(x, 1, src[..., None].expand(G, t * k, d))
    buf = x.new_zeros((G, e, cap, d))
    buf.index_put_((g, sorted_eid, slot),
                   torch.where(keep[..., None], rows, torch.zeros_like(rows)),
                   accumulate=True)
    first = (F.one_hot(top_e[..., 0], e).to(torch.float32) if with_aux
             else None)
    return buf, (order, sorted_eid, slot, keep, src, g, top_w), probs, first


def _combine(out_buf: torch.Tensor, route, t: int) -> torch.Tensor:
    """Step 6 on local groups: (G, t, d) from the experts' outputs."""
    order, sorted_eid, slot, keep, src, g, top_w = route
    G, k = top_w.shape[0], top_w.shape[-1]
    vals = out_buf[g, sorted_eid, slot] * keep[..., None].to(out_buf.dtype)
    w_sorted = torch.gather(top_w.reshape(G, t * k), -1,
                            order).to(out_buf.dtype)
    y = out_buf.new_zeros((G, t, out_buf.shape[-1]))
    y.index_put_((g, src), vals * w_sorted[..., None], accumulate=True)
    return y


def _route_sharded(x, router, cfg, cap: int, with_aux: bool):
    """:func:`_route` under a mesh: each rank routes its own groups (a
    group never straddles ranks: G is split over its batch axes only),
    the router gathered whole (its gradient a sum over those axes). The
    buffer, probabilities and first choices come back as DTensors split
    like the groups; the routing stays local, for :func:`_combine`."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    x_pl = tuple(pl if isinstance(pl, Shard) and pl.dim == 0
                 else Replicate() for pl in x.placements)
    r_grad = tuple(Partial() if isinstance(pl, Shard) else Replicate()
                   for pl in x_pl)
    xl = redistribute(x, x_pl).to_local()
    rl = redistribute(router, (Replicate(),) * mesh.ndim).to_local(
        grad_placements=r_grad)
    buf, route, probs, first = _route(xl, rl, cfg, cap, with_aux)
    wrap = lambda a: (None if a is None else
                      DTensor.from_local(a, mesh, x_pl, run_check=False))
    return wrap(buf), (route, x_pl), wrap(probs), wrap(first)


def _combine_sharded(out_buf, route, t: int):
    """:func:`_combine` on each rank's own groups."""
    from torch.distributed.tensor import DTensor
    route, x_pl = route
    mesh = out_buf.device_mesh
    ol = redistribute(out_buf, x_pl).to_local()
    return DTensor.from_local(_combine(ol, route, t), mesh, x_pl,
                              run_check=False)


def apply_moe(p: dict, x: torch.Tensor, cfg, *, with_aux: bool = False,
              group_rows: int = 1):
    """x: (B, S, d) -> y (B, S, d). ``max(1, min(group_rows, B))`` batch
    rows form one routing group, whose token count sets the capacity; a B
    that this group size does not divide raises ``ValueError`` (the JAX
    model's reshape fails there too). With ``with_aux`` returns (y, aux):
    the reference's load-balance loss ``E * sum(frac_tokens *
    frac_probs)``, float32, with ``frac_tokens`` the share of tokens whose
    first choice is each expert and ``frac_probs`` the mean router
    probability, both over every token. Under a mesh (x a DTensor) the
    routing and the combine run on each rank's groups and the experts'
    products on DTensors."""
    m = cfg.moe
    B, S, d = x.shape
    per_group = max(1, min(group_rows, B))
    if B % per_group:
        raise ValueError(f"apply_moe: {B} batch rows do not split into "
                         f"routing groups of {per_group}")
    x = x.reshape(B // per_group, per_group * S, d)
    t = x.shape[1]
    sharded = is_dtensor(x)
    cap = capacity(cfg, t)
    buf, route, probs, first = (_route_sharded if sharded else _route)(
        x, p["router"], cfg, cap, with_aux)
    buf = shard(buf, "batch_nopod", "experts", None, "embed")
    w_gate, w_up, w_down = p["w_gate"], p["w_up"], p["w_down"]
    if sharded:
        w_gate, w_up, w_down = (gather_fsdp(w) for w in (w_gate, w_up,
                                                          w_down))

    h = F.silu(torch.einsum("gecd,edf->gecf", buf, w_gate))
    h = h * torch.einsum("gecd,edf->gecf", buf, w_up)
    h = shard(h, "batch_nopod", "experts", None, "expert_ffn")
    if sharded:
        # a redistribution can leave the local shard strided; einsum views
        # its operands
        h = h.contiguous()
    out_buf = torch.einsum("gecf,efd->gecd", h, w_down)
    out_buf = shard(out_buf, "batch_nopod", "experts", None, "moe_out")

    y = (_combine_sharded if sharded else _combine)(out_buf, route, t)
    y = y.reshape(B, S, d)
    if not with_aux:
        return y
    frac_tokens = torch.mean(first, dim=(0, 1))
    frac_probs = torch.mean(probs, dim=(0, 1))
    return y, m.num_experts * torch.sum(frac_tokens * frac_probs)
