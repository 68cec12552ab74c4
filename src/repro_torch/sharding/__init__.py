"""Logical-axis sharding of the port: ``repro.sharding`` on a torch
``DeviceMesh``.

Model code annotates activations with *logical* axis names ("batch",
"seq", "heads", "embed", "ffn", "vocab", "experts", ...). The launcher
installs a mapping logical axis -> mesh axis; outside a mesh context the
annotations return their input untouched (no op, no host sync), so the
same model code serves on one card and trains on a mesh of ranks.

A spec is the ``PartitionSpec`` counterpart: a tuple with one entry per
tensor dim, each ``None`` (replicated), a mesh axis name, or a tuple of
axis names (the dim split over several mesh axes, the first outermost).
``AxisRules.placements`` turns it into one DTensor ``Placement`` per mesh
dim: ``Shard(d)`` where mesh axis names dim d, else ``Replicate()``. A dim
over ``("pod", "data")`` is ``Shard(d)`` on both mesh dims, pod-major as
in JAX, because the mesh lists ``pod`` before ``data``.
"""
from __future__ import annotations

import contextlib
import sys
import threading
from typing import Mapping, Optional, Sequence


_STATE = threading.local()


def axis_names(entry) -> tuple:
    """The mesh axes of one spec entry: () for None, (name,) for a name,
    the tuple itself for a tuple of names."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def pspec(*entries) -> tuple:
    """A spec of ``entries``, normalised as ``PartitionSpec`` normalises
    them: a tuple (or list) of one axis name becomes the name, an empty
    one None."""
    def one(e):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            return None if not e else e[0] if len(e) == 1 else e
        return e
    return tuple(one(e) for e in entries)


def placements_of(mesh, spec: Sequence) -> tuple:
    """One DTensor placement per mesh dim of ``mesh`` for ``spec``: Shard
    of the tensor dim whose entry names that mesh axis, else Replicate.
    Axes the mesh lacks are ignored (replicated), and so are axes of one
    rank: a split over one rank is no split, and DTensor's view rules
    refuse to merge a dim "split" so."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for ax in axis_names(entry):
            if ax in names and sizes[names.index(ax)] > 1:
                out[names.index(ax)] = Shard(d)
    return tuple(out)


class AxisRules:
    """Maps logical axis names to mesh axis names (or None = replicated)
    over a ``DeviceMesh``."""

    def __init__(self, mesh, mapping: Mapping[str, object]):
        self.mesh = mesh
        self.mapping = dict(mapping)

    def spec(self, logical: Sequence[Optional[str]]) -> tuple:
        return pspec(*(self.mapping.get(ax) if ax is not None else None
                       for ax in logical))

    def placements(self, logical: Sequence[Optional[str]]) -> tuple:
        return placements_of(self.mesh, self.spec(logical))


def current_rules() -> Optional[AxisRules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[AxisRules]):
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def is_dtensor(x) -> bool:
    """Whether x is a DTensor. Nothing can be one before DTensor's module
    is imported, so a process that never imports it pays no import."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def redistribute(x, placements):
    """``x.redistribute`` to ``placements``, a pending sum made whole
    before it is split: the gradient of a sum reduced straight to a split
    would have to go from that split back to a pending sum, which DTensor
    does not do in every torch release (an all-reduce then a local split
    costs more bytes but runs everywhere)."""
    from torch.distributed.tensor import Replicate
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    mid = tuple(Replicate() if p.is_partial() and q.is_shard() else p
                for p, q in zip(x.placements, placements))
    if mid != tuple(x.placements):
        x = x.redistribute(x.device_mesh, mid)
    return x if mid == placements else x.redistribute(x.device_mesh,
                                                      placements)


def shard(x, *logical: Optional[str]):
    """Redistribute a DTensor to the installed rules' placements for
    ``logical`` (JAX's ``with_sharding_constraint``). Without rules it
    returns ``x`` itself; a plain tensor under rules (one rank's local
    data, a serve) is returned as it is. A dim that the mesh axis does not
    divide stays whole over it, where JAX would pad it."""
    rules = current_rules()
    if rules is None:
        return x
    if x.ndim != len(logical):
        raise ValueError(f"rank mismatch: {tuple(x.shape)} vs logical axes "
                         f"{logical}")
    if not is_dtensor(x):
        return x
    # a split that does not divide its dim stays whole (JAX pads it;
    # DTensor's rules for uneven splits are partial)
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    pl = tuple(p if not p.is_shard() or x.shape[p.dim] % mesh.size(i) == 0
               else Replicate()
               for i, p in enumerate(rules.placements(logical)))
    return redistribute(x, pl)


def mesh_context(x):
    """``implicit_replication`` (plain tensors beside DTensors read as
    replicated: the RoPE tables, masks and step scalars a step builds)
    when x is a DTensor, else nothing."""
    if not is_dtensor(x):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def gather_fsdp(w):
    """A parameter DTensor made whole over the installed rules' ``fsdp``
    axis (ZeRO/FSDP's gather before use; its gradient is scattered back
    to the stored split), its other splits kept."""
    rules = current_rules()
    axis = None if rules is None else rules.mapping.get("fsdp")
    if axis is None or not is_dtensor(w) \
            or axis not in w.device_mesh.mesh_dim_names:
        return w
    from torch.distributed.tensor import Replicate
    i = w.device_mesh.mesh_dim_names.index(axis)
    if isinstance(w.placements[i], Replicate):
        return w
    pl = list(w.placements)
    pl[i] = Replicate()
    return redistribute(w, pl)


# Default logical->mesh mappings -----------------------------------------

# Tensor-parallel serving: params replicated over `data`, sharded over
# `model`; batch over (`pod`, `data`).
SERVE_RULES = {
    "batch": ("pod", "data"),
    "batch_nopod": "data",
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "ffn": "model",
    "vocab": "model",
    "experts": None,
    "expert_ffn": "model",
    "moe_out": None,
    "act_seq": None,
    "lru": "model",
    "ssm_heads": "model",
    "state": None,
    "layers": None,
    "fsdp": None,
}

# Training: same tensor parallelism + params FSDP-sharded over `data`.
TRAIN_RULES = dict(SERVE_RULES, fsdp="data")


def make_rules(mesh, kind: str = "serve") -> AxisRules:
    base = TRAIN_RULES if kind == "train" else SERVE_RULES
    mapping = dict(base)
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        mapping["batch"] = "data"
    if "data" not in names:
        mapping["batch"] = None
        mapping["batch_nopod"] = None
        mapping["fsdp"] = None
    if "model" not in names:
        for k, v in list(mapping.items()):
            if v == "model":
                mapping[k] = None
    return AxisRules(mesh, mapping)


__all__ = ["AxisRules", "SERVE_RULES", "TRAIN_RULES", "axis_names",
           "current_rules", "gather_fsdp", "is_dtensor", "make_rules",
           "mesh_context", "placements_of", "pspec", "redistribute", "shard",
           "use_rules"]
