"""The dry run's counting mode: the port's counterpart of XLA's
``cost_analysis()`` and ``memory_analysis()``.

The JAX dry run compiles each step for hundreds of placeholder devices
and reads the compiled module's costs. The port has no compiler to ask:
it runs the step once on fake tensors (``FakeTensorMode``: shapes,
dtypes and devices, no storage, no arithmetic) as rank 0 of a fake
process group, with its parameters, caches and batches as DTensors
placed by the spec derivation, and :class:`CountingMode` counts what each
operation would do on rank 0's local shards. DTensor dispatches a global
operation as local operations on the shards (and the collectives that
its redistributions need); the mode sees those local operations, below
DTensor, so every count is one device's:

  * ``flops``: the matrix products (``torch.utils.flop_counter``'s
    formulas: mm, bmm, addmm, baddbmm, convolutions, attention) at their
    local shapes — a product whose contraction is split counts its local
    part, replicated work counts in full — plus the hand-written kernels'
    operations, which their shape-only path reports
    (``repro_torch.kernels._shape``). Elementwise work is not counted;
  * ``bytes accessed``: every local operation's inputs read and outputs
    written, unfused (views move nothing; an in-place row write such as
    ``index_put_`` moves its new rows, not the whole destination), plus
    the kernels' bytes: an upper bound, as XLA's count on the CPU is;
  * the collectives: one record per functional collective with its
    operand's bytes on this rank and the link its group crosses
    (``repro_torch.launch.collectives`` sums them by kind).

``local_bytes`` gives the argument and output sizes (the local shards'
bytes). A host read of a tensor's value (``.item()``, ``int(t)``) raises
under the mode: a step that a dry run can trace takes its static sizes
from shapes.
"""
from __future__ import annotations

import sys

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import flop_registry

from ..kernels._shape import recording
from .collectives import NAMESPACE, collective_kind

# GPUs joined by NVLink: the 8 of one H100 SXM node (NVIDIA DGX H100 data
# sheet); a group whose ranks lie in one block of 8 consecutive ranks
# stays on NVLink, any other crosses the network
GPUS_PER_NODE = 8

# operations that allocate without writing or only read metadata
_NO_BYTES = frozenset((
    "empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided",
    "device", "detach", "lift_fresh", "_local_scalar_dense", "set_",
    "resize_", "_to_copy_meta"))
# in-place writes of a few rows into a larger destination
_ROW_WRITES = ("index_put", "_index_put_impl", "index_copy", "scatter",
               "index_add", "masked_scatter")
# in-place operations that do not read their destination first
_OVERWRITES = frozenset(("copy_", "fill_", "zero_", "normal_", "uniform_"))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(e) for e in x)
    return 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for e in x:
            yield from _tensors(e)
    elif isinstance(x, dict):
        for e in x.values():
            yield from _tensors(e)


def _in_frame(prefix: str) -> bool:
    """Whether a caller's function name starts with ``prefix``."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.startswith(prefix):
            return True
        f = f.f_back
    return False


def _in_shape_propagation() -> bool:
    """Whether DTensor's sharding propagation is running this op: the
    first time it meets an op it runs it on fake tensors of the global
    shapes, in the active fake mode, to learn the output's shape (and
    caches what it learns); that run is no work of the step."""
    return _in_frame("_propagate_tensor_meta")


def local_bytes(tree) -> int:
    """The bytes a tree of tensors holds on this rank: a DTensor's local
    shard, a plain tensor whole (dicts, lists, tuples and dataclass-free
    containers walked)."""
    from ..sharding import is_dtensor
    total = 0
    for t in _tensors(tree):
        total += _nbytes(t.to_local() if is_dtensor(t) else t)
    return total


class CountingMode(FakeTensorMode):
    """A ``FakeTensorMode`` that counts each local operation's work (see
    the module docstring). Enter it with :meth:`counting`, which also
    collects the kernels' shape-only calls; :meth:`reset` zeroes the
    counts (after the inputs are made)."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        self._depth = 0
        self._links: dict = {}
        self.reset()

    def reset(self) -> None:
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: list = []
        self.kernels: dict = {}

    def counting(self):
        """The mode and the kernels' sink, as one context manager."""
        import contextlib
        stack = contextlib.ExitStack()
        stack.enter_context(self)
        stack.enter_context(recording(self._kernel))
        return stack

    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"count": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["count"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from ..sharding import is_dtensor
        if self._depth or any(is_dtensor(t) for t in _tensors((args,
                                                              kwargs))):
            # a nested call (a decomposition) or a DTensor-level one, which
            # DTensor turns into local operations that come back here
            return super().__torch_dispatch__(func, types, args, kwargs)
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if not _in_shape_propagation():
            self._count(func, args, kwargs, out)
        return out

    def _link(self, group_name: str):
        """(ranks in the group, "nvlink" or "network") of a group."""
        if group_name not in self._links:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import (
                _resolve_process_group)
            ranks = dist.get_process_group_ranks(
                _resolve_process_group(group_name))
            node = {r // GPUS_PER_NODE for r in ranks}
            self._links[group_name] = (len(ranks), "nvlink" if len(node) == 1
                                       else "network")
        return self._links[group_name]

    def _count(self, func, args, kwargs, out) -> None:
        schema = func._schema
        name = schema.name.split("::")[-1]
        space = schema.name.split("::")[0]
        if space == NAMESPACE or name == "shard_dim_alltoall":
            if name == "wait_tensor":
                return
            group = args[-1] if isinstance(args[-1], str) \
                else kwargs.get("group_name")
            n, link = self._link(group)
            kind = collective_kind(name) or name
            if name == "shard_dim_alltoall" or (
                    kind == "all-gather" and _in_frame("shard_dim_alltoall")):
                # DTensor moves a split from one dim to another with an
                # all-to-all on the card; over a CPU mesh (the dry run's)
                # it gathers the same operand and keeps its chunk
                kind = "all-to-all"
            if n > 1:           # a group of one moves nothing
                self.collectives.append(
                    {"op": f"{space}.{name}", "kind": kind,
                     "bytes": _nbytes(args[0]), "ranks": n, "link": link})
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.is_view or name in _NO_BYTES:
            return
        mutated = [i for i, a in enumerate(schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write]
        if not mutated:
            self.bytes += _nbytes(args) + _nbytes(list(kwargs.values())) \
                + _nbytes(out)
            return
        rest = [a for i, a in enumerate(args) if i not in mutated]
        rest += list(kwargs.values())
        if name.rstrip("_") in _ROW_WRITES or any(
                name.startswith(w) for w in _ROW_WRITES):
            self.bytes += 2 * _nbytes(rest)      # rows read, then written
        elif name in _OVERWRITES:
            self.bytes += _nbytes(rest) + _nbytes([args[i] for i in mutated])
        else:
            self.bytes += _nbytes(args) + _nbytes(list(kwargs.values())) \
                + _nbytes([args[i] for i in mutated])
