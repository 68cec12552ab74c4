"""Meshes and the parameter / batch / cache sharding-spec derivation of the
port: ``repro.launch.mesh`` on a torch ``DeviceMesh``.

``make_production_mesh`` keeps the JAX package's shapes and axis names:

  * single-pod:  (data=16, model=16)            — 256 GPUs
  * multi-pod :  (pod=2, data=16, model=16)     — 512 GPUs

On H100 SXM nodes of 8 GPUs a ``model`` axis of 16 spans two NVLink
domains, so its collectives cross the inter-node network; the shapes are
kept so that the dry-run lowers the same combinations as the JAX
package's. ``make_host_mesh`` is a 1-D ``data`` mesh over the ranks of
the process group (tests, examples, the trainer).

Specs are tuples with one entry per tensor dim (``None``, an axis name or
a tuple of axis names; see ``repro_torch.sharding``), derived per leaf of
the port's nested-dict trees by the JAX package's rules in the same order:

  1. the name table picks the *preferred* tensor-parallel dim (heads / ffn
     / vocab / d_inner / lru width ...) -> "model" when divisible,
  2. otherwise the largest remaining dim divisible by the model-axis size,
  3. ZeRO/FSDP: the largest remaining dim divisible by the data-axis size
     -> "data",
  4. stacked-layer leading dims (under "blocks"/"tail") are never sharded.

KV-cache specs: batch dim over ("pod","data") when divisible, then the
largest remaining dim over "model". ``named`` turns a spec tree into
DTensor placements and ``distribute`` a tree of tensors into DTensors.
A mesh here is a ``DeviceMesh`` or anything with its ``mesh_dim_names``
and ``shape`` (the spec functions read nothing else).
"""
from __future__ import annotations

import atexit
import math
import os
import shutil
from types import SimpleNamespace
from typing import Optional, Sequence

import torch

from ..sharding import placements_of, pspec
from ..training.tree import flatten_with_paths, map_tree, unflatten_like


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The target mesh; needs a process group of 256 (512) ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda"):
    """Every rank of the process group, as a 1-D 'data' mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("data",))


def init_process_group(device_type: str, *, timeout_s: float = 600.0):
    """The default process group of this process: from the environment
    that ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``), else a group of one rank on a file store in a
    temporary directory, so that one code path serves both. NCCL on cuda,
    gloo on the CPU. Nothing happens when a group is up already."""
    import datetime
    import tempfile
    import torch.distributed as dist
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, timeout=timeout)
        return
    tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    dist.init_process_group(backend,
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 1),
                            rank=0, world_size=1, timeout=timeout)


def init_fake_group(world_size: int) -> None:
    """Make this process rank 0 of a fake process group of ``world_size``
    ranks (the dry run's 256 or 512 GPUs): its collectives return at once
    and move nothing, so a step traced on fake tensors sees the
    collectives that rank 0 would issue. A fake group of another size is
    replaced; a real one raises."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() == world_size and \
                dist.get_backend() == "fake":
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(f"init_fake_group: a {dist.get_backend()} "
                               f"process group is up already")
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


# ---------------------------------------------------------------------------
# Hardware constants (NVIDIA H100 SXM) for the roofline terms
# ---------------------------------------------------------------------------

# NVIDIA H100 Tensor Core GPU data sheet, SXM: dense bf16 tensor-core peak
# (as H100_SXM in repro_torch.serving.npu_model)
PEAK_FLOPS = 989e12       # bf16 FLOP/s per GPU
# the same data sheet: HBM3 bandwidth of the 80 GB SXM card
HBM_BW = 3.35e12          # bytes/s per GPU
# the same data sheet: NVLink 4, 900 GB/s per GPU (18 links, both
# directions summed), among the 8 GPUs of one node
NVLINK_BW = 900e9         # bytes/s per GPU
# NVIDIA DGX H100 data sheet: 8 single-port ConnectX-7 adapters of 400
# Gb/s (InfiniBand), one per GPU: 50 GB/s each way, 100 GB/s both
# directions summed (as NVLINK_BW), for a collective between nodes
NETWORK_BW = 100e9        # bytes/s per GPU


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

# name -> index of the preferred model-parallel dim (negative = from the end,
# counted on the UNSTACKED shape).
_PREFERRED_MODEL_DIM = {
    # embeddings / head
    "tok": 0,            # (V, d): shard vocab
    "unembed": 1,        # (d, V): shard vocab
    # attention
    "wq": 1, "wk": 1, "wv": 1,      # (d, h, hd): shard heads
    "wo": 0,                         # (h, hd, d): shard heads
    "wq_b": 1,                       # (r, h, qk): shard heads
    "wkv_b": 1,                      # (r, h, nope+v): shard heads
    # dense MLP
    "w_gate": -1, "w_up": -1,        # (d, ff) or (e, d, ff): shard ff
    "w_down": -2,                    # (ff, d) or (e, ff, d): shard ff
    # mamba-2
    "w_z": -1, "w_x": -1,            # (d, di): shard d_inner
    "out_proj": 0,                   # (di, d)
    # rg-lru
    "w_gate_branch": -1, "w_rec_branch": -1,   # (d, w)
    "w_r": -1, "w_i": -1,                       # (w, w)
    "w_out": 0,                                 # (w, d)
}

_STACKED_KEYS = ("blocks", "tail")


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def param_pspec(path, shape: Sequence[int], *, model_n: int, data_n: int,
                fsdp: bool, pod: bool,
                prefer: Optional[dict] = None) -> tuple:
    """The spec of one leaf at ``path`` (its dict keys and list indices
    from the root) of ``shape``."""
    keys = [str(k) for k in path]
    name = keys[-1] if keys else ""
    stacked = any(k in _STACKED_KEYS for k in keys)
    start = 1 if stacked else 0
    ndim = len(shape)
    spec: list = [None] * ndim

    def try_assign(dim: Optional[int], axis: str, n: int) -> bool:
        if dim is None:
            return False
        d = dim + start if dim >= 0 else ndim + dim
        if d < start or d >= ndim or spec[d] is not None:
            return False
        if shape[d] % n or shape[d] < n:
            return False
        spec[d] = axis
        return True

    # 1. preferred model dim by name (overrides take precedence)
    table = dict(_PREFERRED_MODEL_DIM, **(prefer or {}))
    ok = try_assign(table.get(name), "model", model_n)
    # 2. heuristic fallback: largest unassigned dim divisible by model_n
    if not ok and model_n > 1:
        cand = sorted(range(start, ndim), key=lambda d: -shape[d])
        for d in cand:
            if spec[d] is None and shape[d] % model_n == 0 \
                    and shape[d] >= model_n:
                spec[d] = "model"
                break
    # 3. FSDP over data
    if fsdp and data_n > 1:
        cand = sorted(range(start, ndim), key=lambda d: -shape[d])
        for d in cand:
            if spec[d] is None and shape[d] % data_n == 0 \
                    and shape[d] >= data_n:
                spec[d] = "data"
                break
    return tuple(spec)


def param_pspecs(tree, *, mesh, fsdp: bool = True,
                 prefer: Optional[dict] = None):
    """A tree of specs like ``tree`` (parameters, or a train state as
    :func:`state_tree` lays it out; meta tensors will do)."""
    sizes = mesh_sizes(mesh)
    model_n = sizes.get("model", 1)
    data_n = sizes.get("data", 1)
    pod = "pod" in sizes
    specs = [param_pspec(path, tuple(leaf.shape), model_n=model_n,
                         data_n=data_n, fsdp=fsdp, pod=pod, prefer=prefer)
             for path, leaf in flatten_with_paths(tree)]
    return unflatten_like(tree, specs)


def state_tree(state) -> dict:
    """A ``TrainState`` as a tree of its tensors: {"params": ..., "opt":
    {"step", "mu", "nu"}} (the leaf names the JAX state's paths end in)."""
    return {"params": state.params,
            "opt": {"step": state.opt.step, "mu": state.opt.mu,
                    "nu": state.opt.nu}}


def _batch_axes(mesh, batch: int):
    """Mesh axes to shard the global batch over (largest divisible
    prefix)."""
    sizes = mesh_sizes(mesh)
    axes = [a for a in ("pod", "data") if a in sizes]
    total = math.prod(sizes[a] for a in axes) if axes else 1
    if axes and batch % total == 0 and batch >= total:
        return tuple(axes)
    if "data" in sizes and batch % sizes["data"] == 0 \
            and batch >= sizes["data"]:
        return ("data",)
    return None


def batch_pspecs(specs: dict, *, mesh) -> dict:
    """Specs for a dict of (B, ...) input tensors."""
    return {k: pspec(_batch_axes(mesh, v.shape[0]),
                     *(None,) * (v.dim() - 1))
            for k, v in specs.items()}


def cache_pspecs(cache_shape, *, mesh, prefer: str = "trailing"):
    """KV/state cache specs: dim0=layers (stacked), dim1=batch, then one
    dim over "model".

    prefer="trailing" (baseline): the last divisible dim (head_dim /
    latent rank / ssm state). prefer="kv": the kv-head dim (index batch+2
    on 4-D attention caches), even when not divisible (JAX pads there)."""
    model_n = mesh_sizes(mesh).get("model", 1)
    stacked_part, tail_part = cache_shape

    def one(leaf, *, stacked: bool):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        b_dim = 1 if stacked else 0
        spec: list = [None] * ndim
        spec[b_dim] = _batch_axes(mesh, shape[b_dim])
        if model_n > 1:
            kv_dim = b_dim + 2
            if prefer == "kv" and ndim == b_dim + 4 and shape[kv_dim] > 1:
                spec[kv_dim] = "model"
                return pspec(*spec)
            for d in reversed(range(b_dim + 1, ndim)):
                if shape[d] % model_n == 0 and shape[d] >= model_n:
                    spec[d] = "model"
                    break
        return pspec(*spec)

    return (map_tree(lambda l: one(l, stacked=True), stacked_part),
            map_tree(lambda l: one(l, stacked=False), tail_part))


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def _map_specs(fn, tree):
    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    raise TypeError(f"named: {type(tree).__name__} is not a spec tree")


def named(mesh, spec_tree):
    """The DTensor placements of every spec in ``spec_tree`` on ``mesh``
    (JAX's ``NamedSharding`` per leaf)."""
    return _map_specs(lambda s: placements_of(mesh, s), spec_tree)


def spec_leaves(spec_tree) -> list:
    """The specs of a spec tree in the leaf order of its tensor tree."""
    return [box.spec for _, box in flatten_with_paths(
        _map_specs(lambda s: SimpleNamespace(spec=s), spec_tree))]


def distribute(tree, spec_tree, mesh, *, requires_grad: bool = False):
    """Every tensor of ``tree`` as a DTensor on ``mesh`` with the
    placements of its spec (``distribute_tensor`` from each rank's own
    copy, no communication: every rank must hold the same global tensor,
    and keeps its shard). With ``requires_grad`` each DTensor is a leaf
    that requires grad."""
    from torch.distributed.tensor import distribute_tensor
    out = []
    for (_, leaf), spec in zip(flatten_with_paths(tree),
                               spec_leaves(spec_tree)):
        dt = distribute_tensor(leaf.detach(), mesh,
                               placements_of(mesh, spec), src_data_rank=None)
        out.append(dt.requires_grad_(True) if requires_grad else dt)
    return unflatten_like(tree, out)
