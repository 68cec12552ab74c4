"""Checkpoints of the port, in the JAX package's format.

A tree is flattened into one ``.npz`` whose keys are the leaves' JAX
``keystr`` paths (``['blocks']['attn']['wq']``), written to a temporary
file and renamed into place. bfloat16 leaves widen to float32 (lossless);
``restore`` casts each leaf back to the target's dtype and device and
raises on a missing key or a wrong shape. A checkpoint written by either
package restores into the other (``repro.training.checkpoint``). A DTensor
leaf (a mesh's state) is saved whole, so a checkpoint from a mesh loads on
one device, and restores into a DTensor of the target leaf's placements.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np
import torch

from ..sharding import is_dtensor
from .tree import flatten_with_paths, keystr, unflatten_like


def _to_numpy(leaf) -> np.ndarray:
    t = leaf.detach()
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.cpu()
    if t.dtype == torch.bfloat16:          # numpy has no bf16: widen
        t = t.to(torch.float32)
    return t.numpy()


def save(path: str, tree, step: Optional[int] = None) -> None:
    arrays = {keystr(p): _to_numpy(leaf)
              for p, leaf in flatten_with_paths(tree)}
    if step is not None:
        arrays["__step__"] = np.asarray(step)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def restore(path: str, like):
    """(a tree of ``like``'s structure, each leaf in its dtype and on its
    device, the saved step or None)."""
    with np.load(path) as data:
        out = []
        for p, leaf in flatten_with_paths(like):
            key = keystr(p)
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"model {tuple(leaf.shape)}")
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=leaf.device, dtype=leaf.dtype)
            if is_dtensor(leaf):
                from torch.distributed.tensor import distribute_tensor
                t = distribute_tensor(t, leaf.device_mesh, leaf.placements,
                                      src_data_rank=None)
            out.append(t)
        step = int(data["__step__"]) if "__step__" in data else None
    return unflatten_like(like, out), step
