"""Weight bridge: JAX ``Model.init`` parameters -> the port's tensors.

The port keeps the JAX parameter layout, so a tree converts leaf by leaf.
The caller hands over the tree with numpy leaves (``jax.tree.map(
np.asarray, params)``) — this module imports no JAX. ``torch.from_numpy``
rejects ``ml_dtypes.bfloat16`` arrays, so every leaf goes through float32
and is cast to its target dtype (lossless for bfloat16 leaves).
"""
from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def params_from_jax(tree, *, device):
    """Convert a JAX parameter tree (dicts/lists of numpy leaves) to the
    port's parameter dict on ``device``, each leaf in its JAX dtype.
    ``device`` is required: nothing lands on the CPU unless asked."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device=device) for v in tree)
    a = np.asarray(tree)
    if a.dtype.name not in _DTYPES:
        raise TypeError(f"params_from_jax: unsupported leaf dtype {a.dtype}")
    t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
    return t.to(device=device, dtype=_DTYPES[a.dtype.name])
