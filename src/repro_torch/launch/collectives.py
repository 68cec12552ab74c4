"""Collective traffic of a traced step: ``repro.launch.hlo_stats`` of the
port.

XLA's dry run parses the compiled module's text for its collective
instructions. The port has no compiled module: its dry run
(``repro_torch.launch.counting``) traces the step once, as one rank of a
fake process group, and records every functional collective that DTensor
issues (``_c10d_functional.all_gather_into_tensor`` ...) with its
operand's bytes on that rank. This module sums those records by kind,
under XLA's kind names so that the two packages' records compare.

Bytes are the *operand* sizes on one device, XLA's convention: an
all-gather counts its local shard, an all-reduce and a reduce-scatter
their whole local input.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Optional

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# the functional collectives' op names (``torch.ops._c10d_functional``)
# -> XLA's kind; ``wait_tensor`` moves nothing, and any other collective
# (a broadcast) is recorded under its own name
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
NAMESPACE = "_c10d_functional"


def collective_kind(op_name: str) -> Optional[str]:
    """XLA's kind of a functional collective (``"_c10d_functional.
    all_reduce.default"`` or its bare name), or None for anything else
    (``wait_tensor`` among them)."""
    parts = op_name.split(".")
    if parts[0] == NAMESPACE:
        parts = parts[1:]
    return _KINDS.get(parts[0]) if parts else None


def collective_stats(records: Iterable[dict]) -> Dict[str, dict]:
    """Per-collective-kind {count, bytes} summed over a step's records
    (dicts with "kind" and "bytes", as the counting mode writes them)."""
    stats: Dict[str, dict] = defaultdict(lambda: {"count": 0, "bytes": 0})
    for r in records:
        stats[r["kind"]]["count"] += 1
        stats[r["kind"]]["bytes"] += int(r["bytes"])
    return dict(stats)


def total_collective_bytes(records: Iterable[dict]) -> int:
    return sum(v["bytes"] for v in collective_stats(records).values())
