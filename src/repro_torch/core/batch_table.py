"""Stack-based batch state table (paper §IV-B, Fig. 10).

The entry at the top of the stack is the *active batch* currently executing.
Pushing preempts the active batch; when the top two entries reach the same
graph node they are merged into a single entry. All operations happen at
node (layer) boundaries, in software — O(1) scheduling, no hardware change.
"""
from __future__ import annotations

from typing import List, Optional

from .request import Request, SubBatch


class BatchTable:
    def __init__(self, max_batch: int = 64):
        self.stack: List[SubBatch] = []     # index -1 == top == active batch
        self.max_batch = max_batch

    # ------------------------------------------------------------------
    @property
    def active(self) -> Optional[SubBatch]:
        return self.stack[-1] if self.stack else None

    @property
    def empty(self) -> bool:
        return not self.stack

    @property
    def num_entries(self) -> int:
        return len(self.stack)

    def all_requests(self) -> List[Request]:
        return [r for sb in self.stack for r in sb.live_requests]

    @property
    def total_size(self) -> int:
        return sum(sb.size for sb in self.stack)

    # ------------------------------------------------------------------
    def push(self, requests: List[Request]) -> SubBatch:
        """Preempt the active batch and make ``requests`` the new active one."""
        sb = SubBatch(list(requests))
        self.stack.append(sb)
        return sb

    def merge_top(self, predicate=None) -> int:
        """Merge the topmost entries while they share a node id (Fig. 10 t=6).

        ``predicate`` (optional ``callable(top, below) -> bool``) lets a
        policy further restrict merges beyond the structural
        ``mergeable_with`` rule — e.g. cellular batching only merges at
        weight-shared *cell* nodes. Returns the number of merges performed.
        """
        merges = 0
        while len(self.stack) >= 2:
            top, below = self.stack[-1], self.stack[-2]
            if top.size == 0:
                self.stack.pop()
                continue
            if below.size == 0:
                del self.stack[-2]
                continue
            if not top.mergeable_with(below, self.max_batch):
                break
            if predicate is not None and not predicate(top, below):
                break
            below.merge(top)
            self.stack.pop()
            merges += 1
        self._drop_empty()
        return merges

    def _drop_empty(self):
        self.stack = [sb for sb in self.stack if sb.size > 0]

    def pop_if_done(self):
        while self.stack and self.stack[-1].size == 0:
            self.stack.pop()

    def __repr__(self):
        rows = [f"  [{i}] node={sb.node_id} rids={[r.rid for r in sb.live_requests]}"
                for i, sb in enumerate(self.stack)]
        return "BatchTable(\n" + "\n".join(rows) + ")"
