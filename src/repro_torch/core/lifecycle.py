"""The request/handle lifecycle state machine, as ONE declarative table.

PR 7 documented the handle lifecycle as *monotone-except-retry*: a
request only ever moves forward through

    QUEUED -> ADMITTED -> RUNNING -> DONE

or jumps from a live state to a terminal disposition (``REJECTED`` at
admission, ``CANCELLED``/``EXPIRED``/``FAILED``/``SHED`` out-of-band),
with exactly ONE backward edge — the fault-retry rewind
``RUNNING -> QUEUED`` — and every terminal state absorbing. That
contract used to live in three places at once (the ``HandleState`` enum,
the ``_FATE_STATE`` dict, and prose in docstrings), which is how a
drifting edge stays unnoticed until a property test trips over it.

This module is now the single source of truth. The runtime imports it
(:mod:`repro.serving.session` derives its enum and terminal sets from
``STATES``/``TERMINAL``/``FATES``; :class:`repro.core.request.Request`
validates ``fate`` writes against ``FATES``) and the ``handle-lattice``
static checker (:mod:`repro.analysis.handles`) imports it too — so the
code that moves handles and the analysis that polices those moves can
never disagree about what a legal edge is.

``_validate()`` runs at import and raises if the table itself stops
being monotone-except-retry (a backward edge sneaking in, an edge out of
a terminal state), so an illegal edit to the TABLE is as loud as an
illegal edit to the code.
"""
from __future__ import annotations

from typing import FrozenSet, Tuple

#: Every lifecycle state, in lattice order: the live progression first,
#: then the terminal dispositions. (serving.session derives its
#: ``HandleState`` enum from this tuple — order is part of the contract.)
STATES: Tuple[str, ...] = (
    "queued", "admitted", "running",
    "done", "rejected", "cancelled", "expired", "failed", "shed",
)

#: Live (non-terminal) states, in progression order.
LIVE: Tuple[str, ...] = ("queued", "admitted", "running")

#: Terminal states — absorbing: no legal edge leaves one.
TERMINAL: FrozenSet[str] = frozenset(STATES) - frozenset(LIVE)

#: Out-of-band terminal dispositions recorded on ``Request.fate``
#: (``done``/``rejected`` are reached through the normal bookkeeping —
#: ``t_finish`` / rejection at submit — never through ``fate``).
FATES: Tuple[str, ...] = ("cancelled", "expired", "failed", "shed")

#: The ONE backward edge: a faulted dispatch rewinds its members from
#: RUNNING back to QUEUED for a backoff-delayed prefill replay.
RETRY_EDGE: Tuple[str, str] = ("running", "queued")

#: The full legal edge set. Everything except RETRY_EDGE moves strictly
#: forward in ``STATES`` order; terminal states have no out-edges.
EDGES: FrozenSet[Tuple[str, str]] = frozenset(
    {
        ("queued", "admitted"),      # policy pulls it out of the InfQ
        ("admitted", "running"),     # first committed run executes
        ("running", "done"),         # final node at a run boundary
        ("queued", "rejected"),      # admission control at submit
        RETRY_EDGE,                  # fault retry (the one rewind)
    }
    # any live state can go terminal out-of-band: cancel works on queued
    # and batched work alike, expiry sweeps queued+admitted+running,
    # shedding hits the ingress and the backlog, faults hit dispatched
    # (running) members whose retry budget is gone
    | {(live, fate) for live in LIVE for fate in FATES}
)

# ---------------------------------------------------------------------------
# Declarations consumed by the handle-lattice static checker: which
# attribute writes encode a BACKWARD move (the retry rewind), and which
# functions are licensed to perform them / to write fates dynamically.
# ---------------------------------------------------------------------------

#: Attribute writes that rewind a handle/request along the lattice —
#: each maps the attribute to the literal rewind value. Writing one of
#: these outside ``RETRY_FUNCTIONS`` (or an ``__init__``) is an illegal
#: backward edge: the derived state would jump RUNNING/ADMITTED -> QUEUED
#: with no fault to justify it.
ROLLBACK_WRITES = {
    "t_first_issue": None,   # un-admits: derived state falls to QUEUED
    "idx": 0,                # prefill replay from node 0
    "_running": False,       # clears the RUNNING observation
}

#: The only functions allowed to take the RETRY_EDGE (and therefore to
#: perform ROLLBACK_WRITES): the session's fault handler.
RETRY_FUNCTIONS: FrozenSet[str] = frozenset({"_on_fault"})

#: The only functions allowed to assign a NON-LITERAL fate (the single
#: validated funnel every terminal disposition routes through); literal
#: fate writes are checked against ``FATES`` wherever they appear.
FATE_SETTER_FUNCTIONS: FrozenSet[str] = frozenset({"_terminate"})


def is_terminal(state: str) -> bool:
    return state in TERMINAL


def legal(src: str, dst: str) -> bool:
    """True iff ``src -> dst`` is a legal lifecycle edge."""
    return (src, dst) in EDGES


def _validate() -> None:
    rank = {s: i for i, s in enumerate(STATES)}
    unknown = {s for e in EDGES for s in e} - set(STATES)
    if unknown:
        raise RuntimeError(f"lifecycle EDGES mention unknown states "
                           f"{sorted(unknown)} (STATES={STATES})")
    for src, dst in EDGES:
        if src in TERMINAL:
            raise RuntimeError(
                f"lifecycle edge {src!r} -> {dst!r} leaves a terminal "
                f"state — terminal states are absorbing")
        if (src, dst) != RETRY_EDGE and rank[src] >= rank[dst]:
            raise RuntimeError(
                f"lifecycle edge {src!r} -> {dst!r} moves backward — the "
                f"machine is monotone except the retry edge {RETRY_EDGE}")
    if RETRY_EDGE not in EDGES:
        raise RuntimeError("lifecycle RETRY_EDGE missing from EDGES")
    if not set(FATES) <= TERMINAL:
        raise RuntimeError(f"every fate must be terminal: {FATES}")


_validate()
