"""Declarative state-machine spec of the cache hierarchy (Fig. 5 + HBM edges).

The dynamic protocol checker (``repro_torch.analysis.protocol``) validates every
observed slot transition against these tables — the spec is data, the checker
is the interpreter, so extending the protocol means adding an edge HERE and
watching the checker reject anything the implementation does beyond it.

Host pool (``RecordBufferPool``), per public method ("event"): the set of
(pre, post) state pairs the event may apply to the slot(s) it targets.  Any
event that acquires a slot may additionally run the clock, whose side
effects on OTHER slots are the ``CLOCK_EDGES``.

Device tier (``HbmTier`` / ``DeviceRecordCache``): the scatter installs
staged records (FREE -> OCCUPIED, running the device sweep under pressure);
lookups give MARKED slots their second chance.  Staging itself never touches
slot state — that is exactly the double-buffering claim the checker enforces
(records wait host-side until the next dispatch boundary).
"""

from __future__ import annotations

from repro_torch.core.bufferpool import SlotState

FREE = int(SlotState.FREE)
LOCKED = int(SlotState.LOCKED)
OCCUPIED = int(SlotState.OCCUPIED)
MARKED = int(SlotState.MARKED)

STATE_NAMES = {FREE: "FREE", LOCKED: "LOCKED",
               OCCUPIED: "OCCUPIED", MARKED: "MARKED"}

# clock second-chance side effects (demote / evict), legal on any slot while
# an acquiring event sweeps for a free one
CLOCK_EDGES: frozenset[tuple[int, int]] = frozenset(
    {(OCCUPIED, MARKED), (MARKED, FREE)}
)

# event -> allowed (pre, post) transitions for the slot(s) the event targets
POOL_EVENTS: dict[str, frozenset[tuple[int, int]]] = {
    # reserve a LOCKED window before the read is issued (no-op if racing
    # loader won the reservation)
    "begin_load": frozenset({(FREE, LOCKED)}),
    # publish the window; degrades to a plain admit if the window was aborted
    # (FREE -> OCCUPIED through the fallback admit)
    "finish_load": frozenset({(LOCKED, OCCUPIED), (FREE, OCCUPIED)}),
    # tear the window down; waiters resume with None
    "abort_load": frozenset({(LOCKED, FREE)}),
    # synchronous install; publishes an open window on the duplicate race
    "admit": frozenset({(FREE, OCCUPIED), (LOCKED, OCCUPIED)}),
    "admit_group": frozenset({(FREE, OCCUPIED), (LOCKED, OCCUPIED)}),
    # a hit gives a MARKED slot its second chance
    "lookup": frozenset({(MARKED, OCCUPIED)}),
    "peek_record": frozenset(),          # pure observer: no transitions
    "take_resumes": frozenset(),         # drains the resume queue only
    "run_clock": CLOCK_EDGES,
}

# events that may acquire slots and therefore run the clock on OTHER slots
ACQUIRING_EVENTS: frozenset[str] = frozenset(
    {"begin_load", "finish_load", "admit", "admit_group", "run_clock"}
)

# The batched scatter (DeviceRecordCache.admit) applies several micro-steps
# per call — install FREE -> OCCUPIED, sweep demote OCCUPIED -> MARKED,
# sweep evict MARKED -> FREE — so one pre/post diff observes their COMPOSITES
# too: evict + reinstall (MARKED -> OCCUPIED), demote + evict
# (OCCUPIED -> FREE).  A same-state slot whose vid changed is the full
# demote + evict + reinstall chain and is also legal for this event only.
HBM_SCATTER_EDGES: frozenset[tuple[int, int]] = (
    frozenset({(FREE, OCCUPIED), (MARKED, OCCUPIED), (OCCUPIED, FREE)})
    | CLOCK_EDGES
)

# device tier (HbmTier): event -> allowed slot_state transitions
HBM_EVENTS: dict[str, frozenset[tuple[int, int]]] = {
    # staging is host-side only: NO device slot may change state
    "note_publish": frozenset(),
    "note_hit": frozenset(),
    # the dispatch-boundary scatter installs staged rows; the device sweep
    # may demote/evict under pressure (composite edges, see above)
    "scatter_staged": HBM_SCATTER_EDGES,
    # a tier hit gives a MARKED slot its second chance
    "lookup": frozenset({(MARKED, OCCUPIED)}),
    "peek_split": frozenset({(MARKED, OCCUPIED)}),
}

# events allowed to swap a slot's vid without a state change (reinstall)
HBM_REINSTALL_EVENTS: frozenset[str] = frozenset({"scatter_staged"})
