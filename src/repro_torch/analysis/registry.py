"""The engine-op registry: the ONE declared source of truth for the coroutine
wire protocol (core/search.py's docstring table, made machine-checkable).

Every search coroutine communicates with the scheduler exclusively through
``yield ("<op>", ...)`` tuples; the scheduler dispatches on the op name.
Nothing mechanical otherwise keeps the two sides in sync: a new op added to
search.py but not engine.py (or vice versa), or an operand added to one
yield site but not another, would only surface as a confusing runtime
unpack error deep inside a workload.  The port's search.py and engine.py
speak the same ops as the JAX package's, so the table is the same.

This module declares the registry; ``repro_torch.analysis.lint`` cross-checks it
against the code WITHOUT importing it (pure AST):

  * every ``yield ("name", ...)`` in checked files must name a registered op
    and carry exactly ``arity`` operands (rule ``op-unknown`` / ``op-arity``);
  * every dispatcher (a function comparing one variable against two or more
    registered op names) must handle EVERY registered op and nothing that is
    neither an op nor an event kind (rule ``op-dispatch``).

Adding a new engine op therefore means touching this table first — the lint
fails on both sides until yield sites and dispatcher agree with it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One engine op: its operand count and scheduling behavior."""

    name: str
    arity: int          # operands AFTER the op name in the yielded tuple
    suspends: bool      # the coroutine may be parked (resumed via event)
    resumes_with: str   # what gen.send() delivers back
    doc: str


# The coroutine -> scheduler op vocabulary (search.py protocol table).
ENGINE_OPS: dict[str, OpSpec] = {
    op.name: op
    for op in (
        OpSpec("compute", 1, False, "None",
               "charge simulated CPU seconds to the worker"),
        OpSpec("score", 1, False, "np.ndarray",
               "a ScoreRequest; may park in the rendezvous buffer"),
        OpSpec("beam", 1, False, "BeamResult",
               "a BeamRequest executing one fused on-device beam step "
               "(score + visited mask + top-k merge + frontier selection); "
               "may park in the rendezvous buffer; the reply is the next "
               "frontier, not raw distances"),
        OpSpec("scatter", 1, True, "np.ndarray",
               "a ShardScatter routing a ScoreRequest's rows to their "
               "owning engine shards; may park in per-shard rendezvous "
               "buffers until the shards flush and the slices merge"),
        OpSpec("read", 1, True, "{pid: bytes}",
               "blocking batched page read"),
        OpSpec("load_wait", 2, True, "record | None",
               "park on a vid's LOCKED buffer-pool window"),
        OpSpec("submit_cb", 2, False, "None",
               "fire-and-forget reads with a completion callback"),
        OpSpec("submit", 1, False, "[token, ...]",
               "non-blocking reads returning wait tokens"),
        OpSpec("wait_any", 1, True, "(token, pid, bytes)",
               "await the earliest completion of a token set"),
    )
}

# Scheduler-internal completion-event kinds: these legitimately appear in the
# same dispatch functions as engine ops but are NOT part of the coroutine
# protocol (nothing ever yields them).  "arrival" is the SLA scheduler's
# query-arrival event (an SlaPlan timestamp releasing a query into the
# admission queue); it exists only when a plan with nonzero arrivals is
# attached, so default runs carry none.
EVENT_KINDS: frozenset[str] = frozenset({"callback", "resume", "arrival"})

# Buffer-pool protocol names the pairing / purity lint rules key on.
WINDOW_OPENERS: frozenset[str] = frozenset({"begin_load"})
WINDOW_CLOSERS: frozenset[str] = frozenset(
    {"finish_load", "abort_load", "admit", "admit_group"}
)
# Blocking pool/cache methods a search coroutine must never call directly
# (it must go through an accessor, or yield the corresponding engine op).
BLOCKING_POOL_METHODS: frozenset[str] = frozenset(
    {"lookup", "admit", "admit_group", "run_clock",
     "begin_load", "finish_load", "abort_load"}
)
