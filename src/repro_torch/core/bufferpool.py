"""Record-level buffer pool with clock second-chance eviction (paper §3.2, Fig. 5).

Faithful pieces:

  * a slotted pool sized to a fraction of the index ("buffer ratio"), with a
    free list of slots;
  * the *record mapping array*: one hybrid pointer per vertex whose MSB encodes
    residency — MSB=1: remaining bits index a pool slot; MSB=0: remaining bits
    are the page id of the record's disk location.  O(1) vid -> location, no
    hash table, no pointer swizzling (works for graphs, unlike LeanStore).
  * per-slot state machine FREE -> LOCKED -> OCCUPIED <-> MARKED -> FREE driven
    exactly as Fig. 5 (Locked during load; clock hand demotes Occupied to
    Marked; access promotes Marked back; Marked slots under the hand are
    evicted).

The LOCKED state is a real *window*, not a transient flag: ``begin_load(vid)``
reserves a slot as LOCKED before the page read is even issued, and
``finish_load(vid, record)`` publishes it OCCUPIED when the I/O completes.
Any searcher that hits the LOCKED slot in between parks itself on the slot's
waiter list (``add_waiter``) instead of issuing a duplicate read — the paper's
record-level load coalescing, complementing the engine's page-level in-flight
dedup.  ``finish_load`` moves the parked waiters onto ``pending_resumes``;
the engine drains that queue and reschedules the coroutines with the freshly
published record.

Group admits (``admit_group``) install a whole batch-decoded co-resident
record group (the ``store.record_matrix`` unit) under ONE clock interaction:
the sweep runs once for the group's whole slot deficit instead of once per
record.  Slots carry the admitting group's id; with ``group_demote=True`` the
clock demotes all still-OCCUPIED members of a group together, so co-placed
groups age (and free whole pages' worth of slots) as a unit.

One pool instance is shared by every worker of a system (`build_system`
creates it once); coroutines on any worker coalesce on the same LOCKED slots.

Multi-tenant quotas (the serving plane, core.serving): when the pool is
shared by several tenants (``tenant_of`` maps each vid to its tenant), a
*soft clock-based quota* can cap the slots any one tenant holds
(``tenant_quota``: a fraction of the pool, or explicit per-tenant caps).  A
tenant at its cap acquires slots by running the second-chance sweep over its
OWN slots only (``quota_reclaims``) — it recycles itself instead of growing
— and an admission that finds nothing of its own evictable is simply skipped
(``quota_denials``: the record is served uncached, never an error).  Under
its cap a tenant uses the free list and the plain global clock, so an idle
tenant's cold slots are naturally lent to busy ones.  Quota off (the
default) is the pure global clock — bit-identical to the single-tenant pool.

Adaptation note: the paper uses CAS atomics because coroutines
race on slots; our engine is single-threaded per worker and lockstep on device,
so the same state machine is evolved without atomics — transitions and
invariants are identical and are what tests/test_bufferpool.py and the
stateful suite in tests/test_bufferpool_stateful.py check.
"""

from __future__ import annotations

import enum

import numpy as np

RESIDENT_BIT = np.uint64(1) << np.uint64(63)
PTR_MASK = RESIDENT_BIT - np.uint64(1)


class SlotState(enum.IntEnum):
    FREE = 0
    LOCKED = 1
    OCCUPIED = 2
    MARKED = 3


class RecordBufferPool:
    """Caches decoded records at *record* granularity."""

    def __init__(self, n_slots: int, vid_to_page: np.ndarray,
                 group_demote: bool = False, tenant_of: np.ndarray | None = None,
                 tenant_quota: float | list | tuple | np.ndarray | None = None,
                 on_publish=None):
        assert n_slots >= 1
        self.n_slots = n_slots
        # publication hook: called as on_publish(vid, record) whenever a NEW
        # record is actually installed — finish_load publishes, demand admits,
        # and every member of a group admit.  Duplicate admits (keep-first) do
        # not fire it.  The HBM record-cache tier subscribes here: this is the
        # miss-list handoff that stages freshly loaded records for the next
        # double-buffered scatter into device cache slots.
        self.on_publish = on_publish
        self.disk_pages = np.asarray(vid_to_page, dtype=np.int64)  # immutable
        # record mapping array: initially every record is on disk at its page.
        self.record_map = self.disk_pages.astype(np.uint64) & PTR_MASK
        self.state = np.full(n_slots, SlotState.FREE, dtype=np.int8)
        self.slot_vid = np.full(n_slots, -1, dtype=np.int64)
        self.slots: list[object | None] = [None] * n_slots
        self.free_list: list[int] = list(range(n_slots - 1, -1, -1))
        self.hand = 0
        # multi-tenant bookkeeping: who owns each vid / each non-FREE slot,
        # how many slots each tenant holds, and the per-tenant caps (None ==
        # quota off: the accounting still runs, admission never consults it)
        self.tenant_of = (
            None if tenant_of is None else np.asarray(tenant_of, dtype=np.int64)
        )
        self.n_tenants = (
            1 if self.tenant_of is None else int(self.tenant_of.max()) + 1
        )
        self.slot_tenant = np.full(n_slots, -1, dtype=np.int64)
        self.tenant_owned = np.zeros(self.n_tenants, dtype=np.int64)
        self.tenant_hand = np.zeros(self.n_tenants, dtype=np.int64)
        # incremental per-tenant slot index (kept by _claim/_release) so the
        # quota reclaim sweep touches only the tenant's own slots
        self.tenant_slots: list[set[int]] = [set() for _ in range(self.n_tenants)]
        if tenant_quota is None or (np.isscalar(tenant_quota) and not tenant_quota):
            self.tenant_cap = None
        elif np.isscalar(tenant_quota):
            cap = max(1, int(float(tenant_quota) * n_slots))
            self.tenant_cap = np.full(self.n_tenants, cap, dtype=np.int64)
        else:
            self.tenant_cap = np.asarray(tenant_quota, dtype=np.int64)
            assert self.tenant_cap.shape == (self.n_tenants,)
        # group admits: slot -> admitting group id (0 == admitted alone),
        # plus the reverse index so group demotion is O(group), not O(pool)
        self.group_demote = group_demote
        self.slot_group = np.zeros(n_slots, dtype=np.int64)
        self.group_slots: dict[int, list[int]] = {}
        self._next_group = 1
        # LOCKED windows: vid -> waiters parked on the in-flight load, and the
        # (waiter, record) pairs ready for the engine to resume
        self.waiters: dict[int, list[object]] = {}
        self.pending_resumes: list[tuple[object, object | None]] = []
        # stats
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.lock_waits = 0              # searchers parked on a LOCKED slot
        self.coalesced_record_loads = 0  # waiters served by someone else's load
        self.group_admits = 0            # admit_group calls that admitted >= 1
        self.clock_skips = 0             # sweep steps that landed on LOCKED
        self.quota_reclaims = 0          # over-quota tenants recycling their own
        self.quota_denials = 0           # slot ACQUISITIONS denied at the cap —
                                         # one uncached demand admission can
                                         # contribute two (its LOCKED-window
                                         # reservation and the fallback admit)

    # ------------------------------------------------------------- residency

    def is_resident(self, vid: int) -> bool:
        """The mapping-array MSB: the vid owns a slot (LOCKED *or* published)."""
        return bool(self.record_map[vid] & RESIDENT_BIT)

    def page_of(self, vid: int) -> int:
        """Disk page id from the hybrid pointer (valid when not resident)."""
        assert not self.is_resident(vid)
        return int(self.record_map[vid] & PTR_MASK)

    def _slot_of(self, vid: int) -> int:
        return int(self.record_map[vid] & PTR_MASK)

    def is_loading(self, vid: int) -> bool:
        """True while vid's slot sits in its LOCKED window (load in flight)."""
        return self.is_resident(vid) and self.state[self._slot_of(vid)] == SlotState.LOCKED

    def status(self, vid: int) -> str:
        """'absent' | 'loading' | 'present' (no stats side effects)."""
        if not self.is_resident(vid):
            return "absent"
        if self.state[self._slot_of(vid)] == SlotState.LOCKED:
            return "loading"
        return "present"

    # ---------------------------------------------------------------- lookup

    def lookup(self, vid: int) -> object | None:
        """Hit: return record, giving MARKED slots their second chance.
        Miss: return None (caller loads via `admit`/`begin_load`).  A LOCKED
        slot is a miss too — the record bytes aren't in memory yet; callers
        that can suspend should park on it via the engine's load_wait op."""
        if self.is_resident(vid):
            slot = self._slot_of(vid)
            if self.state[slot] == SlotState.LOCKED:
                self.misses += 1
                return None
            if self.state[slot] == SlotState.MARKED:
                self.state[slot] = SlotState.OCCUPIED  # second chance
            self.hits += 1
            return self.slots[slot]
        self.misses += 1
        return None

    def peek_resident(self, vid: int) -> bool:
        """Slot-ownership probe without stats side effects.  True for LOCKED
        windows too — the prefetcher uses this to avoid re-submitting a load
        that is already in flight."""
        return self.is_resident(vid)

    def peek_present(self, vid: int) -> bool:
        """Alg. 2's InMemory() test: the record can be read without blocking.
        A LOCKED slot is NOT in memory — pivoting to it would stall on the
        in-flight load rather than avoid an I/O wait."""
        return self.is_resident(vid) and self.state[self._slot_of(vid)] != SlotState.LOCKED

    def peek_record(self, vid: int) -> object | None:
        """Published record or None — NO stats, NO second chance.  The engine
        uses this to resolve a load_wait whose window closed before the op was
        scheduled: that access was already counted as a miss when the searcher
        classified it, exactly like a waiter resumed by finish_load."""
        if self.peek_present(vid):
            return self.slots[self._slot_of(vid)]
        return None

    # --------------------------------------------------------------- tenants

    def _tenant(self, vid: int) -> int:
        return 0 if self.tenant_of is None else int(self.tenant_of[vid])

    def _claim(self, slot: int, vid: int) -> None:
        """Slot-ownership bookkeeping on every FREE -> non-FREE transition."""
        t = self._tenant(vid)
        self.slot_tenant[slot] = t
        self.tenant_owned[t] += 1
        self.tenant_slots[t].add(slot)

    def _release(self, slot: int) -> None:
        t = int(self.slot_tenant[slot])
        if t >= 0:
            self.tenant_owned[t] -= 1
            self.tenant_slots[t].discard(slot)
            self.slot_tenant[slot] = -1

    def _reclaim_from_tenant(self, tenant: int) -> bool:
        """Second-chance sweep restricted to ``tenant``'s own slots — the
        over-quota acquisition path.  The sweep iterates ONLY the slots the
        tenant owns (O(own slots), not O(pool)), resuming from a per-tenant
        hand, with the same OCCUPIED -> MARKED -> evict rules as the global
        clock; LOCKED slots are skipped and counted.  Two passes suffice: the
        first demotes (and evicts anything already MARKED), the second evicts
        what the first demoted.  Returns True when one slot was freed."""
        if not self.tenant_slots[tenant]:
            return False
        own = np.asarray(sorted(self.tenant_slots[tenant]), dtype=np.int64)
        start = int(np.searchsorted(own, int(self.tenant_hand[tenant])))
        order = np.roll(own, -start)
        for _sweep in range(2):
            for s in order:
                s = int(s)
                st = self.state[s]
                if st == SlotState.OCCUPIED:
                    self.state[s] = SlotState.MARKED
                    if self.group_demote and self.slot_group[s]:
                        self._demote_group(int(self.slot_group[s]))
                elif st == SlotState.MARKED:
                    self.tenant_hand[tenant] = (s + 1) % self.n_slots
                    self._evict_slot(s)
                    self.quota_reclaims += 1
                    return True
                elif st == SlotState.LOCKED and _sweep == 0:
                    self.clock_skips += 1
        return False  # every owned slot pinned by an in-flight load

    # ---------------------------------------------------- async LOCKED window

    def begin_load(self, vid: int) -> int:
        """Reserve a slot as LOCKED for an in-flight load of vid.

        Called BEFORE the page read is issued, so concurrent searchers observe
        the LOCKED window and coalesce instead of re-reading.  Returns the
        slot, or -1 when no slot can be reserved (every slot LOCKED); if vid
        already owns a slot (racing loader won), returns that slot."""
        if self.is_resident(vid):
            return self._slot_of(vid)
        slot = self._acquire_slot(vid)
        if slot < 0:
            return -1
        self.state[slot] = SlotState.LOCKED
        self.slot_vid[slot] = vid
        self.slots[slot] = None
        self.record_map[vid] = RESIDENT_BIT | np.uint64(slot)
        self._claim(slot, vid)
        return slot

    def finish_load(self, vid: int, record: object) -> int:
        """Publish a LOCKED slot as OCCUPIED and queue its parked waiters for
        resumption with the record.  Idempotent against the duplicate-admit
        race: if another loader already published vid, the FIRST record is
        kept; if the window was aborted meanwhile, this degrades to a plain
        admit.  Returns the slot (or -1 on an exhausted pool)."""
        if not self.is_resident(vid):
            return self.admit(vid, record)
        slot = self._slot_of(vid)
        if self.state[slot] != SlotState.LOCKED:
            return slot  # racing loader published first: keep its record
        self.slots[slot] = record
        self.state[slot] = SlotState.OCCUPIED
        for waiter in self.waiters.pop(vid, ()):
            self.coalesced_record_loads += 1
            self.pending_resumes.append((waiter, record))
        if self.on_publish is not None:
            self.on_publish(vid, record)
        return slot

    def abort_load(self, vid: int) -> None:
        """Tear down a LOCKED window whose load will never complete; parked
        waiters are queued for resumption with None (they re-issue the load)."""
        if not self.is_loading(vid):
            return
        slot = self._slot_of(vid)
        for waiter in self.waiters.pop(vid, ()):
            self.pending_resumes.append((waiter, None))
        self.record_map[vid] = np.uint64(self.disk_pages[vid])
        self.slot_vid[slot] = -1
        self.slots[slot] = None
        self.slot_group[slot] = 0
        self._release(slot)
        self.state[slot] = SlotState.FREE
        self.free_list.append(slot)

    def add_waiter(self, vid: int, waiter: object) -> None:
        """Park a searcher on vid's LOCKED window (engine load_wait op)."""
        assert self.is_loading(vid), "waiters park only on LOCKED slots"
        self.waiters.setdefault(vid, []).append(waiter)
        self.lock_waits += 1

    def take_resumes(self) -> list[tuple[object, object | None]]:
        """Drain the (waiter, record) pairs made runnable by finish/abort."""
        out, self.pending_resumes = self.pending_resumes, []
        return out

    # ----------------------------------------------------------------- admit

    def admit(self, vid: int, record: object) -> int:
        """Load a record into a slot synchronously (no LOCKED window exposed).

        Returns the slot index, or -1 when the pool is exhausted — every slot
        LOCKED by an in-flight load (pool smaller than the prefetch window).
        Callers handle -1 by skipping admission: the record is still returned
        to the search, it just isn't cached.  A demand admit racing an open
        LOCKED window publishes that window (first record kept, waiters
        resumed) — the record-level duplicate-admit rule."""
        if self.is_resident(vid):
            if self.state[self._slot_of(vid)] == SlotState.LOCKED:
                return self.finish_load(vid, record)
            return self._slot_of(vid)  # duplicate admit: keep first
        slot = self._acquire_slot(vid)
        if slot < 0:
            return -1
        self.state[slot] = SlotState.LOCKED
        self.slot_vid[slot] = vid
        self.slots[slot] = record
        self.record_map[vid] = RESIDENT_BIT | np.uint64(slot)
        self._claim(slot, vid)
        self.state[slot] = SlotState.OCCUPIED
        if self.on_publish is not None:
            self.on_publish(vid, record)
        return slot

    def admit_group(self, vids, records) -> int:
        """Admit a batch-decoded co-resident record group under ONE clock
        interaction (one sweep covers the whole slot deficit).  Already-owned
        vids (published or LOCKED by an in-flight load) are skipped — keep
        first.  Partial admission under pressure is fine: the remainder is
        simply not cached.  Returns the number of records admitted."""
        todo: list[tuple[int, object]] = []
        batch_seen: set[int] = set()
        for v, r in zip(vids, records):
            v = int(v)
            # skip resident vids AND in-batch duplicates (keep first) — a
            # duplicate would otherwise allocate two slots for one vid and
            # corrupt the mapping array when the stale one is evicted
            if v in batch_seen or self.is_resident(v):
                continue
            batch_seen.add(v)
            todo.append((v, r))
        if not todo:
            return 0
        # The hand is persistent, so acquiring the group's slots back to back
        # is ONE continued sweep over the whole deficit (the clock is never
        # re-entered from scratch per record), and slot assignment + demote
        # interleaving are bit-identical to what per-record admits would do —
        # group admission adds the shared group id, group demotion, and the
        # single bookkeeping interaction, without perturbing replacement.
        gid = self._next_group
        self._next_group += 1
        # register the member list up front: under extreme pressure a later
        # acquisition can clock-evict an EARLIER member of this very group,
        # and _evict_slot must find it here to keep the reverse index true
        members: list[int] = []
        self.group_slots[gid] = members
        admitted = 0
        for vid, record in todo:
            slot = self._acquire_slot(vid)
            if slot < 0:
                break  # every slot LOCKED: the rest simply isn't cached
            self.state[slot] = SlotState.OCCUPIED
            self.slot_vid[slot] = vid
            self.slots[slot] = record
            self.slot_group[slot] = gid
            self.record_map[vid] = RESIDENT_BIT | np.uint64(slot)
            self._claim(slot, vid)
            members.append(slot)
            # re-link on every install: if the clock just evicted the LAST
            # earlier member, _evict_slot dropped the (then-empty) index
            # entry, and this slot's tag would otherwise dangle
            self.group_slots[gid] = members
            admitted += 1
            if self.on_publish is not None:
                self.on_publish(vid, record)
        if not members:
            # nothing survived (or nothing admitted); _evict_slot may already
            # have dropped the entry when it removed the last member
            self.group_slots.pop(gid, None)
        if admitted:
            self.group_admits += 1
        return admitted

    def _acquire_slot(self, vid: int = -1) -> int:
        if self.tenant_cap is not None and vid >= 0:
            t = self._tenant(vid)
            if self.tenant_owned[t] >= self.tenant_cap[t]:
                # soft quota: a tenant at its cap recycles its OWN slots
                # (tenant-scoped second-chance sweep) instead of growing;
                # nothing of its own evictable -> the admission is skipped
                if not self._reclaim_from_tenant(t):
                    self.quota_denials += 1
                    return -1
                return self.free_list.pop()
        if self.free_list:
            return self.free_list.pop()
        if not self.run_clock(target=1):
            return -1  # every slot LOCKED: nothing is evictable right now
        return self.free_list.pop()

    # ----------------------------------------------------------------- clock

    def run_clock(self, target: int = 1) -> int:
        """Clock second-chance sweep (the paper's 'eviction coroutine').

        OCCUPIED -> MARKED and advance; MARKED under the hand -> evict.
        LOCKED is skipped — each skip is counted in ``clock_skips``, and a
        full revolution that lands ONLY on LOCKED slots terminates the sweep
        immediately (nothing can become evictable while every slot is pinned
        by an in-flight load), instead of silently burning 3 * n_slots steps.
        Returns the number of slots freed.
        """
        freed = 0
        steps = 0
        locked_run = 0  # consecutive steps that landed on LOCKED slots
        # up to three full sweeps: one to demote OCCUPIED to MARKED, one to
        # evict, plus slack for LOCKED slots skipped mid-sweep.  If nothing
        # freed by then, every slot is LOCKED and the caller must cope.
        max_steps = 3 * self.n_slots
        while freed < target and steps < max_steps:
            s = self.hand
            self.hand = (self.hand + 1) % self.n_slots
            steps += 1
            st = self.state[s]
            if st == SlotState.OCCUPIED:
                locked_run = 0
                self.state[s] = SlotState.MARKED
                if self.group_demote and self.slot_group[s]:
                    self._demote_group(int(self.slot_group[s]))
            elif st == SlotState.MARKED:
                locked_run = 0
                self._evict_slot(s)
                freed += 1
            elif st == SlotState.LOCKED:
                self.clock_skips += 1
                locked_run += 1
                if locked_run >= self.n_slots:
                    break  # whole revolution pinned: sweeping is a live-lock
            else:  # FREE under the hand
                locked_run = 0
        return freed

    def _demote_group(self, gid: int) -> None:
        """Demote every still-OCCUPIED member of a group in the same clock
        step, so co-admitted record groups age out together."""
        for s in self.group_slots.get(gid, ()):
            if self.state[s] == SlotState.OCCUPIED:
                self.state[s] = SlotState.MARKED

    def _evict_slot(self, slot: int) -> None:
        vid = int(self.slot_vid[slot])
        assert vid >= 0
        # restore the on-disk pointer (a record's page id never changes)
        self.record_map[vid] = np.uint64(self.disk_pages[vid])
        self.slot_vid[slot] = -1
        self.slots[slot] = None
        gid = int(self.slot_group[slot])
        if gid:
            members = self.group_slots[gid]
            members.remove(slot)
            if not members:
                del self.group_slots[gid]
        self.slot_group[slot] = 0
        self._release(slot)
        self.state[slot] = SlotState.FREE
        self.free_list.append(slot)
        self.evictions += 1

    # ----------------------------------------------------------------- stats

    def occupancy(self) -> int:
        return self.n_slots - len(self.free_list)

    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    def pressure_stats(self) -> dict[str, int]:
        """The pool-pressure counters WorkloadStats surfaces per run."""
        return {
            "lock_waits": self.lock_waits,
            "coalesced_record_loads": self.coalesced_record_loads,
            "group_admits": self.group_admits,
            "clock_skips": self.clock_skips,
            "quota_reclaims": self.quota_reclaims,
            "quota_denials": self.quota_denials,
        }

    def reset_stats(self) -> None:
        self.hits = self.misses = self.evictions = 0
        self.lock_waits = self.coalesced_record_loads = 0
        self.group_admits = self.clock_skips = 0
        self.quota_reclaims = self.quota_denials = 0

    def check_invariants(self, cheap: bool = False) -> None:
        """Structural invariants (exercised by hypothesis tests and, with
        ``SystemConfig.verify_protocol``, at every engine flush boundary):
        every resident vid's slot points back at it; free slots hold nothing;
        occupancy + free == n_slots; LOCKED slots carry no record yet and are
        the only ones allowed parked waiters; per-tenant quota accounting
        matches actual slot ownership exactly.

        ``cheap=True`` runs only the vectorized subset (free-list/state
        agreement, mapping-array occupancy, quota totals and caps, and the
        waiters-only-on-LOCKED rule) — O(n_slots) numpy plus O(waiters)
        python, no per-slot python loop; this is what the protocol checker
        calls on the hot flush path."""
        assert len(self.free_list) == (self.state == SlotState.FREE).sum(), (
            "free list out of sync with slot states"
        )
        resident = (self.record_map & RESIDENT_BIT) != 0
        assert int(resident.sum()) == self.occupancy(), (
            "mapping-array residency out of sync with pool occupancy"
        )
        # waiter lists may exist ONLY for vids inside an open LOCKED window —
        # a waiter on a published/FREE/MARKED slot is a lost wakeup in the
        # making (nothing will ever queue its resume)
        for vid, ws in self.waiters.items():
            assert ws, "empty waiter lists must be dropped"
            assert self.is_loading(vid), (
                f"waiters parked on vid {vid} whose slot is not LOCKED"
            )
        assert int(self.tenant_owned.sum()) == self.occupancy(), (
            "tenant quota accounting out of sync with occupancy"
        )
        if self.tenant_cap is not None:
            assert (self.tenant_owned <= self.tenant_cap).all(), (
                "tenant holds more slots than its quota cap"
            )
        if cheap:
            return
        owned_recount = np.zeros(self.n_tenants, dtype=np.int64)
        for s in range(self.n_slots):
            st = self.state[s]
            if st == SlotState.FREE:
                assert self.slots[s] is None and self.slot_vid[s] == -1
                assert self.slot_group[s] == 0
                assert self.slot_tenant[s] == -1
            else:
                vid = int(self.slot_vid[s])
                assert vid >= 0
                assert self.record_map[vid] == (RESIDENT_BIT | np.uint64(s))
                assert self.slot_tenant[s] == self._tenant(vid)
                owned_recount[self.slot_tenant[s]] += 1
                if st == SlotState.LOCKED:
                    assert self.slots[s] is None  # record not published yet
        # quota accounting == slot ownership, after every operation
        assert (owned_recount == self.tenant_owned).all(), (
            f"tenant quota recount {owned_recount.tolist()} disagrees with "
            f"tenant_owned {self.tenant_owned.tolist()}"
        )
        for t in range(self.n_tenants):
            assert self.tenant_slots[t] == {
                s for s in range(self.n_slots) if self.slot_tenant[s] == t
            }, f"tenant {t} slot index out of sync"
        if self.tenant_cap is not None:
            assert (self.tenant_owned <= self.tenant_cap).all()
        # the group reverse index and the per-slot tags agree exactly
        for gid, members in self.group_slots.items():
            assert members, "empty group entries must be dropped"
            for s in members:
                assert self.slot_group[s] == gid
        for s in range(self.n_slots):
            g = int(self.slot_group[s])
            if g:
                assert s in self.group_slots.get(g, ())
