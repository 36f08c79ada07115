"""The port's protocol verifier (repro_torch.analysis) against the JAX
package's (repro.analysis): lint rules, dynamic checker, verify_protocol.

  * static lint — one firing and one clean fixture per rule, driven through
    the port's ``run_lint_text`` with synthetic filenames (the determinism
    and purity rules are path-scoped to ``repro_torch/core``); every fixture
    gives the same (rule, line) findings under the reference's lint at the
    reference's path; torch's global generator has its own firing and clean
    fixtures; ``run_lint(["src/repro_torch"])`` is clean.
  * dynamic checker — ``_Buggy*Pool`` subclasses that each reintroduce one
    historic bug class, built on the port's ``RecordBufferPool`` and on the
    reference's from one source: the port's checker names the same detector
    with the same violations as the reference's.  A clean pool driven
    through the same motions stays silent.
  * verify_protocol — bitwise inert end to end on the CPU (velo with the HBM
    tier off and on, pipeann, diskann) and on a quota-enabled serving plane.
"""

import pathlib
import textwrap

import numpy as np
import pytest
import torch

from repro.analysis import lint as ref_lint
from repro.analysis import registry as ref_registry
from repro.analysis import spec as ref_spec
from repro.analysis.protocol import ProtocolChecker as RefChecker
from repro.core import bufferpool as ref_bufferpool
from repro_torch.analysis import registry, run_lint, run_lint_text, spec
from repro_torch.analysis.explore import _smoke_fixture, normalize_results
from repro_torch.analysis.protocol import ProtocolChecker, ProtocolError
from repro_torch.core import baselines
from repro_torch.core import bufferpool
from repro_torch.core import workload as workload_mod
from repro_torch.core.bufferpool import RecordBufferPool
from repro_torch.core.search import SearchParams
from repro_torch.core.serving import ServingPlane, TenantSpec

ROOT = pathlib.Path(__file__).resolve().parents[1]

# path-scoped rules (purity + determinism) key on "repro_torch/core"
CORE = "src/repro_torch/core/fake.py"
ELSEWHERE = "src/repro_torch/velo/fake.py"
REF_CORE = "src/repro/core/fake.py"


def lint(src: str, filename: str = CORE):
    return run_lint_text(textwrap.dedent(src), filename)


def rules(findings) -> set:
    return {f.rule for f in findings}


def _dispatcher(*names: str) -> str:
    lines = ["def dispatch(kind):"]
    kw = "if"
    for name in names:
        lines.append(f'    {kw} kind == "{name}":')
        lines.append("        pass")
        kw = "elif"
    return "\n".join(lines) + "\n"


ALL_OPS = tuple(registry.ENGINE_OPS)  # every registered op, no hand copy

# every lint fixture of the reference's tests, by name
SRC = {
    "unknown_op": """
        def co(q):
            yield ("read", 1)
            yield ("frobnicate", 2)
    """,
    "non_protocol": """
        def rows():
            yield ("status", "ok")
            yield ("status", "done")
    """,
    "bad_arity": """
        def co(q):
            yield ("compute", 1, 2)
            yield ("load_wait", 5)
    """,
    "good_arity": """
        def co(q):
            yield ("compute", 1)
            yield ("load_wait", 5, "tok")
            yield ("submit_cb", 3, None)
            yield ("wait_any", ["a", "b"])
    """,
    "dispatch_missing": _dispatcher("compute", "score"),
    "dispatch_unregistered": _dispatcher(*ALL_OPS, "frobnicate"),
    "dispatch_full": _dispatcher(*ALL_OPS, "callback", "resume"),
    "event_kind_switch": """
        def pump(kind):
            if kind == "callback":
                return 1
            elif kind == "resume":
                return 2
    """,
    "unclosed_window": """
        def loader(pool, vid):
            pool.begin_load(vid)
    """,
    "one_armed": """
        def loader(pool, vid, rec, ok):
            pool.begin_load(vid)
            if ok:
                pool.finish_load(vid, rec)
    """,
    "both_branches": """
        def loader(pool, vid, rec, ok):
            pool.begin_load(vid)
            if ok:
                pool.finish_load(vid, rec)
            else:
                pool.abort_load(vid)
    """,
    "nested_callback": """
        def loader(pool, ssd, vid):
            pool.begin_load(vid)
            def on_complete(rec):
                pool.finish_load(vid, rec)
            ssd.submit(on_complete)
    """,
    "loop_body": """
        def loader(pool, vids, recs):
            for v in vids:
                pool.begin_load(v)
            for v, r in zip(vids, recs):
                pool.finish_load(v, r)
    """,
    "transitive": """
        def _publish(pool, vid, rec):
            pool.finish_load(vid, rec)

        def loader(pool, vid, rec):
            pool.begin_load(vid)
            _publish(pool, vid, rec)
    """,
    "delegation": """
        def reserve(pool, vid):
            return pool.begin_load(vid)
    """,
    "raise_path": """
        def loader(pool, vid):
            pool.begin_load(vid)
            raise RuntimeError("load backend gone")
    """,
    "publish_locked": """
        def publish(self, slot, vid, rec):
            self.state[slot] = SlotState.LOCKED
            self.on_publish(vid, rec)
    """,
    "publish_no_state": """
        def publish(self, vid, rec):
            self.on_publish(vid, rec)
    """,
    "publish_occupied": """
        def publish(self, slot, vid, rec):
            self.state[slot] = SlotState.OCCUPIED
            self.on_publish(vid, rec)
    """,
    "blocking_coroutine": """
        def search(ctx, q):
            rec = ctx.pool.lookup(0)
            yield ("read", 1)
    """,
    "accessor_method": """
        class Accessor:
            def fetch(self, vid):
                rec = self.pool.lookup(vid)
                yield ("read", 1)
    """,
    "wall_clock": """
        import time

        def stamp():
            return time.perf_counter()
    """,
    "default_rng_unseeded": """
        import numpy as np
        rng = np.random.default_rng()
    """,
    "legacy_rng": """
        import numpy as np
        x = np.random.rand(3)
    """,
    "stdlib_random": """
        import random
        y = random.random()
    """,
    "seeded_generator": """
        import numpy as np

        def draw(seed):
            rng = np.random.default_rng(seed)
            return rng.integers(0, 10)
    """,
    "named_set": """
        pending = {1, 2, 3}
        for x in pending:
            print(x)
    """,
    "set_literal": """
        for x in {1, 2}:
            print(x)
    """,
    "closure_set": """
        def outer():
            pending = set()
            def drain():
                for x in pending:
                    print(x)
            return drain
    """,
    "rebound_sorted": """
        s = {1, 2}
        s = sorted(s)
        for x in s:
            print(x)
    """,
    "dict_iteration": """
        d = {}
        for k in d:
            print(k)
    """,
}

# torch's global generator: the port's rule alone (JAX has no global RNG)
TORCH_RNG_FIRING = """
    import torch

    def noise(n):
        torch.manual_seed(0)
        a = torch.rand(n)
        b = torch.randn(n, 4)
        c = torch.randint(0, 10, (n,))
        d = torch.randperm(n)
        e = torch.normal(0.0, 1.0, (n,))
        f = torch.bernoulli(a)
        return a, b, c, d, e, f
"""
TORCH_RNG_CLEAN = """
    import torch

    def noise(n, seed):
        g = torch.Generator().manual_seed(seed)
        a = torch.rand(n, generator=g)
        b = torch.randn(n, 4, generator=g)
        c = torch.randint(0, 10, (n,), generator=g)
        d = torch.randperm(n, generator=g)
        e = torch.normal(0.0, 1.0, (n,), generator=g)
        f = torch.bernoulli(a, generator=g)
        return a, b, c, d, e, f, torch.zeros(n)
"""


# ===================================================== static lint fixtures


class TestOpRegistry:
    def test_unknown_op_fires(self):
        fs = lint(SRC["unknown_op"])
        assert rules(fs) == {"op-unknown"}
        assert "frobnicate" in fs[0].message

    def test_non_protocol_module_is_silent(self):
        assert lint(SRC["non_protocol"]) == []

    def test_arity_mismatch_fires(self):
        fs = lint(SRC["bad_arity"])
        assert rules(fs) == {"op-arity"}
        assert len(fs) == 2

    def test_correct_arities_clean(self):
        assert lint(SRC["good_arity"]) == []


class TestOpDispatch:
    def test_missing_ops_fire(self):
        fs = lint(SRC["dispatch_missing"])
        assert rules(fs) == {"op-dispatch"}
        assert "wait_any" in fs[0].message

    def test_unregistered_name_fires(self):
        fs = lint(SRC["dispatch_unregistered"])
        assert rules(fs) == {"op-dispatch"}
        assert "frobnicate" in fs[0].message

    def test_full_dispatcher_with_event_kinds_clean(self):
        assert lint(SRC["dispatch_full"]) == []

    def test_event_kind_switch_is_not_a_dispatcher(self):
        assert lint(SRC["event_kind_switch"]) == []


class TestBeginLoadPairing:
    @pytest.mark.parametrize("name", ["unclosed_window", "one_armed"])
    def test_unclosed_window_fires(self, name):
        assert rules(lint(SRC[name])) == {"begin-load-pairing"}

    @pytest.mark.parametrize("name", ["both_branches", "nested_callback", "loop_body",
                                      "transitive", "delegation", "raise_path"])
    def test_closed_or_lenient_clean(self, name):
        assert lint(SRC[name]) == []


class TestPublishInLocked:
    def test_publish_under_locked_fires(self):
        fs = lint(SRC["publish_locked"])
        assert rules(fs) == {"publish-in-locked"}
        assert "LOCKED" in fs[0].message

    def test_publish_without_state_write_fires(self):
        assert rules(lint(SRC["publish_no_state"])) == {"publish-in-locked"}

    def test_publish_after_occupied_clean(self):
        assert lint(SRC["publish_occupied"]) == []


class TestPathScopedRules:
    """Purity and the determinism rules apply to this package's core only:
    not to its other subpackages, and not to the reference's core path."""

    @pytest.mark.parametrize("name,rule", [
        ("blocking_coroutine", "blocking-call-in-coroutine"),
        ("wall_clock", "wall-clock"),
        ("default_rng_unseeded", "unseeded-rng"),
        ("legacy_rng", "unseeded-rng"),
        ("stdlib_random", "unseeded-rng"),
        ("named_set", "set-iteration"),
        ("set_literal", "set-iteration"),
        ("closure_set", "set-iteration"),
    ])
    def test_fires_in_core_only(self, name, rule):
        assert rule in rules(lint(SRC[name]))
        for elsewhere in (ELSEWHERE, REF_CORE):
            assert rule not in rules(lint(SRC[name], elsewhere))

    @pytest.mark.parametrize("name", ["accessor_method", "seeded_generator",
                                      "rebound_sorted", "dict_iteration"])
    def test_clean_in_core(self, name):
        assert lint(SRC[name]) == []


class TestTorchRng:
    def test_global_generator_fires_once_per_call(self):
        fs = lint(TORCH_RNG_FIRING)
        assert rules(fs) == {"unseeded-rng"}
        assert [f.line for f in fs] == list(range(5, 12))
        assert "manual_seed" in fs[0].message and "torch.rand()" in fs[1].message

    def test_explicit_generator_clean(self):
        assert lint(TORCH_RNG_CLEAN) == []

    def test_rule_is_scoped_to_core(self):
        assert lint(TORCH_RNG_FIRING, ELSEWHERE) == []


@pytest.mark.parametrize("name", sorted(SRC))
def test_same_findings_as_the_reference(name):
    """One source text, the reference's lint at the reference's core path and
    the port's at its own: the same (rule, line) findings."""
    text = textwrap.dedent(SRC[name])
    want = [(f.rule, f.line) for f in ref_lint.run_lint_text(text, REF_CORE)]
    got = [(f.rule, f.line) for f in run_lint_text(text, CORE)]
    assert got == want


def test_registry_and_spec_equal_the_reference():
    assert registry.ENGINE_OPS == {
        k: registry.OpSpec(**vars(v)) for k, v in ref_registry.ENGINE_OPS.items()}
    for name in ("EVENT_KINDS", "WINDOW_OPENERS", "WINDOW_CLOSERS", "BLOCKING_POOL_METHODS"):
        assert getattr(registry, name) == getattr(ref_registry, name), name
    assert "arrival" in registry.EVENT_KINDS
    for name in ("FREE", "LOCKED", "OCCUPIED", "MARKED", "STATE_NAMES", "CLOCK_EDGES",
                 "POOL_EVENTS", "ACQUIRING_EVENTS", "HBM_SCATTER_EDGES", "HBM_EVENTS",
                 "HBM_REINSTALL_EVENTS"):
        assert getattr(spec, name) == getattr(ref_spec, name), name


def test_port_source_tree_is_lint_clean():
    """The gate for the port: its whole tree under every rule (the path-scoped
    ones over its own core), zero findings."""
    assert run_lint([str(ROOT / "src" / "repro_torch")]) == []


def test_finding_format():
    fs = lint(SRC["unclosed_window"])
    assert fs[0].format().startswith(f"{CORE}:3: [begin-load-pairing]")


def test_cli_lints_the_port_by_default(capsys, tmp_path):
    from repro_torch.analysis.__main__ import main

    assert main([]) == 0
    bad = tmp_path / "repro_torch" / "core" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text(textwrap.dedent(SRC["wall_clock"]))
    assert main([str(bad)]) == 1
    assert "[wall-clock]" in capsys.readouterr().out


# ================================================ dynamic protocol checker


def _pool(n_slots=4, n_vids=16, cls=RecordBufferPool, **kw):
    pages = np.arange(n_vids, dtype=np.int64)
    return cls(n_slots, pages, **kw)


def _watched(pool, checker_cls=ProtocolChecker):
    checker = checker_cls()
    checker.watch_pool(pool)
    return checker


def _buggy_pools(mod):
    """The five historic bug classes on ``mod.RecordBufferPool`` (the port's
    or the reference's bufferpool module), from one source."""
    Pool, SlotState, RESIDENT_BIT = mod.RecordBufferPool, mod.SlotState, mod.RESIDENT_BIT

    class LostWakeupPool(Pool):
        """finish_load publishes but silently drops the parked waiters."""

        def finish_load(self, vid, record):
            slot = self._slot_of(vid)
            self.slots[slot] = record
            self.state[slot] = SlotState.OCCUPIED
            self.waiters.pop(vid, None)  # BUG: no resumes queued
            return slot

    class SkipLockWindowPool(Pool):
        """begin_load installs straight to OCCUPIED — no LOCKED window."""

        def begin_load(self, vid):
            if self.is_resident(vid):
                return self._slot_of(vid)
            slot = self._acquire_slot(vid)
            if slot < 0:
                return -1
            self.state[slot] = SlotState.OCCUPIED  # BUG: skips LOCKED
            self.slot_vid[slot] = vid
            self.slots[slot] = None
            self.record_map[vid] = RESIDENT_BIT | np.uint64(slot)
            self._claim(slot, vid)
            return slot

    class DoublePublishPool(Pool):
        """Duplicate admit re-fires the publish hook instead of keep-first."""

        def admit(self, vid, record):
            if (self.is_resident(vid)
                    and self.state[self._slot_of(vid)] != SlotState.LOCKED):
                if self.on_publish is not None:
                    self.on_publish(vid, record)  # BUG: second fire while resident
                return self._slot_of(vid)
            return super().admit(vid, record)

    class SlotLeakPool(Pool):
        """Eviction forgets to return the freed slot to the free list."""

        def _evict_slot(self, slot):
            vid = int(self.slot_vid[slot])
            self.record_map[vid] = np.uint64(self.disk_pages[vid])
            self.slot_vid[slot] = -1
            self.slots[slot] = None
            self.slot_group[slot] = 0
            self._release(slot)
            self.state[slot] = SlotState.FREE
            self.evictions += 1
            # BUG: free_list.append(slot) missing

    class QuotaDriftPool(Pool):
        """Slot claims stop updating the per-tenant ownership counter."""

        def _claim(self, slot, vid):
            t = self._tenant(vid)
            self.slot_tenant[slot] = t
            self.tenant_slots[t].add(slot)
            # BUG: tenant_owned[t] never incremented

    return dict(lost_wakeup=LostWakeupPool, skip_lock=SkipLockWindowPool,
                double_publish=DoublePublishPool, slot_leak=SlotLeakPool,
                quota_drift=QuotaDriftPool)


def _drive_lost_wakeup(pool, checker):
    pool.begin_load(0)
    pool.add_waiter(0, "searcher")
    pool.finish_load(0, "rec")


def _drive_skip_lock(pool, checker):
    pool.begin_load(0)


def _drive_double_publish(pool, checker):
    pool.admit(0, "rec")
    assert checker.ok()  # first publish is legitimate
    pool.admit(0, "rec")  # duplicate admit re-fires the hook


def _drive_slot_leak(pool, checker):
    for vid in range(3):
        pool.admit(vid, f"rec{vid}")
    pool.run_clock(target=1)  # buggy eviction drops the slot
    checker.at_flush()


def _drive_quota_drift(pool, checker):
    pool.admit(0, "rec")
    checker.at_flush()


BUGS = {
    "lost_wakeup": (_drive_lost_wakeup, {}, "lost-wakeup", None),
    "skip_lock": (_drive_skip_lock, {}, "bad-transition", "FREE -> OCCUPIED"),
    "double_publish": (_drive_double_publish, {}, "double-publish", None),
    "slot_leak": (_drive_slot_leak, dict(n_slots=3), "slot-leak", "free list"),
    "quota_drift": (_drive_quota_drift, {}, "quota-accounting", None),
}


@pytest.mark.parametrize("bug", sorted(BUGS))
def test_buggy_pool_trips_the_reference_detector(bug):
    """Each bug class, on the port's pool under the port's checker, gives the
    reference's violations on the reference's pool under its checker."""
    drive, kw, rule, detail = BUGS[bug]
    found = []
    for mod, checker_cls in ((bufferpool, ProtocolChecker), (ref_bufferpool, RefChecker)):
        pool = _pool(cls=_buggy_pools(mod)[bug], **kw)
        checker = _watched(pool, checker_cls)
        drive(pool, checker)
        found.append([(v.rule, v.event, v.detail) for v in checker.violations])
    assert found[0] == found[1]
    hits = [d for r, _, d in found[0] if r == rule]
    assert hits, found[0]
    assert detail is None or detail in hits[0]


class TestProtocolChecker:
    def test_clean_pool_stays_silent(self):
        pool = _pool(n_slots=3)
        checker = _watched(pool)
        pool.begin_load(0)
        pool.add_waiter(0, "searcher")
        pool.finish_load(0, "rec0")
        assert pool.take_resumes() == [("searcher", "rec0")]
        for vid in range(1, 8):
            pool.admit(vid, f"rec{vid}")
        pool.admit_group([8, 9], ["rec8", "rec9"])
        pool.lookup(9)
        pool.abort_load(10)  # no-op: not loading
        checker.at_flush()
        checker.at_end()
        checker.raise_if_violations()
        assert checker.ok()
        assert checker.calls["begin_load"] == 1
        assert checker.calls["finish_load"] == 1
        assert checker.calls["admit"] == 7
        assert checker.flushes == 1

    def test_lost_wakeup_raises(self):
        pool = _pool(cls=_buggy_pools(bufferpool)["lost_wakeup"])
        checker = _watched(pool)
        _drive_lost_wakeup(pool, checker)
        with pytest.raises(ProtocolError, match="lost-wakeup"):
            checker.raise_if_violations()

    def test_parked_waiter_surviving_the_run_is_a_lost_wakeup(self):
        pool = _pool()
        checker = _watched(pool)
        pool.begin_load(0)
        pool.add_waiter(0, "searcher")
        checker.at_end()
        assert "lost-wakeup" in {v.rule for v in checker.violations}

    def test_evicted_vid_may_republish(self):
        pool = _pool(n_slots=2)
        checker = _watched(pool)
        for vid in range(6):
            pool.admit(vid, f"rec{vid}")
        pool.admit(0, "rec0-again")
        checker.at_end()
        assert checker.ok()

    def test_wrapping_is_observational(self):
        drive = lambda p: (
            p.begin_load(0), p.add_waiter(0, "w"), p.finish_load(0, "r0"),
            [p.admit(v, f"r{v}") for v in range(1, 7)],
            p.admit_group([8, 9], ["r8", "r9"]),
        )
        bare, watched = _pool(), _pool()
        _watched(watched)
        drive(bare)
        drive(watched)
        assert (bare.state == watched.state).all()
        assert (bare.slot_vid == watched.slot_vid).all()
        assert (bare.record_map == watched.record_map).all()
        assert bare.pressure_stats() == watched.pressure_stats()


# ======================================== end-to-end verify_protocol wiring


@pytest.fixture(scope="module")
def small():
    torch.set_num_threads(1)
    return _smoke_fixture()


def _build_and_run(small, name, verify, hbm=False, **cfg_kw):
    ds, graph, qb = small
    cfg = baselines.SystemConfig(
        n_workers=2, batch_size=4, buffer_ratio=0.3, device="cpu",
        hbm_tier=hbm, verify_protocol=verify, **cfg_kw,
    )
    system = baselines.build_system(name, ds.base, graph, qb, config=cfg)
    results, _ = system.run(ds.queries)
    return system, results


def _exact(results):
    return [(r.ids.tolist(), r.dists.tolist(), r.hops, r.reads) for r in results]


@pytest.mark.parametrize("algo,hbm", [
    ("velo", False), ("velo", True), ("pipeann", False), ("diskann", False),
])
def test_verify_protocol_is_bitwise_inert(small, algo, hbm):
    """verify_protocol=True observes and never perturbs: ids, dists, hops and
    reads equal the unverified run's, zero violations, and the checker saw
    traffic (calls and flush boundaries)."""
    _, ref = _build_and_run(small, algo, verify=False, hbm=hbm)
    system, got = _build_and_run(small, algo, verify=True, hbm=hbm)
    assert _exact(got) == _exact(ref)
    assert system.ctx.dist.name == "torch"
    assert system.checker is not None
    system.checker.raise_if_violations()
    assert system.checker.flushes > 0
    if getattr(system.ctx.accessor, "pool", None) is not None:
        assert sum(system.checker.calls.values()) > 0
    if hbm:
        assert any(k.startswith("hbm.") for k in system.checker.calls)
        # the re-pointed publish hook reaches the wrapped staging method
        assert system.checker.calls.get("hbm.note_publish", 0) > 0


@pytest.mark.parametrize("hbm", [False, True])
def test_verify_protocol_on_serving_plane(small, hbm):
    """The plane wires the checker across the shared pool (and the plane's
    HBM tier); a quota-enabled zipfian mix runs violation-free and bitwise
    matches the unverified plane."""
    ds, graph, qb = small
    specs = [
        TenantSpec.from_dataset(f"t{i}", ds, graph, qb, system="velo",
                                params=SearchParams(L=24, W=4, prefetch=False))
        for i in range(2)
    ]
    nq = len(ds.queries)
    wload = workload_mod.zipfian_mix([nq, nq], 40, s=1.5, seed=0)

    def run(verify):
        cfg = baselines.SystemConfig(buffer_ratio=0.2, batch_size=4, device="cpu",
                                     tenant_quota=0.6, hbm_tier=hbm,
                                     verify_protocol=verify)
        plane = ServingPlane(specs, cfg, shared_pool=True)
        return plane, plane.run(wload)

    _, ref = run(False)
    plane, got = run(True)
    for t_ref, t_got in zip(ref.tenants, got.tenants):
        assert _exact(t_got.results) == _exact(t_ref.results)
        assert normalize_results(t_got.results) == normalize_results(t_ref.results)
    assert plane.checker is not None
    plane.checker.raise_if_violations()
    assert plane.checker.flushes > 0
    assert plane.checker.calls.get("begin_load", 0) > 0
    assert (plane.hbm is not None) == hbm
    assert (plane.checker.calls.get("hbm.note_publish", 0) > 0) == hbm


def test_verify_protocol_on_partitioned_plane(small):
    """Under a static partition the checker watches every tenant's own pool."""
    ds, graph, qb = small
    specs = [TenantSpec.from_dataset(f"t{i}", ds, graph, qb, system="velo")
             for i in range(2)]
    cfg = baselines.SystemConfig(buffer_ratio=0.2, batch_size=4, device="cpu",
                                 verify_protocol=True)
    plane = ServingPlane(specs, cfg, shared_pool=False)
    nq = len(ds.queries)
    plane.run(workload_mod.uniform_mix([nq, nq], 24, seed=1))
    assert plane.pool is None and len(plane.checker._pools) == 2
    plane.checker.raise_if_violations()
    assert plane.checker.flushes > 0
