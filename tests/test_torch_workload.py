"""The port's mixed-traffic workload generators against the JAX package's.

``core/workload.py`` is pure NumPy over a seeded ``default_rng``: the same
seed must give identical tenant ids, query ids and arrival times in both
packages, for every mix and seed the reference's serving, scheduling and
sharding tests use.  The generators' own contracts (determinism, per-tenant
sequential query ids, skew, burstiness, the requested tenant count) are
held on the port.
"""

import numpy as np
import pytest

from repro.core import workload as ref_workload
from repro_torch.core import workload as workload_mod

# (generator, counts, n_ops, kwargs): the cases of tests/test_serving.py,
# tests/test_scheduling.py, tests/test_sharding.py and tests/test_hbm.py
CASES = [
    ("uniform_mix", [30], 30, dict(seed=0)),
    ("uniform_mix", [30, 30], 40, dict(seed=3)),
    ("uniform_mix", [30, 30], 60, dict(seed=1)),
    ("uniform_mix", [30, 30], 40, dict(seed=5)),
    ("uniform_mix", [50] * 4, 400, dict(seed=0)),
    ("zipfian_mix", [30, 30], 120, dict(s=1.8, seed=0)),
    ("zipfian_mix", [30, 30], 80, dict(s=1.4, seed=0)),
    ("zipfian_mix", [50] * 4, 400, dict(s=1.6, seed=0)),
    ("zipfian_mix", [16] * 4, 200, dict(s=1.6, seed=2, qps=30000.0)),
    ("zipfian_mix", [10] * 6, 12, dict(s=3.0, seed=0)),
    ("zipfian_mix", [30, 30], 60, dict(seed=0)),
    ("bursty_mix", [30, 30], 80, dict(mean_burst=8, seed=1, qps=20000.0)),
    ("bursty_mix", [50] * 4, 400, dict(mean_burst=10, seed=0)),
    ("bursty_mix", [20, 20, 20], 90, dict(mean_burst=6, seed=7)),
    ("uniform_mix", [20, 20, 20], 90, dict(seed=7, qps=5000.0)),
]


@pytest.mark.parametrize("fn,counts,n_ops,kw", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_generators_give_the_reference_arrays(fn, counts, n_ops, kw):
    got = getattr(workload_mod, fn)(counts, n_ops, **kw)
    want = getattr(ref_workload, fn)(counts, n_ops, **kw)
    assert got.name == want.name and got.n_tenants == want.n_tenants
    for field in ("tenant_ids", "query_ids"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    if want.arrival_s is None:
        assert got.arrival_s is None
    else:
        assert got.arrival_s.dtype == want.arrival_s.dtype
        assert np.array_equal(got.arrival_s, want.arrival_s)
    assert np.array_equal(got.counts(), want.counts())
    assert got.run_lengths() == want.run_lengths()
    for t in range(len(counts)):
        assert np.array_equal(got.positions(t), want.positions(t))


def test_generators_deterministic_and_sequential():
    for fn, kw in [
        (workload_mod.uniform_mix, {}),
        (workload_mod.zipfian_mix, {"s": 1.5}),
        (workload_mod.bursty_mix, {"mean_burst": 6}),
    ]:
        w1 = fn([20, 20, 20], 90, seed=7, **kw)
        w2 = fn([20, 20, 20], 90, seed=7, **kw)
        np.testing.assert_array_equal(w1.tenant_ids, w2.tenant_ids)
        np.testing.assert_array_equal(w1.query_ids, w2.query_ids)
        assert len(w1) == 90
        # per-tenant query ids are sequential (wrapping): the isolation
        # contract's precondition
        for t in range(3):
            qs = w1.query_ids[w1.positions(t)]
            np.testing.assert_array_equal(qs, np.arange(len(qs), dtype=np.int64) % 20)


def test_zipfian_mix_is_skewed_and_bursty_mix_runs():
    counts = workload_mod.zipfian_mix([50] * 4, 400, s=1.6, seed=0).counts()
    assert counts[0] > 2 * counts[-1], counts
    lens = workload_mod.bursty_mix([50] * 4, 400, mean_burst=10, seed=0).run_lengths()
    assert float(np.mean(lens)) > 2.5, np.mean(lens)
    uni = workload_mod.uniform_mix([50] * 4, 400, seed=0).run_lengths()
    assert float(np.mean(lens)) > float(np.mean(uni))


def test_n_tenants_survives_never_sampled_tenants():
    """Heavy skew on few ops leaves cold tenants unsampled; the generator
    still reports the requested tenant count, with zero ops for them."""
    m = workload_mod.zipfian_mix([10] * 6, 12, s=3.0, seed=0)
    assert int(m.tenant_ids.max()) < 5 and m.n_tenants == 6
    counts = m.counts()
    assert counts.shape == (6,) and counts.sum() == 12
    assert (counts[int(m.tenant_ids.max()) + 1:] == 0).all()
    legacy = workload_mod.MixedWorkload(name=m.name, tenant_ids=m.tenant_ids.copy(),
                                        query_ids=m.query_ids.copy())
    assert legacy.n_tenants == int(m.tenant_ids.max()) + 1


def test_arrival_times_are_increasing_at_the_asked_rate():
    w = workload_mod.uniform_mix([40, 40], 400, seed=3, qps=10000.0)
    assert w.arrival_s is not None and (np.diff(w.arrival_s) >= 0).all()
    assert 0.5 < len(w) / float(w.arrival_s[-1]) / 10000.0 < 2.0
    assert workload_mod.uniform_mix([40, 40], 40, seed=3).arrival_s is None
