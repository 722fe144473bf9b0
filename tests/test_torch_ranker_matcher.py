"""The split cycle's ``Ranker.rank_pool`` and ``Matcher.match_pool``
against the JAX package's on the CPU.

The worlds are ``tests/test_torch_driver.py``'s, built once with each
package.  The ranked queue must be the reference's job for job, for the
device backend (``"tpu"``: ``ops/dru`` over K2 and K3's plain versions
here) and the numpy one (``"cpu"``), from the columnar index and from
the entities.  ``match_pool`` over those queues must launch the same
``(job uuid, hostname)`` pairs with the same counts, for the ``auto``
and ``tpu-greedy`` backends, over two cycles with churn between them.
"""

import pytest

import cook_tpu.sched.ranker
from cook_tpu_torch.sched.ranker import RankedQueue, Ranker
from test_torch_driver import (PORT, REF, WORLDS, World, counts, launched)

RANK_WORLDS = ["plain", "user_quota", "pool_group_quota", "rate_limit",
               "two_pools", "unique_group", "rack_gang", "checkpoint",
               "ragged_three_pools"]


def rankers(ref, port, backend):
    return (cook_tpu.sched.ranker.Ranker(ref.store, ref.cfg,
                                         backend=backend),
            Ranker(port.store, port.cfg, backend=backend, device="cpu"))


def queue(ranker, store, pool):
    p = next(p for p in store.pools() if p.name == pool)
    return [j.uuid for j in ranker.rank_pool(pool, p.dru_mode)]


@pytest.mark.parametrize("columnar", [True, False])
@pytest.mark.parametrize("backend", ["tpu", "cpu"])
@pytest.mark.parametrize("name", RANK_WORLDS)
def test_rank_pool_parity(name, backend, columnar):
    """Rank before any cycle, then again after a fused cycle (users now
    carry running usage) and the arrival of more jobs."""
    spec = WORLDS[name]
    ref, port = World(REF, spec, 5), World(PORT, spec, 5)
    ranked = 0
    for step in range(2):
        if step:
            for w in (ref, port):
                w.cfg.columnar_index = True
                w.cycle()
                w.churn(40)
        for w in (ref, port):
            w.cfg.columnar_index = columnar
        ra, rb = rankers(ref, port, backend)
        for pool in spec.get("pools", ["default"]):
            qa, qb = queue(ra, ref.store, pool), queue(rb, port.store, pool)
            assert qa == qb, (step, pool)
            ranked += len(qa)
    assert ranked


def test_columnar_rank_is_a_lazy_queue():
    port = World(PORT, WORLDS["plain"], 5)
    q = Ranker(port.store, port.cfg, device="cpu").rank_pool("default")
    assert isinstance(q, RankedQueue)
    assert len(q) == 24


def split_cycle(w, ranker, matcher):
    """Rank then match every pool of the world (the split cycle)."""
    out = {}
    for pool in w.spec.get("pools", ["default"]):
        ranked = ranker.rank_pool(pool)
        offers = []
        for c in w.sched.launchable_clusters(pool):
            offers.extend(c.pending_offers(pool))
        out[pool] = matcher.match_pool(pool, ranked, offers,
                                       w.sched.clusters,
                                       w.sched.reserved_hosts)
    return out


MATCH_WORLDS = ["plain", "user_quota", "rate_limit", "plugin_filter",
                "backoff_cap", "two_pools", "unique_group", "rack_gang",
                "dropped_gang", "checkpoint"]


@pytest.mark.parametrize("backend", ["auto", "tpu-greedy"])
@pytest.mark.parametrize("name", MATCH_WORLDS)
def test_match_pool_parity(name, backend):
    spec = WORLDS[name]
    ref, port = World(REF, spec, 7), World(PORT, spec, 7)
    for w in (ref, port):
        mc = w.cfg.default_matcher
        w.cfg.default_matcher = w.m.MatcherConfig(
            backend=backend, max_jobs_considered=mc.max_jobs_considered)
    ra, rb = rankers(ref, port, "tpu")
    ma, mb = ref.sched.matcher, port.driver.matcher
    total = 0
    for c in range(2):
        resa = split_cycle(ref, ra, ma)
        resb = split_cycle(port, rb, mb)
        la, lb = launched(ref, resa), launched(port, resb)
        assert la == lb, f"cycle {c}"
        assert counts(resa) == counts(resb), f"cycle {c}"
        total += sum(len(v) for v in lb.values())
        ref.churn(4)
        port.churn(4)
    assert total > 0
