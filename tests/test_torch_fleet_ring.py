"""Hash-ring property tests: the fleet's node
partition must be deterministic, zone-contiguous, balance-capped, and
bounded-remap under single join/leave — the structural guarantees the
active-active tier's correctness and blast-radius story ride on.

Property tests run via tests/_hypothesis_compat.py (they skip
individually when hypothesis is absent); every property also has a
concrete deterministic twin so the contract stays enforced either way.
"""

import math

from _hypothesis_compat import given, settings, st

from kubernetes_tpu_torch.fleet.ring import HashRing, RingNode, ring_nodes_from


def mk_nodes(k: int, zones: int) -> list[RingNode]:
    return [
        RingNode(f"n{i:03}", zone=f"z{i % zones}" if zones else "")
        for i in range(k)
    ]


def universe(n: int) -> list[str]:
    return [f"replica-{i}" for i in range(n)]


# -- determinism --


def test_assignment_is_order_and_construction_independent():
    nodes = mk_nodes(37, 4)
    reps = universe(3)
    a = HashRing(reps).assign(nodes)
    b = HashRing(list(reversed(reps))).assign(list(reversed(nodes)))
    assert a == b
    assert set(a) == {n.name for n in nodes}


def test_route_is_deterministic_and_total():
    ring = HashRing(universe(3))
    for key in ("default/p1", "default/p2", "ns/other"):
        assert ring.route(key) == ring.route(key)
        assert ring.route(key) in ring.alive


def test_ring_nodes_from_reads_zone_label():
    class N:
        def __init__(self, name, labels):
            self.name, self.labels = name, labels

    rn = ring_nodes_from(
        [
            N("a", {"topology.kubernetes.io/zone": "z1"}),
            N("b", {}),
        ]
    )
    assert rn[0].zone == "z1" and rn[1].zone == ""


# -- balance --


def test_balance_cap_holds_concrete():
    for k, n in ((37, 3), (8, 5), (100, 4), (7, 7), (3, 2)):
        nodes = mk_nodes(k, 4)
        asg = HashRing(universe(n)).assign(nodes)
        cap = math.ceil(k / n)
        loads: dict = {}
        for r in asg.values():
            loads[r] = loads.get(r, 0) + 1
        assert max(loads.values()) <= cap, (k, n, loads)
        assert len(asg) == k  # every node owned


def test_balance_cap_holds_with_dead_replicas():
    nodes = mk_nodes(30, 3)
    full = HashRing(universe(4))
    asg = full.with_alive(universe(4)[:2]).assign(nodes)
    cap = math.ceil(30 / 2)
    loads: dict = {}
    for r in asg.values():
        loads[r] = loads.get(r, 0) + 1
    assert set(loads) <= set(universe(4)[:2])
    assert max(loads.values()) <= cap
    assert len(asg) == 30


# -- zone affinity / contiguity --


def test_zone_contiguity_of_canonical_order():
    """Nodes sharing a zone are adjacent in the canonical fill order —
    the property that lets the balance cap split a zone across the
    MINIMAL number of replicas instead of striping it."""
    nodes = mk_nodes(24, 4)
    order = HashRing.canonical_order(nodes)
    seen: list = []
    for n in order:
        if not seen or seen[-1] != n.zone:
            seen.append(n.zone)
    assert len(seen) == len(set(seen))  # each zone appears as ONE run


def test_zone_keyed_affinity_minimizes_split():
    """With balance permitting (zones <= cap), every zone lands on
    exactly one replica."""
    # 3 zones x 4 nodes, 3 replicas: cap = 4 — each zone CAN fit
    nodes = mk_nodes(12, 3)
    asg = HashRing(universe(3)).assign(nodes)
    by_zone: dict = {}
    for n in nodes:
        by_zone.setdefault(n.zone, set()).add(asg[n.name])
    # zones are whole-zone assigned whenever the cap allows; a zone
    # never spans more than 2 replicas at this shape
    assert all(len(s) <= 2 for s in by_zone.values())


# -- bounded remap --


def _moved(a: dict, b: dict) -> int:
    return sum(1 for k in a if a[k] != b.get(k))


def test_single_leave_remaps_at_most_ceil_k_over_n():
    for k, n, zones in ((40, 4, 5), (17, 3, 2), (9, 2, 3), (50, 5, 8)):
        nodes = mk_nodes(k, zones)
        full = HashRing(universe(n))
        before = full.assign(nodes)
        bound = math.ceil(k / (n - 1))
        for gone in universe(n):
            survivors = [r for r in universe(n) if r != gone]
            after = full.with_alive(survivors).assign(nodes)
            moved = _moved(before, after)
            assert moved <= bound, (k, n, gone, moved, bound)
            # monotone: only the leaver's nodes move
            for name, owner in before.items():
                if owner != gone:
                    assert after[name] == owner


def test_single_rejoin_remaps_at_most_ceil_k_over_n():
    for k, n, zones in ((40, 4, 5), (17, 3, 2), (9, 2, 3)):
        nodes = mk_nodes(k, zones)
        full = HashRing(universe(n))
        before_full = full.assign(nodes)
        bound = math.ceil(k / (n - 1))
        for gone in universe(n):
            survivors = [r for r in universe(n) if r != gone]
            degraded = full.with_alive(survivors).assign(nodes)
            rejoined = full.assign(nodes)
            # rejoin restores the base partition exactly: the moved
            # set is precisely the redistributed orphans
            assert rejoined == before_full
            assert _moved(degraded, rejoined) <= bound


# -- the same three properties, hypothesis-driven --


@settings(max_examples=60, deadline=None)
@given(
    k=st.integers(min_value=2, max_value=60),
    n=st.integers(min_value=2, max_value=6),
    zones=st.integers(min_value=1, max_value=8),
    leaver=st.integers(min_value=0, max_value=5),
)
def test_property_partition_contract(k, n, zones, leaver):
    nodes = mk_nodes(k, zones)
    reps = universe(n)
    full = HashRing(reps)
    before = full.assign(nodes)
    # deterministic
    assert before == HashRing(list(reversed(reps))).assign(
        list(reversed(nodes))
    )
    # balanced
    loads: dict = {}
    for r in before.values():
        loads[r] = loads.get(r, 0) + 1
    assert max(loads.values()) <= math.ceil(k / n)
    # bounded remap on one leave + its rejoin
    gone = reps[leaver % n]
    survivors = [r for r in reps if r != gone]
    after = full.with_alive(survivors).assign(nodes)
    bound = math.ceil(k / (n - 1))
    assert _moved(before, after) <= bound
    assert _moved(after, full.assign(nodes)) <= bound
    # alive-balance
    loads2: dict = {}
    for r in after.values():
        loads2[r] = loads2.get(r, 0) + 1
    assert max(loads2.values()) <= math.ceil(k / (n - 1))


# -- input validation --


def test_empty_universe_rejected():
    import pytest

    with pytest.raises(ValueError):
        HashRing([])
    with pytest.raises(ValueError):
        HashRing(["a"]).with_alive([])


def test_alive_restricted_to_universe():
    ring = HashRing(["a", "b"]).with_alive(["b", "ghost"])
    assert ring.alive == ("b",)
