"""The plain reference: it flags what breaks a guarantee, and passes what
kube-scheduler's default profile could have done."""

import pytest

from portbench import reference, roofline

ZONE, HOST = "topology.kubernetes.io/zone", "kubernetes.io/hostname"


def nodes(n=3, cpu="1", pods="110"):
    return [{"metadata": {"name": f"n{i}", "labels": {HOST: f"n{i}", ZONE: f"z{i % 3}"}},
             "status": {"allocatable": {"cpu": cpu, "memory": "4Gi", "pods": pods}}} for i in range(n)]


def pod(name, app="web", cpu="500m", port=None, anti=False, spread=False, pref=None, ns="a"):
    c = {"name": "c", "resources": {"requests": {"cpu": cpu, "memory": "1Gi"}}}
    if port:
        c["ports"] = [{"containerPort": port, "hostPort": port}]
    spec = {"containers": [c]}
    if anti:
        spec["affinity"] = {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
            {"topologyKey": HOST, "labelSelector": {"matchLabels": {"app": app}}}]}}
    if spread:
        spec["topologySpreadConstraints"] = [{"maxSkew": 1, "topologyKey": ZONE, "whenUnsatisfiable": "DoNotSchedule",
                                              "labelSelector": {"matchLabels": {"app": app}}}]
    if pref:
        spec["affinity"] = {"podAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
            {"weight": 50, "podAffinityTerm": {"topologyKey": ZONE, "labelSelector": {"matchLabels": {"app": pref}}}}]}}
    return {"metadata": {"name": name, "namespace": ns, "labels": {"app": app}}, "spec": spec}


def judge(pods, binds, store=None, cache=None, deletes=(), sample_all=True):
    by_key = {f"{p['metadata']['namespace']}/{p['metadata']['name']}": p for p in pods}
    events = [("bind", k, n) for k, n in binds] + [("delete", k) for k in deletes]
    if store is None:
        store = dict(by_key.fromkeys(by_key, ""))
        for k, n in binds:
            store[k] = n
        for k in deletes:
            store.pop(k, None)
    sample = set(range(len(binds))) if sample_all else set()
    return reference.judge(nodes(), by_key, events, store, cache, sample)


def test_quantities():
    assert reference.milli("250m") == 250 and reference.milli("16") == 16000 and reference.milli("0.1") == 100
    assert reference.whole("512Mi") == 2 ** 29 and reference.whole("64Gi") == 2 ** 36
    assert reference.whole("1k") == 1000 and reference.whole("110") == 110


def test_a_sound_sequence_reads_zero():
    # empty nodes tie; each next pod goes to an emptier node
    out = judge([pod("p0"), pod("p1"), pod("p2")], [("a/p0", "n0"), ("a/p1", "n2"), ("a/p2", "n1")])
    assert {k: v for k, v in out.items() if not k.startswith("_")} == dict.fromkeys(
        ("infeasible_binds", "score_gap", "double_or_unknown_binds", "readback_mismatches"), 0)


def test_a_pick_below_the_best_score_is_a_gap():
    out = judge([pod("p0"), pod("p1")], [("a/p0", "n0"), ("a/p1", "n0")])
    assert out["score_gap"] > 0 and out["infeasible_binds"] == 0


def test_overcommit_is_flagged_on_every_bind_unsampled():
    out = judge([pod("p0", cpu="800m"), pod("p1", cpu="800m")], [("a/p0", "n0"), ("a/p1", "n0")],
                sample_all=False)
    assert out["infeasible_binds"] == 1


def test_host_port_conflict():
    out = judge([pod("p0", port=8000), pod("p1", port=8000)], [("a/p0", "n1"), ("a/p1", "n1")],
                sample_all=False)
    assert out["infeasible_binds"] == 1


def test_host_port_on_other_nodes_is_fine():
    out = judge([pod("p0", port=8000), pod("p1", port=8000)], [("a/p0", "n1"), ("a/p1", "n2")])
    assert out["infeasible_binds"] == 0 and out["score_gap"] == 0


def test_anti_affinity_both_ways_and_per_namespace():
    bad = judge([pod("p0", app="db", anti=True), pod("p1", app="db", anti=True)],
                [("a/p0", "n0"), ("a/p1", "n0")], sample_all=False)
    assert bad["infeasible_binds"] == 1
    # an existing pod's required anti-affinity also keeps a matching pod off
    # its node when the newcomer has none of its own
    sym = judge([pod("p0", app="db", anti=True), pod("p1", app="db")],
                [("a/p0", "n0"), ("a/p1", "n0")], sample_all=False)
    assert sym["infeasible_binds"] == 1
    other_ns = judge([pod("p0", app="db", anti=True), pod("p1", app="db", anti=True, ns="b")],
                     [("a/p0", "n0"), ("b/p1", "n0")], sample_all=False)
    assert other_ns["infeasible_binds"] == 0


def test_zone_spread_skew():
    pods = [pod(f"s{i}", app="s", spread=True) for i in range(3)]
    ok = judge(pods, [("a/s0", "n0"), ("a/s1", "n1"), ("a/s2", "n2")])
    assert ok["infeasible_binds"] == 0 and ok["score_gap"] == 0
    bad = judge(pods[:2], [("a/s0", "n0"), ("a/s1", "n0")], sample_all=False)
    assert bad["infeasible_binds"] == 1


def test_preferred_affinity_moves_the_best_node():
    pods = [pod("s0", app="s"), pod("p0", app="p", pref="s")]
    good = judge(pods, [("a/s0", "n0"), ("a/p0", "n0")])
    assert good["score_gap"] == 0  # the affinity's 2 x 100 outweighs the fuller node
    bad = judge(pods, [("a/s0", "n0"), ("a/p0", "n1")])
    assert bad["score_gap"] > 0


@pytest.mark.parametrize("raw,want", [
    # 29 / 100 is 0.28999999999999998 in float64: upstream's product
    # truncates to 28, where 100 * 29 // 100 in integers gives 29
    ([0, 29, 100], [0, 28, 100]),
    ([0, 29, 50], [0, 57, 100]),  # 57.99999999999999 -> 57; integers give 58
    ([-50, 0, 50], [0, 50, 100]),
    ([7, 7, 7], [0, 0, 0]),
    ([3, 4], [0, 100]),
])
def test_interpod_normalisation_is_upstreams_float64_product(raw, want):
    import numpy as np

    assert reference.normalize_interpod(np.array(raw, np.int64)).tolist() == want


def test_interpod_normalisation_decides_a_pick_as_upstream():
    # three nodes in three zones; a pref pod's raw InterPodAffinity scores
    # are 50 x the spread pods in each zone: 0, 29 and 100 matching pods
    # give 0 / 1,450 / 5,000, normalised upstream to 0 / 28 / 100
    def view_cluster(counts):
        cl = reference.Cluster(nodes(3, cpu="1000"))
        for z, n in enumerate(counts):
            for i in range(n):
                cl.bind(reference.PodView(pod(f"s{z}-{i}", app="s", cpu="1m")), z)
        return cl

    import numpy as np

    cl = view_cluster([0, 29, 100])
    p = reference.PodView(pod("p0", app="p", pref="s", cpu="1m"))
    idx = np.arange(3)
    # the same requests with no affinity term: the other plugins' part
    plain = reference.PodView(pod("q0", app="q", cpu="1m"))
    assert (cl.scores(p, idx) - cl.scores(plain, idx)).tolist() == [0, 2 * 28, 2 * 100]


def test_double_and_unknown_binds():
    out = judge([pod("p0")], [("a/p0", "n0"), ("a/p0", "n1")],
                store={"a/p0": "n0"}, sample_all=False)
    assert out["double_or_unknown_binds"] == 1
    out = judge([pod("p0")], [("a/p0", "nX")], store={"a/p0": ""}, sample_all=False)
    assert out["double_or_unknown_binds"] == 1


def test_read_back_from_store_and_cache():
    pods = [pod("p0"), pod("p1")]
    assert judge(pods, [("a/p0", "n0")], store={"a/p0": "n1", "a/p1": ""})["readback_mismatches"] == 1
    assert judge(pods, [("a/p0", "n0")], store={"a/p0": "n0", "a/p1": "n2"})["readback_mismatches"] == 1
    cache_ok = {"n0": (500, 2 ** 30, ["a/p0"]), "n1": (0, 0, []), "n2": (0, 0, [])}
    assert judge(pods, [("a/p0", "n0")], cache=cache_ok)["readback_mismatches"] == 0
    cache_stale = dict(cache_ok, n0=(0, 0, []))
    assert judge(pods, [("a/p0", "n0")], cache=cache_stale)["readback_mismatches"] == 1


def test_deletes_free_the_node():
    pods = [pod("p0", cpu="800m"), pod("p1", cpu="800m")]
    by_key = {f"a/{p['metadata']['name']}": p for p in pods}
    events = [("bind", "a/p0", "n0"), ("delete", "a/p0"), ("bind", "a/p1", "n0")]
    out = reference.judge(nodes(), by_key, events, {"a/p1": "n0"}, None, set())
    assert out["infeasible_binds"] == 0 and out["readback_mismatches"] == 0


def test_unmodelled_features_are_refused():
    p = pod("p0")
    p["spec"]["affinity"] = {"podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
        {"topologyKey": ZONE, "labelSelector": {"matchLabels": {"app": "x"}}}]}}
    with pytest.raises(NotImplementedError):
        reference.PodView(p)


def test_roofline_bytes_on_a_hand_worked_shape():
    from portbench import harness

    c = harness.load_json(harness.BENCH_DIR / "configs" / "interpod5k.json")
    n = 5120
    kinds = {k["name"]: {"metadata": {"name": "x", "namespace": "w", **k["pod"]["metadata"]}, "spec": k["pod"]["spec"]}
             for k in c["pod_kinds"]}
    # ports: no term selects it, no constraint
    assert roofline.domain_aggregation_bytes(kinds["ports"], c) == 0
    # anti: its own (hostname, app=anti) term, which is also the anti kind's
    # term selecting it: one row of dom + count read, total written
    assert roofline.domain_aggregation_bytes(kinds["anti"], c) == n * 12
    # pref: its own (zone, app=spread) term
    assert roofline.domain_aggregation_bytes(kinds["pref"], c) == n * 12
    # spread: the pref kind's term selects it (one row), and its zone
    # constraint reads dom + count and writes 3 zone counts
    assert roofline.domain_aggregation_bytes(kinds["spread"], c) == n * 12 + n * 8 + 3 * 4
    assert roofline.least_seconds(3.35e12) == pytest.approx(1.0)
