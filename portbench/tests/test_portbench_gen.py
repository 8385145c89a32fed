"""The generator: the same seed gives the same traffic, another seed the
same work in another order; a pod's key gives its dict back."""

import json

from portbench import gen, harness

W = 5120


def _config(name):
    return harness.load_json(harness.BENCH_DIR / "configs" / f"{name}.json")


def test_waves_are_deterministic_per_seed():
    c = _config("interpod5k")
    a, b = gen.Traffic(c, 2 ** 31 + 17), gen.Traffic(c, 2 ** 31 + 17)
    assert json.dumps(a.pods(0, W)) == json.dumps(b.pods(0, W))
    assert json.dumps(a.pods(3 * W, 4 * W)) == json.dumps(b.pods(3 * W, 4 * W))
    other = gen.Traffic(c, 5)
    assert json.dumps(a.pods(0, W)) != json.dumps(other.pods(0, W))


def test_every_seed_sends_the_same_kinds_and_ports():
    c = _config("interpod5k")

    def census(seed):
        pods = gen.Traffic(c, seed).pods(0, W)
        kinds = sorted(d["metadata"]["labels"]["app"] for d in pods)
        ports = sorted(d["spec"]["containers"][0].get("ports", [{}])[0].get("hostPort", 0) for d in pods)
        return kinds, ports

    assert census(1) == census(-7) == census(2 ** 33)
    kinds, ports = census(1)
    assert [kinds.count(k) for k in ("anti", "ports", "pref", "spread")] == [1280] * 4
    assert all(ports.count(8000 + i) == 160 for i in range(8))


def test_pod_and_wave_agree_and_namespaces_follow_waves():
    t = gen.Traffic(_config("interpod5k"), 11)
    w = t.pods(2 * W, 3 * W)
    assert all(w[i] == t.pod(2, i) for i in (0, 1, 77, 5119))
    assert {d["metadata"]["namespace"] for d in w} == {"wave-00002"}
    assert len({d["metadata"]["name"] for d in w}) == W
    assert t.pods(W - 1, W + 1)[1]["metadata"]["namespace"] == "wave-00001"


def test_keys_give_the_dicts_back():
    t = gen.Traffic(_config("interpod5k"), 2 ** 40 + 3)
    for j in (0, 5, W - 1, W, 7 * W + 123):
        d = t.pod(*divmod(j, W))
        key = f"{d['metadata']['namespace']}/{d['metadata']['name']}"
        assert t.key(j) == key and t.position(key) == j
    pods = gen.StreamPods(t)
    pods.created = W + 1
    assert t.key(W) in pods and pods[t.key(W)] == t.pod(1, 0)
    assert t.key(W + 1) not in pods
    # another kind's name at a position, or no stream key at all, is unknown
    name = t.key(3).split("/")[1]
    wrong = next(k["name"] for k in _config("interpod5k")["pod_kinds"] if not name.startswith(k["name"] + "-"))
    assert f"wave-00000/{wrong}-000003" not in pods
    assert "default/x" not in pods and "wave-00000/ports-999999" not in pods


def test_nodes_follow_the_configuration():
    nodes = gen.node_dicts(_config("basic10k"))
    assert len(nodes) == 10000
    assert nodes[5]["metadata"]["labels"] == {"kubernetes.io/hostname": "node-00005"}
    # upstream's node-default.yaml
    assert nodes[5]["status"]["allocatable"] == {"cpu": "4", "memory": "32Gi", "pods": "110"}
    nodes = gen.node_dicts(_config("interpod5k"))
    assert len(nodes) == 5120
    zones = [n["metadata"]["labels"]["topology.kubernetes.io/zone"] for n in nodes]
    assert zones[:4] == ["z0", "z1", "z2", "z0"]
