"""The port's extender webhook (``kubernetes_tpu_torch/server/extender.py``):
the cases of ``tests/test_extender.py`` and the first ten of
``tests/test_serve_tpu.py`` on the port, on the CPU, and each verb's JSON
reply held against the JAX package's ``ExtenderCore`` on the same cluster.
"""

import asyncio
import json

import pytest

from kubernetes_tpu.api.wrappers import MakeNode as RefMakeNode
from kubernetes_tpu.api.wrappers import MakePod as RefMakePod
from kubernetes_tpu.server.extender import ExtenderCore as RefExtenderCore
from kubernetes_tpu.solver.exact import ExactSolverConfig as RefSolverConfig
from kubernetes_tpu.state.cluster import ClusterState as RefClusterState
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.api.wrappers import MakeNode, MakePod
from kubernetes_tpu_torch.server.extender import (
    DecodeError,
    ExtenderCore,
    MicroBatcher,
    _load_state_file,
    make_app,
    run_server,
)
from kubernetes_tpu_torch.solver.exact import ExactSolverConfig
from kubernetes_tpu_torch.state.cluster import ClusterState

CPU = dict(device="cpu")


def make_cluster(n=4, taint_last=True, hostnames=False, wrappers=(MakeNode, MakePod),
                 cluster_cls=ClusterState):
    """tests/test_extender.py's cluster (n=4, node-3 tainted) or
    tests/test_serve_tpu.py's (n=6, hostname labels, no taint)."""
    make_node, make_pod = wrappers
    cs = cluster_cls()
    for i in range(n):
        b = (make_node().name(f"node-{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": "20"})
             .label("zone", f"z{i % 2}"))
        if hostnames:
            b = b.label("kubernetes.io/hostname", f"node-{i}")
        if taint_last and i == 3:
            b = b.taint("dedicated", "gpu", "NoSchedule")
        cs.create_node(b.obj())
    cs.create_pod(make_pod().name("existing").node("node-0").req({"cpu": "7"}).obj())
    return cs


def serve_cluster():
    return make_cluster(6, taint_last=False, hostnames=True)


def node_list(cs):
    return {"items": [n.to_dict() for n in cs.list_nodes()]}


# -- tests/test_extender.py on the port ---------------------------------------


def test_filter_wire_shape():
    cs = make_cluster()
    core = ExtenderCore(cs, **CPU)
    pod = MakePod().name("p").req({"cpu": "4"}).obj()
    out = core.filter({"pod": pod.to_dict(), "nodes": node_list(cs)})
    assert set(out) >= {"nodes", "failedNodes", "failedAndUnresolvableNodes"}
    names = [n["metadata"]["name"] for n in out["nodes"]["items"]]
    # node-0 fails resources (7+4 > 8); node-3 fails taints
    assert names == ["node-1", "node-2"]
    assert set(out["failedNodes"]) == {"node-0", "node-3"}
    json.dumps(out)


def test_filter_node_cache_capable():
    cs = make_cluster()
    core = ExtenderCore(cs, node_cache_capable=True, **CPU)
    pod = MakePod().name("p").req({"cpu": "4"}).obj()
    out = core.filter({"pod": pod.to_dict(), "nodenames": ["node-1", "node-0"]})
    assert out["nodenames"] == ["node-1"]
    assert "nodes" not in out


def test_prioritize_wire_shape():
    cs = make_cluster()
    core = ExtenderCore(cs, **CPU)
    pod = MakePod().name("p").req({"cpu": "1"}).obj()
    out = core.prioritize({"pod": pod.to_dict(), "nodes": node_list(cs)})
    by_host = {e["host"]: e["score"] for e in out}
    assert set(by_host) == {"node-0", "node-1", "node-2", "node-3"}
    assert all(0 <= s <= 10 for s in by_host.values())
    assert by_host["node-1"] > by_host["node-0"]
    json.dumps(out)


def test_bind_and_conflict():
    cs = make_cluster()
    core = ExtenderCore(cs, **CPU)
    cs.create_pod(MakePod().name("p").req({"cpu": "1"}).obj())
    ok = core.bind({"podName": "p", "podNamespace": "default", "podUID": "u1", "node": "node-1"})
    assert ok == {}
    assert cs.get_pod("default", "p").node_name == "node-1"
    dup = core.bind({"podName": "p", "podNamespace": "default", "podUID": "u1", "node": "node-2"})
    assert "Conflict" in dup["error"]


def test_preempt_wire_shape():
    cs = make_cluster()
    core = ExtenderCore(cs, **CPU)
    cs.create_pod(MakePod().name("low").node("node-1").req({"cpu": "8"}).priority(1)
                  .uid("low-uid").obj())
    vip = MakePod().name("vip").req({"cpu": "8"}).priority(100).obj()
    out = core.preempt({"pod": vip.to_dict(),
                        "nodeNameToVictims": {"node-1": {"pods": []}, "node-2": {"pods": []}}})
    assert "nodeNameToMetaVictims" not in out
    victims = out["nodeNameToVictims"]
    assert [p["metadata"]["name"] for p in victims["node-1"]["pods"]] == ["low"]
    assert victims["node-1"]["numPDBViolations"] == 0
    assert victims["node-2"]["pods"] == []
    json.dumps(out)
    core_nc = ExtenderCore(cs, node_cache_capable=True, **CPU)
    out2 = core_nc.preempt({"pod": vip.to_dict(), "nodeNameToVictims": {"node-1": {"pods": []}}})
    assert out2["nodeNameToMetaVictims"]["node-1"]["pods"] == [{"uid": "low-uid"}]


def test_filter_unknown_name_fails_per_node():
    cs = make_cluster()
    core = ExtenderCore(cs, node_cache_capable=True, **CPU)
    pod = MakePod().name("p").req({"cpu": "4"}).obj()
    out = core.filter({"pod": pod.to_dict(), "nodenames": ["node-1", "brand-new-node"]})
    assert out["nodenames"] == ["node-1"]
    assert "brand-new-node" in out["failedAndUnresolvableNodes"]
    assert "error" not in out


def test_preempt_respects_static_filters():
    cs = make_cluster()
    core = ExtenderCore(cs, **CPU)
    cs.create_pod(MakePod().name("low3").node("node-3").req({"cpu": "8"}).priority(1)
                  .uid("low3-uid").obj())
    vip = MakePod().name("vip").req({"cpu": "8"}).priority(100).obj()
    out = core.preempt({"pod": vip.to_dict(), "nodeNameToVictims": {"node-3": {"pods": []}}})
    assert out["nodeNameToVictims"] == {}


def test_live_http_round_trip():
    from aiohttp.test_utils import TestClient, TestServer

    cs = make_cluster()
    app = make_app(ExtenderCore(cs, **CPU))
    pod = MakePod().name("p").req({"cpu": "4"}).obj()

    async def drive():
        async with TestClient(TestServer(app)) as client:
            r = await client.post("/filter", json={"pod": pod.to_dict(), "nodes": node_list(cs)})
            assert r.status == 200
            body = await r.json()
            assert [n["metadata"]["name"] for n in body["nodes"]["items"]] == ["node-1", "node-2"]
            assert (await client.get("/healthz")).status == 200
            r3 = await client.get("/metrics")
            assert r3.status == 200
            assert "scheduler_schedule_attempts_total" in await r3.text()
            r4 = await client.get("/debug/hub")
            assert r4.status == 404 and "not a fleet replica" in (await r4.json())["error"]

    asyncio.run(drive())


def test_preempt_device_matches_oracle():
    cs = make_cluster()
    cs.create_pod(MakePod().name("low1").node("node-1").priority(0).req({"cpu": "6"}).obj())
    cs.create_pod(MakePod().name("low2").node("node-2").priority(5).req({"cpu": "4"}).obj())
    vip = MakePod().name("vip").priority(100).req({"cpu": "6"}).obj()
    args = {"pod": vip.to_dict(),
            "nodeNameToVictims": {f"node-{i}": {"pods": []} for i in range(4)}}
    dev = ExtenderCore(cs, **CPU).preempt(args)
    orc = ExtenderCore(cs, backend="oracle").preempt(args)
    assert dev == orc
    assert "node-1" in dev["nodeNameToVictims"]


def test_preempt_device_sees_extended_resources():
    cs = make_cluster()
    gpu_pod = MakePod().name("gpu").priority(100).req({"cpu": "1", "example.com/gpu": "1"}).obj()
    args = {"pod": gpu_pod.to_dict(),
            "nodeNameToVictims": {"node-1": {"pods": []}, "node-2": {"pods": []}}}
    dev = ExtenderCore(cs, **CPU).preempt(args)
    orc = ExtenderCore(cs, backend="oracle").preempt(args)
    assert dev == orc
    assert dev["nodeNameToVictims"] == {}


# -- the first ten cases of tests/test_serve_tpu.py on the port --------------


def test_device_filter_matches_oracle():
    cs = serve_cluster()
    dev = ExtenderCore(cs, **CPU)
    orc = ExtenderCore(cs, backend="oracle")
    for pod in (
        MakePod().name("p").req({"cpu": "4"}).obj(),
        MakePod().name("z").obj(),
        MakePod().name("a").req({"cpu": "1"}).node_affinity_in("zone", ["z1"]).obj(),
    ):
        args = {"pod": pod.to_dict(), "nodes": node_list(cs)}
        got, want = dev.filter(args), orc.filter(args)
        assert [n["metadata"]["name"] for n in got["nodes"]["items"]] == [
            n["metadata"]["name"] for n in want["nodes"]["items"]]
        assert got["failedNodes"] == want["failedNodes"]
        json.dumps(got)


def test_device_prioritize_matches_oracle():
    cs = serve_cluster()
    pod = MakePod().name("p").req({"cpu": "2", "memory": "4Gi"}).obj()
    args = {"pod": pod.to_dict(), "nodes": node_list(cs)}
    assert ExtenderCore(cs, **CPU).prioritize(args) == ExtenderCore(
        cs, backend="oracle").prioritize(args)


def test_run_many_shares_one_evaluation():
    cs = serve_cluster()
    core = ExtenderCore(cs, **CPU)
    calls = []
    evaluate = core.evaluator.evaluate

    def spy(pods, *a, **kw):
        calls.append(len(pods))
        return evaluate(pods, *a, **kw)

    core.evaluator.evaluate = spy
    pods = [MakePod().name(f"p{i}").req({"cpu": str(i + 1)}).obj() for i in range(4)]
    reqs = [("prioritize", {"pod": p.to_dict(), "nodes": node_list(cs)}) for p in pods]
    reqs.append(("filter", {"pod": pods[0].to_dict(), "nodes": node_list(cs)}))
    outs = core.run_many(reqs)
    assert calls == [5]  # one evaluation for the whole group
    for i, p in enumerate(pods):
        assert outs[i] == core.prioritize({"pod": p.to_dict(), "nodes": node_list(cs)})
    assert "failedNodes" in outs[4]


def test_run_many_isolates_bad_request():
    cs = serve_cluster()
    core = ExtenderCore(cs, **CPU)
    good = MakePod().name("p").req({"cpu": "1"}).obj()
    outs = core.run_many([
        ("prioritize", {"nodes": node_list(cs)}),
        ("filter", {"nodes": node_list(cs)}),
        ("prioritize", {"pod": good.to_dict(), "nodes": node_list(cs)}),
    ])
    assert isinstance(outs[0], DecodeError)
    assert "error" in outs[1]
    assert isinstance(outs[2], list) and outs[2]


def test_run_many_does_not_share_across_different_payloads():
    cs = serve_cluster()
    core = ExtenderCore(cs, **CPU)
    pod = MakePod().name("p").req({"cpu": "4"}).obj()
    small = [MakeNode().name("n").capacity({"cpu": "2", "memory": "4Gi", "pods": "5"}).obj().to_dict()]
    big = [MakeNode().name("n").capacity({"cpu": "16", "memory": "64Gi", "pods": "5"}).obj().to_dict()]
    outs = core.run_many([
        ("filter", {"pod": pod.to_dict(), "nodes": {"items": small}}),
        ("filter", {"pod": pod.to_dict(), "nodes": {"items": big}}),
        ("filter", {"pod": pod.to_dict(), "nodenames": ["node-1", "ghost"]}),
        ("filter", {"pod": pod.to_dict(), "nodenames": ["node-1"]}),
    ])
    assert outs[0]["nodes"]["items"] == []
    assert [n["metadata"]["name"] for n in outs[1]["nodes"]["items"]] == ["n"]
    assert outs[2]["failedAndUnresolvableNodes"] == {"ghost": "node not found"}
    assert outs[3]["failedAndUnresolvableNodes"] == {}


def test_micro_batcher_no_lost_wakeup():
    import threading

    cs = serve_cluster()
    core = ExtenderCore(cs, **CPU)
    release = threading.Event()
    orig = core.run_many

    def slow(requests):
        release.wait(5.0)
        return orig(requests)

    core.run_many = slow
    batcher = MicroBatcher(core, window=0.005)
    pod = MakePod().name("p").req({"cpu": "1"}).obj()
    args = {"pod": pod.to_dict(), "nodes": node_list(cs)}

    async def go():
        first = asyncio.create_task(batcher.submit("prioritize", args))
        await asyncio.sleep(0.05)
        second = asyncio.create_task(batcher.submit("prioritize", args))
        await asyncio.sleep(0.01)
        release.set()
        return await asyncio.wait_for(asyncio.gather(first, second), timeout=5.0)

    outs = asyncio.run(go())
    assert outs[0] == outs[1] and outs[0]


def test_micro_batcher_coalesces():
    cs = serve_cluster()
    core = ExtenderCore(cs, **CPU)
    calls = []
    orig = core.run_many

    def spy(requests):
        calls.append(len(requests))
        return orig(requests)

    core.run_many = spy
    batcher = MicroBatcher(core, window=0.01)
    pod = MakePod().name("p").req({"cpu": "1"}).obj()

    async def go():
        args = {"pod": pod.to_dict(), "nodes": node_list(cs)}
        return await asyncio.gather(*[batcher.submit("prioritize", args) for _ in range(5)])

    outs = asyncio.run(go())
    assert len(outs) == 5 and all(o == outs[0] for o in outs)
    assert calls and max(calls) >= 2


async def _http_roundtrip(app, reqs):
    from aiohttp.test_utils import TestClient, TestServer

    async with TestClient(TestServer(app)) as client:
        out = []
        for method, path, payload in reqs:
            resp = await client.request(method, path, json=payload)
            body = await resp.json() if resp.content_type == "application/json" else None
            out.append((resp.status, body))
        return out


def test_ingest_endpoints():
    cs = ClusterState()
    app = make_app(ExtenderCore(cs, backend="oracle"))
    nodes = [MakeNode().name(f"n{i}").capacity({"cpu": "4", "memory": "8Gi", "pods": "10"})
             .obj().to_dict() for i in range(3)]
    results = asyncio.run(_http_roundtrip(app, [
        ("POST", "/api/nodes", {"items": nodes}),
        ("POST", "/api/pods", MakePod().name("w").req({"cpu": "1"}).obj().to_dict()),
        ("GET", "/api/state", None),
        ("DELETE", "/api/nodes/n2", None),
        ("DELETE", "/api/nodes/nope", None),
        ("GET", "/api/state", None),
    ]))
    assert results[0] == (200, {"applied": 3})
    assert results[1] == (200, {"applied": 1})
    assert results[2][1]["nodes"] == 3 and results[2][1]["unscheduled"] == 1
    assert results[3][0] == 200
    assert results[4][0] == 404
    assert results[5][1]["nodes"] == 2


def test_scheduler_mode_binds_ingested_pods():
    from kubernetes_tpu_torch.scheduler import Scheduler

    cs = ClusterState()
    for i in range(4):
        cs.create_node(MakeNode().name(f"n{i}").capacity(
            {"cpu": "8", "memory": "16Gi", "pods": "20"}).obj())
    sched = Scheduler(cs, device="cpu")
    app = make_app(ExtenderCore(cs, backend="oracle"), scheduler=sched)

    async def go():
        from aiohttp.test_utils import TestClient, TestServer

        async with TestClient(TestServer(app)) as client:
            pods = {"items": [MakePod().name(f"p{i}").req({"cpu": "1"}).obj().to_dict()
                              for i in range(8)]}
            assert (await client.post("/api/pods", json=pods)).status == 200
            for _ in range(100):
                body = await (await client.get("/api/state")).json()
                if body["unscheduled"] == 0:
                    return body
                await asyncio.sleep(0.05)
            return body

    assert asyncio.run(go())["unscheduled"] == 0
    assert all(p.node_name for p in cs.list_pods())


def test_state_file_loading(tmp_path):
    doc = {
        "nodes": [MakeNode().name("n0").capacity({"cpu": "4", "pods": "10"}).obj().to_dict()],
        "pods": [MakePod().name("p0").req({"cpu": "1"}).obj().to_dict()],
    }
    f = tmp_path / "state.json"
    f.write_text(json.dumps(doc))
    cs = ClusterState()
    _load_state_file(cs, str(f))
    assert len(cs.list_nodes()) == 1 and len(cs.list_pods()) == 1


# -- each verb's reply against the JAX package's -----------------------------


def _paired(n=6):
    """(JAX ExtenderCore, the port's) over two copies of one cluster, with
    preemptable load, in parity mode."""
    ref_cs = make_cluster(n, taint_last=True, hostnames=True,
                          wrappers=(RefMakeNode, RefMakePod), cluster_cls=RefClusterState)
    ref_cs.create_pod(RefMakePod().name("low1").node("node-1").priority(0)
                      .req({"cpu": "6"}).uid("low1-uid").obj())
    ref_cs.create_pod(RefMakePod().name("low2").node("node-2").priority(5)
                      .req({"cpu": "4"}).label("app", "db").uid("low2-uid").obj())
    ref_cs.create_pod(RefMakePod().name("w").req({"cpu": "1"}).obj())
    cs = convert.cluster_state(ref_cs)
    cfg = dict(tie_break="first", balanced_fdtype="float64")
    return (RefExtenderCore(ref_cs, solver_config=RefSolverConfig(**cfg)),
            ExtenderCore(cs, solver_config=ExactSolverConfig(**cfg), **CPU))


def _pods():
    return [
        RefMakePod().name("p").req({"cpu": "4"}).obj(),
        RefMakePod().name("s").req({"cpu": "1"}).spread_constraint(
            1, "zone", "ScheduleAnyway", {"app": "db"}).obj(),
        RefMakePod().name("a").req({"cpu": "1"}).pod_affinity("zone", {"app": "db"}).obj(),
        RefMakePod().name("t").req({"cpu": "1"}).toleration(
            "dedicated", "gpu", "Equal", "NoSchedule").obj(),
    ]


@pytest.mark.parametrize("verb", ["filter", "prioritize"])
@pytest.mark.parametrize("by_name", [False, True])
def test_verb_reply_equals_reference(verb, by_name):
    ref, port = _paired()
    nodes = node_list(ref.cluster)
    for pod in _pods():
        args = {"pod": pod.to_dict()}
        if by_name:
            args["nodenames"] = [n["metadata"]["name"] for n in nodes["items"]] + ["ghost"]
        else:
            args["nodes"] = nodes
        want, got = getattr(ref, verb)(args), getattr(port, verb)(args)
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_run_many_reply_equals_reference():
    ref, port = _paired()
    nodes = node_list(ref.cluster)
    reqs = [(verb, {"pod": p.to_dict(), "nodes": nodes})
            for p in _pods() for verb in ("filter", "prioritize")]
    reqs.append(("filter", {"nodes": nodes}))
    want, got = ref.run_many(reqs), port.run_many(reqs)
    assert json.dumps(got[:-1], sort_keys=True) == json.dumps(want[:-1], sort_keys=True)
    assert got[-1] == want[-1]


@pytest.mark.parametrize("node_cache_capable", [False, True])
def test_preempt_reply_equals_reference(node_cache_capable):
    ref, port = _paired()
    ref.node_cache_capable = port.node_cache_capable = node_cache_capable
    vip = RefMakePod().name("vip").priority(100).req({"cpu": "6"}).obj()
    args = {"pod": vip.to_dict(),
            "nodeNameToVictims": {f"node-{i}": {"pods": []} for i in range(6)}}
    want, got = ref.preempt(args), port.preempt(args)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got[next(iter(got))]


def test_bind_reply_equals_reference():
    ref, port = _paired()
    for args in (
        {"podName": "w", "podNamespace": "default", "podUID": "u", "node": "node-4"},
        {"podName": "w", "podNamespace": "default", "podUID": "u", "node": "node-5"},
        {"podName": "ghost", "podNamespace": "default", "podUID": "u", "node": "node-5"},
        {"podNamespace": "default", "node": "node-5"},
    ):
        assert port.bind(args) == ref.bind(args)
    assert port.cluster.get_pod("default", "w").node_name == "node-4"


def test_grpc_port_serves_the_bulk_path(monkeypatch):
    """``grpc_port > 0`` serves the bulk tensor gRPC path beside the
    webhook, on the server's device, and stops it when the webhook's app
    returns (aiohttp's ``run_app`` is replaced by a function that drives
    the gRPC side and returns)."""
    import socket

    import numpy as np
    from aiohttp import web

    from kubernetes_tpu_torch.server.bulk import BulkClient

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        gport = sk.getsockname()[1]
    seen = {}

    def fake_run_app(app, host, port):
        client = BulkClient(f"127.0.0.1:{gport}", retries=0)
        seen["sync"] = client.sync_nodes(["n0", "n1"], [4000, 4000], [8 << 30, 8 << 30])
        seen["solve"] = client.solve([1000] * 3, [1 << 30] * 3, mode="single_shot")
        client.close()

    monkeypatch.setattr(web, "run_app", fake_run_app)
    cs = ClusterState()
    run_server(cs, grpc_port=gport, device="cpu")
    assert seen["sync"] == {"applied": 2}
    meta, arrays = seen["solve"]
    assert meta["nodes"] == ["n0", "n1"] and (np.asarray(arrays["assignments"]) >= 0).all()
    assert len(cs.list_nodes()) == 2
