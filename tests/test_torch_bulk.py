"""The port's bulk tensor gRPC path against the JAX package's, on the CPU.

The tensorcodec and bulk cases of tests/test_serve_tpu.py: the port's
``BulkCore`` (``device="cpu"``) and the JAX package's, each over its own
copy of one cluster, answer the same request bytes with replies that
decode to the same meta and arrays (``Solve`` in ``exact`` and
``single_shot`` mode, advisory and committing, and ``Evaluate``), and the
committed bindings are equal. The gRPC round trips run on a real socket.
The fleet's two methods (``ExchangeOccupancy``, ``HubOp``) serve the
occupancy hub, reply for reply with the JAX package's hub.
"""

import json
import struct

import numpy as np
import pytest

from kubernetes_tpu.api.wrappers import MakeNode, MakePod
from kubernetes_tpu.server import tensorcodec as ref_codec
from kubernetes_tpu.server.bulk import BulkCore as RefBulkCore
from kubernetes_tpu.solver.exact import ExactSolverConfig as RefConfig
from kubernetes_tpu.state.cluster import ClusterState
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.ops import domain_counts as dc
from kubernetes_tpu_torch.server import tensorcodec
from kubernetes_tpu_torch.server.bulk import (
    BulkClient,
    BulkCore,
    columnar_pod_batch,
    make_grpc_server,
    serve_bulk,
)
from kubernetes_tpu_torch.solver.exact import ExactSolverConfig
from kubernetes_tpu_torch.tensorize.schema import ResourceVocab

PARITY = dict(tie_break="first", balanced_fdtype="float64")


def make_cluster(n=6):
    cs = ClusterState()
    for i in range(n):
        cs.create_node(
            MakeNode().name(f"node-{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": "20"})
            .label("zone", f"z{i % 2}").label("kubernetes.io/hostname", f"node-{i}").obj()
        )
    cs.create_pod(MakePod().name("existing").node("node-0").req({"cpu": "7"}).obj())
    return cs


def paired(n=6, ref_cs=None):
    """(JAX BulkCore, the port's BulkCore) over two copies of one cluster,
    the exact solver and the evaluator in parity mode ("first" tie-break,
    float64 balanced scores: the default "random" mode draws from a stream
    the port cannot reproduce)."""
    ref_cs = ref_cs if ref_cs is not None else make_cluster(n)
    return (RefBulkCore(ref_cs, solver_config=RefConfig(**PARITY)),
            BulkCore(convert.cluster_state(ref_cs), solver_config=ExactSolverConfig(**PARITY),
                     device="cpu"))


def assert_same_reply(ours: bytes, ref: bytes):
    m1, a1 = tensorcodec.decode(ours)
    m2, a2 = ref_codec.decode(ref)
    assert m1 == m2
    assert sorted(a1) == sorted(a2)
    for k in a1:
        assert a1[k].dtype == a2[k].dtype, k
        np.testing.assert_array_equal(a1[k], a2[k], err_msg=k)
    return m1, a1


def both(method, meta, arrays, n=6):
    ref, port = paired(n)
    req = tensorcodec.encode(meta, arrays)
    assert req == ref_codec.encode(meta, arrays)  # one wire format
    return (*assert_same_reply(getattr(port, method)(req), getattr(ref, method)(req)),
            ref, port)


def bindings(cs):
    return sorted((p.key, p.node_name) for p in cs.list_pods())


# -- tensor codec ------------------------------------------------------------


def test_tensorcodec_roundtrip():
    meta = {"mode": "exact", "names": ["a", "b"]}
    arrays = {"x": np.arange(6, dtype=np.int64).reshape(2, 3), "y": np.asarray([True, False])}
    data = tensorcodec.encode(meta, arrays)
    assert data == ref_codec.encode(meta, arrays)
    m2, a2 = tensorcodec.decode(data)
    assert m2 == meta
    assert np.array_equal(a2["x"], arrays["x"]) and np.array_equal(a2["y"], arrays["y"])


def test_tensorcodec_rejects_bad_shapes():
    data = tensorcodec.encode({"a": 1}, {"x": np.zeros(4, dtype=np.int32)})
    (hlen,) = struct.unpack_from("<I", data, 0)
    hdr = json.loads(data[4: 4 + hlen])
    hdr["arrays"][0]["shape"] = [999]
    bad_hdr = json.dumps(hdr).encode()
    bad = struct.pack("<I", len(bad_hdr)) + bad_hdr + data[4 + hlen:]
    with pytest.raises(ValueError):
        tensorcodec.decode(bad)
    with pytest.raises(ValueError):
        tensorcodec.encode({}, {"z": np.zeros(2, dtype=np.complex64)})


# -- BulkCore ----------------------------------------------------------------


def test_bulk_core_solve_matches_direct():
    meta, arrays, _, _ = both("solve", {"mode": "exact"},
                              {"cpu_milli": np.full(8, 1000, dtype=np.int64),
                               "mem_bytes": np.full(8, 1 << 30, dtype=np.int64)})
    asg = arrays["assignments"]
    assert asg.shape == (8,) and (asg >= 0).all()
    assert sum(1 for a in asg if meta["nodes"][a] == "node-0") <= 1


@pytest.mark.parametrize("mode", ["exact", "single_shot"])
def test_bulk_core_advisory_solve_changes_nothing(mode):
    rng = np.random.default_rng(3)
    meta, arrays, ref, port = both(
        "solve", {"mode": mode},
        {"cpu_milli": rng.integers(1, 9, 64).astype(np.int64) * 250,
         "mem_bytes": rng.integers(1, 5, 64).astype(np.int64) << 29,
         "priority": rng.integers(0, 4, 64).astype(np.int32)})
    assert meta["mode"] == mode and "committed" not in meta
    assert (arrays["assignments"] >= 0).sum() > 0
    assert bindings(port.cluster) == bindings(ref.cluster)
    assert len(port.cluster.list_pods()) == 1


def test_bulk_core_single_shot_and_commit():
    names = [f"default/bulk-{i}" for i in range(6)]
    meta, arrays, ref, port = both(
        "solve", {"mode": "single_shot", "commit": True, "names": names},
        {"cpu_milli": np.full(6, 500, dtype=np.int64),
         "mem_bytes": np.full(6, 1 << 29, dtype=np.int64)}, n=4)
    assert int((arrays["assignments"] >= 0).sum()) == 6 and meta["committed"] == 6
    bound = [p for p in port.cluster.list_pods() if p.name.startswith("bulk-")]
    assert len(bound) == 6 and all(p.node_name for p in bound)
    assert bindings(port.cluster) == bindings(ref.cluster)


def test_bulk_commit_honors_namespaced_keys():
    meta, arrays, ref, port = both(
        "solve", {"mode": "single_shot", "commit": True,
                  "names": ["team-a/web", "team-b/web", "bare"], "namespace": "fallback-ns"},
        {"cpu_milli": np.full(3, 500, dtype=np.int64),
         "mem_bytes": np.full(3, 1 << 29, dtype=np.int64)}, n=4)
    assert int((arrays["assignments"] >= 0).sum()) == 3
    for ns, name in (("team-a", "web"), ("team-b", "web"), ("fallback-ns", "bare")):
        assert port.cluster.get_pod(ns, name).node_name
    assert bindings(port.cluster) == bindings(ref.cluster)


def test_bulk_core_evaluate_matches_jax(monkeypatch):
    """Evaluate's [P, N] scores equal the JAX package's. Columnar pods
    carry only resources, so the batch has no spread or interpod rows and
    the evaluator aggregates no domain counts: neither domain_counts nor
    its plain version runs."""
    calls = []
    plain = dc.aggregate_plain
    monkeypatch.setattr(dc, "aggregate_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
    _, arrays, _, _ = both("evaluate", {},
                           {"cpu_milli": np.asarray([1000, 64000, 500], dtype=np.int64),
                            "mem_bytes": np.asarray([1 << 30, 1 << 30, 1 << 28], dtype=np.int64)})
    scores = arrays["scores"]
    assert scores.shape == (3, 6)
    assert (scores[1] < 0).all()
    assert (scores[0, 1:] >= 0).all()
    assert calls == []


def test_bulk_core_without_nodes_reports_the_error():
    ref, port = RefBulkCore(ClusterState()), BulkCore(ClusterState(), device="cpu")
    req = tensorcodec.encode({"mode": "single_shot"},
                             {"cpu_milli": np.ones(2, np.int64), "mem_bytes": np.ones(2, np.int64)})
    assert_same_reply(port.solve(req), ref.solve(req))
    assert tensorcodec.decode(port.solve(req))[0] == {"error": "no nodes ingested"}


def test_columnar_pod_batch_applies_nonzero_defaults():
    pb = columnar_pod_batch(np.asarray([0, 300]), np.asarray([0, 1 << 30]), None,
                            ResourceVocab(("cpu", "memory")))
    assert pb.num_pods == 2 and pb.padded >= 2
    assert pb.nonzero_req[:2].tolist() == [[100, 200 * 1024 * 1024], [300, 1 << 30]]
    assert pb.valid.sum() == 2 and pb.keys == ["default/bulk-0", "default/bulk-1"]


# one occupancy-hub session: (op, meta) in order, every reply compared
HUB_OPS = [
    ("peers_version", {"replica": "r1"}),
    ("cas_stage", {"replica": "r1", "expect": 0,
                   "row": ["default/b", "n2", "z0", "default", [["app", "web"]], "pending"]}),
    ("publish_nodes", {"replica": "r0", "nodes": [["n0", "z0"], ["n1", "z1"]]}),
    ("publish_nodes", {"replica": "r1", "nodes": [["n2", "z0"]]}),
    ("stage", {"replica": "r0", "row": ["default/a", "n0", "z0", "default",
                                         [["app", "web"]], "pending"]}),
    ("peers_view", {"replica": "r1"}),
    ("commit", {"replica": "r0", "pod": "default/a"}),
    ("hand_off", {"replica": "r0", "to": "r1", "pod": "default/c", "hops": 1,
                  "from": "r0", "trace": "r0-1:3:default/c"}),
    ("pending_handoff_keys", {"replica": "r1"}),
    ("claim_handoffs", {"replica": "r1"}),
    ("set_degraded", {"replica": "r1", "degraded": True}),
    ("degraded_replicas", {"replica": "r0"}),
    ("ship_journal", {"replica": "r0", "lines": ['{"k":"d","pod":"default/a"}']}),
    ("journal_lines", {"replica": "r0"}),
    ("withdraw", {"replica": "r0", "pod": "default/a"}),
    ("peers_view", {"replica": "r1"}),
    ("version", {}),
    ("hub_status", {}),
]


def test_fleet_methods_raise_naming_item_8c():
    """The fleet's two methods, which answered UNIMPLEMENTED (naming ROADMAP
    item 8c) before the fleet was ported, now serve the occupancy hub: the
    port's ``BulkCore(exchange=)`` and the JAX package's answer the same
    ``HubOp`` session and the same ``ExchangeOccupancy`` payload with equal
    replies."""
    from kubernetes_tpu.fleet import NodeRow as RefNodeRow
    from kubernetes_tpu.fleet import OccupancyExchange as RefExchange
    from kubernetes_tpu.fleet import PodRow as RefPodRow
    from kubernetes_tpu.fleet.occupancy import encode_rows as ref_encode_rows
    from kubernetes_tpu_torch.fleet import NodeRow, OccupancyExchange, PodRow
    from kubernetes_tpu_torch.fleet.occupancy import decode_rows, encode_rows

    from kubernetes_tpu.utils.clock import FakeClock as RefFakeClock
    from kubernetes_tpu_torch.utils.clock import FakeClock

    # virtual clocks: peer ages in the replies are clock arithmetic
    core = BulkCore(ClusterState(), exchange=OccupancyExchange(FakeClock()), device="cpu")
    ref = RefBulkCore(ClusterState(), exchange=RefExchange(RefFakeClock()))
    for op, meta in HUB_OPS:
        ours = tensorcodec.decode(core.hub_op(tensorcodec.encode({"op": op, **meta})))
        theirs = ref_codec.decode(ref.hub_op(ref_codec.encode({"op": op, **meta})))
        assert ours[0] == theirs[0], op
    row = dict(pod="default/x", node="n9", zone="z2", namespace="default",
               labels=(("app", "db"),))
    ours = core.exchange_occupancy(encode_rows(
        "r2", 0, [NodeRow("n9", "z2")], [PodRow(**row)]))
    theirs = ref.exchange_occupancy(ref_encode_rows(
        "r2", 0, [RefNodeRow("n9", "z2")], [RefPodRow(**row)]))
    assert ours == theirs
    replica, version, nodes, pods = decode_rows(ours)
    assert version >= 1 and {n.node for n in nodes} >= {"n0", "n1", "n2"}
    with pytest.raises(ValueError, match="unknown hub op"):
        core.hub_op(tensorcodec.encode({"op": "no-such-op"}))


# -- over a socket -----------------------------------------------------------


def test_bulk_grpc_socket_roundtrip():
    """gRPC server + client on a real socket: SyncNodes -> Solve (both
    modes) -> Evaluate, each reply equal to the JAX BulkCore's over the
    same nodes."""
    import grpc

    ref, core = paired(ref_cs=ClusterState())
    server, port = make_grpc_server(core, port=0)
    server.start()
    client = BulkClient(f"127.0.0.1:{port}")
    try:
        nodes = dict(names=[f"n{i}" for i in range(5)], cpu_milli=[8000] * 5,
                     mem_bytes=[32 << 30] * 5, max_pods=[20] * 5)
        assert client.sync_nodes(**nodes) == {"applied": 5}
        ref.sync_nodes(ref_codec.encode(
            {"names": nodes["names"]},
            {"cpu_milli": np.asarray(nodes["cpu_milli"], np.int64),
             "mem_bytes": np.asarray(nodes["mem_bytes"], np.int64),
             "max_pods": np.asarray(nodes["max_pods"], np.int32)}))
        cpu, mem = np.full(10, 1000, np.int64), np.full(10, 1 << 30, np.int64)
        for mode in ("exact", "single_shot"):
            meta, arrays = client.solve(cpu_milli=cpu, mem_bytes=mem, mode=mode)
            m2, a2 = ref_codec.decode(ref.solve(ref_codec.encode(
                {"mode": mode, "commit": False}, {"cpu_milli": cpu, "mem_bytes": mem})))
            assert meta == m2
            np.testing.assert_array_equal(arrays["assignments"], a2["assignments"])
            assert (arrays["assignments"] >= 0).all()
        meta, arrays = client.evaluate(cpu_milli=[1000, 64000], mem_bytes=[1 << 30, 1 << 30])
        assert arrays["scores"].shape == (2, 5)
        assert (arrays["scores"][0] >= 0).all() and (arrays["scores"][1] < 0).all()
        # the fleet's methods over the wire: the same hub session as the
        # JAX BulkCore's in process, reply for reply; an unknown op is
        # INVALID_ARGUMENT, a semantic rejection the client never retries
        from kubernetes_tpu.fleet import OccupancyExchange as RefExchange
        from kubernetes_tpu.utils.clock import FakeClock as RefFakeClock
        from kubernetes_tpu_torch.fleet import OccupancyExchange
        from kubernetes_tpu_torch.utils.clock import FakeClock

        # the served core's hub on a virtual clock, as the reference's
        core.exchange = OccupancyExchange(FakeClock())
        ref_hub = RefBulkCore(ClusterState(), exchange=RefExchange(RefFakeClock()))
        for op, meta in HUB_OPS:
            ours = client.hub_op(op, **{k: v for k, v in meta.items()})
            theirs = ref_codec.decode(ref_hub.hub_op(ref_codec.encode({"op": op, **meta})))[0]
            assert ours == theirs, op
        with pytest.raises(grpc.RpcError) as err:
            client.hub_op("no-such-op")
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    finally:
        client.close()
        server.stop(grace=None)


def test_serve_bulk_commits_over_the_wire():
    import socket

    ref_cs = make_cluster(4)
    cs = convert.cluster_state(ref_cs)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    server = serve_bulk(cs, port=free, device="cpu")
    client = BulkClient(f"127.0.0.1:{free}")
    try:
        names = [f"default/w{i}" for i in range(5)]
        cpu, mem = np.full(5, 500, np.int64), np.full(5, 1 << 29, np.int64)
        meta, arrays = client.solve(cpu_milli=cpu, mem_bytes=mem, mode="single_shot",
                                    names=names, commit=True)
        RefBulkCore(ref_cs).solve(ref_codec.encode(
            {"mode": "single_shot", "commit": True, "names": names},
            {"cpu_milli": cpu, "mem_bytes": mem}))
        assert meta["committed"] == 5
        assert bindings(cs) == bindings(ref_cs)
    finally:
        client.close()
        server.stop(grace=None)
