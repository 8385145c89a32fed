"""Scan-step batches solved through the fused step kernel
(``ops/scan_step.py``) and through the torch step (``solver/exact.py``
``_make_step``), for the CPU tests (the kernel's block body on the host,
``tests/_scan_step_host.cpp``) and the card's (``tests/test_torch_cuda.py``).
Imports no JAX.

A case is a cluster, pods already bound on it and the batch to place, in
interpod5k's four pod kinds (hostPort, hard zone spread, required hostname
anti-affinity, preferred zone affinity) and the kinds that reach the rest of
the pipeline; ``solve`` runs it on one solver and returns, per call of the
solver's run, the assignments, the carried ``i64`` / ``i32`` state, and the
stream's key, with the solve counts."""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.api.wrappers import MakeNode, MakePod
from kubernetes_tpu_torch.ops import scan_step as ss
from kubernetes_tpu_torch.ops import threefry as tf
from kubernetes_tpu_torch.solver import exact
from kubernetes_tpu_torch.solver import graphs as sg
from kubernetes_tpu_torch.solver.exact import ExactSolver, ExactSolverConfig
from kubernetes_tpu_torch.tensorize.interpod import build_interpod_tensors
from kubernetes_tpu_torch.tensorize.plugins import build_port_tensors, build_static_tensors
from kubernetes_tpu_torch.tensorize.schema import ResourceVocab, build_node_batch, build_pod_batch
from kubernetes_tpu_torch.tensorize.spread import build_spread_tensors

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent

# interpod5k's four kinds
MIXED = ("ports", "spread", "anti", "pref")

# the crowded kinds' spread constraints of each kind and InterPodAffinity
# terms of each list
CROWD_SPREAD, CROWD_TERMS = 9, 17


def nodes(n, *, cpu=4, images=False, taints=False):
    """``n`` nodes of ``cpu`` cores in 3 zones (node i in z(i mod 3)); every
    fifth holds an image the ``image`` pods run, every fourth a
    PreferNoSchedule taint, where asked."""
    out = []
    for i in range(n):
        b = (MakeNode().name(f"n{i:04}").capacity({"cpu": str(cpu), "memory": "16Gi",
                                                   "pods": "20"})
             .label(ZONE, f"z{i % 3}").label(HOST, f"n{i:04}"))
        if images and i % 5 == 0:
            b = b.image("registry.local/app:1", 400 * 1024 * 1024)
        if taints and i % 4 == 0:
            b = b.taint("dedicated", "batch", "PreferNoSchedule")
        out.append(b.obj())
    return out


def pod(kind, name, *, bad=False):
    """One pod of ``kind``; ``bad``: it requests a resource no node has (an
    invalid scan row, whose split the stream owes the next draw)."""
    req = {"cpu": "100m", "memory": "500Mi"}
    if bad:
        req["example.com/missing"] = "1"
    b = MakePod().name(name).label("app", kind).req(req)
    i = int(name[-3:])
    if kind == "ports":
        b = b.host_port(8000 + i % 4)
    elif kind == "port_taken":  # a port every node of a full load holds
        b = b.host_port(9000)
    elif kind == "spread":
        b = b.spread_constraint(1, ZONE, "DoNotSchedule", {"app": "spread"})
    elif kind == "spread_min_domains":  # minDomains above the zones: the minimum is 0
        b = b.spread_constraint(2, ZONE, "DoNotSchedule", {"app": "spread_min_domains"},
                                min_domains=5)
    elif kind == "anti":
        b = b.pod_anti_affinity(HOST, {"app": "anti"})
    elif kind == "pref":
        b = b.preferred_pod_affinity(50, ZONE, {"app": "spread"})
    elif kind == "aff":  # required affinity to its own kind: the first pod's case
        b = b.pod_affinity(ZONE, {"app": "aff"})
    elif kind == "soft":
        b = (b.spread_constraint(1, ZONE, "ScheduleAnyway", {"app": "soft"})
             .spread_constraint(1, HOST, "ScheduleAnyway", {"app": "soft"}))
    elif kind == "nodeaff":
        b = b.preferred_node_affinity(10, ZONE, ["z1"])
    elif kind == "image":
        b = b.container_image("registry.local/app:1")
    elif kind == "crowded":
        # more constraint slots than a group of eight in every list: hard
        # spread on its own kind (the tightest last), soft spread, required
        # anti-affinity (one on its own kind), preferred affinity to the
        # other kinds
        for k in range(CROWD_SPREAD):
            b = b.spread_constraint(CROWD_SPREAD - k, (ZONE, HOST)[k % 2], "DoNotSchedule",
                                    {"app": "crowded"})
            b = b.spread_constraint(1 + k, (HOST, ZONE)[k % 2], "ScheduleAnyway",
                                    {"app": "spread"})
        for k in range(CROWD_TERMS):
            b = b.pod_anti_affinity(HOST, {"app": "crowded" if k == 0 else f"none{k}"})
            b = b.preferred_pod_affinity(1 + k, (ZONE, HOST)[k % 2],
                                         {"app": ("spread", "pref", "anti", "ports")[k % 4]})
    elif kind == "crowded_aff":
        # required affinity terms to its own labels, more than a group of
        # eight: the first pod goes anywhere, the rest to its zone
        for k in range(CROWD_TERMS):
            b = b.label(f"l{k}", "x").pod_affinity(ZONE, {f"l{k}": "x"})
    return b.obj()


def batch(n, kinds, *, prefix="p", bad_every=0):
    return [pod(kinds[i % len(kinds)], f"{prefix}{i:03}",
                bad=bool(bad_every) and i % bad_every == bad_every - 1) for i in range(n)]


def load(cluster, n_pods, kinds, seed):
    """``n_pods`` pods of ``kinds`` already bound, on nodes drawn from
    ``seed``: node name -> pods."""
    rng = np.random.default_rng(seed)
    placed: dict = {}
    for k, at in enumerate(rng.choice(len(cluster), n_pods)):
        p = pod(kinds[k % len(kinds)], f"live{seed}-{k:03}")
        placed.setdefault(cluster[int(at)].name, []).append(p)
    return placed


def inputs(cluster, placed, pods):
    """The solver's inputs for ``pods`` on ``cluster`` with ``placed`` bound."""
    vocab = ResourceVocab.build([], cluster)
    nb = build_node_batch(cluster, placed, vocab=vocab)
    pb = build_pod_batch(pods, vocab)
    slots = list(cluster) + [None] * (nb.padded - len(cluster))
    by_slot = {i: placed[n.name] for i, n in enumerate(cluster) if n.name in placed}
    st = build_static_tensors(pods, pb, slots, nb.padded)
    return (nb, pb, st, build_port_tensors(pods, pb, slots, by_slot, nb.padded),
            build_spread_tensors(pods, st.reps, pb, slots, by_slot, nb.padded, st.c_pad),
            build_interpod_tensors(pods, st.reps, pb, slots, by_slot, nb.padded, st.c_pad))


def cases(n_nodes, n_pods):
    """The cases at one scale: ``n_nodes`` nodes, batches of ``n_pods``."""
    return {
        # interpod5k's four kinds on a partly filled cluster, invalid rows
        # among them (owed splits)
        "interpod_loaded": dict(nodes=n_nodes, live=n_nodes, live_kinds=MIXED,
                                batches=[(n_pods, MIXED, 7)]),
        # a port every node holds: those pods fit nowhere; anti pods more
        # than the nodes leave the last of them nowhere too
        "infeasible": dict(nodes=n_nodes, live=n_nodes, live_kinds=("port_taken",),
                           live_every_node=True,
                           batches=[(n_nodes + n_pods // 4, ("anti", "port_taken", "anti"), 0)]),
        # required affinity to its own kind with none bound: the first pod
        # may go anywhere, the rest follow its zone; two batches, the second
        # on the first's placements
        "first_pod": dict(nodes=n_nodes, live=0, batches=[(n_pods // 4, ("aff", "ports"), 0),
                                                          (n_pods // 4, ("aff", "spread"), 0)]),
        # soft spread (zone and hostname), minDomains, TaintToleration,
        # NodeAffinity and ImageLocality scores
        "scores": dict(nodes=n_nodes, live=n_nodes // 2, live_kinds=("soft", "spread_min_domains"),
                       node_kw=dict(images=True, taints=True),
                       batches=[(n_pods, ("soft", "nodeaff", "image", "spread_min_domains",
                                          "pref"), 5)]),
        # classes of more slots than a group of eight in every list
        "crowded": dict(nodes=n_nodes, live=n_nodes // 2, live_kinds=MIXED,
                        batches=[(n_pods, ("crowded", "crowded_aff", "spread", "anti"), 0)]),
    }


def solve(mp, spec, dev, seed, *, fused, tie="random", scoring="LeastAllocated",
          fdtype="float64", graphs=False):
    """The case's batches on one solver: per call of the solver's run
    (assignments, carried i64 / i32 state, the stream's key words or None),
    and the solve counts of every batch. ``fused``: whether the fused step
    engages (on the CPU the caller has made its launch the host's);
    ``graphs``: whether the step graphs engage (on the CPU, emulated by the
    caller)."""
    runs, used = [], []
    real_call, real_steps = exact._Run.__call__, exact._Run._steps

    def steps(run, packed, plan, stream, *a):
        used.append(stream)  # the call's stream: its own, or the graph pass's
        real_steps(run, packed, plan, stream, *a)

    def call(run, packed, plan, key):
        real_call(run, packed, plan, key)
        stream = used[-1]
        runs.append((run.assignments.cpu().numpy().copy(), packed["i64"][0].cpu().numpy().copy(),
                     packed["i32"][0].cpu().numpy().copy(),
                     stream.key_words() if stream is not None else None))

    mp.setattr(exact._Run, "_steps", steps)
    mp.setattr(exact._Run, "__call__", call)
    if not fused:
        mp.setattr(ss, "engages", lambda *a: False)
    if not graphs:
        mp.setattr(sg, "engages", lambda *a: False)
    cluster = nodes(spec["nodes"], **spec.get("node_kw", {}))
    placed = {}
    if spec.get("live_every_node"):
        placed = {n.name: [pod(spec["live_kinds"][0], f"live-{i:03}")]
                  for i, n in enumerate(cluster)}
    elif spec["live"]:
        placed = load(cluster, spec["live"], spec["live_kinds"], seed)
    solver = ExactSolver(ExactSolverConfig(tie_break=tie, seed=seed, group_size=1,
                                           scoring_strategy=scoring, balanced_fdtype=fdtype))
    counts = []
    for b, (n, kinds, bad_every) in enumerate(spec["batches"]):
        pods = batch(n, kinds, prefix=f"b{b}-", bad_every=bad_every)
        got = solver.solve(*inputs(cluster, placed, pods), device=dev)
        counts.append(dict(solver.times.counts))
        for p, a in zip(pods, got):
            if a >= 0:
                placed.setdefault(cluster[int(a)].name, []).append(p)
    return runs, counts


def assert_same(got, want, case):
    """The fused solves equal the torch step's bit for bit: assignments,
    carried state and the stream's key after every run; every scan step of
    the fused solves ran in the kernel, none of the torch ones did."""
    (a_runs, a_counts), (b_runs, b_counts) = got, want
    assert len(a_runs) == len(b_runs), case
    for (a, a64, a32, ka), (b, b64, b32, kb) in zip(a_runs, b_runs):
        np.testing.assert_array_equal(a, b, err_msg=case)
        np.testing.assert_array_equal(a64, b64, err_msg=case)
        np.testing.assert_array_equal(a32, b32, err_msg=case)
        assert ka == kb, case
    for ca, cb in zip(a_counts, b_counts):
        assert ca["scan_steps"] == cb["scan_steps"] > 0, case
        assert ca["fused_scan_steps"] == ca["scan_steps"], case
        assert cb["fused_scan_steps"] == 0, case


def build_host_kernel(out_dir: Path):
    """The kernel's block body built for the host with g++, declared as the
    card's library is, with its emulated launch; skips without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's block body for the host")
    out = out_dir / "libscan_step_host.so"
    cmd = [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-shared", "-fPIC",
           "-include", str(HERE / "_cuda_host_shim.h"),
           "-I", str(ROOT / "kubernetes_tpu_torch" / "csrc"),
           "-o", str(out), str(HERE / "_scan_step_host.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ss._declare(ctypes.CDLL(str(out)))
    lib.scan_step_emulate.argtypes = [ctypes.c_void_p]
    lib.scan_step_emulate.restype = ctypes.c_int
    return lib


def on_the_host(mp, lib, *, blocks=2, threads=64, smem=1 << 20, launches=None):
    """The fused step engages on the CPU and launches the block body on the
    host: a cluster of ``blocks`` blocks of ``threads`` threads, the per-node
    arrays in their shared memory (``smem``, the bytes a block may take,
    holds them) or in the workspace; a CPU stream carries a state row the
    body reads and writes (its key, copied in and out around each launch).
    ``launches`` gets, a launch each, whether its arrays were in shared
    memory."""
    real_init = tf.Stream.__init__

    def init(self, key, device):
        real_init(self, key, device)
        self.state = torch.zeros(6, dtype=torch.int64)

    def emit(self, words, stream):
        if self.random:
            stream.state[0], stream.state[1] = stream.key
        assert lib.scan_step_emulate(ctypes.addressof(words)) == 0
        if self.random:
            stream.key = (int(stream.state[0]), int(stream.state[1]))
        if launches is not None:
            launches.append(words[ss.W_WORK] == 0)

    mp.setattr(tf.Stream, "__init__", init)
    mp.setattr(ss, "engages", lambda device, shards, use_nominated, scorer: shards == 1
               and not use_nominated and scorer in ss.SCORERS)
    mp.setattr(ss, "_load", lambda: lib)
    mp.setattr(ss, "smem_limit", lambda device: smem)
    mp.setattr(ss, "shape", lambda n: (blocks, threads))
    mp.setattr(ss.Step, "_emit", emit)
