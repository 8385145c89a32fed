"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (a failure in any of them propagates and exits nonzero):

1. Environment: the card's name and power limit, torch and CUDA versions,
   whether the optional packages ``aiohttp``, ``grpc`` and ``yaml`` import,
   and the build of every kernel under kubernetes_tpu_torch/csrc (one nvcc
   per source, all started together).
2. Each kernel against its plain PyTorch version on the card, exactly (both
   outputs of domain_counts: the [T, d_pad] totals and the gathered
   per-node totals), at the main path's shapes -- InterPodAffinity's in
   and ex rows as one two-set launch, a spread row, and the grouped path's
   rows: a zone-spread row (kind 2) and a hostname anti-affinity row
   (kind 3, d_pad 8,192 at 5,120 nodes) -- and at the shapes that take its
   other paths and cluster sizes (d_pad 16,384 at 10,240 nodes, 65,536,
   and 2^19 beyond a cluster); kernel, plain and library times with CUDA
   events (per call over runs of back-to-back calls, median of 20 runs
   after warm-up), and each one's own device time from torch.profiler.
   Then every cluster size at the main path's launch, and every cluster
   size on both paths, each exact.
3. Card against CPU at reduced depth, tie_break "first": 1,024 nodes and
   512 pods of the mixed workload below, and of each grouped kind (plain,
   zone spread, hostname anti-affinity) and the mixed one again, each
   with and without a nominated set that holds nominated hostPorts;
   assignments and written-back node state must be identical.
4. Full width, each path with the kernel's launch count set to 0 just
   before it and read just after:
   a. the InterPodAffinity / anti-affinity configuration of BASELINE.json
      ("5k pods x 5k nodes"), 5,120 nodes in 3 zones and 5,120 pods of the
      mixed workload in 5 batches of 1,024 (the per-pod scan);
   b. the grouped path on the BASELINE.json configurations it serves, in
      "first" and "random" mode: "PodTopologySpread across 3 zones"
      (10,240 pods with one hard zone constraint onto 5,120 nodes in 10
      batches, kind 2), the anti-affinity half of "InterPodAffinity /
      anti-affinity" (4,096 pods with a self-selecting hostname
      anti-affinity onto 5,120 nodes in 4 batches, kind 3) and
      "NodeResourcesFit + BalancedAllocation" (5,120 pods onto 1,024 nodes
      in 5 batches, kind 1); each batch tensorized against the pods the
      earlier batches placed. Every pod must place with the workload's
      invariants holding, and in "first" mode the first batch's grouped
      solve must equal the per-pod scan's bit for bit;
   c. the kind-2 run again through the device session (the caller bumps
      the version of every column it writes, so the heal runs), then with
      deferred reads, then split into 4 chained sub-batches, then the
      streaming carry across batches; each must equal (b)'s assignments.
5. Torch kernel launches per scan step and the device's busy share, from
   torch.profiler on two short solves; and torch launches per placed pod
   on the grouped path, per kind and mode, by the same difference.
6. The Scheduler: pods created in a ClusterState, popped, solved, assumed
   and bound by ``Scheduler.schedule_batch`` / ``run_until_settled``:
   a. card == CPU at reduced depth: a mixed multi-batch run (hostPorts,
      hard zone spread, hostname anti-affinity, preferred affinity, a
      nominated pod; a node added and a pod deleted between batches, so
      the session heals) and a preemption run, in "first" mode, must give
      equal bindings, nominations and victims on both; the production
      default config ("random", group 64) holds every invariant on both;
   b. full width, parity mode: phase 4a's InterPodAffinity workload
      (5,120 pods x 5,120 nodes) drained by run_until_settled in batches
      of 1,024; every invariant held;
   c. full width, the production default config: BASELINE.json's
      north-star shape, 50,000 plain 250m / 512Mi pods on 10,000 nodes of
      16 CPU / 64Gi / 110 pods in 3 zones;
   d. full width, preemption: 5,120 nodes each full of 16 low-priority
      pods (created bound), then 128 higher-priority pods that fit only by
      preemption: every preemptor nominated, every victim of lower
      priority, and every preemptor bound once the victims are gone;
      dry-runs per second, and torch launches per dry-run from
      torch.profiler.
   Each reads pods bound per second (first schedule_batch to last bind),
   the wall split into tensorize, solve, apply and commit, p50 / p99 of
   each pod's time from queue add to bind, and domain_counts launches
   (the count set to 0 just before the run and read just after). In every
   run each batch must have solved at the top ladder tier: the solve-tier
   gauge at the top rung, no breaker transition, no host rung, no bisection
   or quarantine; otherwise the phase fails.
7. The Scheduler's other loops (``run_pipelined``, ``run_streaming``,
   ``drain_backlog``):
   a. reduced depth, "first" mode: 6a's mixed scenario through each loop
      on the card and on the CPU must bind as ``run_until_settled`` does;
      a drain whose budget forces an auto-split binds as the unsplit one;
      a fence case (a bound pod deleted while the first flight is in the
      ring) discards the flight, on the card as on the CPU;
   b. full width, parity mode: 6b's workload through ``run_pipelined``
      and ``run_streaming``, between two ``run_until_settled`` runs (the
      same call's baseline for the share of the wall each loop hides);
      every run's bindings must equal 6b's;
   c. full width, the production default config: 6c's north-star shape
      as a backlog through each loop, between two ``run_until_settled``
      runs as in (b), then with arrivals: waves of 1,024
      pods at half the rate ``run_streaming`` sustained, ``run_streaming``
      after each wave; p50 / p99 from queue add to bind;
   d. full width: ``drain_backlog`` of 100,000 pods (three in four plain,
      one in four with a hard 3-zone spread) on 20,000 nodes of 6c's
      shape with the default budget; the planned chunk, auto-splits, the
      estimated and measured h2d bytes, and each chunk's peak allocated
      memory against the budget model's estimate.
   Every run holds 6's top-tier rule, and no batch may take the
   synchronous cycle, nor (outside the fence case) be discarded.
8. The extender webhook (``server/extender.py`` over the batched
   ``solver/evaluate.py``), restart incarnations and replay bundles:
   a. reduced depth, parity mode, card == CPU: every verb's JSON reply
      (``run_many`` filter / prioritize, preempt, bind) on 240 nodes; a
      restart: incarnation 1 runs ``run_pipelined`` over 6a's workload until
      the commit seam raises mid-batch, four pods that fit only by
      preemption arrive, incarnation 2 settles the cluster; bindings,
      ``recovered`` records and victims equal, every invariant held;
   b. full width: BASELINE.json's "InterPodAffinity / anti-affinity 5k pods
      x 5k nodes" behind the webhook: 5,120 nodes holding 6b's 5,120 bound
      pods, 1,024 further mixed pods as wire-JSON filter / prioritize
      requests over every node, through ``ExtenderCore.run_many`` in
      micro-batches of 256, then all at once through ``MicroBatcher``;
      requests/s, micro-batch p50 / p99 split into the host build and the
      card's evaluation, and domain_counts launches per evaluation (the
      same for every batch size); the first micro-batch's [256, 5,120]
      matrix equals the CPU's, 8 of its rows equal the NumPy oracle's
      feasible set and totals, and the kernel at each of its launches
      equals its plain version;
   c. full width: 6b's workload through ``run_until_settled`` with the
      anomaly sentinel and a bundle directory; a manual capture after the
      first batch replays bit-identically on the card and on the CPU.

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from kubernetes_tpu_torch import build  # noqa: E402
from kubernetes_tpu_torch import metrics  # noqa: E402
from kubernetes_tpu_torch.api.wrappers import MakeNode, MakePod  # noqa: E402
from kubernetes_tpu_torch.ops import domain_counts as dc  # noqa: E402
from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig  # noqa: E402
from kubernetes_tpu_torch.state.cluster import ClusterState  # noqa: E402
from kubernetes_tpu_torch.solver import grouped as gp  # noqa: E402
from kubernetes_tpu_torch.solver.exact import (  # noqa: E402
    ExactSolver,
    ExactSolverConfig,
)
from kubernetes_tpu_torch.tensorize.interpod import build_interpod_tensors  # noqa: E402
from kubernetes_tpu_torch.tensorize.plugins import (  # noqa: E402
    build_port_tensors,
    build_static_tensors,
)
from kubernetes_tpu_torch.tensorize.schema import (  # noqa: E402
    ResourceVocab,
    build_node_batch,
    build_nominated_tensors,
    build_pod_batch,
)
from kubernetes_tpu_torch.tensorize.spread import build_spread_tensors  # noqa: E402

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
SEED = 0
# H100 SXM: HBM3 at 3.35 TB/s; 67 TFLOP/s float32 outside the tensor
# cores, the table's rate for plain 32-bit lane arithmetic
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 67e12


def log(*a):
    print(*a, flush=True)


# -- the workload ----------------------------------------------------------


def make_nodes(n):
    return [
        MakeNode()
        .name(f"node-{i:05}")
        .capacity({"cpu": "16", "memory": "64Gi", "pods": "110"})
        .label(ZONE, f"z{i % 3}")
        .label(HOST, f"node-{i:05}")
        .obj()
        for i in range(n)
    ]


def make_pod(i):
    """Kinds cycle by i % 4: a hostPort, hard zone spread, required
    hostname anti-affinity, preferred zone affinity toward the spread group."""
    kind = ("ports", "spread", "anti", "pref")[i % 4]
    b = MakePod().name(f"pod-{i:05}").label("app", kind).req(
        {"cpu": "250m", "memory": "512Mi"}
    )
    if kind == "ports":
        b = b.host_port(8000 + i % 8)
    elif kind == "spread":
        b = b.spread_constraint(1, ZONE, "DoNotSchedule", {"app": "spread"})
    elif kind == "anti":
        b = b.pod_anti_affinity(HOST, {"app": "anti"})
    else:
        b = b.preferred_pod_affinity(50, ZONE, {"app": "spread"})
    return b.obj()


def make_kind_pod(kind, i):
    """One pod of a grouped configuration: 250m / 512Mi, plus one hard zone
    constraint (maxSkew 1) selecting its own label ("spread"), or one
    required hostname anti-affinity term selecting its own label ("anti")."""
    b = MakePod().name(f"{kind}-{i:05}").label("app", f"g-{kind}").req(
        {"cpu": "250m", "memory": "512Mi"}
    )
    if kind == "spread":
        b = b.spread_constraint(1, ZONE, "DoNotSchedule", {"app": "g-spread"})
    elif kind == "anti":
        b = b.pod_anti_affinity(HOST, {"app": "g-anti"})
    return b.obj()


def tensorize(nodes, pods, placed_by_node, vocab, nominated=()):
    """The scheduler's tensorize of one batch against the placed pods;
    with ``nominated`` (pod, node slot) pairs, also the nominated load and
    each batch pod's own nominated slot (as the JAX package's scheduler
    builds them: foreign nominations count in spread and interpod, batch
    pods' own do not)."""
    nb = build_node_batch(nodes, placed_by_node, vocab=vocab)
    pb = build_pod_batch(pods, vocab)
    slot_nodes = list(nodes) + [None] * (nb.padded - len(nodes))
    placed_by_slot = {
        i: placed_by_node[n.name] for i, n in enumerate(nodes) if n.name in placed_by_node
    }
    keys = {p.key for p in pods}
    peers = [(q, s) for q, s in nominated if q.key not in keys]
    static = build_static_tensors(pods, pb, slot_nodes, nb.padded)
    ports = build_port_tensors(pods, pb, slot_nodes, placed_by_slot, nb.padded,
                               nominated=list(nominated))
    spread = build_spread_tensors(
        pods, static.reps, pb, slot_nodes, placed_by_slot, nb.padded, static.c_pad,
        nominated=peers,
    )
    interpod = build_interpod_tensors(
        pods, static.reps, pb, slot_nodes, placed_by_slot, nb.padded, static.c_pad,
        nominated=peers,
    )
    inputs = (nb, pb, static, ports, spread, interpod)
    if not nominated:
        return inputs
    nom = build_nominated_tensors(list(nominated), vocab, nb.padded, ports=ports)
    slot_by_key = {p.key: s for p, s in nominated}
    slots = np.asarray([slot_by_key.get(p.key, -1) for p in pods], np.int32)
    return inputs, {"nominated": nom, "nominated_slot": slots}


def nominated_set(nodes, pods):
    """24 foreign pods nominated to nodes across the cluster at priorities
    5, 10 and 20, a third of them holding the mixed workload's hostPorts,
    and every 64th batch pod carrying its own nomination."""
    pairs = []
    for i in range(24):
        b = (MakePod().name(f"nom-{i:02}").req({"cpu": "2", "memory": "4Gi"})
             .priority((5, 10, 20)[i % 3]).scheduler_name("other-scheduler"))
        if i % 3 == 0:
            b = b.host_port(8000 + i % 8)
        pairs.append((b.obj(), (i * 37) % len(nodes)))
    pairs += [(pods[i], (i * 11) % len(nodes)) for i in range(0, len(pods), 64)]
    return pairs


# -- phase 1 ---------------------------------------------------------------


def environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    import importlib.util

    optional = {m: importlib.util.find_spec(m) is not None for m in ("aiohttp", "grpc", "yaml")}
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} optional packages {json.dumps(optional)}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, len(build.sources()))) as ex:
        libs = list(ex.map(build.compile_library, build.sources()))
    log(f"kernel build {time.perf_counter() - t0:.3f}s: "
        + ", ".join(p.name for p in libs))
    return smi


# -- phase 2 ---------------------------------------------------------------


def time_ms(fn, runs=20, calls=10, warmup=5):
    """Milliseconds per call: CUDA events around ``calls`` back-to-back
    calls, the median of ``runs`` such runs after warm-up. A call whose
    kernels finish before the host issues the next one is timed at the
    host's issue rate, which is what the scan pays per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def device_kernels(prof):
    from torch.autograd import DeviceType

    return [
        e for e in prof.events()
        if e.device_type == DeviceType.CUDA
        and not e.name.startswith(("Memcpy", "Memset"))
    ]


def device_ms(fn, calls=20):
    """The card's own time per call: the summed device time of the
    kernels ``calls`` calls ran, from torch.profiler, over ``calls``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    if not kernels:
        return "not measured"
    return sum(e.device_time_total for e in kernels) / 1e3 / calls


def _dev(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _library(sets, d_pad, counts, gather):
    """The fewest PyTorch calls that compute the same function: zero_ and
    one scatter_add_ over the flattened (row, domain) index of every set,
    then one gather for the per-node totals. Index preparation is left out
    of the timing. Returns (fn, result getter)."""
    dom = torch.cat([s[0] for s in sets])
    cnt = torch.cat([s[1] for s in sets])
    gdom = torch.cat([s[0] if s[2] is None else s[2] for s in sets])
    rows = dom.shape[0]
    ar = torch.arange(rows, device=dom.device)[:, None] * (d_pad + 1)
    ok = (dom >= 0) & (dom < d_pad)
    seg = (torch.where(ok, dom.to(torch.int64), d_pad) + ar).reshape(-1)
    gidx = torch.clamp(gdom, min=0).to(torch.int64)
    vals = cnt.reshape(-1)
    buf = torch.zeros(rows * (d_pad + 1), dtype=torch.int32, device=dom.device)
    state = {}

    def library():
        buf.zero_()
        buf.scatter_add_(0, seg, vals)
        if gather:
            state["tot"] = torch.gather(buf.view(rows, d_pad + 1), 1, gidx)

    def result():
        out = buf.view(rows, d_pad + 1)[:, :d_pad]
        return out if counts else None, state.get("tot")

    return library, result


def _max_err(got, want):
    """(max abs error, the first mismatch as text or None) over every
    output of every set."""
    err, first = 0, None
    for s, (g_pair, w_pair) in enumerate(zip(got, want)):
        for name, g, w in zip(("totals", "per-node"), g_pair, w_pair):
            if w is None:
                continue
            if g is None or g.shape != w.shape:
                raise AssertionError("kernel output missing or misshaped")
            if not g.numel():
                continue
            diff = (g.to(torch.int64) - w.to(torch.int64)).abs()
            e = int(diff.max())
            if e and first is None:
                at = tuple(int(i) for i in (diff > 0).nonzero()[0])
                first = (f"set {s} {name} {tuple(g.shape)} first differs at {at}: "
                         f"kernel {int(g[at])}, plain {int(w[at])}, "
                         f"{int((diff > 0).sum())} elements differ")
            err = max(err, e)
    return err, first


def check_exact(label, sets, d_pad, cluster=None):
    """Both outputs of one launch against the plain versions; exact. A
    mismatch names the seed, the shapes, the first differing index and
    both values."""
    got = dc.aggregate(sets, d_pad, cluster=cluster)
    want = dc.aggregate_plain(sets, d_pad)
    torch.cuda.synchronize()
    err, first = _max_err(got, want)
    if err:
        shapes = [tuple(x[0].shape) for x in sets]
        raise AssertionError(f"domain_counts {label} (seed {SEED}, T x N {shapes}, d_pad "
                             f"{d_pad}, cluster {cluster}): kernel != plain (max err {err}); "
                             f"{first}")
    return err


def kernel_case(label, sets, d_pad, counts=True, gather=True):
    """One case: the kernel against its plain version (exact, both outputs),
    then the kernel, plain and library times of the form the caller uses.
    ``ms`` times a prepared launch, as the scan makes it; ``oneshot_ms``
    times ``aggregate``, which checks and allocates on every call."""
    err = check_exact(label, sets, d_pad)
    rows = sum(s[0].shape[0] for s in sets)
    n = sets[0][0].shape[1]
    library, lib_result = _library(sets, d_pad, counts, gather)
    library()
    want = dc.aggregate_plain(sets, d_pad)
    lib_out, lib_tot = lib_result()
    if counts and not torch.equal(lib_out, torch.cat([w[0] for w in want])):
        raise AssertionError(f"domain_counts {label}: scatter_add_ yardstick disagrees")
    if gather and not torch.equal(lib_tot, torch.cat([w[1] for w in want])):
        raise AssertionError(f"domain_counts {label}: gather yardstick disagrees")
    adds = sum(int(((s[0] >= 0) & (s[0] < d_pad) & (s[1] != 0)).sum()) for s in sets)
    separate_gather = sum(s[0].numel() for s in sets if s[2] is not None)
    bytes_moved = (rows * n * 8 + (separate_gather * 4 if gather else 0)
                   + (rows * d_pad * 4 if counts else 0) + (rows * n * 4 if gather else 0))
    b_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    o_ms = (adds + (rows * n if gather else 0)) / LANE_OPS_PER_S * 1e3
    # the kernel as the scan calls it: prepared once, launched per call
    kernel = dc.Aggregation(sets, d_pad, counts=counts, gather=gather)

    def oneshot():
        dc.aggregate(sets, d_pad, counts=counts, gather=gather)

    def plain():
        dc.aggregate_plain(sets, d_pad, counts=counts, gather=gather)

    case = {
        "case": label,
        "shape": {"T": [s[0].shape[0] for s in sets], "N": n, "d_pad": d_pad},
        "outputs": [k for k, on in (("out", counts), ("tot", gather)) if on],
        "path": "global" if kernel.is_global else "shared",
        "cluster": kernel.cluster,
        "exact": True,
        "max_abs_err": err,
        "ms": time_ms(kernel),
        "oneshot_ms": time_ms(oneshot),
        "plain_ms": time_ms(plain),
        "library_ms": time_ms(library),
        "library": "zero_ + scatter_add_" + (" + gather" if gather else ""),
        "device_ms": device_ms(kernel),
        "plain_device_ms": device_ms(plain),
        "library_device_ms": device_ms(library),
        "bound_ms": max(b_ms, o_ms),
        "bound_by": "bytes" if b_ms >= o_ms else "operations",
    }
    log("kernel case " + json.dumps(case))
    return case


def cluster_sweep(sets, d_pad):
    """Every cluster size on the main path's launch: exact, then its per-call
    and device times."""
    out = []
    for c in (1, 2, 4, 8):
        check_exact(f"sweep C={c}", sets, d_pad, cluster=c)
        kernel = dc.Aggregation(sets, d_pad, counts=False, cluster=c)

        row = {"cluster": c, "ms": time_ms(kernel), "device_ms": device_ms(kernel)}
        out.append(row)
        log("cluster sweep " + json.dumps(row))
    return out


def coverage(dev, rng):
    """Every cluster size on both paths, exact."""
    ran = []
    for path, d_pad in (("shared", 8192), ("global", 2**19)):
        dom = _dev(rng.integers(-1, d_pad, (4, 5120)).astype(np.int32), dev)
        cnt = _dev(rng.integers(0, 4, (4, 5120)).astype(np.int32), dev)
        gdom = _dev(rng.integers(-1, d_pad, (4, 5120)).astype(np.int32), dev)
        for c in (1, 2, 4, 8):
            agg = dc.Aggregation([(dom, cnt, gdom)], d_pad, cluster=c)
            if agg.cluster != c or agg.is_global != (path == "global"):
                raise AssertionError(f"{path} C={c}: launched C={agg.cluster}")
            check_exact(f"{path} C={c}", [(dom, cnt, gdom)], d_pad, cluster=c)
            ran.append(f"{path} C={c}")
    log("coverage " + json.dumps(ran))
    return ran


def kernel_checks(dev, interpod, kind2, kind3):
    """``interpod``: the full-width mixed batch's interpod tensors;
    ``kind2``/``kind3``: the spread and interpod tensors of the grouped
    kind-2 and kind-3 runs' first batches."""
    rng = np.random.default_rng(SEED)
    # the main path's shapes: the full-width batch's real term rows, with
    # counts as a scan carries them
    ipa = []
    for name in ("in_dom", "ex_dom"):
        dom_np = getattr(interpod, name)
        ipa.append((_dev(dom_np, dev), _dev(rng.integers(0, 4, dom_np.shape).astype(np.int32), dev),
                    None))
    d = interpod.d_pad
    cases = [
        kernel_case("interpod in+ex, one launch (main path)", ipa, d, counts=False),
        kernel_case("interpod in_dom, counts only (the TPU kernel's function)",
                    ipa[:1], d, gather=False),
    ]
    # the grouped path's launches: a zone-spread row over its counted lanes,
    # gathered by its domain row (kind 2), and a hostname anti-affinity row
    # (kind 3); counts as a chunk's iterations carry them
    j = int(kind2.hard[kind2.hard[:, 0] >= 0][0, 0])
    dom = np.asarray(kind2.dom[j : j + 1], np.int32)
    counted = np.where(np.asarray(kind2.elig[j : j + 1]) & (dom >= 0), dom, -1).astype(np.int32)
    n = dom.shape[1]
    cases.append(kernel_case(
        "grouped spread row (kind 2)",
        [(_dev(counted, dev), _dev(rng.integers(0, 4, (1, n)).astype(np.int32), dev),
          _dev(dom, dev))], kind2.d_pad,
    ))
    j = int(kind3.cls_req_anti[kind3.cls_req_anti[:, 0] >= 0][0, 0])
    dom = np.ascontiguousarray(kind3.in_dom[j : j + 1], np.int32)
    n = dom.shape[1]
    cases.append(kernel_case(
        "grouped anti row (kind 3)",
        [(_dev(dom, dev), _dev(rng.integers(0, 2, (1, n)).astype(np.int32), dev), None)],
        kind3.d_pad,
    ))
    # one spread row at an untiled node count, gathered by its own domain row
    n = 5001
    dom = rng.integers(-1, 3, (1, n)).astype(np.int32)
    counted = np.where(rng.random((1, n)) < 0.8, dom, -1).astype(np.int32)
    cases.append(kernel_case(
        "spread T=1 N=5001 untiled",
        [(_dev(counted, dev), _dev(rng.integers(0, 4, (1, n)).astype(np.int32), dev),
          _dev(dom, dev))], 8,
    ))
    for label, t, n, d_pad in (
        ("d_pad=16384 at 10,240 nodes", 8, 10240, 16384),
        ("d_pad=65536 (cluster path)", 8, 5120, 65536),
        ("d_pad=2^19 beyond a cluster (global path)", 8, 5120, 2**19),
    ):
        dom = _dev(rng.integers(-1, min(d_pad, 2 * n), (t, n)).astype(np.int32), dev)
        cnt = _dev(rng.integers(0, 4, (t, n)).astype(np.int32), dev)
        cases.append(kernel_case(label, [(dom, cnt, None)], d_pad))
    paths = {c["path"] for c in cases}
    if paths != {"shared", "global"}:
        raise AssertionError(f"kernel paths exercised: {paths}")
    sweep = cluster_sweep(ipa, d)
    ran = coverage(dev, rng)
    return cases, sweep, ran


# -- phases 3 and 4 --------------------------------------------------------


def reduced_depth(dev):
    """The mixed workload and each grouped kind, with and without the
    nominated set: the card's solve equals the CPU's."""
    nodes = make_nodes(1024)
    workloads = {
        "mixed": [make_pod(i) for i in range(512)],
        **{k: [make_kind_pod(k, i) for i in range(512)] for k in ("plain", "spread", "anti")},
    }
    cfg = ExactSolverConfig(tie_break="first", balanced_fdtype="float64")
    rows = []
    for name, pods in workloads.items():
        vocab = ResourceVocab.build(pods, nodes)
        for nominated in (False, True):
            pairs = nominated_set(nodes, pods) if nominated else ()
            out = []
            for where in (dev, torch.device("cpu")):
                got = tensorize(nodes, pods, {}, vocab, pairs)
                inputs, extra = got if nominated else (got, {})
                solver = ExactSolver(cfg)
                t0 = time.perf_counter()
                a = solver.solve(*inputs, device=where, **extra)
                out.append((a, inputs[0], time.perf_counter() - t0,
                            dict(solver.dispatch_counts)))
            (a_gpu, nb_gpu, s_gpu, d_gpu), (a_cpu, nb_cpu, s_cpu, d_cpu) = out
            label = f"{name}{' + nominated' if nominated else ''}"
            if not np.array_equal(a_gpu, a_cpu):
                bad = np.flatnonzero(a_gpu != a_cpu)
                raise AssertionError(f"{label}: card != CPU at {bad.size} pods, first {bad[:5]}")
            for k in ("used", "nonzero_used", "pod_count"):
                if not np.array_equal(getattr(nb_gpu, k), getattr(nb_cpu, k)):
                    raise AssertionError(f"{label}: card != CPU in written-back {k}")
            if d_gpu != d_cpu:
                raise AssertionError(f"{label}: dispatch {d_gpu} != {d_cpu}")
            want = {"plain": "kind1", "spread": "kind2", "anti": "kind3"}.get(name, "scan")
            if (want if not nominated else "scan") not in d_gpu:
                raise AssertionError(f"{label}: expected {want} in the dispatch, got {d_gpu}")
            row = {"workload": label, "placed": int((a_gpu >= 0).sum()), "dispatch": d_gpu,
                   "card_s": s_gpu, "cpu_s": s_cpu}
            rows.append(row)
            log("reduced depth 1024 nodes x 512 pods: card == CPU " + json.dumps(row))
    return rows


def full_width(dev, n_nodes=5120, n_pods=5120, batch=1024):
    nodes = make_nodes(n_nodes)
    pods = [make_pod(i) for i in range(n_pods)]
    vocab = ResourceVocab.build(pods, nodes)
    solver = ExactSolver(ExactSolverConfig(tie_break="first"))
    placed: dict[str, list] = {}
    where = {}
    tens_s, solve_s, first_interpod = [], [], None
    dc.LAUNCHES = 0
    t_start = time.perf_counter()
    for lo in range(0, n_pods, batch):
        bp = pods[lo : lo + batch]
        t0 = time.perf_counter()
        nb, pb, static, ports, spread, interpod = tensorize(nodes, bp, placed, vocab)
        if first_interpod is None:
            first_interpod = interpod
            if interpod.ident:
                raise AssertionError("zone terms must make ident False")
        t1 = time.perf_counter()
        a = solver.solve(nb, pb, static, ports, spread, interpod, device=dev)
        t2 = time.perf_counter()
        tens_s.append(t1 - t0)
        solve_s.append(t2 - t1)
        for i, s in enumerate(a):
            if s >= 0:
                placed.setdefault(nodes[s].name, []).append(bp[i])
                where[lo + i] = int(s)
    wall = time.perf_counter() - t_start
    launches = dc.LAUNCHES

    # invariants
    if len(where) != n_pods:
        raise AssertionError(f"only {len(where)}/{n_pods} pods placed")
    cpu = np.zeros(n_nodes, np.int64)
    mem = np.zeros(n_nodes, np.int64)
    cnt = np.zeros(n_nodes, np.int64)
    ports: dict[int, set] = {}
    anti = np.zeros(n_nodes, np.int64)
    zones = np.zeros(3, np.int64)
    for i, s in where.items():
        cpu[s] += 250
        mem[s] += 512 * 1024**2
        cnt[s] += 1
        kind = i % 4
        if kind == 0:
            p = 8000 + i % 8
            if p in ports.setdefault(s, set()):
                raise AssertionError(f"node {s} holds hostPort {p} twice")
            ports[s].add(p)
        elif kind == 1:
            zones[s % 3] += 1
        elif kind == 2:
            anti[s] += 1
    if (cpu > 16000).any() or (mem > 64 * 1024**3).any() or (cnt > 110).any():
        raise AssertionError("a node is over its cpu, memory or pod capacity")
    if zones.max() - zones.min() > 1:
        raise AssertionError(f"app=spread zone counts {zones.tolist()} skew > 1")
    if anti.max() > 1:
        raise AssertionError("a node holds two app=anti pods")
    if launches <= 0:
        raise AssertionError("the main path launched no domain_counts kernel")
    res = {
        "nodes": n_nodes, "pods": n_pods, "batch": batch, "placed": len(where),
        "wall_s": wall, "pods_per_s": n_pods / wall,
        "solve_s": solve_s, "tensorize_s": tens_s,
        "domain_counts_launches": launches,
        "launches_per_step": launches / n_pods,
        "spread_zone_counts": zones.tolist(),
        "interpod_d_pad": first_interpod.d_pad,
        "dispatch": dict(solver.dispatch_counts),
    }
    log("full width " + json.dumps(res))
    return res


GROUPED_RUNS = (
    # (kind, nodes, pods, batch)
    ("spread", 5120, 10240, 1024),
    ("anti", 5120, 4096, 1024),
    ("plain", 1024, 5120, 1024),
)


def _check_grouped(kind, where, n_nodes, zones_after):
    """The configuration's invariants over every placement so far."""
    cnt = np.bincount(np.fromiter(where.values(), np.int64), minlength=n_nodes)
    # 250m / 512Mi pods on 16 CPU / 64Gi / 110-pod nodes: cpu binds first
    if (cnt * 250 > 16000).any() or (cnt * 512 > 64 * 1024).any() or (cnt > 110).any():
        raise AssertionError(f"{kind}: a node is over its cpu, memory or pod capacity")
    if kind == "anti" and cnt.max() > 1:
        raise AssertionError("anti: a node holds two pods of the anti-affinity group")
    for z in zones_after:
        if z.max() - z.min() > 1:
            raise AssertionError(f"spread: zone counts {z.tolist()} skew > 1 after a batch")


def grouped_run(dev, kind, n_nodes, n_pods, batch, tie):
    """One grouped configuration through the standalone solve, batch by
    batch; the kernel's launch count and the random loop's device reads
    are set to 0 just before and read just after."""
    nodes = make_nodes(n_nodes)
    pods = [make_kind_pod(kind, i) for i in range(n_pods)]
    vocab = ResourceVocab.build(pods, nodes)
    solver = ExactSolver(ExactSolverConfig(tie_break=tie, seed=SEED))
    placed: dict[str, list] = {}
    where: dict[int, int] = {}
    zones_after, per_batch, tens_s, solve_s, h2d = [], [], [], [], []
    dc.LAUNCHES = 0
    gp.READS = 0
    for lo in range(0, n_pods, batch):
        bp = pods[lo : lo + batch]
        t0 = time.perf_counter()
        inputs = tensorize(nodes, bp, placed, vocab)
        t1 = time.perf_counter()
        h2d0 = metrics.h2d_bytes_total.value()
        a = solver.solve(*inputs, device=dev)
        t2 = time.perf_counter()
        tens_s.append(t1 - t0)
        solve_s.append(t2 - t1)
        h2d.append(metrics.h2d_bytes_total.value() - h2d0)
        per_batch.append(a)
        for i, s_ in enumerate(a):
            if s_ >= 0:
                placed.setdefault(nodes[s_].name, []).append(bp[i])
                where[lo + i] = int(s_)
        if kind == "spread":
            zones_after.append(np.bincount(np.fromiter(where.values(), np.int64) % 3,
                                           minlength=3))
    launches, reads = dc.LAUNCHES, gp.READS
    if len(where) != n_pods:
        raise AssertionError(f"{kind} {tie}: only {len(where)}/{n_pods} pods placed")
    _check_grouped(kind, where, n_nodes, zones_after)
    want = {"plain": "kind1", "spread": "kind2", "anti": "kind3"}[kind]
    chunks = solver.dispatch_counts[want]
    if chunks != n_pods // 64:
        raise AssertionError(f"{kind} {tie}: dispatch {dict(solver.dispatch_counts)}")
    if kind != "plain" and launches <= 0:
        raise AssertionError(f"{kind} {tie}: the grouped path launched no domain_counts")
    res = {
        "kind": kind, "tie_break": tie, "nodes": n_nodes, "pods": n_pods, "batch": batch,
        "placed": len(where), "pods_per_s": n_pods / (sum(tens_s) + sum(solve_s)),
        "solve_pods_per_s": n_pods / sum(solve_s), "solve_s": solve_s, "tensorize_s": tens_s,
        "domain_counts_launches": launches, "device_reads": reads,
        "device_reads_per_chunk": reads / chunks, "h2d_bytes_per_batch": h2d,
        "dispatch": dict(solver.dispatch_counts),
    }
    if tie == "first":
        # the grouped solve of the first batch equals the per-pod scan's
        scan = ExactSolver(ExactSolverConfig(tie_break="first", group_size=0)).solve(
            *tensorize(nodes, pods[:batch], {}, vocab), device=dev)
        if not np.array_equal(scan, per_batch[0]):
            bad = np.flatnonzero(scan != per_batch[0])
            raise AssertionError(f"{kind}: grouped != scan at {bad.size} pods, first {bad[:5]}")
        res["first_batch_equals_scan"] = True
    log("grouped " + json.dumps(res))
    return res, per_batch


def _gather(handles, n):
    out = np.full(n, -1, np.int64)
    for h in handles:
        out[h.lo : h.lo + h.count] = h.get()
    return out


def session_run(dev, variant, want, n_nodes=5120, n_pods=10240, batch=1024):
    """The kind-2 configuration through the device session, "first" mode:
    ``variant`` "session" (blocking reads), "deferred" (DeferredAssignments),
    "split" (4 chained sub-batches) or "stream" (the carry kept across
    batches and chained on when ``can_chain``). The caller applies each
    batch's placements and bumps the version of each column it writes, as
    the scheduler's snapshot does. Every batch must equal ``want``."""
    nodes = make_nodes(n_nodes)
    pods = [make_kind_pod("spread", i) for i in range(n_pods)]
    vocab = ResourceVocab.build(pods, nodes)
    solver = ExactSolver(ExactSolverConfig(tie_break="first", seed=SEED))
    placed: dict[str, list] = {}
    versions = None
    solve_s, get_s, h2d, chained = [], [], [], 0
    dc.LAUNCHES = 0
    for b, lo in enumerate(range(0, n_pods, batch)):
        bp = pods[lo : lo + batch]
        inputs = tensorize(nodes, bp, placed, vocab)
        if versions is None:
            versions = np.zeros(inputs[0].padded, np.int64)
        kw = {"col_versions": versions.copy(), "device": dev}
        h2d0 = metrics.h2d_bytes_total.value()
        t1 = time.perf_counter()
        if variant == "session":
            a = solver.solve(*inputs, **kw)
            t2 = t3 = time.perf_counter()
        elif variant == "deferred":
            h = solver.solve(*inputs, defer_read=True, **kw)
            t2 = time.perf_counter()
            a = h.get()
            t3 = time.perf_counter()
        elif variant == "split":
            hs = solver.solve(*inputs, defer_read=True, split=4, **kw)
            t2 = time.perf_counter()
            a = _gather(hs, len(bp))
            t3 = time.perf_counter()
        else:
            key = solver.stream_chain_key(*inputs)
            chain = solver.can_chain(key, versions)
            chained += chain
            # a chained dispatch defers the heal: the carry holds the
            # placements the applied columns record
            hs = solver.solve(*inputs, defer_read=True, stream_carry_out=True, chain_key=key,
                              chain_occupancy=chain, allow_heal=not chain, **kw)
            t2 = time.perf_counter()
            a = _gather(hs, len(bp))
            t3 = time.perf_counter()
        solve_s.append(t2 - t1)
        get_s.append(t3 - t2)
        h2d.append(metrics.h2d_bytes_total.value() - h2d0)
        if not np.array_equal(a, want[b]):
            bad = np.flatnonzero(np.asarray(a) != want[b])
            raise AssertionError(f"session {variant} batch {b}: != standalone at {bad.size} pods")
        for i, s_ in enumerate(a):
            if s_ >= 0:
                placed.setdefault(nodes[s_].name, []).append(bp[i])
                versions[s_] += 1
        if variant == "stream":
            solver.note_stream_applied(versions)
    launches = dc.LAUNCHES
    if variant == "stream" and chained != n_pods // batch - 1:
        raise AssertionError(f"stream: chained {chained} of {n_pods // batch - 1} batches")
    if launches <= 0:
        raise AssertionError(f"session {variant}: no domain_counts launch")
    res = {"variant": variant, "solve_s": solve_s, "read_s": get_s,
           "solve_pods_per_s": n_pods / (sum(solve_s) + sum(get_s)),
           "domain_counts_launches": launches, "chained_batches": chained,
           "h2d_bytes_per_batch": h2d, "dispatch": dict(solver.dispatch_counts)}
    log("session " + json.dumps(res))
    return res


# -- phase 5 ---------------------------------------------------------------


def launches_per_step(dev, small=64, large=128):
    """Kernels the card runs per scan step, from torch.profiler: two
    solves of the workload on the full-width node set that differ only by
    ``large - small`` pods (the kinds cycle every 4 pods), so the upload
    and the final read cancel out of the difference. Also the device's
    busy share of the larger solve: summed kernel time over its wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    nodes = make_nodes(5120)
    out = {}
    for n_pods in (small, large):
        pods = [make_pod(i) for i in range(n_pods)]
        inputs = tensorize(nodes, pods, {}, ResourceVocab.build(pods, nodes))
        solver = ExactSolver(ExactSolverConfig(tie_break="first"))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solver.solve(*inputs, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = device_kernels(prof)
        out[n_pods] = (len(kernels), sum(e.device_time_total for e in kernels) / 1e6, wall)
        names = Counter(e.name[:60] for e in kernels)
    if not out[large][0]:
        res = {"per_step": "not measured"}
    else:
        res = {
            "per_step": (out[large][0] - out[small][0]) / (large - small),
            "kernels": {str(k): v[0] for k, v in out.items()},
            "device_busy_s": out[large][1],
            "wall_s": out[large][2],
            "device_busy_share": out[large][1] / out[large][2],
            "top_kernels": names.most_common(12),
        }
    log("launches per step " + json.dumps(res))
    return res


def grouped_launches(dev, small=128, large=256):
    """Torch kernels the card runs per placed pod on the grouped path, per
    kind and mode, by the difference of two solves of ``small`` and
    ``large`` pods (2 and 4 chunks of 64) on the kind's node set; the
    device's busy share of the larger solve; and the random loop's device
    reads per chunk."""
    from torch.profiler import ProfilerActivity, profile

    res = {}
    for kind, n_nodes, _, _ in GROUPED_RUNS:
        nodes = make_nodes(n_nodes)
        for tie in ("first", "random"):
            out = {}
            for n_pods in (small, large):
                pods = [make_kind_pod(kind, i) for i in range(n_pods)]
                inputs = tensorize(nodes, pods, {}, ResourceVocab.build(pods, nodes))
                solver = ExactSolver(ExactSolverConfig(tie_break=tie, seed=SEED))
                gp.READS = 0
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    a = solver.solve(*inputs, device=dev)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                if (a < 0).any():
                    raise AssertionError(f"{kind} {tie}: a pod of the launch count went unplaced")
                kernels = device_kernels(prof)
                out[n_pods] = (len(kernels), sum(e.device_time_total for e in kernels) / 1e6,
                               wall, gp.READS)
            key = f"{kind}/{tie}"
            if not out[large][0]:
                res[key] = {"per_placed_pod": "not measured"}
                continue
            res[key] = {
                "per_placed_pod": (out[large][0] - out[small][0]) / (large - small),
                "kernels": {str(k): v[0] for k, v in out.items()},
                "device_busy_s": out[large][1],
                "wall_s": out[large][2],
                "device_busy_share": out[large][1] / out[large][2],
                "device_reads_per_chunk": out[large][3] / (large // 64),
            }
    log("grouped launches per placed pod " + json.dumps(res))
    return res

# -- phase 6: the Scheduler ------------------------------------------------

PROFILE = "default-scheduler"


def _counter_total(counter):
    return sum(child.value() for _, child in counter.children())


class TopTier:
    """Holds a Scheduler to its top ladder tier for a whole run: after
    every batch the solve-tier gauge must read the top rung, no batch may
    have taken the host rung or been quarantined, and at the end no
    breaker transition, batch failure or fallback solve may have been
    counted."""

    def __init__(self, sched, label):
        self.sched, self.label = sched, label
        self.before = self._counts()

    @staticmethod
    def _counts():
        return {
            "breaker_transitions": _counter_total(metrics.breaker_transitions_total),
            "batch_failures": _counter_total(metrics.batch_failure_total),
            "fallback_solves": _counter_total(metrics.fallback_solves_total),
            "quarantined": metrics.quarantined_pods_total.value(),
        }

    def batch(self, res):
        s = self.sched
        tier = metrics.solve_tier.labels(PROFILE).value()
        if tier != 0:
            raise AssertionError(f"{self.label}: a batch ran at ladder rung {tier}")
        if any(t != s.resilience.ladder[0] for t in s._tier_last.values()):
            raise AssertionError(f"{self.label}: a batch descended: {s._tier_last}")
        if res.quarantined:
            raise AssertionError(f"{self.label}: quarantined {res.quarantined[:4]}")

    def close(self):
        after = self._counts()
        moved = {k: after[k] - self.before[k] for k in after if after[k] != self.before[k]}
        if moved or self.sched.resilience.trips or self.sched.resilience.rebuilds:
            raise AssertionError(f"{self.label}: left the top tier: {moved}, "
                                 f"{self.sched.resilience.summary()}")
        return {"ladder": list(self.sched.resilience.ladder), "top_tier_held": True}


def drain(sched, label, max_batches=10_000):
    """run_until_settled, batch by batch, with the readings of one run:
    pods bound per second from the first schedule_batch to the last bind,
    the wall split, each pod's time from queue add to bind, and the
    kernel's launches (its count set to 0 just before and read just
    after)."""
    guard = TopTier(sched, label)
    tens0 = metrics.tensorize_seconds.sum()
    dc.LAUNCHES = 0
    results = []
    t0 = time.perf_counter()
    idle_until = None
    for _ in range(max_batches):
        r = sched.schedule_batch()
        guard.batch(r)
        if not r.progressed:
            # pods still in their backoff (preemptors whose victims just
            # went): wait it out on the real clock, up to 10 s idle
            if sched.queue.pending_counts()["backoff"]:
                idle_until = idle_until or time.perf_counter() + 10.0
                if time.perf_counter() < idle_until:
                    time.sleep(0.02)
                    continue
            break
        idle_until = None
        results.append(r)
    launches = dc.LAUNCHES
    bound = sum(len(r.scheduled) for r in results)
    last_bind = max((r.completed_at for r in results if r.scheduled), default=t0)
    wall = max(last_bind - t0, 1e-9)
    tens = metrics.tensorize_seconds.sum() - tens0
    solve = sum(r.solve_seconds for r in results)
    apply_ = sum(r.host_seconds for r in results) - tens
    lat = np.asarray([x for r in results for x in r.e2e_latencies], np.float64)
    reading = {
        "batches": len(results), "bound": bound,
        "unschedulable": sum(len(r.unschedulable) for r in results),
        "wall_s": wall, "pods_bound_per_s": bound / wall,
        "tensorize_s": tens, "solve_s": solve, "apply_s": apply_,
        "commit_s": wall - tens - solve - apply_,
        "latency_p50_s": float(np.percentile(lat, 50)) if lat.size else None,
        "latency_p99_s": float(np.percentile(lat, 99)) if lat.size else None,
        "domain_counts_launches": launches,
        **guard.close(),
    }
    return results, reading


def _cluster(nodes, pods=()):
    cs = ClusterState()
    cs.create_nodes(nodes)
    cs.create_pods(pods)
    return cs


def _bindings(cs):
    return {p.key: p.node_name for p in cs.list_pods()}


def check_cluster(cs, label):
    """The mixed workload's invariants over the bound pods of ``cs``:
    capacity, hostPorts, the app=spread zone skew and the app=anti
    hostname exclusivity."""
    nodes = {n.name: n for n in cs.list_nodes()}
    used, ports, anti, zones = {}, set(), set(), Counter()
    for p in cs.list_pods():
        if not p.node_name:
            continue
        for r, v in p.resource_request().items():
            used[(p.node_name, r)] = used.get((p.node_name, r), 0) + v
        used[(p.node_name, "count")] = used.get((p.node_name, "count"), 0) + 1
        for hp in p.host_ports():
            if (p.node_name, hp) in ports:
                raise AssertionError(f"{label}: hostPort {hp} twice on {p.node_name}")
            ports.add((p.node_name, hp))
        app = p.labels.get("app")
        if app == "anti":
            if p.node_name in anti:
                raise AssertionError(f"{label}: two app=anti pods on {p.node_name}")
            anti.add(p.node_name)
        elif app == "spread":
            zones[nodes[p.node_name].labels[ZONE]] += 1
    for (node, r), v in used.items():
        cap = nodes[node].allowed_pod_number if r == "count" else nodes[node].allocatable.get(r)
        if r != "pods" and cap is not None and v > cap:
            raise AssertionError(f"{label}: {node} over its {r}")
    if zones and max(zones.values()) - min(zones.get(f"z{z}", 0) for z in range(3)) > 1:
        raise AssertionError(f"{label}: app=spread zone counts {dict(zones)} skew > 1")


def scheduler_mixed(dev, n_nodes=240, n_pods=480, batch=128):
    """6a, the mixed run: returns the bindings, nominations and batch
    results on ``dev``."""
    nodes = make_nodes(n_nodes)
    nominee = (MakePod().name("nominee").req({"cpu": "1", "memory": "1Gi"}).priority(10)
               .nominated_node_name(nodes[7].name).obj())
    cs = _cluster(nodes, [nominee] + [make_pod(i) for i in range(n_pods // 2)])
    sched = Scheduler(cs, SchedulerConfig(
        batch_size=batch,
        solver=ExactSolverConfig(tie_break="first", balanced_fdtype="float64")), device=dev)
    guard = TopTier(sched, f"6a mixed {dev.type}")
    views = []

    def step():
        r = sched.schedule_batch()
        guard.batch(r)
        views.append((list(r.scheduled), list(r.unschedulable), list(r.preemptions)))
        return r

    step()
    extra = (MakeNode().name(f"node-{n_nodes:05}")
             .capacity({"cpu": "16", "memory": "64Gi", "pods": "110"})
             .label(ZONE, "z0").label(HOST, f"node-{n_nodes:05}").obj())
    cs.create_node(extra)
    cs.create_pods([make_pod(i) for i in range(n_pods // 2, 3 * n_pods // 4)])
    step()
    victim = sorted(k for k, v in _bindings(cs).items() if v and "/pod-" in k)[0]
    cs.delete_pod(*victim.split("/"))
    cs.create_pods([make_pod(i) for i in range(3 * n_pods // 4, n_pods)])
    while step().progressed:
        pass
    guard.close()
    check_cluster(cs, f"6a mixed {dev.type}")
    if not cs.get_pod("default", "nominee").node_name:
        raise AssertionError("6a mixed: the nominated pod did not bind")
    noms = {p.key: p.nominated_node_name for p in cs.list_pods()}
    return _bindings(cs), noms, views


def _full_nodes(n_nodes, per_node):
    """``n_nodes`` nodes each full of ``per_node`` low-priority pods,
    created bound; the preemptor shape takes one of their slots."""
    nodes = make_nodes(n_nodes)
    cpu, mem = 16000 // per_node, 64 * 1024 // per_node
    low = [
        MakePod().name(f"low-{i:05}-{j}").node(n.name).priority(1 + (i + j) % 3)
        .start_time(float(j)).label("app", "low").req({"cpu": f"{cpu}m", "memory": f"{mem}Mi"})
        .obj()
        for i, n in enumerate(nodes) for j in range(per_node)
    ]
    shape = {"cpu": f"{cpu}m", "memory": f"{mem}Mi"}
    return nodes, low, shape


def scheduler_preempt(dev, n_nodes, n_preemptors, per_node=16, batch=1024, time_dry_runs=False):
    """The preemption run on ``dev``: returns (bindings, nominations,
    preemptions, reading)."""
    nodes, low, shape = _full_nodes(n_nodes, per_node)
    cs = _cluster(nodes, low)
    sched = Scheduler(cs, SchedulerConfig(
        batch_size=batch,
        solver=ExactSolverConfig(tie_break="first", balanced_fdtype="float64")), device=dev)
    dry = {"n": 0, "s": 0.0}
    evaluate = sched.preemptor.evaluate

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return evaluate(*a, **kw)
        finally:
            dry["n"] += 1
            dry["s"] += time.perf_counter() - t0

    sched.preemptor.evaluate = timed
    cs.create_pods([MakePod().name(f"vip-{k:04}").priority(100).req(shape).obj()
                    for k in range(n_preemptors)])
    results, reading = drain(sched, f"6d preemption {dev.type}")
    preemptions = [x for r in results for x in r.preemptions]
    prio = {p.key: p.effective_priority for p in low}
    if len(preemptions) != n_preemptors:
        raise AssertionError(f"preemption: {len(preemptions)} of {n_preemptors} nominated")
    for pod, node, victims in preemptions:
        if not victims or any(prio[v] >= 100 for v in victims):
            raise AssertionError(f"preemption: {pod} on {node} took victims {victims}")
    vips = [p for p in cs.list_pods() if p.name.startswith("vip-")]
    if not all(p.node_name for p in vips):
        raise AssertionError("preemption: a preemptor was not bound after its victims went")
    if any(p.node_name != node for p in vips for k, node, _ in preemptions if k == p.key):
        raise AssertionError("preemption: a preemptor bound off its nominated node")
    check_cluster(cs, f"preemption {dev.type}")
    reading.update({
        "nodes": n_nodes, "low_priority_pods": len(low), "preemptors": n_preemptors,
        "victims": sum(len(v) for _, _, v in preemptions),
        "dry_runs": dry["n"], "dry_run_s": dry["s"],
        "dry_runs_per_s": dry["n"] / dry["s"] if dry["s"] else None,
    })
    if time_dry_runs:
        (reading["torch_launches_per_dry_run"], reading["torch_launches_each_dry_run"],
         reading["dry_run_kernels_that_varied"]) = dry_run_launches(dev, nodes, low, shape)
    noms = {p.key: p.nominated_node_name for p in cs.list_pods()}
    return _bindings(cs), noms, preemptions, reading


def dry_run_launches(dev, nodes, low, shape, runs=4):
    """Torch kernels the card runs per preemption dry-run, from
    torch.profiler around each of ``runs`` dry-runs of a preemptor against
    the full cluster (outside the main path: its kernel counts are not
    read). Returns (mean, the count of each run, and the kernels whose
    count differed between the runs, by name)."""
    from torch.profiler import ProfilerActivity, profile

    from kubernetes_tpu_torch.solver.preemption import PreemptionEvaluator

    cs = _cluster(nodes, low)
    sched = Scheduler(cs, SchedulerConfig(), device=dev)
    sched.snapshot.update(sched.cache)
    placed = sched._placed_by_slot()
    batch = sched.snapshot.batch
    static_row = np.ones(batch.padded, bool)
    ev = PreemptionEvaluator(device=dev)
    pod = MakePod().name("probe").priority(100).req(shape).obj()
    ev._dry_run(pod, batch, placed, static_row, [])  # warm-up
    torch.cuda.synchronize()
    per_run = []
    for _ in range(runs):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ev._dry_run(pod, batch, placed, static_row, [])
            torch.cuda.synchronize()
        per_run.append(Counter(e.name for e in device_kernels(prof)))
    counts = [sum(c.values()) for c in per_run]
    names = set().union(*per_run)
    differ = {k: [c[k] for c in per_run] for k in sorted(names)
              if len({c[k] for c in per_run}) > 1}
    mean = sum(counts) / runs if any(counts) else "not measured"
    return mean, counts, differ


def scheduler_random(dev, n_nodes, n_pods, batch=1024, label="6c"):
    """The production default config (tie_break "random", group 64) over
    plain 250m / 512Mi pods; returns the reading."""
    nodes = make_nodes(n_nodes)
    t0 = time.perf_counter()
    cs = _cluster(nodes)
    sched = Scheduler(cs, SchedulerConfig(batch_size=batch, solver=ExactSolverConfig(seed=SEED)),
                      device=dev)
    cs.create_pods([
        MakePod().name(f"plain-{i:06}").req({"cpu": "250m", "memory": "512Mi"}).obj()
        for i in range(n_pods)
    ])
    setup = time.perf_counter() - t0
    if sched.solver.config.tie_break != "random" or sched.solver.config.group_size != 64:
        raise AssertionError("the production default config is random, group 64")
    results, reading = drain(sched, f"{label} {dev.type}")
    if reading["bound"] != n_pods:
        raise AssertionError(f"{label}: {reading['bound']} of {n_pods} bound")
    check_cluster(cs, label)
    reading.update({"nodes": n_nodes, "pods": n_pods, "setup_s": setup,
                    "dispatch": dict(sched.solver.dispatch_counts)})
    return reading


def scheduler_phase(dev, full=(5120, 5120), north_star=(10_000, 50_000), preempt=(5120, 128)):
    """6a-6d; the keyword sizes are the full-width shapes (smaller ones
    rehearse the phase on the CPU)."""
    cpu = torch.device("cpu")
    out = {}
    # 6a: card == CPU at reduced depth
    b_dev, n_dev, v_dev = scheduler_mixed(dev)
    b_cpu, n_cpu, v_cpu = scheduler_mixed(cpu)
    if b_dev != b_cpu or n_dev != n_cpu or v_dev != v_cpu:
        bad = [k for k in b_cpu if b_dev.get(k) != b_cpu[k]]
        raise AssertionError(f"6a mixed: card != CPU ({len(bad)} bindings differ, first {bad[:4]})")
    pb_dev, pn_dev, pp_dev, pr_dev = scheduler_preempt(dev, 64, 16, batch=64)
    pb_cpu, pn_cpu, pp_cpu, _ = scheduler_preempt(cpu, 64, 16, batch=64)
    if pb_dev != pb_cpu or pn_dev != pn_cpu or pp_dev != pp_cpu:
        raise AssertionError("6a preemption: card != CPU in bindings, nominations or victims")
    r_dev = scheduler_random(dev, 256, 4096, label="6a random")
    r_cpu = scheduler_random(cpu, 256, 4096, label="6a random")
    out["6a"] = {
        "mixed": {"batches": len(v_dev), "bound": sum(1 for v in b_dev.values() if v),
                  "card_equals_cpu": True},
        "preemption": {"preemptions": len(pp_dev), "card_equals_cpu": True,
                       "domain_counts_launches": pr_dev["domain_counts_launches"]},
        "random": {"bound": r_dev["bound"], "invariants_held_card_and_cpu": True,
                   "cpu_bound": r_cpu["bound"]},
    }
    log("scheduler 6a " + json.dumps(out["6a"]))
    # 6b: full width, parity mode
    (n_nodes, n_pods), batch = full, 1024
    t0 = time.perf_counter()
    cs = _cluster(make_nodes(n_nodes))
    sched = Scheduler(cs, SchedulerConfig(
        batch_size=batch,
        solver=ExactSolverConfig(tie_break="first", balanced_fdtype="float64")), device=dev)
    cs.create_pods([make_pod(i) for i in range(n_pods)])
    setup = time.perf_counter() - t0
    _, reading = drain(sched, "6b")
    if reading["bound"] != n_pods:
        raise AssertionError(f"6b: {reading['bound']} of {n_pods} bound")
    check_cluster(cs, "6b")
    if reading["domain_counts_launches"] <= 0:
        raise AssertionError("6b: the Scheduler's solves launched no domain_counts kernel")
    reading.update({"nodes": n_nodes, "pods": n_pods, "batch": batch, "setup_s": setup,
                    "dispatch": dict(sched.solver.dispatch_counts)})
    out["6b"] = reading
    out["6b_bindings"] = _bindings(cs)
    log("scheduler 6b " + json.dumps(reading))
    # 6c: full width, the production default config
    out["6c"] = scheduler_random(dev, *north_star)
    log("scheduler 6c " + json.dumps(out["6c"]))
    # 6d: full width, preemption
    _, _, _, out["6d"] = scheduler_preempt(dev, *preempt, time_dry_runs=dev.type == "cuda")
    log("scheduler 6d " + json.dumps(out["6d"]))
    return out


# -- phase 7: the pipelined and streaming loops, the backlog drain -----------

MODES = ("overlap", "carry", "sync", "stream")


def _loop_counts():
    return {
        **{f"mode_{m}": metrics.pipeline_mode_total.labels(m).value() for m in MODES},
        "fallbacks": metrics.pipeline_fallback_total.value(),
        "slot_discards": metrics.stream_slot_discard_total.value(),
        "discarded": metrics.solves_discarded_total.value(),
        "unhidden_reads": metrics.stream_unhidden_reads_total.value(),
        "subbatches": metrics.pipeline_subbatches_total.value(),
    }


class LoopGuard(TopTier):
    """TopTier over one run of a loop, and the loops' own degraded paths:
    no batch may have been routed to the synchronous cycle (by
    resilience.should_sync or the livelock backstop), and, outside the
    fence case, no solve or stream slot discarded."""

    def __init__(self, sched, label, fence_case=False):
        super().__init__(sched, label)
        self.fence_case = fence_case
        self.loop0 = _loop_counts()

    def close(self):
        out = super().close()
        now = _loop_counts()
        delta = {k: now[k] - self.loop0[k] for k in now}
        if delta["mode_sync"] or delta["fallbacks"]:
            raise AssertionError(f"{self.label}: a batch took the synchronous cycle: {delta}")
        if not self.fence_case and (delta["slot_discards"] or delta["discarded"]):
            raise AssertionError(f"{self.label}: a solve was discarded: {delta}")
        out["loop_counters"] = delta
        return out


def run_loop(sched, loop, **kw):
    """One call of ``loop``: its BatchResults and the drain report, if any."""
    if loop == "settled":
        return sched.run_until_settled(), None
    if loop == "pipelined":
        return sched.run_pipelined(), None
    if loop == "streaming":
        return sched.run_streaming(), None
    rep = sched.drain_backlog(**kw)
    return rep.results, rep


def loop_reading(sched, loop, label, **kw):
    """One run of ``loop`` with its readings: pods bound per second (call
    to last bind), p50 / p99 from queue add to bind, the modes taken,
    chained slots, paid and hidden reads, the blocking read and dispatch
    seconds of the deferred flights, and the kernel's launches (its count
    set to 0 just before the run and read just after)."""
    import gc

    gc.collect()  # each run starts from the same collector state
    guard = LoopGuard(sched, label)
    timing = {"read_s": 0.0, "dispatch_s": 0.0, "flights": 0}
    note = sched._note_flight_timing

    def timed(flight, n_pods):
        timing["read_s"] += flight.read_seconds
        timing["dispatch_s"] += flight.dispatch_seconds
        timing["flights"] += 1
        note(flight, n_pods)

    sched._note_flight_timing = timed
    chained0 = sched.solver.dispatch_counts.get("stream_chained", 0)
    paid0, hidden0 = sched._reads_paid, sched._reads_hidden
    tens0 = metrics.tensorize_seconds.sum()
    dc.LAUNCHES = 0
    t0 = time.perf_counter()
    results, report = run_loop(sched, loop, **kw)
    launches = dc.LAUNCHES
    del sched._note_flight_timing
    for r in results:
        guard.batch(r)
    bound = sum(len(r.scheduled) for r in results)
    last_bind = max((r.completed_at for r in results if r.scheduled), default=t0)
    wall = max(last_bind - t0, 1e-9)
    lat = np.asarray([x for r in results for x in r.e2e_latencies], np.float64)
    reading = {
        "loop": loop, "batches": len(results), "bound": bound,
        "unschedulable": sum(len(r.unschedulable) for r in results),
        "wall_s": wall, "pods_bound_per_s": bound / wall,
        "tensorize_s": metrics.tensorize_seconds.sum() - tens0,
        "solve_s": sum(r.solve_seconds for r in results), **timing,
        "latency_p50_s": float(np.percentile(lat, 50)) if lat.size else None,
        "latency_p99_s": float(np.percentile(lat, 99)) if lat.size else None,
        "chained_slots": sched.solver.dispatch_counts.get("stream_chained", 0) - chained0,
        "reads_paid": sched._reads_paid - paid0, "reads_hidden": sched._reads_hidden - hidden0,
        "domain_counts_launches": launches,
        **guard.close(),
    }
    reading["modes"] = {m: reading["loop_counters"][f"mode_{m}"] for m in MODES}
    return results, report, reading


def parity_config(batch, **kw):
    return SchedulerConfig(batch_size=batch, solver=ExactSolverConfig(
        tie_break="first", balanced_fdtype="float64", **kw))


def loop_mixed(dev, loop, n_nodes=240, n_pods=480, batch=128, tight=False):
    """7a: 6a's mixed scenario through ``loop`` on ``dev`` (a backlog, then
    a node added with more pods, then a bound pod deleted with more pods,
    each followed by one call of the loop); returns the bindings,
    nominations and the drains' budget splits."""
    from kubernetes_tpu_torch.solver import budget as hbm

    nodes = make_nodes(n_nodes)
    nominee = (MakePod().name("nominee").req({"cpu": "1", "memory": "1Gi"}).priority(10)
               .nominated_node_name(nodes[7].name).obj())
    cs = _cluster(nodes, [nominee] + [make_pod(i) for i in range(n_pods // 2)])
    sched = Scheduler(cs, parity_config(batch, group_size=64), device=dev)
    label = f"7a {loop}{' tight' if tight else ''} {dev.type}"
    guard = LoopGuard(sched, label)
    splits = []

    def go():
        budget = 8 << 30
        if tight:
            budget = hbm.estimate(sched.drain_shape(batch)).per_device_bytes - 1
        results, rep = run_loop(sched, loop, chunk_pods=batch, budget_bytes=budget)
        if rep is not None:
            splits.append(rep.budget_splits)
        for r in results:
            guard.batch(r)

    go()
    cs.create_node(MakeNode().name(f"node-{n_nodes:05}")
                   .capacity({"cpu": "16", "memory": "64Gi", "pods": "110"})
                   .label(ZONE, "z0").label(HOST, f"node-{n_nodes:05}").obj())
    cs.create_pods([make_pod(i) for i in range(n_pods // 2, 3 * n_pods // 4)])
    go()
    victim = sorted(k for k, v in _bindings(cs).items() if v and "/pod-" in k)[0]
    cs.delete_pod(*victim.split("/"))
    cs.create_pods([make_pod(i) for i in range(3 * n_pods // 4, n_pods)])
    go()
    guard.close()
    check_cluster(cs, label)
    if not cs.get_pod("default", "nominee").node_name:
        raise AssertionError(f"{label}: the nominated pod did not bind")
    return _bindings(cs), {p.key: p.nominated_node_name for p in cs.list_pods()}, splits


def loop_fence(dev, loop, n_nodes=60, n_pods=96, batch=32):
    """7a's fence case: a bound app=anti pod is deleted while the first
    flight is in the ring (after its solve computed, before its apply); the
    flight must be discarded and every pod bound on the retry."""
    nodes = make_nodes(n_nodes)
    old = MakePod().name("old").label("app", "anti").node(nodes[0].name).req(
        {"cpu": "250m", "memory": "512Mi"}).obj()
    cs = _cluster(nodes, [old] + [make_pod(i) for i in range(n_pods)])
    sched = Scheduler(cs, parity_config(batch), device=dev)
    fired = []

    def hook(flight):
        if not fired:
            fired.append(True)
            flight.handle.wait()
            cs.delete_pod("default", "old")

    sched._post_dispatch_hook = hook
    guard = LoopGuard(sched, f"7a fence {loop} {dev.type}", fence_case=True)
    results, _ = run_loop(sched, loop)
    for r in results:
        guard.batch(r)
    delta = guard.close()["loop_counters"]
    if delta["discarded"] < 1 or (loop == "streaming" and delta["slot_discards"] != 1):
        raise AssertionError(f"7a fence {loop} {dev.type}: the stale flight was not discarded: {delta}")
    check_cluster(cs, f"7a fence {loop}")
    if sum(1 for v in _bindings(cs).values() if v) != n_pods:
        raise AssertionError(f"7a fence {loop} {dev.type}: not every pod bound")
    return _bindings(cs), delta


def loops_parity_run(dev, loop, n_nodes, n_pods, batch):
    """7b: phase 6b's InterPodAffinity workload through ``loop``."""
    cs = _cluster(make_nodes(n_nodes))
    sched = Scheduler(cs, parity_config(batch), device=dev)
    cs.create_pods([make_pod(i) for i in range(n_pods)])
    _, _, reading = loop_reading(sched, loop, f"7b {loop}")
    if reading["bound"] != n_pods:
        raise AssertionError(f"7b {loop}: {reading['bound']} of {n_pods} bound")
    check_cluster(cs, f"7b {loop}")
    return _bindings(cs), reading


def plain_pod(i, prefix="plain"):
    return MakePod().name(f"{prefix}-{i:06}").req({"cpu": "250m", "memory": "512Mi"}).obj()


def north_star_backlog(dev, loop, n_nodes, n_pods, batch=1024):
    """7c: the north-star shape queued at once, drained by ``loop`` under
    the production default config."""
    cs = _cluster(make_nodes(n_nodes))
    sched = Scheduler(cs, SchedulerConfig(batch_size=batch, solver=ExactSolverConfig(seed=SEED)),
                      device=dev)
    cs.create_pods([plain_pod(i) for i in range(n_pods)])
    _, _, reading = loop_reading(sched, loop, f"7c {loop}")
    if reading["bound"] != n_pods:
        raise AssertionError(f"7c {loop}: {reading['bound']} of {n_pods} bound")
    check_cluster(cs, f"7c {loop}")
    return reading


def north_star_arrivals(dev, n_nodes, n_pods, rate, wave=1024, batch=1024):
    """7c with arrivals: waves of ``wave`` pods every ``wave / rate``
    seconds, run_streaming after each wave; p50 / p99 from queue add to
    bind over every pod."""
    cs = _cluster(make_nodes(n_nodes))
    sched = Scheduler(cs, SchedulerConfig(batch_size=batch, solver=ExactSolverConfig(seed=SEED)),
                      device=dev)
    guard = LoopGuard(sched, "7c arrivals")
    interval = wave / rate
    results, late = [], 0
    dc.LAUNCHES = 0
    t0 = time.perf_counter()
    for w in range(-(-n_pods // wave)):
        delay = t0 + w * interval - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        elif w:
            late += 1
        cs.create_pods([plain_pod(i, "arrival") for i in range(w * wave, min((w + 1) * wave, n_pods))])
        got = sched.run_streaming()
        for r in got:
            guard.batch(r)
        results += got
    wall = time.perf_counter() - t0
    bound = sum(len(r.scheduled) for r in results)
    if bound != n_pods:
        raise AssertionError(f"7c arrivals: {bound} of {n_pods} bound")
    check_cluster(cs, "7c arrivals")
    lat = np.asarray([x for r in results for x in r.e2e_latencies], np.float64)
    return {
        "offered_pods_per_s": rate, "wave": wave, "waves": -(-n_pods // wave),
        "waves_behind_schedule": late, "bound": bound, "wall_s": wall,
        "pods_bound_per_s": bound / wall,
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "domain_counts_launches": dc.LAUNCHES, **guard.close(),
    }


def drain_pod(i):
    """7d: three pods in four plain, one in four with a hard 3-zone spread,
    in blocks of 64 so every grouped chunk holds one kind."""
    if (i // 64) % 4 == 3:
        return (MakePod().name(f"spread-{i:06}").label("app", "spread")
                .req({"cpu": "250m", "memory": "512Mi"})
                .spread_constraint(1, ZONE, "DoNotSchedule", {"app": "spread"}).obj())
    return plain_pod(i, "drain")


def backlog_drain(dev, n_nodes, n_pods, batch=1024):
    """7d: drain_backlog with the default budget and the production config;
    the peak memory of each chunk's dispatch (reset before, read after,
    less what the process held before the drain) against the budget
    model's estimate for the chunk."""
    import gc

    from kubernetes_tpu_torch.solver import budget as hbm

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cs = _cluster(make_nodes(n_nodes))
    sched = Scheduler(cs, SchedulerConfig(batch_size=batch, solver=ExactSolverConfig(seed=SEED)),
                      device=dev)
    cs.create_pods([drain_pod(i) for i in range(n_pods)])
    setup = time.perf_counter() - t0
    est = hbm.estimate(sched.drain_shape(batch))
    peaks = []
    base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    dispatch = sched._dispatch_stream

    def measured(prep, **kw):
        if dev.type != "cuda":
            return dispatch(prep, **kw)
        torch.cuda.reset_peak_memory_stats()
        out = dispatch(prep, **kw)
        peaks.append(torch.cuda.max_memory_allocated() - base)
        return out

    sched._dispatch_stream = measured
    _, report, reading = loop_reading(sched, "drain", "7d")
    del sched._dispatch_stream
    if report.drained != n_pods:
        raise AssertionError(f"7d: {report.drained} of {n_pods} bound")
    check_cluster(cs, "7d")
    if dev.type == "cuda" and reading["domain_counts_launches"] <= 0:
        raise AssertionError("7d: the drain launched no domain_counts kernel")
    raw = est.sharded_bytes + est.replicated_bytes
    reading.update({
        "nodes": n_nodes, "pods": n_pods, "setup_s": setup,
        "planned_chunk": report.chunk_pods, "chunks": report.chunks,
        "auto_splits": report.budget_splits, "budget_bytes": report.budget_bytes,
        "chain_fraction": report.chain_fraction,
        "estimated_h2d_bytes": report.estimated_h2d_bytes,
        "measured_h2d_bytes": report.measured_h2d_bytes,
        "drain_pods_per_s": report.pods_per_sec,
        "estimate_per_device_bytes": est.per_device_bytes,
        "estimate_resident_bytes": raw,
        "workspace_factor": hbm.WORKSPACE_FACTOR,
        "peak_bytes_each_chunk": peaks,
        "peak_bytes_max": max(peaks) if peaks else "not measured",
        "peak_over_resident_estimate": max(peaks) / raw if peaks else "not measured",
        "dispatch": dict(sched.solver.dispatch_counts),
    })
    return reading


# the loops between two runs of run_until_settled: each loop's wall is
# compared with the mean of the two, taken in the same call
BASELINE_ORDER = ("settled", "pipelined", "streaming", "settled again")


def hidden_share(out, cell):
    """1 - a loop's wall / the mean wall of the two run_until_settled runs
    of ``cell``: the share of the synchronous wall the loop hides."""
    base = (out[f"{cell} settled"]["wall_s"] + out[f"{cell} settled again"]["wall_s"]) / 2
    return {loop: 1.0 - out[f"{cell} {loop}"]["wall_s"] / base
            for loop in ("pipelined", "streaming")}


def loops_phase(dev, want_6b, mixed=(240, 480, 128), full=(5120, 5120, 1024),
                north_star=(10_000, 50_000), backlog=(20_000, 100_000)):
    """7a-7d; the keyword sizes are the full-width shapes (smaller ones
    rehearse the phase on the CPU, with ``want_6b`` None)."""
    cpu = torch.device("cpu")
    out = {}
    # 7a: card == CPU, loop == run_until_settled, at reduced depth
    want, want_noms, _ = loop_mixed(cpu, "settled", *mixed)
    runs = {}
    for loop in ("pipelined", "streaming", "drain"):
        for d in (dev, cpu):
            b, n, splits = loop_mixed(d, loop, *mixed)
            if b != want or n != want_noms:
                bad = [k for k in want if b.get(k) != want[k]]
                raise AssertionError(f"7a {loop} {d.type}: bindings differ from run_until_settled "
                                     f"({len(bad)}, first {bad[:4]})")
            runs[f"{loop}/{d.type}"] = splits
    for d in (dev, cpu):
        b, _, splits = loop_mixed(d, "drain", *mixed, tight=True)
        if not splits or min(splits) < 1:
            raise AssertionError(f"7a tight drain {d.type}: the budget forced no auto-split {splits}")
        if b != want:
            raise AssertionError(f"7a tight drain {d.type}: bindings differ from the unsplit drain")
        runs[f"drain tight/{d.type}"] = splits
    fences = {}
    for loop in ("pipelined", "streaming"):
        fb_dev, delta = loop_fence(dev, loop)
        fb_cpu, _ = loop_fence(cpu, loop)
        if fb_dev != fb_cpu:
            raise AssertionError(f"7a fence {loop}: card != CPU")
        fences[loop] = {k: delta[k] for k in ("discarded", "slot_discards")}
    out["7a"] = {"bound": sum(1 for v in want.values() if v), "loops_equal_settled": True,
                 "card_equals_cpu": True, "drain_splits": runs, "fence": fences}
    log("loops 7a " + json.dumps(out["7a"]))
    # 7b: full width, parity mode, equal to 6b's bindings; run_until_settled
    # before and after the loops gives the same call's sync baseline
    if want_6b is None:
        cs = _cluster(make_nodes(full[0]))
        s = Scheduler(cs, parity_config(full[2]), device=dev)
        cs.create_pods([make_pod(i) for i in range(full[1])])
        s.run_until_settled()
        want_6b = _bindings(cs)
    for key in BASELINE_ORDER:
        loop = key.split()[0]
        b, reading = loops_parity_run(dev, loop, *full)
        if b != want_6b:
            bad = [k for k in want_6b if b.get(k) != want_6b[k]]
            raise AssertionError(f"7b {key}: bindings differ from 6b ({len(bad)}, first {bad[:4]})")
        if dev.type == "cuda" and reading["domain_counts_launches"] <= 0:
            raise AssertionError(f"7b {key}: no domain_counts launch")
        out[f"7b {key}"] = reading
        log(f"loops 7b {key} " + json.dumps(reading))
    # 7c: the north-star shape, production config: backlogs (between two
    # run_until_settled baselines), then arrivals
    for key in BASELINE_ORDER:
        out[f"7c {key}"] = north_star_backlog(dev, key.split()[0], *north_star)
        log(f"loops 7c {key} " + json.dumps(out[f"7c {key}"]))
    rate = 0.5 * out["7c streaming"]["pods_bound_per_s"]
    out["7c arrivals"] = north_star_arrivals(dev, *north_star, rate=rate)
    log("loops 7c arrivals " + json.dumps(out["7c arrivals"]))
    # 7d: drain_backlog at full width
    out["7d"] = backlog_drain(dev, *backlog)
    log("loops 7d " + json.dumps(out["7d"]))
    return out



# -- phase 8: the extender webhook, restart incarnations, replay bundles -----


class _Crash(Exception):
    """The scheduler process died at the commit seam (8a)."""


def _placed_cluster(n_nodes, n_placed, bindings=None):
    """``make_nodes(n_nodes)`` with ``make_pod(i)`` for i < n_placed bound:
    to ``bindings[key]`` when given, else pod i on node i % n_nodes."""
    nodes = make_nodes(n_nodes)
    pods = []
    for i in range(n_placed):
        p = make_pod(i)
        p.node_name = bindings[p.key] if bindings is not None else nodes[i % n_nodes].name
        pods.append(p)
    return _cluster(nodes, pods)


def extender_requests(first, n, names):
    """``n`` webhook requests in wire JSON (``Pod.to_dict``) for the mixed
    pods ``make_pod(first + i)``: filter and prioritize alternating, by
    ``nodenames`` over ``names``."""
    return [("filter" if i % 2 == 0 else "prioritize",
             {"pod": make_pod(first + i).to_dict(), "nodenames": names}) for i in range(n)]


def extender_verbs(dev, n_nodes=240, n_requests=64):
    """8a: every verb's reply through ExtenderCore on ``dev``, parity
    config: ``run_many`` over filter and prioritize requests, a preempt
    whose candidates fit only by eviction, and a bind and its conflict."""
    from kubernetes_tpu_torch.server.extender import ExtenderCore

    cs = _placed_cluster(n_nodes, n_nodes)
    core = ExtenderCore(cs, node_cache_capable=True, device=dev, solver_config=ExactSolverConfig(
        tie_break="first", balanced_fdtype="float64"))
    names = [n.name for n in cs.list_nodes()]
    replies = core.run_many(extender_requests(n_nodes, n_requests, names))
    vip = MakePod().name("vip").priority(100).req({"cpu": "16", "memory": "8Gi"}).obj()
    preempt = core.preempt({"pod": vip.to_dict(),
                            "nodeNameToVictims": {n: {"pods": []} for n in names[::8]}})
    if not preempt["nodeNameToMetaVictims"]:
        raise AssertionError(f"8a {dev.type}: preempt offered no candidate")
    cs.create_pod(make_pod(10_000))
    args = {"podName": "pod-10000", "podNamespace": "default", "node": names[3]}
    bind = [core.bind(args), core.bind({**args, "node": names[4]})]
    if bind[0] != {} or "Conflict" not in bind[1].get("error", ""):
        raise AssertionError(f"8a {dev.type}: bind replies {bind}")
    return json.dumps([replies, preempt, bind], sort_keys=True)


def restart_run(dev, n_nodes=240, n_pods=480, batch=128):
    """8a: incarnation 1 runs ``run_pipelined`` over 6a's mixed workload
    until ``_pre_commit_hook`` raises on its second batch (pods assumed and
    approved, nothing bound); four priority-100 pods, each pinned to one of
    the fullest nodes, arrive during the outage; incarnation 2 on the same
    ClusterState settles it. Returns the bindings at the crash, the
    recovered records, the victims and the final bindings."""
    from kubernetes_tpu_torch.obs import ObsConfig

    cs = _cluster(make_nodes(n_nodes), [make_pod(i) for i in range(n_pods)])
    s1 = Scheduler(cs, parity_config(batch), device=dev)
    calls = []

    def die(pending):
        calls.append(len(pending))
        if len(calls) == 2:
            raise _Crash()

    s1._pre_commit_hook = die
    try:
        s1.run_pipelined()
    except _Crash:
        pass
    else:
        raise AssertionError(f"8a restart {dev.type}: the commit seam never fired")
    cs.unsubscribe(s1._on_event)
    at_crash = _bindings(cs)
    orphans = sorted(k for k, v in at_crash.items() if not v)
    # each pinned to one of the four fullest nodes, which it fits only empty
    load = Counter(v for v in at_crash.values() if v)
    full = sorted(load, key=lambda n: (-load[n], n))[:4]
    cs.create_pods([MakePod().name(f"vip-{k}").priority(100).node_affinity_in(HOST, [n])
                    .req({"cpu": "16", "memory": "8Gi"}).obj() for k, n in enumerate(full)])
    s2 = Scheduler(cs, SchedulerConfig(
        batch_size=batch, incarnation=2, obs=ObsConfig(journal=True),
        solver=ExactSolverConfig(tie_break="first", balanced_fdtype="float64")), device=dev)
    recovered = [json.loads(x) for x in s2.journal.lines]
    got = sorted(r["pod"] for r in recovered if r["outcome"] == "recovered")
    if got != sorted(orphans + [f"default/vip-{k}" for k in range(4)]):
        raise AssertionError(f"8a restart {dev.type}: recovered {len(got)}, "
                             f"orphans {len(orphans)} + 4")
    if {r["incarnation"] for r in recovered} != {2}:
        raise AssertionError(f"8a restart {dev.type}: records not tagged with incarnation 2")
    results, reading = drain(s2, f"8a restart {dev.type}")
    victims = [(p, n, list(v)) for r in results for p, n, v in r.preemptions]
    final = _bindings(cs)
    if len(victims) != 4 or not all(final.values()):
        raise AssertionError(f"8a restart {dev.type}: {len(victims)} preemptions, "
                             f"{sum(1 for v in final.values() if not v)} unbound")
    check_cluster(cs, f"8a restart {dev.type}")
    return at_crash, [(r["pod"], r["outcome"], r["incarnation"]) for r in recovered], victims, final


def _first_mismatch(got, want):
    bad = np.argwhere(got != want)
    if not bad.size:
        return None
    at = tuple(int(i) for i in bad[0])
    return f"{len(bad)} cells differ, first at {at}: card {got[at]}, CPU {want[at]}"


def extender_full(dev, bindings, n_nodes=5120, n_requests=1024, micro=256):
    """8b: BASELINE.json's InterPodAffinity configuration behind the
    webhook: 5,120 nodes holding 6b's 5,120 bound mixed pods; ``n_requests``
    further mixed pods as filter / prioritize requests over every node,
    through ``ExtenderCore.run_many`` in micro-batches of ``micro``, then
    all at once through ``MicroBatcher.submit`` on one asyncio loop."""
    import asyncio

    from kubernetes_tpu_torch.ops.oracle.profile import FullOracle, make_oracle_nodes
    from kubernetes_tpu_torch.server.extender import ExtenderCore, MicroBatcher
    from kubernetes_tpu_torch.solver.evaluate import BatchEvaluator

    cfg = ExactSolverConfig(tie_break="first", balanced_fdtype="float64")
    t0 = time.perf_counter()
    cs = _placed_cluster(n_nodes, len(bindings), bindings)
    core = ExtenderCore(cs, node_cache_capable=True, solver_config=cfg, device=dev)
    names = [n.name for n in cs.list_nodes()]
    reqs = extender_requests(n_nodes, n_requests, names)
    setup = time.perf_counter() - t0
    ev = core.evaluator
    evals, batches, first, launch_sets = [], [], {}, []
    evaluate, evaluate_tensors, run_many = ev.evaluate, ev.evaluate_tensors, core.run_many
    call = dc.Aggregation.__call__
    # the host's per-request work around the evaluation: resolving each
    # request's node names, and writing each reply's per-node entries
    host = {"resolve_s": 0.0, "reply_s": 0.0}

    def host_timed(fn, key):
        def timed(*a):
            t = time.perf_counter()
            out = fn(*a)
            host[key] += time.perf_counter() - t
            return out
        return timed

    core._resolve_nodes = host_timed(core._resolve_nodes, "resolve_s")
    core._filter_result = host_timed(core._filter_result, "reply_s")
    core._prioritize_result = host_timed(core._prioritize_result, "reply_s")

    def timed_tensors(*a):
        t = time.perf_counter()
        out = evaluate_tensors(*a)
        evals[-1]["card_s"] = time.perf_counter() - t
        return out

    def timed_evaluate(pods, nodes, by_node, **kw):
        evals.append({"pods": len(pods)})
        t = time.perf_counter()
        out = evaluate(pods, nodes, by_node, **kw)
        evals[-1]["wall_s"] = time.perf_counter() - t
        evals[-1]["build_s"] = evals[-1]["wall_s"] - evals[-1]["card_s"]
        if not first:
            first.update(matrix=out, pods=list(pods), nodes=nodes, by_node=by_node)
        return out

    def timed_run_many(requests):
        t = time.perf_counter()
        out = run_many(requests)
        batches.append({"requests": len(requests), "wall_s": time.perf_counter() - t})
        return out

    def recording(self):
        if not first:  # the first evaluation's launches, checked below
            launch_sets.append((self.sets, self.d_pad, self.counts, self.gather))
        return call(self)

    ev.evaluate, ev.evaluate_tensors, core.run_many = timed_evaluate, timed_tensors, timed_run_many
    dc.Aggregation.__call__ = recording
    try:
        dc.LAUNCHES = 0
        t0 = time.perf_counter()
        replies = []
        for lo in range(0, n_requests, micro):
            replies += core.run_many(reqs[lo: lo + micro])
        wall1 = time.perf_counter() - t0
        launches1, evals1, batches1 = dc.LAUNCHES, list(evals), list(batches)
        host1 = dict(host)
        evals.clear()
        batches.clear()
        host.update(resolve_s=0.0, reply_s=0.0)
        batcher = MicroBatcher(core)

        async def submit_all():
            return await asyncio.gather(*[batcher.submit(v, a) for v, a in reqs])

        dc.LAUNCHES = 0
        t0 = time.perf_counter()
        replies2 = asyncio.run(submit_all())
        wall2 = time.perf_counter() - t0
        launches2, evals2, batches2 = dc.LAUNCHES, list(evals), list(batches)
        host2 = dict(host)
    finally:
        dc.Aggregation.__call__ = call
        del ev.evaluate, ev.evaluate_tensors, core.run_many
        del core._resolve_nodes, core._filter_result, core._prioritize_result
    if json.dumps(replies2, sort_keys=True) != json.dumps(replies, sort_keys=True):
        raise AssertionError("8b: the micro-batcher's replies differ from run_many's")
    per_eval = {launches1 / len(evals1), launches2 / len(evals2)}
    if len(per_eval) != 1 or launches1 == 0:
        raise AssertionError(f"8b: domain_counts launches per evaluation depend on the batch: "
                             f"{launches1} over {len(evals1)}, {launches2} over {len(evals2)}")
    # the first micro-batch's matrix == the CPU port's
    want = BatchEvaluator(cfg, device="cpu").evaluate(first["pods"], first["nodes"],
                                                      first["by_node"])
    got = first["matrix"]
    if got.shape != (micro, n_nodes) or (why := _first_mismatch(got, want)):
        raise AssertionError(f"8b: the first micro-batch on the card != CPU: {got.shape} {why}")
    # 8 pods' rows against the NumPy oracle: the feasible set and the totals on it
    oracle = FullOracle(make_oracle_nodes(first["nodes"], first["by_node"]))
    for i, pod in enumerate(first["pods"][:8]):
        feasible = sorted(oracle.feasible_set(pod))
        totals = oracle.score_totals(pod, feasible)
        row = got[i]
        if feasible != sorted(np.nonzero(row >= 0)[0].tolist()):
            raise AssertionError(f"8b: {pod.key}'s feasible set differs from the oracle's")
        bad = [j for j in feasible if int(totals[j]) != int(row[j])]
        if bad:
            raise AssertionError(f"8b: {pod.key}'s totals differ from the oracle's at "
                                 f"node {bad[0]}: card {row[bad[0]]}, oracle {totals[bad[0]]}")
    # the kernel at this path's shapes == its plain version
    shapes = []
    for sets, d_pad, _, _ in launch_sets:
        check_exact("extender 8b", sets, d_pad)
        shapes.append({"T": [x[0].shape[0] for x in sets], "N": sets[0][0].shape[1],
                       "d_pad": d_pad})

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else None

    def run_reading(wall, launches, ev_list, b_list, host_s):
        return {
            "requests": n_requests, "wall_s": wall, "requests_per_s": n_requests / wall,
            "evaluate_s": sum(e["wall_s"] for e in ev_list), **host_s,
            "micro_batches": [b["requests"] for b in b_list],
            "micro_batch_p50_s": pct([b["wall_s"] for b in b_list], 50),
            "micro_batch_p99_s": pct([b["wall_s"] for b in b_list], 99),
            "host_build_p50_s": pct([e["build_s"] for e in ev_list], 50),
            "host_build_p99_s": pct([e["build_s"] for e in ev_list], 99),
            "card_eval_p50_s": pct([e["card_s"] for e in ev_list], 50),
            "card_eval_p99_s": pct([e["card_s"] for e in ev_list], 99),
            "evaluations": len(ev_list), "domain_counts_launches": launches,
            "launches_per_evaluation": launches / len(ev_list),
        }

    return {
        "nodes": n_nodes, "bound_pods": len(bindings), "setup_s": setup,
        "run_many": run_reading(wall1, launches1, evals1, batches1, host1),
        "micro_batcher": run_reading(wall2, launches2, evals2, batches2, host2),
        "first_batch_card_equals_cpu": True, "oracle_rows_checked": 8,
        "kernel_shapes_checked": shapes,
        "feasible_per_request_first_batch": int((got >= 0).sum()) / micro,
    }, launch_sets


def capture_replay(dev, n_nodes=5120, n_pods=5120, batch=1024):
    """8c: 6b's workload through ``run_until_settled`` with the anomaly
    sentinel and a bundle directory; one manual capture after the first
    batch, replayed on the card and on the CPU."""
    import tempfile

    from kubernetes_tpu_torch.obs import ObsConfig, SentinelConfig
    from kubernetes_tpu_torch.obs.bundle import replay_bundle

    with tempfile.TemporaryDirectory() as tmp:
        cs = _cluster(make_nodes(n_nodes))
        sched = Scheduler(cs, SchedulerConfig(
            batch_size=batch, obs=ObsConfig(sentinel=SentinelConfig(), bundle_dir=tmp),
            solver=ExactSolverConfig(tie_break="first", balanced_fdtype="float64")), device=dev)
        cs.create_pods([make_pod(i) for i in range(n_pods)])
        guard = TopTier(sched, "8c")
        dc.LAUNCHES = 0
        t0 = time.perf_counter()
        guard.batch(sched.schedule_batch())
        path = sched.telemetry.capture("manual")
        for r in sched.run_until_settled():
            guard.batch(r)
        wall = time.perf_counter() - t0
        launches = dc.LAUNCHES
        guard.close()
        check_cluster(cs, "8c")
        bound = sum(1 for v in _bindings(cs).values() if v)
        if path is None or bound != n_pods:
            raise AssertionError(f"8c: capture {path}, {bound} of {n_pods} bound")
        replays = {}
        for d in (dev, torch.device("cpu")):
            t = time.perf_counter()
            rep = replay_bundle(path, device=d)
            rep["seconds"] = time.perf_counter() - t
            if not (rep["ok"] and rep["detail"] == "assignments bit-identical"):
                raise AssertionError(f"8c: replay on {d.type}: {rep}")
            replays[d.type] = rep
        snap = sched.telemetry.snapshot()
        return {"wall_s": wall, "bound": bound, "domain_counts_launches": launches,
                "replays": replays, "bundles": {k: snap["bundles"][k] for k in (
                    "captures", "missed", "by_trigger")},
                "sentinel_fired": snap["sentinel"]["fired_total"]}


def extender_phase(dev, bindings_6b, mixed=(240, 480, 128), full=(5120, 1024, 256),
                   capture=(5120, 5120, 1024)):
    """8a-8c; the keyword sizes are the full-width shapes (smaller ones
    rehearse the phase on the CPU)."""
    cpu = torch.device("cpu")
    out = {}
    t0 = time.perf_counter()
    verbs = {d.type: extender_verbs(d, mixed[0]) for d in (dev, cpu)}
    if len(set(verbs.values())) != 1:
        raise AssertionError("8a: a verb's reply on the card differs from the CPU's")
    restarts = {d.type: restart_run(d, *mixed) for d in (dev, cpu)}
    if restarts[dev.type] != restarts["cpu"]:
        raise AssertionError("8a restart: card != CPU in bindings, recovered records or victims")
    at_crash, recovered, victims, _ = restarts["cpu"]
    out["8a"] = {"verbs_card_equals_cpu": True, "restart_card_equals_cpu": True,
                 "unbound_at_crash": sum(1 for v in at_crash.values() if not v),
                 "recovered_records": len(recovered), "preemptions": len(victims),
                 "victims": sum(len(v) for _, _, v in victims)}
    log("extender 8a " + json.dumps(out["8a"]))
    out["8b"], out["8b_launch_sets"] = extender_full(dev, bindings_6b, *full)
    log("extender 8b " + json.dumps(out["8b"]))
    out["8c"] = capture_replay(dev, *capture)
    log("extender 8c " + json.dumps(out["8c"]))
    out["phase_s"] = time.perf_counter() - t0
    return out


def main():
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU")
        return 2
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = environment()
    log(smi)

    # the full-width batches' tables give the kernel its main-path shapes
    nodes = make_nodes(5120)
    first = [make_pod(i) for i in range(1024)]
    interpod = tensorize(nodes, first, {}, ResourceVocab.build(first, nodes))[5]
    k2 = [make_kind_pod("spread", i) for i in range(1024)]
    kind2 = tensorize(nodes, k2, {}, ResourceVocab.build(k2, nodes))[4]
    k3 = [make_kind_pod("anti", i) for i in range(1024)]
    kind3 = tensorize(nodes, k3, {}, ResourceVocab.build(k3, nodes))[5]
    cases, sweep, ran = kernel_checks(dev, interpod, kind2, kind3)
    reduced = reduced_depth(dev)
    full = full_width(dev)
    grouped, spread_first = {}, None
    for kind, n_nodes, n_pods, batch in GROUPED_RUNS:
        for tie in ("first", "random"):
            res, per_batch = grouped_run(dev, kind, n_nodes, n_pods, batch, tie)
            grouped[f"{kind}/{tie}"] = res
            if kind == "spread" and tie == "first":
                spread_first = per_batch
    sessions = {v: session_run(dev, v, spread_first)
                for v in ("session", "deferred", "split", "stream")}
    per_step = launches_per_step(dev)
    per_pod = grouped_launches(dev)
    sched = scheduler_phase(dev)
    bindings_6b = sched.pop("6b_bindings")
    loops = loops_phase(dev, bindings_6b)
    ext = extender_phase(dev, bindings_6b)
    # the kernel at the evaluator's launches: exact, and timed as the others
    for i, (sets, d_pad, counts, gather) in enumerate(ext.pop("8b_launch_sets")):
        rows = "+".join(str(x[0].shape[0]) for x in sets)
        cases.append(kernel_case(f"extender 8b evaluation, launch {i}: T {rows}, N "
                                 f"{sets[0][0].shape[1]}, d_pad {d_pad}", sets, d_pad,
                                 counts=counts, gather=gather))

    launches_by_path = {
        "interpod full width (scan)": full["domain_counts_launches"],
        **{f"grouped {k}": r["domain_counts_launches"] for k, r in grouped.items()},
        **{f"session {k}": r["domain_counts_launches"] for k, r in sessions.items()},
        **{f"scheduler {k}": sched[k]["domain_counts_launches"] for k in ("6b", "6c", "6d")},
        **{f"loops {k}": r["domain_counts_launches"] for k, r in loops.items()
           if k != "7a" and "settled" not in k},
        "extender 8b": ext["8b"]["run_many"]["domain_counts_launches"],
        "extender 8b micro-batcher": ext["8b"]["micro_batcher"]["domain_counts_launches"],
        "capture 8c": ext["8c"]["domain_counts_launches"],
    }
    main_case = cases[0]
    record = {
        "name": "domain_counts",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/domain_counts.cu",
        "replaces": "kubernetes_tpu/ops/pallas_kernels.py:96",
        "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path,
        "exact": True,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "library_ms": main_case["library_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "device_ms": main_case["device_ms"],
        "plain_device_ms": main_case["plain_device_ms"],
        "library_device_ms": main_case["library_device_ms"],
        "library": main_case["library"],
        "shape": main_case["shape"],
        "cluster": main_case["cluster"],
        "cases": cases,
        "cluster_sweep": sweep,
        "paths_and_cluster_sizes_run": sorted(ran),
    }
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({
        "full_width": {k: full[k] for k in ("wall_s", "pods_per_s", "placed")},
        "grouped": {k: {f: r[f] for f in ("pods_per_s", "solve_pods_per_s", "placed",
                                           "device_reads_per_chunk")}
                    for k, r in grouped.items()},
        "session": {k: {f: r[f] for f in ("solve_pods_per_s", "chained_batches")}
                    for k, r in sessions.items()},
        "reduced_depth_cases": len(reduced),
        "torch_launches_per_step": per_step["per_step"],
        "grouped_launches_per_placed_pod": {k: r["per_placed_pod"] for k, r in per_pod.items()},
        "card": smi,
    }))
    keys = ("pods_bound_per_s", "wall_s", "tensorize_s", "solve_s", "apply_s", "commit_s",
            "latency_p50_s", "latency_p99_s", "domain_counts_launches", "bound", "batches")
    log(json.dumps({"scheduler": {
        "6a": sched["6a"],
        **{k: {f: sched[k][f] for f in keys} for k in ("6b", "6c", "6d")},
        "6d_preemption": {f: sched["6d"][f] for f in (
            "low_priority_pods", "preemptors", "victims", "dry_runs", "dry_runs_per_s",
            "torch_launches_per_dry_run", "torch_launches_each_dry_run",
            "dry_run_kernels_that_varied")},
        "card": smi,
    }}))
    keys7 = ("pods_bound_per_s", "wall_s", "tensorize_s", "solve_s", "read_s", "dispatch_s",
             "flights", "latency_p50_s", "latency_p99_s", "modes", "chained_slots",
             "reads_paid", "reads_hidden", "domain_counts_launches", "bound", "batches",
             "loop_counters")
    log(json.dumps({"loops": {
        "7a": loops["7a"],
        **{k: {f: r[f] for f in keys7} for k, r in loops.items() if k.startswith(("7b", "7c "))
           and k != "7c arrivals"},
        "7c arrivals": loops["7c arrivals"],
        "7d": loops["7d"],
        "overlap_hidden_share_7b": hidden_share(loops, "7b"),
        "overlap_hidden_share_7c": hidden_share(loops, "7c"),
        "card": smi,
    }}))
    log(json.dumps({"extender": ext, "script_s": time.perf_counter() - t_start, "card": smi}))
    log(smi)  # the card's name and power limit, on the line before the last
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
