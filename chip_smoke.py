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
      default config ("random", group 64) holds every invariant on both
      and binds alike on both (bindings digest: the card's threefry
      kernel draws what the CPU port's plain versions draw);
   b. full width, parity mode: phase 4a's InterPodAffinity workload
      (5,120 pods x 5,120 nodes) drained by run_until_settled in batches
      of 1,024; every invariant held;
   c. full width, the production default config: BASELINE.json's
      north-star shape, 50,000 plain 250m / 512Mi pods on 10,000 nodes of
      16 CPU / 64Gi / 110 pods in 3 zones; then the card against the CPU
      port at that width and a reduced depth (4,096 pods), by bindings
      digest;
   d. full width, preemption: 5,120 nodes each full of 16 low-priority
      pods (created bound), then 64 higher-priority pods that fit only by
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

9. The simulator, the scheduler_perf runner and ``serve``, each path's
   domain_counts launches counted (the count set to 0 just before, read
   just after) and its first launch on the card held against the plain
   version on the same inputs:
   a. the 24 simulator profiles (the fleet's 7 on one scheduler here, as
      in the JAX package), each twice on the card at 8 cycles with the same seed
      (``--selfcheck``): every invariant OK, the two traces byte-identical,
      and the trace equal to the CPU port's run given the card's fallback
      ladder (event and decision lines byte-identical, footer bindings,
      unbound pods, violations and summary equal) -- but ``megaplan``, whose
      relax plan is float32 work: where its card trace differs, its first
      differing line is recorded and its invariants hold it; seconds and
      launches per profile;
   b. the shipped performance-config.yaml whole through ``python -m
      kubernetes_tpu_torch perf`` in a subprocess (each workload's JSON
      line and the exit code; a workload under its threshold is printed as
      FAIL and does not fail the phase, an unplaced pod or a raise does --
      the two preemption workloads are held to the CPU port's count, see
      PREEMPTION_CASES); then SchedulingPodAntiAffinity at 5,120 nodes and
      5,120 pods and SchedulingPodTopologySpread at 5,120 nodes and 10,240
      pods through ``PerfRunner.run_workload``: every pod placed, no two
      anti pods on one node; steady pods/s, p50 / p99, device-solve seconds;
   c. ``python -m kubernetes_tpu_torch --leader-elect serve --mode
      scheduler`` on the card on a free port: 240 nodes and 240 bound pods
      ingested through its endpoints, 64 filter / prioritize replies equal
      to an in-process CPU ExtenderCore's, 240 pending pods bound by its
      background loop, exit 0 on SIGTERM.
10. The single-shot auction, the relax planner, the bulk tensor gRPC path
    and the rebalancer:
   a. BASELINE.json's north star through the auction (bench.py
      ladder5_north_star's recipe): 51,200 pods onto 10,240 nodes, 8
      request classes, default SingleShotConfig, then 128 request classes
      over 32 static classes with random 60 % node masks; solve seconds
      (median of 3 after a warm call), rounds, device reads, placed; the
      card's assignments, node state and rounds equal a CPU run's bit for
      bit;
   b. the relax planner (bench.py ladder16_megaplan's recipe) at 512,000
      pods x 102,400 preloaded nodes, pack objective, its tail repaired by
      the plan auction, against the plan auction alone: seconds,
      iterations, residual, reads, the objective ratio under the shared
      pack score, and no overcommit in either plan (a host check); then
      2,000,000 x 200,000 once ``relax_estimate`` fits the card's budget;
   c. ``serve_bulk`` on a socket: SyncNodes for 1,000 nodes, Solve for
      5,000 pods in ``exact`` and ``single_shot`` mode, Evaluate for 256
      pods, then the north star's single-shot solve over the wire; the
      round trip beside the server's solve; every reply equal to a CPU
      BulkCore's;
   d. the rebalancer in the Scheduler's loop: the ``fragmentation``
      profile's cluster at 5,120 nodes with a PDB-guarded cohort, settled
      with ``RebalanceConfig`` on, pass by pass: runs, evictions,
      migrations, packing before and after, plan seconds; no PDB overrun,
      no capacity violation, every pod bound, every batch at the top rung.
   10c and 10d count domain_counts launches and hold a first launch to
   plain as phase 9 does (their pods carry only resources, so neither
   launches the kernel).
11. The fleet (``kubernetes_tpu_torch/fleet``): scheduler replicas in this
    process sharing the one card, each solving the shard of nodes its
    hash ring assigns it, admitting across shards through an occupancy hub
    (``OccupancyExchange``) that the port's ``BulkCore(exchange=)`` serves
    over localhost gRPC, every replica reaching it through
    ``RemoteOccupancyExchange``; each path's launches counted and its first
    launch held to plain as phase 9 does:
   a. 4 replicas over 6b's 5,120 nodes and 1,024 pods of the mixed
      workload (depth cut from 5,120: see ``fleet_full``), "first" mode, driven round-robin on one thread until every
      pod is bound or two rounds bind nothing: pods bound per second (call
      to last bind), admissions, rejections, hand-offs and requeues per
      replica, hub round trips with p50 / p99, the wall's share in the
      solve and in the hub, domain_counts launches per replica. Gates: no
      pod bound twice, every bind on a node its replica owned, no
      overcommit, hostPort or anti-affinity violation fleet-wide, and every
      unbound pod parked by the fleet's own cross-shard spread rule. Then
      512 x 512 on the card and on the CPU must bind alike;
   b. bench.py ladder #17's protocol at 7d's scale: 100,000 plain pods on
      20,480 nodes, one global relax plan, ``drain.partition_backlog``
      (every 512th pod forced into the residual), the ledger installed at
      the hub; 4 replicas loop ``fleet_drain_backlog``, r3 retired while it
      holds a lease and a survivor re-claims it: drained pods/s, plan
      seconds, leases granted and reassigned, each replica's budget slice
      beside its peak allocated memory. Gates: every pod bound, none twice,
      no overcommit, the ledger complete;
   c. the 7 fleet profiles through ``run_fleet_sim`` with 2 replicas,
      twice on the card and once on the CPU given the card's ladder:
      every replica's journal, the hub's journal, bindings and summary
      byte-equal, every invariant OK;
   d. phase 9c's ``serve`` as a fleet replica (``fleet.hubAddress`` at a
      hub holding 11a's journal, ``--obs``): ``GET /debug/hub`` reports the
      hub, and ``obs explain --fleet --hub`` renders a pod the served
      replica bound and a pod of 11a whose history crosses replicas.
12. The tooling:
   a. the kernel build cache (``utils/compile_cache.py``): four child
      processes, each one 6b-shaped domain_counts launch (T 8 + 8, N 5,120,
      d_pad 8,192, seeded inputs) held exactly to plain, each with
      ``KUBERNETES_TPU_COMPILE_CACHE`` set: a fresh empty directory (exactly
      one nvcc build, counted by ``build.BUILD_LISTENERS``), the same
      directory again (no build), a read-only copy of it with the compiler
      taken away (no build), and a directory that cannot be created, under
      a regular file (the launch must raise KernelError naming it); nvcc
      seconds and each child's seconds from its start to its first exact
      launch;
   b. the port's Scheduler on the card against the port's sequential oracle
      (``ops/oracle/scheduler.py``): 1,024 nodes of BASELINE.json's widths
      and 3,072 pods of tests/test_scheduler_e2e.py's request mix (depth cut
      so the Python oracle's two passes take about 30 s); in "first" mode the
      bindings equal ``schedule()`` in creation order, in "random" mode every
      pick lies in the oracle's tie set (``validate_assignments``);
   c. ``python -m kubernetes_tpu_torch.analysis --ratchet`` and
      ``--check-lock-order`` in child processes on the card's machine (which
      has no JAX): both exit 0, 0 active findings, seconds each.
13. The node-axis mesh (``parallel/sharding.py``): k shards of the one
    card (``force_device_count`` makes k entries of it visible), each run
    against the unsharded card run of the same inputs, each shard's first
    domain_counts launch held to plain:
   a. 6b's InterPodAffinity workload in parity mode through
      ``ExactSolver.solve`` at 5,120 nodes, 1,024 pods (depth cut: the
      sharded step's host cost is k times the unsharded one's), on 4 and
      on 2 shards: equal to the unsharded solve and to 6b's bindings, with
      exactly k times the unsharded launches; pods/s, solve seconds,
      launches per step, combines and their host seconds;
   b. the grouped kinds 2 and 3 (phase 4's zone spread and hostname anti
      pods on 5,120 nodes, one batch of 1,024) in both tie-break modes,
      and kind 2 through the device session with the heal of the columns
      the first batch placed on, on 4 shards;
   c. the Scheduler on 4 shards: 6a's mixed run and the north star (6c's
      50,000 plain pods on 10,000 nodes, the production default config),
      every batch at the mesh rung, the bindings equal to the unsharded
      Scheduler's (6c's, by digest), and 6c's reduced-depth run on 4
      shards equal to the CPU port's; ``scheduler_mesh_devices`` reads 4;
   d. the auction at the north star (10a's inputs) on 4 shards, bit for
      bit; the relax plan at 10b's 512,000 x 102,400 on 4 shards, within
      the planner's tolerance (the same iterations, 99 % of assignments
      equal), no overcommit;
   e. the simulator's churn_heavy at ``--mesh-devices 2`` against 1, trace
      and journal byte-identical; then ``resolve_mesh`` on the real device
      list: meshDevices 8 is the unsharded path on one card, meshSlice 0/1
      a 1-way mesh pinning the card (a fleet replica schedules on it), 0/2
      the JAX package's ValueError.
   The kernel's case list gains one shard's launch of 13a (T 8 + 8, N
   1,280, d_pad 8,192, counts only).
14. The threefry kernel (``csrc/threefry.cu`` through ``ops/threefry.py``),
    random mode's draws, the JAX package's threefry2x32 stream:
   a. both entry points against the plain versions (``ops/prng.py``),
      exactly: the card's stream against the CPU's and against the plain
      version on the card's tensors, over seeded keys, the scan's tie
      counts (0 to 10,240) with skipped rows, and the grouped loop's
      uniform and node-key draws at 5,120 and 10,240 columns, with and
      without a split; the Random123 known answer; a 1,000-step scan
      chain. Per-call and device times of each entry point beside its
      plain version's, the ``torch.rand`` / ``torch.randint`` call it
      replaces (another stream: a reference only) and its bound (integer
      operations at the H100's INT32 rate, or bytes);
   b. 13a's shape in random mode (6b's mixed workload, 1,024 pods on
      5,120 nodes, one batch, unsharded): exactly one scan draw per pod,
      pods/s, torch launches per step in random mode; then the card
      against the CPU port at that width and 64 pods.
   The kernels line lists both entry points beside domain_counts, each
   with its launches on the random-mode paths (4b, 6a, 6c, 13b, 13c,
   14b), every count set to 0 just before its path and read just after.
15. The fused spread loop (``csrc/grouped_spread.cu`` through
    ``ops/grouped_spread.py``), run right after phase 2: at spread5k's
    shape (5,000 nodes in 3 zones, maxSkew 5, two batches of 1,024 pods,
    64-pod chunks) the main path against the eager loop it replaces (the
    fused loop and the graphs off) on the same inputs, exactly: every
    batch's assignments, node state, stream key, iterations and kept
    water-fills, every chunk's m and stream key. Per-chunk wall times of
    both, the kernel's own time from CUDA events, and its bound. The
    kernels line lists it with its launches on 4b's random spread run and
    on 15, each count set to 0 just before its path and read just after.
16. The fused scan step (``csrc/scan_step.cu`` through
    ``ops/scan_step.py``), run right after phase 15: at interpod5k's shape
    (5,120 nodes, two batches of 1,024 pods of its four kinds) the main
    path against the torch step's graphs (the fused step off) on the same
    inputs, exactly: every batch's assignments, node state and stream key.
    The whole replayed step on both paths and the kernel's eager launches,
    each timed by CUDA events behind a sleep of the card, and the kernel's
    device time from the profiler; the kernels line lists its record.

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
from kubernetes_tpu_torch.ops import grouped_spread as gs  # noqa: E402
from kubernetes_tpu_torch.ops import prng  # noqa: E402
from kubernetes_tpu_torch.ops import scan_step as ss  # noqa: E402
from kubernetes_tpu_torch.ops import threefry as tf  # noqa: E402
from kubernetes_tpu_torch.parallel import sharding as sh  # noqa: E402
from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig  # noqa: E402
from kubernetes_tpu_torch.state.cluster import ClusterState  # noqa: E402
from kubernetes_tpu_torch.solver import timing as solve_timing  # noqa: E402
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


def tf_reset():
    """The launch counts of the kernels that draw the random stream to 0:
    the threefry kernel's two entry points and the fused scan step."""
    tf.SCAN_LAUNCHES = tf.GROUPED_LAUNCHES = ss.LAUNCHES = 0


def tf_launches() -> dict:
    return {"scan_draw": tf.SCAN_LAUNCHES, "grouped_draw": tf.GROUPED_LAUNCHES,
            "scan_step": ss.LAUNCHES}


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
    kernels = []
    # CUDA activity alone; where that records no kernel, with the host's
    # activity too (which some launches through ctypes need to be seen)
    for activities in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profile(activities=activities) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        if kernels:
            break
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
    dc.LAUNCHES = ss.LAUNCHES = 0
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
    launches, steps = dc.LAUNCHES, ss.LAUNCHES

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
        "domain_counts_launches": launches, "scan_step_launches": steps,
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
    solve_timing.COUNTS["grouped"] = 0
    tf_reset()
    gs.LAUNCHES = 0
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
    launches, reads, draws = dc.LAUNCHES, solve_timing.COUNTS["grouped"], tf_launches()
    fused = gs.LAUNCHES
    if len(where) != n_pods:
        raise AssertionError(f"{kind} {tie}: only {len(where)}/{n_pods} pods placed")
    if dev.type == "cuda" and tie == "random" and draws["grouped_draw"] < reads:
        raise AssertionError(f"{kind} random: {draws} threefry launches for {reads} iterations")
    _check_grouped(kind, where, n_nodes, zones_after)
    want = {"plain": "kind1", "spread": "kind2", "anti": "kind3"}[kind]
    chunks = solver.dispatch_counts[want]
    if chunks != n_pods // 64:
        raise AssertionError(f"{kind} {tie}: dispatch {dict(solver.dispatch_counts)}")
    if kind != "plain" and launches + fused <= 0:
        raise AssertionError(f"{kind} {tie}: the grouped path launched no domain_counts "
                             "and no fused spread loop")
    res = {
        "kind": kind, "tie_break": tie, "nodes": n_nodes, "pods": n_pods, "batch": batch,
        "placed": len(where), "pods_per_s": n_pods / (sum(tens_s) + sum(solve_s)),
        "solve_pods_per_s": n_pods / sum(solve_s), "solve_s": solve_s, "tensorize_s": tens_s,
        "domain_counts_launches": launches, "threefry_launches": draws,
        "grouped_spread_launches": fused, "device_reads": reads,
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


def launches_per_step(dev, small=64, large=128, tie="first"):
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
        solver = ExactSolver(ExactSolverConfig(tie_break=tie))
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
    log(f"launches per step ({tie}) " + json.dumps(res))
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
                solve_timing.COUNTS["grouped"] = 0
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
                               wall, solve_timing.COUNTS["grouped"])
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
        self.before = self.counts()

    @staticmethod
    def counts():
        return {
            "breaker_transitions": _counter_total(metrics.breaker_transitions_total),
            "batch_failures": _counter_total(metrics.batch_failure_total),
            "fallback_solves": _counter_total(metrics.fallback_solves_total),
            "quarantined": metrics.quarantined_pods_total.value(),
        }

    def tier(self):
        s = self.sched
        tier = metrics.solve_tier.labels(PROFILE).value()
        if tier != 0:
            raise AssertionError(f"{self.label}: a batch ran at ladder rung {tier}")
        if any(t != s.resilience.ladder[0] for t in s._tier_last.values()):
            raise AssertionError(f"{self.label}: a batch descended: {s._tier_last}")

    def batch(self, res):
        self.tier()
        if res.quarantined:
            raise AssertionError(f"{self.label}: quarantined {res.quarantined[:4]}")

    def close(self):
        after = self.counts()
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
    tf_reset()
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
    launches, draws = dc.LAUNCHES, tf_launches()
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
        "threefry_launches": draws, "scan_step_launches": draws["scan_step"],
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
    if sched.mesh is not None and sched.resilience.ladder[0] != "mesh":
        raise AssertionError("6a mixed: a mesh scheduler's ladder does not start at the mesh")
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


# 6c's card == CPU check: the north star's 10,000 nodes, depth cut to this
# many pods (the CPU port's grouped draws are tensor hashes on the host)
NORTH_STAR_CPU_PODS = 4096


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
    if dev.type == "cuda" and not reading["threefry_launches"]["grouped_draw"]:
        raise AssertionError(f"{label}: random mode launched no threefry_grouped_draw")
    check_cluster(cs, label)
    reading.update({"nodes": n_nodes, "pods": n_pods, "setup_s": setup,
                    "dispatch": dict(sched.solver.dispatch_counts),
                    "mesh_devices": metrics.mesh_devices.value(),
                    "bindings_digest": bindings_digest(cs)})
    return reading


def bindings_digest(cs):
    import hashlib

    return hashlib.blake2b(json.dumps(sorted(_bindings(cs).items())).encode(),
                           digest_size=16).hexdigest()


def scheduler_phase(dev, full=(5120, 5120), north_star=(10_000, 50_000), preempt=(5120, 64)):
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
    if r_dev["bindings_digest"] != r_cpu["bindings_digest"]:
        raise AssertionError("6a random: card != CPU (bindings digest)")
    out["6a"] = {
        "mixed": {"batches": len(v_dev), "bound": sum(1 for v in b_dev.values() if v),
                  "card_equals_cpu": True},
        "preemption": {"preemptions": len(pp_dev), "card_equals_cpu": True,
                       "domain_counts_launches": pr_dev["domain_counts_launches"]},
        "random": {"bound": r_dev["bound"], "invariants_held_card_and_cpu": True,
                   "cpu_bound": r_cpu["bound"], "card_equals_cpu": True,
                   "threefry_launches": r_dev["threefry_launches"]},
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
    # 6c: full width, the production default config; then card == CPU at
    # the north star's width and a reduced depth (the CPU port's draws are
    # the plain versions of the card's threefry kernel)
    out["6c"] = scheduler_random(dev, *north_star)
    log("scheduler 6c " + json.dumps(out["6c"]))
    shape = (north_star[0], min(north_star[1], NORTH_STAR_CPU_PODS))
    r_dev = scheduler_random(dev, *shape, label="6c reduced")
    r_cpu = scheduler_random(cpu, *shape, label="6c reduced")
    if r_dev["bindings_digest"] != r_cpu["bindings_digest"]:
        raise AssertionError(f"6c reduced {shape}: card != CPU (bindings digest)")
    out["6c_reduced"] = {"nodes": shape[0], "pods": shape[1], "card_equals_cpu": True,
                         "bindings_digest": r_cpu["bindings_digest"],
                         "cpu_wall_s": r_cpu["wall_s"],
                         "threefry_launches": r_dev["threefry_launches"]}
    log("scheduler 6c reduced " + json.dumps(out["6c_reduced"]))
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
    dc.LAUNCHES = ss.LAUNCHES = 0
    t0 = time.perf_counter()
    results, report = run_loop(sched, loop, **kw)
    launches, steps = dc.LAUNCHES, ss.LAUNCHES
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
        "solve_s": sum(r.solve_seconds for r in results), **timing, "scan_step_launches": steps,
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
    gs.LAUNCHES = 0
    _, report, reading = loop_reading(sched, "drain", "7d")
    reading["grouped_spread_launches"] = gs.LAUNCHES
    del sched._dispatch_stream
    if report.drained != n_pods:
        raise AssertionError(f"7d: {report.drained} of {n_pods} bound")
    check_cluster(cs, "7d")
    # the spread chunks aggregate inside the fused spread loop (phase 15),
    # so a drain of whole chunks may launch no domain_counts kernel
    if dev.type == "cuda" and reading["domain_counts_launches"] + gs.LAUNCHES <= 0:
        raise AssertionError("7d: the drain launched neither domain_counts nor grouped_spread")
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


# -- phase 9: the simulator, the perf runner and serve ------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
SIM_CYCLES = 8
# the ladder's counters that a batch served below the top rung moves
LADDER_KEYS = ("breaker_transitions", "batch_failures", "fallback_solves")
PERF_YAML = os.path.join(REPO, "kubernetes_tpu_torch", "perf", "performance-config.yaml")
# the two workloads whose preemptors the copied runner leaves pending: its
# drain stops at the first round that binds nothing, which the preemption
# round is (the JAX package's runner does the same; ROADMAP queue 3)
PREEMPTION_CASES = ("SchedulingPreemption", "SchedulingPreemptionUnderChurn")


class HeldLaunch:
    """While active, the first ``n`` domain_counts launches on the card
    (a sharded aggregation's first launch on each of its n shards) are
    held against the plain version on the same inputs, read right after
    each launch (a comparison launches no kernel, so the path's count is
    untouched). Nothing is raised inside the launch: the Scheduler's
    ladder would take an error there for a solve failure and retry the
    batch, unchecked. The verdict is kept and ``require`` raises it once
    the run is over; a comparison that did not finish fails it too."""

    def __init__(self, label, n=1):
        self.label, self.tried, self.checked = label, False, False
        self.max_abs_err = self.first = None
        self.n, self.held = n, []

    def __enter__(self):
        call = self._call = dc.Aggregation.__call__

        def held(agg):
            out = call(agg)
            if len(self.held) < self.n and agg._args is not None:
                self.tried = True
                want = dc.aggregate_plain(agg.sets, agg.d_pad, counts=agg.counts,
                                          gather=agg.gather)
                torch.cuda.synchronize()
                err, first = _max_err(out, want)
                shapes = [tuple(x[0].shape) for x in agg.sets]
                self.held.append({"T x N": shapes, "d_pad": agg.d_pad, "counts": agg.counts,
                                  "gather": agg.gather, "max_abs_err": err})
                self.max_abs_err = max(self.max_abs_err or 0, err)
                if first and self.first is None:
                    self.first = f"T x N {shapes}, d_pad {agg.d_pad}: {first}"
                self.checked = len(self.held) == self.n
            return out

        dc.Aggregation.__call__ = held
        return self

    def __exit__(self, *exc):
        dc.Aggregation.__call__ = self._call
        return False

    def state(self):
        return {"launch_held_to_plain": self.checked, "comparison_started": self.tried,
                "max_abs_err": self.max_abs_err, "first_mismatch": self.first,
                "launches_held": len(self.held)}

    def require(self, launches):
        return held_verdict(self.label, self.state(), launches)


def held_verdict(label, state, launches):
    """Fails unless a path that launched the kernel had its first launch
    compared to plain to the end, with no element differing."""
    if launches and not state["launch_held_to_plain"]:
        why = "its comparison did not finish" if state["comparison_started"] else "none held"
        raise AssertionError(f"{label}: {launches} launches, {why}")
    if state["max_abs_err"]:
        raise AssertionError(f"{label}: domain_counts != plain at its first launch "
                             f"(max err {state['max_abs_err']}): {state['first_mismatch']}")
    return {"launch_held_to_plain": state["launch_held_to_plain"],
            "max_abs_err": state["max_abs_err"]}


def child(out_path, argv):
    """``python chip_smoke.py --child OUT -- ARGS``: run ``python -m
    kubernetes_tpu_torch ARGS`` in this process, with domain_counts'
    launches counted, the first one held to plain and the ladder's
    counters read, and write all three to OUT when it ends (serve ends on
    SIGTERM); the parent gates on them."""
    import runpy

    rc, held = 0, HeldLaunch("child " + " ".join(argv[:1]))
    ladder0 = TopTier.counts()
    dc.LAUNCHES = 0
    sys.argv = ["python -m kubernetes_tpu_torch", *argv]
    try:
        with held:
            runpy.run_module("kubernetes_tpu_torch", run_name="__main__", alter_sys=True)
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    finally:
        ladder = TopTier.counts()
        with open(out_path, "w") as f:
            json.dump({"launches": dc.LAUNCHES, "held": held.state(),
                       "ladder_moved": {k: ladder[k] - ladder0[k] for k in ladder
                                        if ladder[k] != ladder0[k]}}, f)
    return rc


def child_verdict(label, result):
    """The parent's gate on a ``--child`` run: its first launch equal to
    plain, and no breaker transition, batch failure, fallback solve or
    quarantine counted (every batch served at the ladder's top rung)."""
    if result["ladder_moved"]:
        raise AssertionError(f"{label}: left the top tier: {result['ladder_moved']}")
    return held_verdict(label, result["held"], result["launches"])


def _child_cmd(out_path, argv):
    return [sys.executable, os.path.abspath(__file__), "--child", out_path, "--", *argv]


def _trace_parts(lines):
    recs = [json.loads(x) for x in lines]
    head = [r for r in recs if r["k"] == "h"]
    foot = [r for r in recs if r["k"] == "f"]
    body = [x for x, r in zip(lines, recs) if r["k"] in ("e", "d")]
    return head, body, foot


def traces_match(label, ours, ref):
    """The simulator's parity rule: header equal, event and decision lines
    byte-identical, footer bindings, unbound, violations and summary
    equal (no summary field is excused between the card and the CPU run
    given the card's ladder)."""
    h1, b1, f1 = _trace_parts(ours)
    h2, b2, f2 = _trace_parts(ref)
    if h1 != h2 or len(f1) != 1 or len(f2) != 1:
        raise AssertionError(f"{label}: trace header or footer differs")
    if b1 != b2:
        i = next((i for i, (a, b) in enumerate(zip(b1, b2)) if a != b), min(len(b1), len(b2)))
        raise AssertionError(f"{label}: event/decision line {i} differs "
                             f"({len(b1)} vs {len(b2)} lines)")
    for key in ("bindings", "unbound", "violations", "summary"):
        if f1[0][key] != f2[0][key]:
            raise AssertionError(f"{label}: footer {key} differs")


def sim_phase(dev, cycles=SIM_CYCLES):
    """9a: each profile twice on ``dev`` with the same seed (--selfcheck),
    every invariant OK, the two traces byte-identical, and the trace equal
    to the CPU port's. The CPU run is given the card's ladder, (single,
    cpu, host): the fault profiles' injector draws once per rung, so their
    decisions follow the ladder's shape. Only the profiles that inject
    solver faults (a fault rate or poison pods) may leave the top rung;
    in every other profile no breaker transition, batch failure or
    fallback solve may be counted on the card."""
    import kubernetes_tpu_torch.resilience as rz
    import kubernetes_tpu_torch.scheduler as sm
    from kubernetes_tpu_torch.sim import run_sim
    from kubernetes_tpu_torch.sim.harness import runnable_profiles
    from kubernetes_tpu_torch.sim.profiles import PROFILES

    card_ladder = rz.build_ladder(dev)
    profiles = runnable_profiles()  # all 24, the fleet's 7 on one scheduler
    out, launches = {}, 0
    t0 = time.perf_counter()
    with HeldLaunch("sim 9a") as held:
        for p in profiles:
            build = sm.build_ladder
            sm.build_ladder = lambda device: card_ladder
            try:
                ref = run_sim(p, seed=SEED, cycles=cycles, device="cpu")
            finally:
                sm.build_ladder = build
            faulty = PROFILES[p].solver_fault_rate > 0 or PROFILES[p].poison_rate > 0
            ladder0 = TopTier.counts()
            dc.LAUNCHES = 0
            t = time.perf_counter()
            a = run_sim(p, seed=SEED, cycles=cycles, device=dev)
            secs, n = time.perf_counter() - t, dc.LAUNCHES
            b = run_sim(p, seed=SEED, cycles=cycles, device=dev)
            ladder1 = TopTier.counts()
            moved = {k: ladder1[k] - ladder0[k] for k in LADDER_KEYS if ladder1[k] != ladder0[k]}
            if not faulty and (moved or a.summary["resilience"]["trips"]):
                raise AssertionError(f"9a {p}: left the top tier on {dev.type} with no fault "
                                     f"injected: {moved}, {a.summary['resilience']}")
            if not a.ok:
                raise AssertionError(f"9a {p}: settled {a.settled}, violations "
                                     f"{[v.as_dict() for v in a.violations][:4]}")
            if a.trace.lines != b.trace.lines or a.journal_lines != b.journal_lines:
                raise AssertionError(f"9a {p}: two same-seed runs on {dev.type} differ")
            # the relax planner's float32 work (megaplan's probe and warm
            # start) may round apart on the card and the CPU: ROADMAP's
            # float parity rule holds such a profile by its invariants
            # (every one OK above, check_megaplan included) and records
            # the first line that differs; every other profile is byte
            # equal or fails here
            float_plan = PROFILES[p].backlog_warm_start
            equal, first_diff = a.trace.lines == ref.trace.lines, None
            if not (float_plan and not equal):
                traces_match(f"9a {p} {dev.type} vs cpu", a.trace.lines, ref.trace.lines)
            else:
                first_diff = next((i for i, (x, y) in enumerate(zip(a.trace.lines,
                                                                     ref.trace.lines))
                                   if x != y), min(len(a.trace.lines), len(ref.trace.lines)))
            s = a.summary
            out[p] = {"seconds": secs, "domain_counts_launches": n, "events": s["events"],
                      "bound": s["bound"], "journal_records": s["journal_records"],
                      "resilience_trips": s["resilience"]["trips"],
                      "faults_injected": faulty, "ladder_moved": moved, "invariants": "OK",
                      "selfcheck": "byte-identical", "card_equals_cpu": equal,
                      "first_differing_line": first_diff}
            launches += n
            log("sim 9a " + json.dumps({p: out[p]}))
    return {"profiles": out, "cycles": cycles, "ladder": list(card_ladder),
            "domain_counts_launches": launches, **held.require(launches),
            "phase_s": time.perf_counter() - t0}


def _yaml_cases():
    import yaml

    with open(PERF_YAML) as f:
        return yaml.safe_load(f)


def expected_pods(case, params):
    """Pods the workload should bind: every created pod without a
    scheduling gate, plus the churn op's pods (each bound, then deleted)."""
    from kubernetes_tpu_torch.perf.runner import _resolve_count

    n = 0
    for op in case["workloadTemplate"]:
        if op["opcode"] in ("createPods", "createPodsSteady"):
            spec = (op.get("podTemplate") or {}).get("spec") or {}
            if not spec.get("schedulingGates"):
                n += _resolve_count(op, params)
        elif op["opcode"] == "churn":
            n += int(op.get("number") or 1)
    return n


def _recorded_runner(runner_mod):
    """Patch the runner's ClusterState and Scheduler so the caller keeps
    each one it builds: ``made`` maps each class's name to its instances,
    ``base`` holds the two classes to put back."""
    base = (runner_mod.ClusterState, runner_mod.Scheduler)
    made = {cls.__name__: [] for cls in base}

    def recording(cls):
        class Recording(cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made[cls.__name__].append(self)
        return Recording

    runner_mod.ClusterState, runner_mod.Scheduler = map(recording, base)
    return made, base


def perf_phase(dev, yaml_timeout=900, anti=(5120, 5120), spread=(5120, 10240)):
    """9b: (1) the shipped YAML whole through ``python -m kubernetes_tpu_torch
    perf`` on ``dev``, in a subprocess; (2) two workloads at full width
    through ``PerfRunner.run_workload`` with the default config, every pod
    placed, no two anti pods on one node, the kernel held to plain at the
    path's first launch."""
    import tempfile

    import kubernetes_tpu_torch.perf.runner as runner_mod
    from kubernetes_tpu_torch.config import types as ct

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        res_path = os.path.join(tmp, "child.json")
        argv = ["perf", PERF_YAML] + (["--device", "cpu"] if dev.type == "cpu" else [])
        proc = subprocess.run(_child_cmd(res_path, argv), cwd=REPO, capture_output=True,
                              text=True, timeout=yaml_timeout)
        lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
        with open(res_path) as f:
            yaml_child = json.load(f)
    for x in lines:
        log("perf 9b.1 " + json.dumps(x))
    log(f"perf 9b.1 exit code {proc.returncode}")
    if proc.returncode not in (0, 1) or "Traceback" in proc.stderr:
        raise AssertionError(f"9b.1: the perf CLI raised (exit {proc.returncode}):\n"
                             + proc.stderr[-3000:])
    cases = {c["name"]: c for c in _yaml_cases()}
    want = {(c["name"], w["name"]): expected_pods(c, w.get("params") or {})
            for c in cases.values() for w in c["workloads"]}
    got = {(x["testCase"], x["workload"]): x for x in lines}
    if set(got) != set(want):
        raise AssertionError(f"9b.1: workloads {sorted(got)} != the YAML's {sorted(want)}")
    # the preemption pair (the YAML's only 50Nodes workloads) on the CPU
    # port: what the copied runner binds there
    cpu_runner = runner_mod.PerfRunner(ct.scheduler_config(ct.KubeSchedulerConfiguration()),
                                       device="cpu")
    cpu_pre = {(r.test_case, r.workload): r.scheduled
               for r in cpu_runner.run_file(PERF_YAML, workload_filter="50Nodes")}
    below, table = [], {}
    for key, x in sorted(got.items()):
        if key[0] in PREEMPTION_CASES:
            if x["scheduled"] != cpu_pre[key]:
                raise AssertionError(f"9b.1 {key}: scheduled {x['scheduled']}, the CPU port "
                                     f"{cpu_pre[key]}")
        elif x["scheduled"] != want[key]:
            raise AssertionError(f"9b.1 {key}: {x['scheduled']} of {want[key]} pods placed")
        table["/".join(key)] = {"scheduled": x["scheduled"], "expected": want[key],
                                "steady_pods_per_s": x["throughput"]["steady"],
                                "threshold": x.get("threshold"), "passed": x.get("passed", True)}
        if not x.get("passed", True):
            below.append(key)
            log(f"FAIL perf 9b.1 {'/'.join(key)}: steady {x['throughput']['steady']} pods/s "
                f"below threshold {x['threshold']} (scheduled {x['scheduled']} of {want[key]})")
    out["yaml"] = {"exit_code": proc.returncode, "workloads": table,
                   "below_threshold": ["/".join(k) for k in below],
                   "domain_counts_launches": yaml_child["launches"],
                   "top_tier_held": True, **child_verdict("9b.1", yaml_child)}

    # (2) full width through run_workload, the default config
    sched_cfg = ct.scheduler_config(ct.KubeSchedulerConfiguration())
    runner = runner_mod.PerfRunner(sched_cfg, device=dev)
    for case_name, params, label in (
            ("SchedulingPodAntiAffinity", {"initNodes": anti[0], "measurePods": anti[1]},
             "anti"),
            ("SchedulingPodTopologySpread", {"initNodes": spread[0],
                                             "measurePods": spread[1]}, "spread")):
        case = cases[case_name]
        made, base = _recorded_runner(runner_mod)
        try:
            guard = LoopGuard(None, f"9b {label}")
            with HeldLaunch(f"perf 9b {label}") as held:
                dc.LAUNCHES = 0
                t = time.perf_counter()
                r = runner.run_workload(case_name, "full width", case["workloadTemplate"],
                                        params, os.path.dirname(PERF_YAML))
                wall, n = time.perf_counter() - t, dc.LAUNCHES
        finally:
            runner_mod.ClusterState, runner_mod.Scheduler = base
        (cs,), (guard.sched,) = made["ClusterState"], made["Scheduler"]
        guard.tier()
        held_top = guard.close()
        placed = sum(1 for p in cs.list_pods() if p.node_name)
        if r.scheduled != params["measurePods"] or placed != params["measurePods"]:
            raise AssertionError(f"9b {label}: {r.scheduled} of {params['measurePods']} placed")
        if label == "anti":
            check_cluster(cs, f"9b {label}")
        per_node = Counter(p.node_name for p in cs.list_pods() if p.node_name)
        out[label] = {"case": case_name, **params, "scheduled": r.scheduled,
                      "wall_s": wall, "steady_pods_per_s": r.steady_pods_per_sec(),
                      "latency_p50_s": r.latency_summary()["p50"],
                      "latency_p99_s": r.latency_summary()["p99"],
                      "device_solve_s": r.solve_seconds, "domain_counts_launches": n,
                      "pods_per_node_max": max(per_node.values()),
                      "pods_per_node_min": min(per_node.get(nd.name, 0)
                                               for nd in cs.list_nodes()),
                      **held.require(n), **held_top}
        log(f"perf 9b {label} " + json.dumps(out[label]))
    out["domain_counts_launches"] = (out["yaml"]["domain_counts_launches"]
                                     + out["anti"]["domain_counts_launches"]
                                     + out["spread"]["domain_counts_launches"])
    out["phase_s"] = time.perf_counter() - t0
    return out


def _http(port, method, path, payload=None, timeout=120):
    import urllib.request

    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = resp.read()
    return json.loads(body) if body != b"ok" else "ok"


def serve_phase(dev, n_nodes=240, n_requests=64, startup_s=180, fleet_hub=None):
    """9c: ``python -m kubernetes_tpu_torch --leader-elect serve --mode
    scheduler`` on ``dev`` as a subprocess on a free port (through
    ``child``, which counts its launches); 240 nodes and 240 bound mixed
    pods ingested through its endpoints; 64 filter / prioritize requests in
    wire JSON whose replies must equal an in-process CPU ExtenderCore's on
    the same cluster; 240 pending mixed pods its background loop must
    bind; a clean exit on SIGTERM.

    11d (``fleet_hub`` set): the same, with ``fleet.hubAddress`` at that
    hub and the decision journal on, so the served Scheduler is a fleet
    replica: ``GET /debug/hub`` must report the hub, and a pod it bound
    must render through ``obs explain --fleet --hub`` from the journal the
    replica shipped."""
    import signal
    import socket
    import tempfile

    from kubernetes_tpu_torch.server.extender import ExtenderCore

    label = "11d" if fleet_hub else "9c"
    t0 = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path, res_path = os.path.join(tmp, "cfg.json"), os.path.join(tmp, "child.json")
        cfg = {"tpuSolver": {"tieBreak": "first", "balancedFdtype": "float64"}}
        if fleet_hub:
            cfg["fleet"] = {"replica": "s0", "replicas": ["s0"], "hubAddress": fleet_hub}
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        log_path = os.path.join(tmp, "serve.log")
        argv = ["--config", cfg_path, "--leader-elect", "serve", "--mode", "scheduler",
                "--node-cache-capable", "--port", str(port)]
        if fleet_hub:
            argv.append("--obs")
        if dev.type == "cpu":
            argv += ["--device", "cpu"]
        with open(log_path, "w") as logf:
            proc = subprocess.Popen(_child_cmd(res_path, argv), cwd=REPO, stdout=logf,
                                    stderr=subprocess.STDOUT)
        try:
            deadline = time.perf_counter() + startup_s
            while True:
                try:
                    if _http(port, "GET", "/healthz", timeout=5) == "ok":
                        break
                except OSError:
                    pass
                if proc.poll() is not None or time.perf_counter() > deadline:
                    raise AssertionError(f"{label}: serve never became healthy:\n"
                                         + open(log_path).read()[-3000:])
                time.sleep(0.25)
            up_s = time.perf_counter() - t0
            ref = _placed_cluster(n_nodes, n_nodes)
            nodes = sorted(ref.list_nodes(), key=lambda n: n.name)
            bound = sorted((p for p in ref.list_pods()), key=lambda p: p.key)
            _http(port, "POST", "/api/nodes", {"items": [n.to_dict() for n in nodes]})
            _http(port, "POST", "/api/pods", {"items": [p.to_dict() for p in bound]})
            st = _http(port, "GET", "/api/state")
            if st["nodes"] != n_nodes or st["unscheduled"] != 0:
                raise AssertionError(f"{label}: state after ingest {st}")
            core = ExtenderCore(ref, node_cache_capable=True, device="cpu",
                                solver_config=ExactSolverConfig(tie_break="first",
                                                                balanced_fdtype="float64"))
            names = [n.name for n in nodes]
            reqs = extender_requests(n_nodes, n_requests, names)
            want = json.loads(json.dumps(core.run_many(reqs)))
            rtt = []
            for (verb, args), w in zip(reqs, want):
                t = time.perf_counter()
                got = _http(port, "POST", f"/{verb}", args)
                rtt.append(time.perf_counter() - t)
                if got != w:
                    raise AssertionError(f"{label}: /{verb} for {args['pod']['metadata']['name']} "
                                         "differs from the CPU ExtenderCore's reply")
            pending = [make_pod(2 * n_nodes + i) for i in range(n_nodes)]
            t = time.perf_counter()
            _http(port, "POST", "/api/pods", {"items": [p.to_dict() for p in pending]})
            while True:
                st = _http(port, "GET", "/api/state")
                if st["unscheduled"] == 0:
                    break
                if time.perf_counter() - t > 120:
                    raise AssertionError(f"{label}: the background loop left {st}")
                time.sleep(0.05)
            bind_s = time.perf_counter() - t
            fleet = None
            if fleet_hub:
                status = _http(port, "GET", "/debug/hub")
                if not isinstance(status, dict) or "epoch" not in status or "client" not in status:
                    raise AssertionError(f"11d: /debug/hub answered {status}")
                # the replica ships its journal on its write-behind flushes;
                # the pods it bound render from the hub's aggregation
                pod = f"default/{pending[0].name}"
                deadline = time.perf_counter() + 30
                while True:
                    rc_x, text = explain_hub(fleet_hub, pod)
                    if rc_x == 0 and "bound" in text:
                        break
                    if time.perf_counter() > deadline:
                        raise AssertionError(f"11d: explain --fleet --hub for {pod} "
                                             f"exited {rc_x}:\n{text[-2000:]}")
                    time.sleep(0.25)
                fleet = {"debug_hub": {k: status[k] for k in sorted(status)
                                       if not isinstance(status[k], (dict, list))},
                         "explained_served_pod": pod}
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
                rc = "killed"
        serve_log = open(log_path).read()
        if rc != 0:
            raise AssertionError(f"{label}: serve exited {rc} on SIGTERM:\n{serve_log[-3000:]}")
        if "leader election: acquired lease" not in serve_log:
            raise AssertionError(f"{label}: no leader lease acquired")
        with open(res_path) as f:
            served = json.load(f)
    if dev.type == "cuda" and not served["launches"]:
        raise AssertionError(f"{label}: serve launched no kernel")
    verdict = child_verdict(label, served)
    rtt = np.asarray(rtt)
    out = {"nodes": n_nodes, "bound_at_ingest": n_nodes, "requests": n_requests,
           "replies_equal_cpu": True, "pending_bound": n_nodes, "startup_s": up_s,
           "request_p50_s": float(np.percentile(rtt, 50)),
           "request_p99_s": float(np.percentile(rtt, 99)),
           "bind_all_s": bind_s, "exit_code": rc,
           "domain_counts_launches": served["launches"],
           "top_tier_held": True, **verdict,
           "phase_s": time.perf_counter() - t0}
    if fleet:
        out["fleet"] = fleet
    else:
        log("serve 9c " + json.dumps(out))
    return out


# -- phase 10: the auction, the relax planner, the bulk gRPC path, the rebalancer --

NS_NODES, NS_PODS = 10_240, 51_200  # BASELINE.json's north star (bench.py NS_*)
BD_NODES, BD_PODS = 102_400, 512_000  # the relax planner's shape (bench.py BD_*)
MP_NODES, MP_PODS = 200_000, 2_000_000  # the 2M-pod relax arm (bench.py MP_*)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def median_timed(fn, dev, runs=3):
    """One warm call, then the median wall of ``runs`` calls, each ended by
    a synchronize: (seconds, the last call's result)."""
    fn()
    _sync(dev)
    times, out = [], None
    for _ in range(runs):
        t = time.perf_counter()
        out = fn()
        _sync(dev)
        times.append(time.perf_counter() - t)
    return float(np.median(times)), out


def north_star_inputs(hetero, n_nodes=NS_NODES, n_pods=NS_PODS):
    """bench.py ladder5_north_star's tensors: 8 request classes over 8
    static classes on an empty cluster of 16 CPU / 64Gi / 110-pod nodes;
    ``hetero``: its variant with 128 request classes over 32 static
    classes, each class's node mask a random 60 %. The auction's 11
    positional inputs, as numpy."""
    rng = np.random.default_rng(0)
    k, c, rc = 3, 8, 8
    alloc = np.zeros((k, n_nodes), np.int64)
    alloc[0], alloc[1] = 16_000, 64 * 1024**3
    rc_req = np.zeros((rc, k), np.int64)
    rc_req[:, 0] = rng.integers(1, 9, rc) * 250
    rc_req[:, 1] = rng.integers(1, 5, rc) * 1024**3
    rc_static = (np.arange(rc) % c).astype(np.int32)
    rc_of = rng.integers(0, rc, n_pods).astype(np.int32)
    priority = rng.integers(0, 10, n_pods).astype(np.int32)
    mask = np.ones((c, n_nodes), bool)
    if hetero:
        rc_h, c_h = 128, 32
        rng_h = np.random.default_rng(1)
        mask = rng_h.random((c_h, n_nodes)) < 0.6
        rc_req = np.zeros((rc_h, k), np.int64)
        rc_req[:, 0] = rng_h.integers(1, 17, rc_h) * 125
        rc_req[:, 1] = rng_h.integers(1, 9, rc_h) * (512 * 1024**2)
        rc_static = rng_h.integers(0, c_h, rc_h).astype(np.int32)
        rc_of = rng_h.integers(0, rc_h, n_pods).astype(np.int32)
    return [alloc, np.zeros((k, n_nodes), np.int64), np.zeros(n_nodes, np.int32),
            np.full(n_nodes, 110, np.int32), np.ones(n_nodes, bool), mask, rc_req, rc_static,
            rc_of, priority, np.ones(n_pods, bool)]


def auction(dev, host_args, cfg):
    """``_single_shot`` on fresh device copies of ``host_args``: (assigned,
    used, pod_count, rounds, reads), tensors on ``dev``."""
    from kubernetes_tpu_torch.solver.single_shot import _single_shot

    args = [torch.tensor(a, device=dev) for a in host_args]
    reads = []
    a, used, cnt, _, rounds = _single_shot(
        *args, max_rounds=cfg.max_rounds, price_step=cfg.price_step, top_t=cfg.top_t,
        repair_rounds=cfg.repair_rounds, pack=cfg.objective == "pack", reads=reads)
    return a, used, cnt, rounds, len(reads)


def _host(out):
    return [x.cpu().numpy() for x in out[:3]] + list(out[3:])


def north_star_phase(dev, shape=(NS_NODES, NS_PODS)):
    """10a: the north star, 51,200 pods onto 10,240 nodes, uniform then
    heterogeneous, default SingleShotConfig: solve seconds (median of 3
    after a warm call, uploads included), rounds, device reads, placed;
    the card's assignments, node state and rounds equal a CPU run's bit
    for bit."""
    from kubernetes_tpu_torch.solver.single_shot import SingleShotConfig

    cfg = SingleShotConfig()
    out = {}
    n_nodes, n_pods = shape
    for variant in ("uniform", "hetero_rc128"):
        host_args = north_star_inputs(variant != "uniform", n_nodes, n_pods)
        secs, res = median_timed(lambda: auction(dev, host_args, cfg), dev)
        got = _host(res)
        t = time.perf_counter()
        want = _host(auction(torch.device("cpu"), host_args, cfg))
        cpu_s = time.perf_counter() - t
        for name, g, w in zip(("assignments", "used", "pod_count"), got, want):
            if not np.array_equal(g, w):
                raise AssertionError(f"10a {variant}: {dev.type} {name} != cpu: "
                                     f"{_first_mismatch(g, w)}")
        if got[3:] != want[3:]:
            raise AssertionError(f"10a {variant}: rounds/reads {got[3:]} != cpu {want[3:]}")
        placed = int((got[0] >= 0).sum())
        out[variant] = {"pods": n_pods, "nodes": n_nodes,
                        "request_classes": int(host_args[6].shape[0]), "solve_s": secs,
                        "pods_per_s": placed / secs, "rounds": got[3], "device_reads": got[4],
                        "placed": placed, "cpu_solve_s": cpu_s, "card_equals_cpu": True}
        log("auction 10a " + json.dumps({variant: out[variant]}))
    return out


def megaplan_inputs(n_nodes, n_pods, seed=12):
    """bench.py _megaplan_tensors: 8 request classes over preloaded nodes
    (0..8 of 16 CPU used), and the integer pack score both plans are
    valued under."""
    rng = np.random.default_rng(seed)
    k, c, rc = 3, 8, 8
    alloc = np.zeros((k, n_nodes), np.int64)
    alloc[0], alloc[1] = 16_000, 64 * 1024**3
    load = rng.integers(0, 9, n_nodes)
    used = np.zeros((k, n_nodes), np.int64)
    used[0], used[1] = load * 1_000, load * (2 * 1024**3)
    rc_req = np.zeros((rc, k), np.int64)
    rc_req[:, 0] = rng.integers(1, 9, rc) * 250
    rc_req[:, 1] = rng.integers(1, 5, rc) * 1024**3
    rc_static = (np.arange(rc) % c).astype(np.int32)
    rc_of = rng.integers(0, rc, n_pods).astype(np.int32)
    priority = rng.integers(0, 10, n_pods).astype(np.int32)
    headroom = (100.0 * ((alloc[0] - used[0]) / np.maximum(alloc[0], 1)
                         + (alloc[1] - used[1]) / np.maximum(alloc[1], 1)) / 2.0).astype(np.int64)
    args = [alloc, used, load.astype(np.int32), np.full(n_nodes, 110, np.int32),
            np.ones(n_nodes, bool), np.ones((c, n_nodes), bool), rc_req, rc_static, rc_of,
            priority, np.ones(n_pods, bool)]
    return args, 100 - headroom


def check_no_overcommit(label, host_args, assigned):
    """Host check of a plan: every placement on a real node, and per node
    the preload plus the placed pods' requests within allocatable and the
    pod count within max pods."""
    alloc, used0, cnt0, max_pods = host_args[:4]
    rc_req, rc_of = host_args[6], host_args[8]
    n = alloc.shape[1]
    placed = assigned >= 0
    if placed.any() and assigned.max() >= n:
        raise AssertionError(f"{label}: a pick past the last node")
    tgt = assigned[placed]
    for k in range(alloc.shape[0]):
        load = np.bincount(tgt, weights=rc_req[rc_of[placed], k].astype(np.float64), minlength=n)
        if (used0[k] + load > alloc[k]).any():
            raise AssertionError(f"{label}: resource {k} overcommitted")
    if (cnt0 + np.bincount(tgt, minlength=n) > max_pods).any():
        raise AssertionError(f"{label}: pod count overcommitted")
    return int(placed.sum())


def relax_plan(dev, host_args, rcfg, repair):
    """The relax plan on ``dev`` (as RelaxSolver runs it, on raw tensors):
    relaxation, rounding, then ``repair`` (an auction config, or None) on
    the tail: (assigned numpy, iterations, residual, relax reads, repair
    rounds, repair reads)."""
    from kubernetes_tpu_torch.solver.relax import _relax
    from kubernetes_tpu_torch.solver.single_shot import _single_shot

    args = [torch.tensor(a, device=dev) for a in host_args]
    relax_reads = []
    a, used, cnt, _, _, _, iters, res = _relax(
        *args, rcfg.tol, rcfg.temp, rcfg.step, max_iters=rcfg.max_iters,
        pack=rcfg.objective == "pack", reads=relax_reads)
    rep_rounds = rep_reads = 0
    if repair is not None:
        tail = args[10] & (a < 0)
        reads = []
        rep_a, used, cnt, _, rep_rounds = _single_shot(
            args[0], used, cnt, *args[3:10], tail, max_rounds=repair.max_rounds,
            price_step=repair.price_step, top_t=repair.top_t,
            repair_rounds=repair.repair_rounds, pack=repair.objective == "pack", reads=reads)
        a = torch.where(tail, rep_a, a)
        rep_reads = len(reads)
    return a.cpu().numpy(), iters, float(res), len(relax_reads), rep_rounds, rep_reads


def relax_phase(dev, shape=(BD_NODES, BD_PODS), mega=(MP_NODES, MP_PODS), budget_s=60.0):
    """10b: bench.py ladder16_megaplan on the card. The relax planner
    (pack objective, the plan auction repairing its tail) against the plan
    auction alone (``plan_auction_config``) on 512,000 pods x 102,400
    preloaded nodes: seconds (median of 3 after a warm call), iterations,
    residual, reads, and the objective ratio under the shared pack score;
    no overcommit in either plan. Then the 2,000,000 x 200,000 relaxed
    solve, after ``relax_estimate`` fits the card's budget, if the phase
    has used less than ``budget_s``."""
    from kubernetes_tpu_torch.rebalance.planner import plan_auction_config
    from kubernetes_tpu_torch.solver import budget as hbm
    from kubernetes_tpu_torch.solver.relax import RelaxConfig

    t0 = time.perf_counter()
    rcfg, acfg = RelaxConfig(objective="pack"), plan_auction_config()
    n_nodes, n_pods = shape
    host_args, pack_score = megaplan_inputs(n_nodes, n_pods)
    auction_s, a_out = median_timed(lambda: auction(dev, host_args, acfg), dev)
    a_assigned = a_out[0].cpu().numpy()
    relax_s, r_out = median_timed(lambda: relax_plan(dev, host_args, rcfg, acfg), dev)
    r_assigned, iters, res, relax_reads, rep_rounds, rep_reads = r_out
    placed_a = check_no_overcommit("10b auction", host_args, a_assigned)
    placed_r = check_no_overcommit("10b relax", host_args, r_assigned)
    obj_a = int(pack_score[a_assigned[a_assigned >= 0]].sum())
    obj_r = int(pack_score[r_assigned[r_assigned >= 0]].sum())
    out = {"pods": n_pods, "nodes": n_nodes, "auction_plan_s": auction_s,
           "auction_rounds": a_out[3], "auction_reads": a_out[4], "auction_placed": placed_a,
           "relax_plan_s": relax_s, "relax_iterations": iters, "relax_residual": res,
           "relax_reads": relax_reads, "repair_rounds": rep_rounds, "repair_reads": rep_reads,
           "relax_placed": placed_r, "objective_ratio": obj_r / max(obj_a, 1),
           "speedup_vs_auction": auction_s / max(relax_s, 1e-9), "no_overcommit": True}
    log("relax 10b " + json.dumps(out))
    mega_nodes, mega_pods = mega
    est = hbm.relax_estimate(mega_nodes, mega_pods, rc=8)
    budget = hbm.device_budget_bytes(0, dev)
    out["mega"] = {"pods": mega_pods, "nodes": mega_nodes,
                   "estimated_bytes": est.per_device_bytes, "budget_bytes": budget}
    if est.per_device_bytes > budget or time.perf_counter() - t0 > budget_s:
        out["mega"]["ran"] = False
        log("relax 10b mega skipped " + json.dumps(out["mega"]))
        return out
    hbm.assert_index_headroom(est.pod_pad, est.node_pad, rc_pad=est.rc_pad)
    host2, _ = megaplan_inputs(mega_nodes, mega_pods, seed=13)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mega_s, m_out = median_timed(lambda: relax_plan(dev, host2, rcfg, None), dev, runs=1)
    out["mega"].update(
        ran=True, relax_s=mega_s, iterations=m_out[1], residual=m_out[2],
        placed=check_no_overcommit("10b mega", host2, m_out[0]),
        pods_per_s=mega_pods / mega_s,
        peak_allocated_bytes=(torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                              else None))
    log("relax 10b mega " + json.dumps(out["mega"]))
    return out


class SolveClock:
    """While active, every bulk solve (the exact solver's and the auction's
    ``solve``) is timed on the host, a synchronize at its end, so a wire
    round trip splits into the solve and the rest; the auction's device
    reads are kept too."""

    def __enter__(self):
        from kubernetes_tpu_torch.solver.exact import ExactSolver as _Exact
        from kubernetes_tpu_torch.solver.single_shot import SingleShotSolver

        self.seconds, self.reads, self._saved = [], [], []
        for cls in (_Exact, SingleShotSolver):
            fn = cls.solve

            def timed(inner, *a, _fn=fn, **kw):
                t = time.perf_counter()
                r = _fn(inner, *a, **kw)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self.seconds.append(time.perf_counter() - t)
                self.reads.append(getattr(inner, "last_reads", None))
                return r

            self._saved.append((cls, fn))
            cls.solve = timed
        return self

    def __exit__(self, *exc):
        for cls, fn in self._saved:
            cls.solve = fn
        return False


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _same_reply(label, got, want_bytes):
    from kubernetes_tpu_torch.server import tensorcodec

    meta, arrays = got
    wmeta, warrays = tensorcodec.decode(want_bytes)
    if meta != wmeta or sorted(arrays) != sorted(warrays):
        raise AssertionError(f"{label}: reply meta differs from the CPU's")
    for k in arrays:
        if not np.array_equal(arrays[k], warrays[k]):
            raise AssertionError(f"{label}: {k} differs from the CPU's: "
                                 f"{_first_mismatch(arrays[k], warrays[k])}")


def bulk_phase(dev, served=(1_000, 5_000), north_star=(NS_NODES, NS_PODS), evaluate_pods=256):
    """10c: the bulk tensor gRPC path through ``serve_bulk`` on ``dev`` and
    a socket. SyncNodes for 1,000 nodes; Solve for 5,000 pods in ``exact``
    ("first" tie-break) and ``single_shot`` mode (bench.py's
    served_grpc_5kx1k shape); Evaluate for 256 pods; then the north star's
    51,200 x 10,240 single-shot solve over the wire. Each: the wire round
    trip (median of 3 after a warm call) beside the server's solve
    seconds; every reply equal to an in-process CPU BulkCore's over the
    same nodes; domain_counts launches (0: columnar pods carry only
    resources)."""
    from kubernetes_tpu_torch.server import tensorcodec
    from kubernetes_tpu_torch.server.bulk import BulkClient, BulkCore, serve_bulk

    cfg = ExactSolverConfig(tie_break="first", balanced_fdtype="float64")
    out, t0 = {}, time.perf_counter()
    with HeldLaunch("bulk 10c") as held:
        dc.LAUNCHES = 0
        for label, (n_nodes, n_pods) in (("served_grpc_5kx1k", served),
                                         ("north_star_51200x10240", north_star)):
            port = _free_port()
            server = serve_bulk(ClusterState(), port=port, solver_config=cfg, device=dev)
            cpu_core = BulkCore(ClusterState(), solver_config=cfg, device="cpu")
            client = BulkClient(f"127.0.0.1:{port}", deadline_s=600.0)
            try:
                names = [f"n{i:05}" for i in range(n_nodes)]
                sync = dict(cpu_milli=np.full(n_nodes, 16_000, np.int64),
                            mem_bytes=np.full(n_nodes, 64 << 30, np.int64),
                            max_pods=np.full(n_nodes, 110, np.int32))
                t = time.perf_counter()
                applied = client.sync_nodes(names, **sync)
                sync_s = time.perf_counter() - t
                cpu_core.sync_nodes(tensorcodec.encode({"names": names}, sync))
                if applied != {"applied": n_nodes}:
                    raise AssertionError(f"10c {label}: SyncNodes answered {applied}")
                if label.startswith("served"):
                    cpu = np.full(n_pods, 250, np.int64)
                    mem = np.full(n_pods, 512 << 20, np.int64)
                    prio, modes = None, ("exact", "single_shot")
                else:
                    ns = north_star_inputs(False, n_nodes, n_pods)
                    cpu, mem = ns[6][ns[8], 0], ns[6][ns[8], 1]
                    prio, modes = ns[9], ("single_shot",)
                res = {"nodes": n_nodes, "pods": n_pods, "sync_nodes_s": sync_s}
                for mode in modes:
                    with SolveClock() as clock:
                        rt, reply = median_timed(
                            lambda: client.solve(cpu_milli=cpu, mem_bytes=mem, priority=prio,
                                                 mode=mode), dev)
                    solve_s = float(np.median(clock.seconds[1:]))
                    arrays = {"cpu_milli": cpu, "mem_bytes": mem}
                    if prio is not None:
                        arrays["priority"] = prio
                    _same_reply(f"10c {label} {mode}", reply, cpu_core.solve(
                        tensorcodec.encode({"mode": mode, "commit": False}, arrays)))
                    placed = int((reply[1]["assignments"] >= 0).sum())
                    res[mode] = {"round_trip_s": rt, "solve_s": solve_s,
                                 "auction_reads": clock.reads[-1],
                                 "wire_and_host_s": rt - solve_s, "placed": placed,
                                 "card_equals_cpu": True}
                if label.startswith("served"):
                    ecpu = np.asarray([250 * (1 + i % 64) for i in range(evaluate_pods)], np.int64)
                    emem = np.full(evaluate_pods, 1 << 30, np.int64)
                    t = time.perf_counter()
                    reply = client.evaluate(cpu_milli=ecpu, mem_bytes=emem)
                    eval_s = time.perf_counter() - t
                    _same_reply(f"10c {label} evaluate", reply, cpu_core.evaluate(
                        tensorcodec.encode({}, {"cpu_milli": ecpu, "mem_bytes": emem})))
                    res["evaluate"] = {"pods": evaluate_pods, "round_trip_s": eval_s,
                                       "shape": list(reply[1]["scores"].shape),
                                       "card_equals_cpu": True}
                out[label] = res
                log("bulk 10c " + json.dumps({label: res}))
            finally:
                client.close()
                server.stop(grace=None)
        launches = dc.LAUNCHES
    return {**out, "domain_counts_launches": launches, **held.require(launches),
            "phase_s": time.perf_counter() - t0}


def fragmented_cluster(n_nodes, seed=SEED):
    """The sim's ``fragmentation`` profile at full width: nodes of 8 CPU /
    32Gi / 110 pods, each holding 1-3 bound pods of 500m or 1 CPU / 1Gi, a
    quarter of them in a PDB-guarded cohort whose budget allows no
    disruption."""
    from kubernetes_tpu_torch.api.labels import Selector, requirements_from_match_labels
    from kubernetes_tpu_torch.api.objects import PodDisruptionBudget
    from kubernetes_tpu_torch.sim.generators import PDB_GUARD_LABEL

    rng = np.random.default_rng(seed)
    nodes = [MakeNode().name(f"frag-{i:05}").capacity(
        {"cpu": "8", "memory": "32Gi", "pods": "110"}).label(ZONE, f"z{i % 3}").obj()
        for i in range(n_nodes)]
    pods, k = [], 0
    for node in nodes:
        for _ in range(int(rng.integers(1, 4))):
            b = MakePod().name(f"frag-{k:06}").req(
                {"cpu": ("500m", "1")[int(rng.integers(0, 2))], "memory": "1Gi"})
            if rng.random() < 0.25:
                b = b.label(PDB_GUARD_LABEL, "1")
            p = b.obj()
            p.node_name = node.name
            pods.append(p)
            k += 1
    cs = _cluster(nodes, pods)
    cs.create_pdb(PodDisruptionBudget(
        name="guard", namespace="default", disruptions_allowed=0,
        selector=Selector(requirements=requirements_from_match_labels({PDB_GUARD_LABEL: "1"}))))
    return cs


def rebalance_phase(dev, n_nodes=5_120, budget=2_048, max_passes=6):
    """10d: the rebalancer in the Scheduler's loop on ``dev``: a
    fragmented cluster (``fragmented_cluster``) settled by
    ``run_until_settled`` with ``RebalanceConfig`` on (the profile's
    interval 4 s and packing bar 0.6, a churn budget of 2,048), one pass
    per interval until the detector calls it packed or ``max_passes``:
    runs, evictions, migrations, packing before and after, each pass's
    plan seconds and domain_counts launches; no PDB overrun (an
    independent tracker), no capacity violation, every pod bound."""
    from kubernetes_tpu_torch.rebalance.detector import detect
    from kubernetes_tpu_torch.rebalance.runtime import RebalanceConfig
    from kubernetes_tpu_torch.sim.invariants import RebalanceTracker, packed_utilization
    from kubernetes_tpu_torch.utils.clock import FakeClock

    class PassClock(FakeClock):
        """Virtual time for the rebalance interval; the host's clock for
        the durations the Scheduler and the rebalancer measure (the plan
        solve's seconds)."""

        def perf(self):
            return time.perf_counter()

    t0 = time.perf_counter()
    cs = fragmented_cluster(n_nodes)
    tracker = RebalanceTracker(cs)
    clock = PassClock()
    sched = Scheduler(cs, SchedulerConfig(
        batch_size=1024,
        rebalance=RebalanceConfig(interval_s=4.0, max_moves_per_cycle=budget, min_packing=0.6)),
        clock=clock, device=dev)
    before = packed_utilization(cs)
    guard = TopTier(sched, "10d")
    passes = []
    with HeldLaunch("rebalance 10d") as held:
        dc.LAUNCHES = 0
        for _ in range(max_passes):
            clock.advance(4.5)
            t = time.perf_counter()
            results = sched.run_until_settled()
            for r in results:
                guard.batch(r)
            sched.rebalancer.reconcile(cs)
            passes.append(time.perf_counter() - t)
            if not detect(sched.snapshot.update(sched.cache), min_packing=0.6).fragmented:
                break
        launches = dc.LAUNCHES
    reb = sched.rebalancer
    stats = reb.stats()
    if tracker.pdb_overruns:
        raise AssertionError(f"10d: {tracker.pdb_overruns} evictions overran a PDB")
    if stats["over_budget"] or not stats["evicted"]:
        raise AssertionError(f"10d: rebalancer stats {stats}")
    if any(not p.node_name for p in cs.list_pods()):
        raise AssertionError("10d: a pod was left unbound")
    check_cluster(cs, "10d")
    after = packed_utilization(cs)
    if after <= before:
        raise AssertionError(f"10d: packing {before} -> {after}")
    out = {"nodes": n_nodes, "pods": len(cs.list_pods()), "budget": budget,
           "runs": stats["runs"], "evictions": stats["evicted"],
           "tracker_evictions": tracker.evictions,
           "migrations_completed": stats["migrations_completed"],
           "migrations_to_target": stats["migrations_to_target"],
           "pdb_blocked": stats["pdb_blocked"], "pdb_overruns": tracker.pdb_overruns,
           "packing_before": before, "packing_after": after,
           "plan_solve_s": [r.plan_solve_s for r in reb.history],
           "pass_wall_s": passes, "domain_counts_launches": launches,
           **held.require(launches), **guard.close(),
           "phase_s": time.perf_counter() - t0}
    log("rebalance 10d " + json.dumps(out))
    return out


def phase10(dev):
    """Phase 10, each part with its own readings and checks."""
    t0 = time.perf_counter()
    out = {"north_star_10a": north_star_phase(dev), "relax_10b": relax_phase(dev),
           "bulk_10c": bulk_phase(dev), "rebalance_10d": rebalance_phase(dev)}
    out["phase_s"] = time.perf_counter() - t0
    return out


# -- phase 11: the fleet ------------------------------------------------------

FLEET_UNIVERSE = ("r0", "r1", "r2", "r3")
FD_NODES, FD_PODS = 20_480, 100_000  # 11b: 7d's scale (bench.py ladder #17 is 102,400 x 512,000)


def fleet_clock():
    """Virtual scheduling time (``now``: backoff, row ages, lease terms, so
    the fleet's decisions repeat run to run and device to device) with real
    durations (``perf``: solve seconds, bind times)."""
    from kubernetes_tpu_torch.utils.clock import FakeClock

    class FleetClock(FakeClock):
        def perf(self):
            return time.perf_counter()

    return FleetClock()


class Hub:
    """One occupancy hub (``OccupancyExchange``) behind the port's bulk gRPC
    server (``BulkCore(exchange=)``) on a free localhost port; replicas reach
    it through ``RemoteOccupancyExchange`` at ``addr``. The hub ages peers'
    rows on ``clock``: the replicas' own, when one thread drives them all
    (a replica waiting its turn is not a silent one)."""

    def __init__(self, dev, clock=None):
        from kubernetes_tpu_torch.fleet import OccupancyExchange
        from kubernetes_tpu_torch.server.bulk import BulkCore, make_grpc_server

        self.exchange = OccupancyExchange(clock)
        self.server, port = make_grpc_server(
            BulkCore(ClusterState(), exchange=self.exchange, device=dev), port=0)
        self.addr = f"127.0.0.1:{port}"
        self.server.start()

    def close(self):
        self.server.stop(grace=None)


class FleetTally:
    """While active: every hub round trip a replica makes (``BulkClient.hub_op``,
    which ``RemoteOccupancyExchange`` calls for each op and write-behind
    flush) with its wall time, and per replica the fleet's admission calls
    (``FleetRuntime.admit``), its rejections and the hand-offs that followed."""

    def __enter__(self):
        from kubernetes_tpu_torch.fleet.runtime import FleetRuntime
        from kubernetes_tpu_torch.server.bulk import BulkClient

        self.rtt, self.per = [], {}
        self._saved = (BulkClient.hub_op, FleetRuntime.admit, FleetRuntime.maybe_hand_off)
        hub_op, admit, hand_off = self._saved
        rtt, per = self.rtt, self.per

        def timed(client, op, **meta):
            t = time.perf_counter()
            try:
                return hub_op(client, op, **meta)
            finally:
                rtt.append((op, time.perf_counter() - t))

        def counted_admit(rt, pod, node_name, cache):
            why = admit(rt, pod, node_name, cache)
            c = per.setdefault(rt.replica, Counter())
            c["admits"] += 1
            c["rejected"] += why is not None
            return why

        def counted_hand_off(rt, pod, trace=""):
            to = hand_off(rt, pod, trace=trace)
            per.setdefault(rt.replica, Counter())["handoffs"] += to is not None
            return to

        BulkClient.hub_op = timed
        FleetRuntime.admit = counted_admit
        FleetRuntime.maybe_hand_off = counted_hand_off
        return self

    def __exit__(self, *exc):
        from kubernetes_tpu_torch.fleet.runtime import FleetRuntime
        from kubernetes_tpu_torch.server.bulk import BulkClient

        BulkClient.hub_op, FleetRuntime.admit, FleetRuntime.maybe_hand_off = self._saved
        return False

    def reading(self):
        secs = np.asarray([t for _, t in self.rtt], np.float64)
        per = {r: dict(c) for r, c in sorted(self.per.items())}
        for c in per.values():
            c.setdefault("handoffs", 0)
            c["requeues"] = c.get("rejected", 0) - c["handoffs"]
        return {
            "hub_round_trips": int(secs.size),
            "hub_seconds": float(secs.sum()),
            "hub_rtt_p50_s": float(np.percentile(secs, 50)) if secs.size else None,
            "hub_rtt_p99_s": float(np.percentile(secs, 99)) if secs.size else None,
            "hub_ops": dict(Counter(op for op, _ in self.rtt)),
            "per_replica": per,
        }


def fleet_replicas(dev, cs, addr, clock, universe=FLEET_UNIVERSE, batch=1024, journal=True,
                   solver=None):
    """One Scheduler per replica of ``universe`` over ``cs``, each a fleet
    replica reaching the hub at ``addr``; all on ``dev`` in this process."""
    from kubernetes_tpu_torch.fleet import FleetConfig
    from kubernetes_tpu_torch.obs import ObsConfig

    solver = solver or ExactSolverConfig(tie_break="first", balanced_fdtype="float64")
    return {rid: Scheduler(cs, SchedulerConfig(
        batch_size=batch, solver=solver, obs=ObsConfig(journal=True) if journal else None,
        fleet=FleetConfig(replica=rid, replicas=universe, hub_address=addr)),
        clock=clock, device=dev) for rid in universe}


def owned_binds(label, sched, rid, got):
    """The ownership half of no-global-overcommit, per drive: every bind a
    replica just reported landed on a node its ring assignment holds right
    now (nothing moved since: one thread drives every replica)."""
    with sched.cluster.lock:
        owners = dict(sched.fleet._assignment)
    bad = [(k, n, owners.get(n)) for k, n in got if owners.get(n) != rid]
    if bad:
        raise AssertionError(f"{label}: {rid} bound onto nodes it does not own: {bad[:4]}")


def _fleet_checks(label, cs, tracker):
    """The fleet-wide gates at the end of a run: no pod bound twice (the
    bind tracker), no node over capacity fleet-wide, no hostPort clash and
    no anti-affinity co-residence (``check_no_global_overcommit``,
    ``check_constraints``)."""
    from kubernetes_tpu_torch.sim.invariants import (
        check_constraints,
        check_no_global_overcommit,
    )

    violations = []
    tracker.drain(0, violations)
    check_no_global_overcommit(cs, 0, violations)
    check_constraints(cs, 0, violations)
    if violations:
        raise AssertionError(f"{label}: {[v.as_dict() for v in violations][:4]}")


def parked_by_the_fleet(label, scheds, unbound):
    """The pods a fleet leaves unbound must be the ones its own rule parks:
    each replica solves over its shard's pods only, and the cross-shard
    check rejects a hard-spread placement the fleet-wide counts forbid; a
    pod every replica rejected (its hand-off walk done) stays parked
    (``FleetRuntime.maybe_hand_off``, as in the JAX package). Each unbound
    pod's last journal record must be that rejection."""
    last = {}
    for s in scheds.values():
        for line in s.journal.lines:
            rec = json.loads(line)
            if rec["pod"] in unbound:
                key = (rec.get("t", 0), rec.get("step", 0))
                if rec["pod"] not in last or key >= last[rec["pod"]][0]:
                    last[rec["pod"]] = (key, rec)
    for pod in unbound:
        rec = last.get(pod, (None, {}))[1]
        if rec.get("outcome") != "unschedulable" or "cross-shard" not in rec.get("reason", ""):
            raise AssertionError(f"{label}: {pod} unbound, its last record {rec}")
    return sorted(unbound)


def fleet_run(dev, n_nodes, n_pods, rounds=24):
    """One 4-replica fleet over ``n_nodes`` x ``n_pods`` of the mixed
    workload, through a fresh gRPC hub, "first" mode on a virtual clock:
    the replicas drive round-robin on this thread (``run_until_settled``
    each), then the clock steps past the backoff and parked pods return,
    until every pod is bound or two rounds in a row bind nothing. Returns
    the bindings, the hub's journal and the readings."""
    from kubernetes_tpu_torch.sim.invariants import BindTransitionTracker

    clock = fleet_clock()
    hub = Hub(dev, clock)
    try:
        cs = _cluster(make_nodes(n_nodes))
        tracker = BindTransitionTracker(cs)
        scheds = fleet_replicas(dev, cs, hub.addr, clock)
        guards = {rid: TopTier(s, f"11a {rid}") for rid, s in scheds.items()}
        cs.create_pods([make_pod(i) for i in range(n_pods)])
        launches, solve_s, binds = Counter(), 0.0, []
        owners = {}
        with FleetTally() as tally:
            t0 = time.perf_counter()
            last_bind, idle = t0, 0
            for rnd in range(rounds):
                n_binds = len(binds)
                for rid, s in scheds.items():
                    dc.LAUNCHES = 0
                    res = s.run_until_settled()
                    launches[rid] += dc.LAUNCHES
                    for r in res:
                        guards[rid].batch(r)
                        solve_s += r.solve_seconds
                    if any(r.scheduled for r in res):
                        last_bind = time.perf_counter()
                    got = [(k, n) for r in res for k, n in r.scheduled]
                    tracker.record_results(got)
                    owned_binds(f"11a on {dev.type}", s, rid, got)
                    binds += [(rid, k, n) for k, n in got]
                    with cs.lock:
                        owners.update(s.fleet._assignment)
                log(f"11a on {dev.type} round {rnd}: {len(binds) - n_binds} bound, "
                    f"{time.perf_counter() - t0:.2f}s, hub round trips {len(tally.rtt)}")
                if all(p.node_name for p in cs.list_pods()):
                    break
                idle = idle + 1 if len(binds) == n_binds else 0
                if idle == 2:
                    break
                clock.advance(11.0)
                for s in scheds.values():
                    with cs.lock:
                        s.queue.move_all_to_active_or_backoff()
            wall = max(last_bind - t0, 1e-9)
        bindings = _bindings(cs)
        parked = parked_by_the_fleet(f"11a on {dev.type}", scheds,
                                     {k for k, n in bindings.items() if not n})
        _fleet_checks(f"11a on {dev.type}", cs, tracker)
        check_cluster(cs, f"11a on {dev.type}")
        for g in guards.values():
            g.close()
        for s in scheds.values():
            s.fleet.exchange.close()
        journal = hub.exchange.journal_lines()
        reading = {
            "nodes": n_nodes, "pods": n_pods, "replicas": len(scheds), "rounds": rnd + 1,
            "bound": len(bindings) - len(parked), "parked_by_fleet_rule": parked,
            "wall_s": wall, "pods_bound_per_s": (len(bindings) - len(parked)) / wall,
            "solve_s": solve_s, "solve_share": solve_s / wall,
            "binds_by_replica": dict(Counter(r for r, _, _ in binds)),
            "owned_nodes": dict(Counter(owners.values())),
            "cas_conflicts": sum(s.fleet.cas_conflicts for s in scheds.values()),
            "stale_rejections": sum(s.fleet.stale_rejections for s in scheds.values()),
            "domain_counts_launches_by_replica": dict(sorted(launches.items())),
            "domain_counts_launches": sum(launches.values()),
            "hub_journal_lines": len(journal),
            **tally.reading(),
        }
        reading["hub_share"] = reading["hub_seconds"] / wall
        return bindings, journal, reading
    finally:
        hub.close()


def fleet_full(dev, full=(5120, 1024), parity=(512, 512)):
    """11a: 4 replicas over 6b's cluster and 1,024 of its pods (``full``)
    through a real gRPC hub on ``dev``, its first launch held to plain;
    then the same fleet at reduced depth (``parity``) on ``dev`` and on the
    CPU must bind alike, parked pods included (tie_break "first"). Depth
    is cut because every constrained admission fetches and scans the whole
    peer view (``FleetRuntime.admit``): the drive grows with the square of
    the pods, and 5,120 took 727 s on the card."""
    t0 = time.perf_counter()
    with HeldLaunch("fleet 11a") as held:
        _, journal, reading = fleet_run(dev, *full)
    reading.update(held.require(reading["domain_counts_launches"]))
    if dev.type == "cuda" and not reading["domain_counts_launches"]:
        raise AssertionError("11a: the fleet launched no domain_counts kernel")
    t = time.perf_counter()
    with HeldLaunch("fleet 11a parity") as held_small:
        small, _, small_reading = fleet_run(dev, *parity)
    cpu_bindings, _, cpu_reading = fleet_run(torch.device("cpu"), *parity)
    if cpu_bindings != small:
        diff = sorted(k for k in small if small[k] != cpu_bindings.get(k))
        raise AssertionError(f"11a: {dev.type} and CPU fleets bind {len(diff)} pods apart "
                             f"at {parity}, e.g. {diff[:4]}")
    reading["parity"] = {
        "nodes": parity[0], "pods": parity[1], "card_equals_cpu": True,
        "parked_by_fleet_rule": small_reading["parked_by_fleet_rule"],
        "rounds": small_reading["rounds"],
        "pods_bound_per_s": small_reading["pods_bound_per_s"],
        "cpu_pods_bound_per_s": cpu_reading["pods_bound_per_s"],
        "domain_counts_launches": small_reading["domain_counts_launches"],
        **held_small.require(small_reading["domain_counts_launches"]),
        "seconds": time.perf_counter() - t}
    reading["phase_s"] = time.perf_counter() - t0
    log("fleet 11a " + json.dumps(reading))
    return reading, journal


def fleet_drain_phase(dev, n_nodes=FD_NODES, n_pods=FD_PODS, chunk=16_384):
    """11b: bench.py ladder #17's protocol on one card: one global relax
    plan over the backlog (plain 250m / 512Mi pods, every 512th forced
    cross-shard into the serialized residual), ``drain.partition_backlog``
    by planned-node ring owner, ``drain_init`` at the gRPC hub; 4 replicas
    loop ``fleet_drain_backlog`` on this thread. r3 drains one chunk of its
    lease and is retired while it holds the rest (the fleet sim's replica
    kill); a survivor must re-claim it. Gates: every pod bound, none twice,
    no node over capacity, every lease complete."""
    import gc

    from kubernetes_tpu_torch.fleet import drain as fdrain
    from kubernetes_tpu_torch.fleet.ring import HashRing, ring_nodes_from
    from kubernetes_tpu_torch.sim.invariants import BindTransitionTracker

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cs = _cluster(make_nodes(n_nodes))
    pods = [plain_pod(i, "fdrain") for i in range(n_pods)]
    keys = [p.key for p in pods]
    planner = Scheduler(cs, SchedulerConfig(batch_size=chunk, solver=ExactSolverConfig(
        seed=SEED, group_size=512)), device=dev)
    cs.create_pods(pods)
    t = time.perf_counter()
    plan = planner.relax_plan_backlog()
    plan_s = time.perf_counter() - t
    cs.unsubscribe(planner._on_event)
    del planner
    planned = sum(1 for v in plan.values() if v)
    assignment = HashRing(FLEET_UNIVERSE).assign(ring_nodes_from(cs.list_nodes()))
    partitions, residual = fdrain.partition_backlog(
        keys, plan, assignment, cross_shard=lambda k: int(k.rsplit("-", 1)[1]) % 512 == 0)
    clock = fleet_clock()
    hub = Hub(dev, clock)
    try:
        hub.exchange.drain_init("r0", partitions, residual)
        tracker = BindTransitionTracker(cs)
        scheds = fleet_replicas(dev, cs, hub.addr, clock, journal=False,
                                solver=ExactSolverConfig(seed=SEED, group_size=512),
                                batch=chunk)
        setup_s = time.perf_counter() - t0
        keyset, alive = set(keys), list(FLEET_UNIVERSE)
        base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        drained, budgets, peaks, leases, launches = Counter(), {}, {}, [], 0
        binds = []
        victim = FLEET_UNIVERSE[-1]
        with FleetTally() as tally, HeldLaunch("fleet 11b") as held:
            t = time.perf_counter()

            def drive(rid, **kw):
                nonlocal launches
                s = scheds[rid]
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                dc.LAUNCHES = 0
                out = s.fleet_drain_backlog(chunk_pods=chunk, plan_keys=keyset, **kw)
                launches += dc.LAUNCHES
                if dev.type == "cuda":
                    peaks[rid] = max(peaks.get(rid, 0), torch.cuda.max_memory_allocated() - base)
                drained[rid] += out["drained"]
                budgets[rid] = out["budget_bytes"]
                leases.extend(dict(lease, replica=rid) for lease in out["leases"])
                got = [(k, n) for r in out["results"] for k, n in r.scheduled]
                tracker.record_results(got)
                owned_binds("11b", s, rid, got)
                binds.extend((rid, k, n) for k, n in got)
                return out

            # the victim drains one chunk of its partition, then dies holding it
            held_out = drive(victim, max_batches=1)
            if not held_out["leases"] or held_out["leases"][0]["completed"]:
                raise AssertionError(f"11b: {victim} held no open lease: {held_out['leases']}")
            cs.unsubscribe(scheds[victim]._on_event)
            hub.exchange.retire(victim)
            alive.remove(victim)
            for rid in alive:
                scheds[rid].fleet.set_alive(alive)
            for rid in alive:
                # re-own the dead replica's shard now, before any claim:
                # a resync after a claim re-routes pods by hash past the
                # claim's shedding
                scheds[rid].fleet.maybe_resync(scheds[rid])
            for _ in range(8):
                for rid in alive:
                    drive(rid)
                st = hub.exchange.drain_status()
                if st.get("complete"):
                    break
                clock.advance(11.0)
                for rid in alive:
                    with cs.lock:
                        scheds[rid].queue.move_all_to_active_or_backoff()
            wall = time.perf_counter() - t
        st = hub.exchange.drain_status()
        unbound = sum(1 for p in cs.list_pods() if not p.node_name)
        if unbound or not st.get("complete"):
            raise AssertionError(f"11b: {unbound} pods unbound, ledger {st}")
        if st.get("reassigned", 0) < 1:
            raise AssertionError(f"11b: no lease was re-claimed after {victim} died: {st}")
        _fleet_checks("11b", cs, tracker)
        for s in scheds.values():
            s.fleet.exchange.close()
        reading = {
            "nodes": n_nodes, "pods": n_pods, "replicas": len(FLEET_UNIVERSE),
            "chunk_pods": chunk, "setup_s": setup_s, "plan_s": plan_s, "planned": planned,
            "partition_sizes": {r: len(k) for r, k in sorted(partitions.items())},
            "residual_pods": len(residual), "retired": victim,
            "drained": sum(drained.values()), "drained_by_replica": dict(sorted(drained.items())),
            "wall_s": wall, "drained_pods_per_s": sum(drained.values()) / wall,
            "leases_granted": st.get("leases"), "leases_reassigned": st.get("reassigned"),
            "ledger_complete": True, "lost": 0, "double_bind": 0,
            "leases": leases,
            "budget_slice_bytes": budgets,
            "peak_bytes_by_replica": peaks or "not measured",
            "domain_counts_launches": launches, **held.require(launches),
            **tally.reading(),
        }
        reading["phase_s"] = time.perf_counter() - t0
        log("fleet 11b " + json.dumps(reading))
        return reading
    finally:
        hub.close()


def fleet_sim_phase(dev, cycles=SIM_CYCLES, replicas=2):
    """11c: the 7 fleet profiles through ``run_fleet_sim`` with 2 replicas,
    twice on ``dev`` and once on the CPU given the card's ladder: every
    replica's journal, the hub's aggregated journal, the bindings and the
    footer summary byte-equal across the three, every invariant OK."""
    import kubernetes_tpu_torch.resilience as rz
    import kubernetes_tpu_torch.scheduler as sm
    from kubernetes_tpu_torch.sim.fleet import run_fleet_sim
    from kubernetes_tpu_torch.sim.harness import FLEET_PROFILES

    card_ladder = rz.build_ladder(dev)
    out, launches = {}, 0
    t0 = time.perf_counter()
    with HeldLaunch("sim 11c") as held:
        for p in sorted(FLEET_PROFILES):
            build = sm.build_ladder
            sm.build_ladder = lambda device: card_ladder
            try:
                ref = run_fleet_sim(p, seed=SEED, cycles=cycles, replicas=replicas,
                                    device="cpu")
            finally:
                sm.build_ladder = build
            dc.LAUNCHES = 0
            t = time.perf_counter()
            a = run_fleet_sim(p, seed=SEED, cycles=cycles, replicas=replicas, device=dev)
            secs, n = time.perf_counter() - t, dc.LAUNCHES
            b = run_fleet_sim(p, seed=SEED, cycles=cycles, replicas=replicas, device=dev)
            for label, x in (("run 1", a), ("run 2", b)):
                if not x.ok:
                    raise AssertionError(f"11c {p} {label}: settled {x.settled}, violations "
                                         f"{[v.as_dict() for v in x.violations][:4]}")
            for label, x, y in (("two card runs", a, b), (f"{dev.type} vs cpu", a, ref)):
                for f in ("journals", "journal_digests", "hub_journal_lines", "bindings",
                          "unbound", "summary"):
                    if getattr(x, f) != getattr(y, f):
                        raise AssertionError(f"11c {p}: {label} differ in {f}")
            s = a.summary
            out[p] = {"seconds": secs, "domain_counts_launches": n, "bound": s["bound"],
                      "binds_by_replica": s["binds_by_replica"],
                      "journal_digests": a.journal_digests,
                      "hub_journal_lines": len(a.hub_journal_lines), "invariants": "OK",
                      "selfcheck": "byte-identical", "card_equals_cpu": True}
            launches += n
            log("sim 11c " + json.dumps({p: out[p]}))
    return {"profiles": out, "replicas": replicas, "cycles": cycles,
            "ladder": list(card_ladder), "domain_counts_launches": launches,
            **held.require(launches), "phase_s": time.perf_counter() - t0}


def explain_hub(addr, pod):
    """``python -m kubernetes_tpu_torch.obs explain POD --fleet --hub ADDR``
    in this process: (exit code, rendered text)."""
    import contextlib
    import io

    from kubernetes_tpu_torch.obs.__main__ import main as obs_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = obs_main(["explain", pod, "--fleet", "--hub", addr])
    return rc, buf.getvalue()


def fleet_shipment(journal, n_pods=32):
    """The 11a journal lines 11d ships to its hub: every record of up to
    ``n_pods`` pods whose history crosses replicas (hand-offs), else of the
    first pods. ``journal_lines`` answers in one gRPC message, which the
    client caps at 4 MiB, so the whole 11a journal is not sent."""
    replicas = {}
    for line in journal:
        rec = json.loads(line)
        replicas.setdefault(rec["pod"], set()).add(rec.get("replica"))
    crossed = sorted(p for p, rs in replicas.items() if len(rs) > 1)
    chosen = set((crossed or sorted(replicas))[:n_pods])
    lines = [ln for ln in journal if json.loads(ln)["pod"] in chosen]
    return lines, crossed, {"journal_lines": len(journal),
                            "journal_bytes": sum(len(x) + 1 for x in journal),
                            "shipped_lines": len(lines), "shipped_pods": len(chosen)}


def fleet_explain(addr, journal):
    """11d's second half: a pod whose history crosses replicas (a hand-off),
    else a pod of 11a, rendered from the live hub's journal."""
    _, crossed, _ = fleet_shipment(journal)
    pod = crossed[0] if crossed else sorted(json.loads(x)["pod"] for x in journal)[0]
    rc, text = explain_hub(addr, pod)
    if rc != 0 or pod not in text:
        raise AssertionError(f"11d: explain --fleet --hub for {pod} exited {rc}:\n{text[-2000:]}")
    if crossed and "->" not in text:
        raise AssertionError(f"11d: {pod}'s cross-replica history not rendered:\n{text[-2000:]}")
    return {"pod": pod, "cross_replica_pods": len(crossed), "cross_replica": bool(crossed),
            "lines": len(text.splitlines())}


def phase11(dev):
    """Phase 11, each part with its own readings and checks; 11d serves as
    a fleet replica against 11a's journal, on a hub of its own."""
    t0 = time.perf_counter()
    a, journal = fleet_full(dev)
    b = fleet_drain_phase(dev)
    c = fleet_sim_phase(dev)
    hub = Hub(dev)
    try:
        shipped, _, sizes = fleet_shipment(journal)
        hub.exchange.ship_journal("r0", shipped)
        d = serve_phase(dev, fleet_hub=hub.addr)
        d["explain"] = {**fleet_explain(hub.addr, shipped), **sizes}
    finally:
        hub.close()
    log("fleet 11d " + json.dumps(d))
    return {"fleet_11a": a, "fleet_drain_11b": b, "fleet_sim_11c": c, "fleet_serve_11d": d,
            "phase_s": time.perf_counter() - t0}


# -- phase 12 --------------------------------------------------------------

# 12a's launch: 6b's InterPodAffinity in + ex aggregation (T 8 + 8, N 5,120,
# d_pad 8,192) on seeded inputs. The child imports torch and the kernel's
# wrapper only, so its seconds from process start to the first exact launch
# read the cache and not the rest of the package.
CACHE_PROBE = r'''
import json, sys, time
import numpy as np
import torch
from kubernetes_tpu_torch import build
from kubernetes_tpu_torch.ops import domain_counts as dc

out_path, mode = sys.argv[1], sys.argv[2]
builds = []
build.BUILD_LISTENERS.append(lambda name, s: builds.append(s))
if mode == "prebuilt":
    def no_compiler():
        raise build.KernelError("a prebuilt directory needs no compiler")
    build.nvcc = no_compiler
rng = np.random.default_rng(12)
dev = torch.device("cuda")
sets = [(torch.from_numpy(rng.integers(-1, 8192, (8, 5120)).astype(np.int32)).to(dev),
         torch.from_numpy(rng.integers(0, 5, (8, 5120)).astype(np.int32)).to(dev), None)
        for _ in range(2)]
res = {"mode": mode}
dc.LAUNCHES = 0
try:
    got = dc.aggregate(sets, 8192)
    torch.cuda.synchronize()
except build.KernelError as e:
    res.update(kernel_error=str(e), launches=dc.LAUNCHES, builds=len(builds))
else:
    res["launch_done"] = time.time()
    want = dc.aggregate_plain(sets, 8192)
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for gp, wp in zip(got, want) for g, w in zip(gp, wp))
    res.update(launches=dc.LAUNCHES, builds=len(builds), build_s=sum(builds),
               max_abs_err=err, build_dir=str(build.BUILD_DIR),
               library=str(build.library_path("domain_counts")))
with open(out_path, "w") as f:
    json.dump(res, f)
'''


def cache_probe(mode, cache_dir, scratch):
    """One 12a child on ``cache_dir`` (``KUBERNETES_TPU_COMPILE_CACHE``):
    its result, and the seconds from its start to its first exact launch."""
    out = os.path.join(scratch, f"{mode}.json")
    env = {**os.environ, "KUBERNETES_TPU_COMPILE_CACHE": str(cache_dir)}
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", CACHE_PROBE, out, mode], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"12a {mode}: child exit {proc.returncode}: {proc.stderr[-2000:]}")
    with open(out) as f:
        res = json.load(f)
    res["process_s"] = wall
    if "launch_done" in res:
        res["start_to_first_exact_launch_s"] = res.pop("launch_done") - t0
    return res


def cache_phase():
    """12a: the kernel build cache across processes. A cold directory
    builds once; the same directory in a new process, and a read-only copy
    of it with the compiler taken away, build nothing; each of the three
    launches equals plain. A directory that cannot be created (a path under
    a regular file: permissions do not stop root) fails the launch with
    KernelError naming it."""
    import shutil

    root = os.path.join(REPO, "kubernetes_tpu_torch", "_build", "phase12a")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cold, pre = os.path.join(root, "cache"), os.path.join(root, "prebuilt")
    blocked = os.path.join(root, "a-file", "cache")
    runs = {}
    try:
        runs["cold"] = cache_probe("cold", cold, root)
        runs["warm"] = cache_probe("warm", cold, root)
        shutil.copytree(cold, pre)
        for d, _, files in os.walk(pre):
            for f in files:
                os.chmod(os.path.join(d, f), 0o444)
            os.chmod(d, 0o555)
        runs["prebuilt"] = cache_probe("prebuilt", pre, root)
        with open(os.path.join(root, "a-file"), "w") as f:
            f.write("a regular file, so nothing can be created under it\n")
        runs["unwritable"] = cache_probe("unwritable", blocked, root)
    finally:
        for d, _, _ in os.walk(root):
            os.chmod(d, 0o755)
    want_builds = {"cold": 1, "warm": 0, "prebuilt": 0}
    for mode, n in want_builds.items():
        r = runs[mode]
        if "kernel_error" in r:
            raise AssertionError(f"12a {mode}: {r['kernel_error']}")
        if r["builds"] != n:
            raise AssertionError(f"12a {mode}: {r['builds']} nvcc builds, want {n}")
        if r["launches"] != 1 or r["max_abs_err"] != 0:
            raise AssertionError(f"12a {mode}: launches {r['launches']}, "
                                 f"max abs err {r['max_abs_err']}")
    if not runs["cold"]["library"].startswith(cold) or not runs["prebuilt"]["library"].startswith(pre):
        raise AssertionError(f"12a: libraries outside their directories: {runs}")
    bad = runs["unwritable"]
    if blocked not in bad.get("kernel_error", "") or bad["launches"] or bad["builds"]:
        raise AssertionError(f"12a unwritable: want KernelError naming {blocked}, got {bad}")
    shutil.rmtree(root, ignore_errors=True)
    out = {"cold": runs["cold"], "warm": runs["warm"], "prebuilt": runs["prebuilt"],
           "unwritable": {k: bad[k] for k in ("kernel_error", "launches", "builds", "process_s")},
           "nvcc_s": runs["cold"]["build_s"],
           "max_abs_err": max(runs[m]["max_abs_err"] for m in want_builds)}
    log("cache 12a " + json.dumps(out))
    return out


ORACLE_NODES, ORACLE_PODS = 1_024, 3_072


def oracle_workload(n_nodes, n_pods):
    """BASELINE.json's node widths (16 CPU / 64Gi / 110 pods) and the
    request mix of tests/test_scheduler_e2e.py (100-520m CPU, 256-512Mi),
    so the scores do not all tie."""
    nodes = [MakeNode().name(f"node-{i:05}")
             .capacity({"cpu": "16", "memory": "64Gi", "pods": "110"}).obj()
             for i in range(n_nodes)]
    pods = [MakePod().name(f"oracle-{i:05}")
            .req({"cpu": f"{100 + 70 * (i % 7)}m", "memory": f"{256 + 128 * (i % 3)}Mi"}).obj()
            for i in range(n_pods)]
    return nodes, pods


def oracle_phase(dev, n_nodes=ORACLE_NODES, n_pods=ORACLE_PODS):
    """12b: the port's Scheduler on the card against the port's sequential
    oracle (ops/oracle/scheduler.py): in "first" mode the bindings equal
    ``schedule()`` in creation order; in "random" mode every pick lies in
    the oracle's tie set given the picks before it (``validate_assignments``)."""
    from kubernetes_tpu_torch.ops.oracle import scheduler as osched

    t0 = time.perf_counter()
    out = {"nodes": n_nodes, "pods": n_pods}
    for tie in ("first", "random"):
        nodes, pods = oracle_workload(n_nodes, n_pods)
        cs = _cluster(nodes, pods)
        sched = Scheduler(cs, SchedulerConfig(
            batch_size=1024,
            solver=ExactSolverConfig(tie_break=tie, balanced_fdtype="float64")), device=dev)
        _, reading = drain(sched, f"12b {tie}")
        index = {n.name: i for i, n in enumerate(nodes)}
        picks = [index.get(cs.get_pod(p.namespace, p.name).node_name, -1) for p in pods]
        t1 = time.perf_counter()
        if tie == "first":
            want = osched.schedule(pods, osched.make_node_states(nodes)).assignments
            if picks != want:
                i = next(i for i, (a, b) in enumerate(zip(picks, want)) if a != b)
                raise AssertionError(f"12b first: pod {pods[i].key} on node {picks[i]}, "
                                     f"the oracle's {want[i]}")
        else:
            errors = osched.validate_assignments(pods, osched.make_node_states(nodes), picks)
            if errors:
                raise AssertionError(f"12b random: {len(errors)} picks outside the oracle's "
                                     f"tie set: {errors[:3]}")
        oracle_s = time.perf_counter() - t1
        out[tie] = {**{k: reading[k] for k in ("bound", "unschedulable", "wall_s",
                                               "pods_bound_per_s", "batches",
                                               "domain_counts_launches")},
                    "oracle_s": oracle_s, "distinct_nodes": len(set(picks))}
    out["phase_s"] = time.perf_counter() - t0
    log("oracle 12b " + json.dumps(out))
    return out


def analysis_phase():
    """12c: the port's analyzer on the card's machine, which has no JAX:
    ``python -m kubernetes_tpu_torch.analysis`` with the ratchet and
    ``--check-lock-order``, both exit 0 with 0 active findings."""
    out = {}
    for label, args in (("scan", ["--json", "--ratchet"]), ("lock_order", ["--check-lock-order"])):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch.analysis", *args],
                              cwd=REPO, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"12c {label}: exit {proc.returncode}: "
                                 f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        rec = {"exit": proc.returncode, "seconds": secs}
        if label == "scan":
            findings = json.loads(proc.stdout)
            active = [f for f in findings if not f["suppressed"]]
            if active:
                raise AssertionError(f"12c: {len(active)} active findings: {active[:3]}")
            rec.update(active=0, suppressed=len(findings))
        out[label] = rec
    log("analysis 12c " + json.dumps(out))
    return out


def phase12(dev):
    t0 = time.perf_counter()
    a = cache_phase()
    b = oracle_phase(dev)
    c = analysis_phase()
    return {"cache_12a": a, "oracle_12b": b, "analysis_12c": c,
            "phase_s": time.perf_counter() - t0}



# -- phase 13: the node-axis mesh, k shards on the one card -----------------

SHARDS = 4


class forced:
    """``k`` entries of ``dev`` visible (``sharding.force_device_count``)
    while active; the visible list restored after."""

    def __init__(self, k, dev):
        self.k, self.dev = k, dev

    def __enter__(self):
        self.saved = sh.forced_device_count()
        sh.force_device_count(self.k, self.dev)
        return self

    def __exit__(self, *exc):
        sh.force_device_count(*self.saved)
        return False


def shard_mesh(dev, k):
    with forced(k, dev):
        return sh.node_mesh(k, dev)


def _combines():
    return {"combines": sh.COMBINES, "combine_s": sh.COMBINE_S}


def _reset_combines():
    sh.COMBINES, sh.COMBINE_S = 0, 0.0


def sharded_scan(dev, bindings_6b, ks=(SHARDS, 2), n_nodes=5120, n_pods=1024, batch=1024):
    """13a: 6b's InterPodAffinity mixed workload in parity mode through
    ``ExactSolver.solve`` on ``n_nodes`` nodes, unsharded and on k shards
    of the card; depth ``n_pods`` (batches of ``batch``). Every sharded
    run equals the unsharded one and 6b's bindings; each shard's first
    launch is held to plain; a sharded run launches k times the unsharded
    kernel launches (one counts-only launch per shard per aggregation)."""
    nodes = make_nodes(n_nodes)
    pods = [make_pod(i) for i in range(n_pods)]
    vocab = ResourceVocab.build(pods, nodes)
    cfg = ExactSolverConfig(tie_break="first", balanced_fdtype="float64")

    def run(mesh):
        solver = ExactSolver(cfg)
        placed, out, solve_s = {}, [], []
        for lo in range(0, n_pods, batch):
            bp = pods[lo : lo + batch]
            inputs = tensorize(nodes, bp, placed, vocab)
            _sync(dev)
            t = time.perf_counter()
            a = solver.solve(*inputs, device=dev, mesh=mesh)
            _sync(dev)
            solve_s.append(time.perf_counter() - t)
            out.append(np.asarray(a))
            for i, s_ in enumerate(a):
                if s_ >= 0:
                    placed.setdefault(nodes[s_].name, []).append(bp[i])
        return np.concatenate(out), solve_s

    dc.LAUNCHES = 0
    want, flat_s = run(None)
    flat_launches = dc.LAUNCHES
    if (want < 0).any():
        raise AssertionError("13a: an unsharded pod did not place")
    if bindings_6b is not None:
        bad = [i for i, a in enumerate(want)
               if bindings_6b.get(f"default/pod-{i:05}") != nodes[a].name]
        if bad:
            raise AssertionError(f"13a: the unsharded solve != 6b's bindings at {len(bad)} pods, "
                                 f"first {bad[:4]}")
    out = {"nodes": n_nodes, "pods": n_pods, "batch": batch,
           "unsharded": {"solve_s": flat_s, "pods_per_s": n_pods / sum(flat_s),
                         "domain_counts_launches": flat_launches,
                         "launches_per_step": flat_launches / n_pods},
           "equals_6b_bindings": bindings_6b is not None}
    for k in ks:
        mesh = shard_mesh(dev, k)
        dc.LAUNCHES = 0
        _reset_combines()
        with HeldLaunch(f"13a k={k}", n=k) as held:
            got, secs = run(mesh)
        launches = dc.LAUNCHES
        reading = {"k": k, "solve_s": secs, "pods_per_s": n_pods / sum(secs),
                   "domain_counts_launches": launches, "launches_per_step": launches / n_pods,
                   **_combines(), "per_shard_first_launches": held.held,
                   **held.require(launches)}
        if not np.array_equal(got, want):
            bad = np.flatnonzero(got != want)
            raise AssertionError(f"13a k={k}: sharded != unsharded at {bad.size} pods, "
                                 f"first {bad[:4]}")
        if dev.type == "cuda" and launches != k * flat_launches:
            raise AssertionError(f"13a k={k}: {launches} launches, expected {k} x {flat_launches}")
        reading["equals_unsharded"] = True
        out[f"k{k}"] = reading
        log("sharded 13a " + json.dumps({f"k{k}": reading}))
    return out


def _session_pair(dev, mesh, tie, nodes, pods, batch, vocab):
    """The kind-2 pods in two session batches, the second healing the
    columns the first placed on: the assignments and the seconds."""
    solver = ExactSolver(ExactSolverConfig(tie_break=tie, seed=SEED))
    placed, versions, out, secs = {}, None, [], []
    for lo in range(0, 2 * batch, batch):
        bp = pods[lo : lo + batch]
        inputs = tensorize(nodes, bp, placed, vocab)
        if versions is None:
            versions = np.zeros(inputs[0].padded, np.int64)
        _sync(dev)
        t = time.perf_counter()
        a = solver.solve(*inputs, col_versions=versions.copy(), device=dev, mesh=mesh)
        _sync(dev)
        secs.append(time.perf_counter() - t)
        out.append(np.asarray(a))
        for i, s_ in enumerate(a):
            if s_ >= 0:
                placed.setdefault(nodes[s_].name, []).append(bp[i])
                versions[s_] += 1
    return np.concatenate(out), secs


def sharded_grouped(dev, k=SHARDS, n_nodes=5120, batch=1024):
    """13b: the grouped kinds 2 (zone spread) and 3 (hostname anti) on the
    phase-4 cluster, one batch each, and kind 2 through the device session
    with a dirty-column heal (two batches), on k shards against the
    unsharded card run, in both tie-break modes; each shard's first launch
    held to plain."""
    mesh = shard_mesh(dev, k)
    nodes = make_nodes(n_nodes)
    out = {}
    for kind in ("spread", "anti"):
        pods = [make_kind_pod(kind, i) for i in range(2 * batch)]
        vocab = ResourceVocab.build(pods, nodes)
        for tie in ("first", "random"):
            runs = {}
            for label, m in (("unsharded", None), (f"k{k}", mesh)):
                solver = ExactSolver(ExactSolverConfig(tie_break=tie, seed=SEED))
                inputs = tensorize(nodes, pods[:batch], {}, vocab)
                dc.LAUNCHES = 0
                tf_reset()
                _reset_combines()
                with HeldLaunch(f"13b {kind} {tie} {label}", n=k if m else 1) as held:
                    _sync(dev)
                    t = time.perf_counter()
                    a = np.asarray(solver.solve(*inputs, device=dev, mesh=m))
                    _sync(dev)
                    secs = time.perf_counter() - t
                runs[label] = (a, {"solve_s": secs, "domain_counts_launches": dc.LAUNCHES,
                                   "threefry_launches": tf_launches(),
                                   "dispatch": dict(solver.dispatch_counts), **_combines(),
                                   **held.require(dc.LAUNCHES)})
            if not np.array_equal(runs[f"k{k}"][0], runs["unsharded"][0]):
                raise AssertionError(f"13b {kind} {tie}: sharded != unsharded")
            if (runs["unsharded"][0] < 0).any():
                raise AssertionError(f"13b {kind} {tie}: a pod did not place")
            if dev.type == "cuda" and not runs[f"k{k}"][1]["domain_counts_launches"]:
                raise AssertionError(f"13b {kind} {tie}: the sharded chunks launched nothing")
            out[f"{kind}/{tie}"] = {lbl: r for lbl, (_, r) in runs.items()}
            log("sharded 13b " + json.dumps({f"{kind}/{tie}": out[f"{kind}/{tie}"]}))
        if kind == "spread":
            for tie in ("first", "random"):
                want, flat_s = _session_pair(dev, None, tie, nodes, pods, batch, vocab)
                dc.LAUNCHES = 0
                got, secs = _session_pair(dev, mesh, tie, nodes, pods, batch, vocab)
                if not np.array_equal(got, want):
                    raise AssertionError(f"13b session {tie}: sharded != unsharded")
                out[f"session/{tie}"] = {"unsharded_s": flat_s, f"k{k}_s": secs,
                                         "domain_counts_launches": dc.LAUNCHES,
                                         "equals_unsharded": True}
                log("sharded 13b " + json.dumps({f"session/{tie}": out[f"session/{tie}"]}))
    return out


def sharded_scheduler(dev, digest_6c, k=SHARDS, north_star=(10_000, 50_000),
                      reduced_6c=None):
    """13c: the Scheduler on k shards, every batch at the mesh rung: 6a's
    mixed run (reduced depth) against the unsharded Scheduler's, the
    north star (the production default config, kind 1) against 6c's
    bindings, and ``reduced_6c`` (6c's card == CPU check: nodes, pods and
    the CPU port's bindings digest) on k shards against the CPU port."""
    b_flat, n_flat, v_flat = scheduler_mixed(dev)
    dc.LAUNCHES = 0
    with forced(k, dev):
        with HeldLaunch("13c mixed", n=k) as held:
            b_sh, n_sh, v_sh = scheduler_mixed(dev)
    mesh_gauge = metrics.mesh_devices.value()
    mixed_launches = dc.LAUNCHES
    if (b_sh, n_sh, v_sh) != (b_flat, n_flat, v_flat):
        bad = [key for key in b_flat if b_sh.get(key) != b_flat[key]]
        raise AssertionError(f"13c mixed: sharded != unsharded ({len(bad)} bindings differ)")
    if mesh_gauge != k:
        raise AssertionError(f"13c: scheduler_mesh_devices reads {mesh_gauge}, not {k}")
    out = {"mixed": {"batches": len(v_sh), "bound": sum(1 for v in b_sh.values() if v),
                     "equals_unsharded": True, "domain_counts_launches": mixed_launches,
                     **held.require(mixed_launches)},
           "scheduler_mesh_devices": mesh_gauge}
    with forced(k, dev):
        reading = scheduler_random(dev, *north_star, label=f"13c north star k={k}")
    if digest_6c is not None and reading["bindings_digest"] != digest_6c:
        raise AssertionError("13c north star: sharded bindings != 6c's")
    if reading["mesh_devices"] != k:
        raise AssertionError(f"13c north star: the Scheduler solved on {reading['mesh_devices']}")
    reading["equals_6c_bindings"] = digest_6c is not None
    out["north_star"] = reading
    if reduced_6c is not None:
        with forced(k, dev):
            r = scheduler_random(dev, reduced_6c["nodes"], reduced_6c["pods"],
                                 label=f"13c reduced k={k}")
        if r["bindings_digest"] != reduced_6c["bindings_digest"]:
            raise AssertionError(f"13c reduced k={k}: card != the CPU port (bindings digest)")
        out["reduced"] = {"nodes": reduced_6c["nodes"], "pods": reduced_6c["pods"],
                          "equals_cpu_port": True, "mesh_devices": r["mesh_devices"],
                          "threefry_launches": r["threefry_launches"]}
    log("sharded 13c " + json.dumps(out))
    return out


def sharded_args(mesh, host_args):
    """The auction's inputs on a mesh: the six node-resident tables split
    over the shards, the rest on the lead device."""
    return [mesh.split(np.asarray(a)) for a in host_args[:6]] + [
        torch.tensor(a, device=mesh.lead) for a in host_args[6:]]


def sharded_plans(dev, k=SHARDS, north_star=(NS_NODES, NS_PODS), plan=(BD_NODES, BD_PODS)):
    """13d: the auction at the north star (10a's inputs) on k shards, bit
    for bit against the unsharded card run; the relax plan (10b's inputs,
    its tail repaired by the plan auction) on k shards within the planner's
    tolerance (the same iterations, at least 99 % of assignments equal) and
    with no overcommit."""
    from kubernetes_tpu_torch.rebalance.planner import plan_auction_config
    from kubernetes_tpu_torch.solver.relax import RelaxConfig, _relax
    from kubernetes_tpu_torch.solver.single_shot import SingleShotConfig, _single_shot

    mesh = shard_mesh(dev, k)
    cfg = SingleShotConfig()
    host_args = north_star_inputs(False, *north_star)

    def auction_sharded(args, c, pod_valid=None):
        reads = []
        if pod_valid is not None:
            args = args[:10] + [pod_valid]
        a, used, cnt, _, rounds = _single_shot(
            *args, max_rounds=c.max_rounds, price_step=c.price_step, top_t=c.top_t,
            repair_rounds=c.repair_rounds, pack=c.objective == "pack", reads=reads)
        return a, used, cnt, rounds, len(reads)

    flat_s, flat = median_timed(lambda: auction(dev, host_args, cfg), dev)
    _reset_combines()
    sh_s, got = median_timed(lambda: auction_sharded(sharded_args(mesh, host_args), cfg), dev)
    flat_h, got_h = _host(flat), _host(got)
    for name, g, w in zip(("assignments", "used", "pod_count"), got_h, flat_h):
        if not np.array_equal(g, w):
            raise AssertionError(f"13d auction: sharded {name} != unsharded: "
                                 f"{_first_mismatch(g, w)}")
    if got_h[3:] != flat_h[3:]:
        raise AssertionError(f"13d auction: rounds/reads {got_h[3:]} != {flat_h[3:]}")
    out = {"auction": {"pods": north_star[1], "nodes": north_star[0], "k": k,
                       "unsharded_s": flat_s, "sharded_s": sh_s, "rounds": got_h[3],
                       "placed": int((got_h[0] >= 0).sum()), "equals_unsharded": True}}
    log("sharded 13d " + json.dumps(out))

    rcfg, acfg = RelaxConfig(objective="pack"), plan_auction_config()
    host2, _ = megaplan_inputs(*plan)
    flat_s, flat = median_timed(lambda: relax_plan(dev, host2, rcfg, acfg), dev, runs=1)

    def relax_sharded():
        args = sharded_args(mesh, host2)
        a, used, cnt, _, _, _, iters, res = _relax(
            *args, rcfg.tol, rcfg.temp, rcfg.step, max_iters=rcfg.max_iters,
            pack=rcfg.objective == "pack")
        tail = args[10] & (a < 0)
        rep = auction_sharded(args[:1] + [mesh.split(used), mesh.split(cnt)] + args[3:], acfg,
                              pod_valid=tail)
        return torch.where(tail, rep[0], a).cpu().numpy(), iters, float(res)

    sh_s, (got_a, iters, res) = median_timed(relax_sharded, dev, runs=1)
    want_a = flat[0]
    share = float(np.mean(got_a == want_a))
    placed = check_no_overcommit("13d relax sharded", host2, got_a)
    placed_flat = check_no_overcommit("13d relax unsharded", host2, want_a)
    out["relax"] = {"pods": plan[1], "nodes": plan[0], "k": k, "unsharded_s": flat_s,
                    "sharded_s": sh_s, "iterations": iters, "unsharded_iterations": flat[1],
                    "residual": res, "unsharded_residual": flat[2],
                    "equal_assignment_share": share, "placed": placed,
                    "unsharded_placed": placed_flat, "no_overcommit": True}
    log("sharded 13d " + json.dumps({"relax": out["relax"]}))
    if iters != flat[1] or share < 0.99:
        raise AssertionError(f"13d relax: outside the tolerance: {out['relax']}")
    return out


def sharded_sim_and_resolution(dev, k=2, cycles=SIM_CYCLES):
    """13e: the sim CLI's churn_heavy at --mesh-devices k on the card (the
    trace, the journal and the printed summary byte-identical to
    --mesh-devices 1), then resolve_mesh on
    the real device list: meshDevices 8 -> None, meshSlice 0/1 -> a 1-way
    mesh on the first card with a fleet replica scheduling on it, 0/2 ->
    the JAX package's ValueError (with one card)."""
    import contextlib
    import io
    import tempfile

    from kubernetes_tpu_torch.fleet import FleetConfig, OccupancyExchange
    from kubernetes_tpu_torch.sim.__main__ import main as sim_main

    def drive(n, tmp):
        paths = [os.path.join(tmp, f"{what}{n}.jsonl") for what in ("trace", "journal")]
        argv = ["--device", str(dev), "--profile", "churn_heavy", "--seed", "0", "--cycles",
                str(cycles), "--mesh-devices", str(n), "--trace", paths[0], "--journal", paths[1]]
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            rc = sim_main(argv)
        if rc != 0:
            raise AssertionError(f"13e: sim --mesh-devices {n} exited {rc}")
        summary = [ln for ln in printed.getvalue().splitlines() if " written: " not in ln]
        return [open(p, "rb").read() for p in paths], summary

    with tempfile.TemporaryDirectory() as tmp:
        one, printed1 = drive(1, tmp)
        dc.LAUNCHES = 0
        with HeldLaunch(f"13e sim k={k}", n=k) as held:
            many, printed_k = drive(k, tmp)
        launches = dc.LAUNCHES
    if sh.forced_device_count() != (None, None):
        raise AssertionError("13e: the sim left the visible device list forced")
    if one != many or printed1 != printed_k or "  invariants: OK" not in printed_k:
        raise AssertionError(f"13e: --mesh-devices {k} trace, journal or summary != "
                             "--mesh-devices 1")
    out = {"sim": {"profile": "churn_heavy", "cycles": cycles, "k": k, "identical": True,
                   "trace_bytes": len(many[0]), "journal_bytes": len(many[1]),
                   "domain_counts_launches": launches, **held.require(launches)}}
    visible = len(sh.visible_devices(dev))
    out["visible_devices"] = visible
    if visible == 1:
        if sh.resolve_mesh(8, None, dev) is not None:
            raise AssertionError("13e: meshDevices 8 on one card must be the unsharded path")
        one = sh.resolve_mesh(0, (0, 1), dev)
        if one is None or one.size != 1:
            raise AssertionError(f"13e: meshSlice 0/1 gave {one}")
        try:
            sh.resolve_mesh(0, (0, 2), dev)
        except ValueError as e:
            out["slice_0_of_2"] = str(e)
        else:
            raise AssertionError("13e: meshSlice 0/2 on one card must raise ValueError")
        nodes = make_nodes(16)
        cs = _cluster(nodes, [make_pod(i) for i in range(32)])
        sched = Scheduler(cs, SchedulerConfig(
            batch_size=16, mesh_slice=(0, 1),
            fleet=FleetConfig(replica="r0", replicas=("r0",), exchange=OccupancyExchange()),
            solver=ExactSolverConfig(tie_break="first")), device=dev)
        guard = TopTier(sched, "13e replica")
        while True:
            r = sched.schedule_batch()
            guard.batch(r)
            if not r.progressed:
                break
        guard.close()
        check_cluster(cs, "13e replica")
        bound = sum(1 for p in cs.list_pods() if p.node_name)
        if bound != 32 or sched.resilience.ladder[0] != "mesh":
            raise AssertionError(f"13e replica: {bound} of 32 bound, ladder "
                                 f"{sched.resilience.ladder}")
        out["slice_0_of_1"] = {"mesh": [str(d) for d in one.devices], "replica_bound": bound,
                               "fleet_mesh_slice_devices":
                                   metrics.fleet_mesh_slice_devices.value()}
    log("sharded 13e " + json.dumps(out))
    return out


def sharded_kernel_case(dev, interpod, k=SHARDS):
    """The kernel at one shard's launch of the sharded scan: 6b's in + ex
    rows over the first of k node blocks, counts only."""
    rng = np.random.default_rng(SEED)
    w = interpod.in_dom.shape[1] // k
    sets = []
    for name in ("in_dom", "ex_dom"):
        dom_np = np.ascontiguousarray(getattr(interpod, name)[:, :w])
        sets.append((_dev(dom_np, dev),
                     _dev(rng.integers(0, 4, dom_np.shape).astype(np.int32), dev), None))
    return kernel_case(f"interpod in+ex, one of {k} shards, counts only (13a's launch)",
                       sets, interpod.d_pad, counts=True, gather=False)


def phase13(dev, bindings_6b, digest_6c, reduced_6c=None):
    """Phase 13, each part with its own readings and checks."""
    t0 = time.perf_counter()
    a = sharded_scan(dev, bindings_6b)
    b = sharded_grouped(dev)
    c = sharded_scheduler(dev, digest_6c, reduced_6c=reduced_6c)
    d = sharded_plans(dev)
    e = sharded_sim_and_resolution(dev)
    return {"scan_13a": a, "grouped_13b": b, "scheduler_13c": c, "plans_13d": d,
            "sim_13e": e, "phase_s": time.perf_counter() - t0}

# -- phase 14: the threefry kernel ---------------------------------------------

# integer operations of one Threefry-2x32-20 hash: 20 rounds of add, rotate
# and xor, 6 key injections of two adds, the key schedule's two xors
HASH_OPS = 20 * 3 + 6 * 2 + 2
# H100 SXM: 64 INT32 lanes per SM (the Hopper white paper) x 132 SMs at the
# 1.98 GHz boost clock that the table's 67 TFLOP/s float32 rate assumes
INT32_OPS_PER_S = 64 * 132 * 1.98e9
THREEFRY_WIDTHS = (5120, 10240)
# tie counts the scan's draw sees at 13a's width: one node, a few, all
SCAN_TIES = (0, 1, 7, 5120, 10240)


def _bound(ops, nbytes):
    o_ms = ops / INT32_OPS_PER_S * 1e3
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(o_ms, b_ms), "bound_by": "operations" if o_ms >= b_ms else "bytes",
            "operations": ops, "bytes": nbytes}


def _words_on(key, dev):
    return tuple(torch.tensor(w, dtype=torch.int64, device=dev) for w in key)


def _as_bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def threefry_checks(dev, seed=SEED):
    """14a: both entry points against the plain versions, exactly: the
    card's stream against the CPU's (Python-int keys) and against the
    plain version run on the card's own tensors, over seeded keys, the
    scan's tie counts and the grouped loop's widths; the Random123 known
    answer and a 1,000-step scan chain. Then each entry point's per-call
    and device times beside its plain version's, the ``torch.rand`` call
    it replaces (a reference only: another stream) and its bound."""
    rng = np.random.default_rng(seed)
    checked = 0
    for trial in range(4):
        key = tuple(int(w) for w in rng.integers(0, 1 << 32, 2))
        card, cpu = tf.Stream(key, dev), tf.Stream(key, "cpu")
        for t in SCAN_TIES:
            if trial % 2:
                card.skip()
                cpu.skip()
            before = card.key_words()
            got = card.rank(torch.tensor(t, dtype=torch.int64, device=dev))
            plain, _ = prng.scan_draw(_words_on(before, dev),
                                      torch.tensor(t, dtype=torch.int64, device=dev))
            want = cpu.rank(torch.tensor(t, dtype=torch.int64))
            if not (int(got) == int(plain) == int(want)) or card.key_words() != cpu.key_words():
                raise AssertionError(f"14a threefry_scan_draw key {key} ties {t}: kernel "
                                     f"{int(got)}, plain on the card {int(plain)}, CPU {int(want)}")
            checked += 1
        for n in THREEFRY_WIDTHS:
            for what, split in (("uniform", True), ("node_keys", False), ("node_keys", True),
                                ("uniform", False)):
                draw = (lambda s, n=n, what=what, split=split:
                        s.uniform(0, n, split=split) if what == "uniform"
                        else s.node_keys(0, n, n, split=split))
                got, want = draw(card), draw(cpu)
                sub = cpu.sub
                plain = (prng.uniform_f64(_words_on(sub, dev), 0, n, dev) if what == "uniform"
                         else prng.node_keys(_words_on(sub, dev), 0, n, n, dev))
                g, p_, w = _as_bits(got).cpu(), _as_bits(plain).cpu(), _as_bits(want)
                if not (torch.equal(g, w) and torch.equal(p_, w)):
                    bad = int((g != w).sum()) + int((p_ != w).sum())
                    raise AssertionError(f"14a threefry_grouped_draw {what} split={split} N {n} "
                                         f"key {key}: {bad} columns differ")
                if card.key_words() != cpu.key_words():
                    raise AssertionError(f"14a threefry_grouped_draw N {n}: keys differ")
                checked += 1
    # the Random123 known answer through the uniform entry point
    ka = tf.Stream((0, 0), dev)
    if dev.type == "cuda":
        ka.state[4:6] = torch.tensor([0x13198A2E, 0x03707344], device=dev)
    else:
        ka.sub = (0x13198A2E, 0x03707344)
    ka.has_sub = True
    u = ka.uniform(0x243F6A8885A308D3, 1, split=False).item()
    want_u = float(np.array([(0xC4923A9C483DF7A0 >> 12) | 0x3FF0000000000000],
                            np.uint64).view(np.float64)[0]) - 1.0
    if u != want_u:
        raise AssertionError(f"14a threefry known answer: {u} != {want_u}")
    # 1,000 scan draws, ranks kept on the card and read once
    card, cpu = tf.Stream(prng.prng_key(seed + 99), dev), tf.Stream(prng.prng_key(seed + 99),
                                                                    "cpu")
    spans = rng.integers(0, 10_241, 1000)
    got = torch.stack([card.rank(torch.tensor(int(t), dtype=torch.int64, device=dev))
                       for t in spans]).cpu()
    want = torch.stack([cpu.rank(torch.tensor(int(t), dtype=torch.int64)) for t in spans])
    if not torch.equal(got, want) or card.key_words() != cpu.key_words():
        raise AssertionError("14a threefry 1,000-step scan chain: kernel != plain")
    checked += 1000

    # times, the main path's shapes
    n = THREEFRY_WIDTHS[0]
    ties = torch.tensor(n, dtype=torch.int64, device=dev)
    stream = tf.Stream(prng.prng_key(seed), dev)
    key_dev = _words_on(prng.prng_key(seed), dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    scan = {
        "name": "threefry_scan_draw", "shape": {"n_ties": n},
        "ms": time_ms(lambda: stream.rank(ties)),
        "plain_ms": time_ms(lambda: prng.scan_draw(key_dev, ties), runs=5, calls=3),
        "device_ms": device_ms(lambda: stream.rank(ties)),
        "plain_device_ms": device_ms(lambda: prng.scan_draw(key_dev, ties), calls=3),
        "torch_rand_ms": time_ms(lambda: torch.rand((), generator=gen, dtype=torch.float64,
                                                    device=dev)),
        "torch_rand_device_ms": device_ms(lambda: torch.rand((), generator=gen,
                                                             dtype=torch.float64, device=dev)),
        # six hashes and the 64-bit remainders; the key, the tie count and the rank
        **_bound(6 * HASH_OPS + 12, 16 + 8 + 16 + 8),
    }
    grouped = {
        "name": "threefry_grouped_draw", "shape": {"N": n, "draws": ["uniform", "node_keys"]},
        "ms": time_ms(lambda: stream.uniform(0, n)),
        "node_keys_ms": time_ms(lambda: stream.node_keys(0, n, n)),
        "plain_ms": time_ms(lambda: prng.uniform_f64(key_dev, 0, n, dev), runs=5, calls=3),
        "plain_node_keys_ms": time_ms(lambda: prng.node_keys(key_dev, 0, n, n, dev),
                                      runs=5, calls=3),
        "device_ms": device_ms(lambda: stream.uniform(0, n)),
        "node_keys_device_ms": device_ms(lambda: stream.node_keys(0, n, n)),
        "plain_device_ms": device_ms(lambda: prng.uniform_f64(key_dev, 0, n, dev), calls=3),
        "torch_rand_ms": time_ms(lambda: torch.rand(n, generator=gen, dtype=torch.float64,
                                                    device=dev)),
        "torch_randint_ms": time_ms(lambda: torch.randint(0, 1 << 20, (n,), generator=gen,
                                                          dtype=torch.int64, device=dev)),
        # the split's two hashes and one hash and the mantissa per column;
        # the key and the subkey, and a float64 per column
        **_bound((2 + n) * HASH_OPS + 3 * n, 48 + 8 * n),
        "node_keys_bound_ms": _bound((4 + 2 * n) * HASH_OPS + 8 * n, 48 + 8 * n)["bound_ms"],
    }
    out = {"checked": checked, "max_abs_err": 0, "scan_draw": scan, "grouped_draw": grouped}
    log("threefry 14a " + json.dumps(out))
    return out


def threefry_scan(dev, n_nodes=5120, n_pods=1024, cpu_pods=64):
    """14b: the random-mode scan at 13a's shape (6b's mixed workload, one
    batch, unsharded, balanced float64) on the card through the torch step
    (the fused step, which draws inside its own kernel, forced off: phase
    16 runs it), its threefry launch count set to 0 just before and read
    just after: one scan draw per valid pod and no grouped draw; pods/s;
    torch launches per step in both tie-break modes. Then card == the CPU
    port at 13a's width and ``cpu_pods`` pods (the CPU's interpod
    aggregation at 5,120 nodes costs seconds a step)."""
    real = ss.engages
    ss.engages = lambda *a: False
    try:
        return _threefry_scan(dev, n_nodes, n_pods, cpu_pods)
    finally:
        ss.engages = real


def _threefry_scan(dev, n_nodes, n_pods, cpu_pods):
    nodes = make_nodes(n_nodes)
    pods = [make_pod(i) for i in range(n_pods)]
    vocab = ResourceVocab.build(pods, nodes)
    cfg = ExactSolverConfig(tie_break="random", balanced_fdtype="float64", seed=SEED)
    inputs = tensorize(nodes, pods, {}, vocab)
    tf_reset()
    dc.LAUNCHES = 0
    _sync(dev)
    t = time.perf_counter()
    a = ExactSolver(cfg).solve(*inputs, device=dev)
    _sync(dev)
    secs = time.perf_counter() - t
    draws = tf_launches()
    if dev.type == "cuda" and draws != {"scan_draw": n_pods, "grouped_draw": 0}:
        raise AssertionError(f"14b: {draws} threefry launches for {n_pods} scan steps")
    if (a < 0).any():
        raise AssertionError("14b: a pod did not place")
    small = [make_pod(i) for i in range(cpu_pods)]
    v_small = ResourceVocab.build(small, nodes)
    card = ExactSolver(cfg).solve(*tensorize(nodes, small, {}, v_small), device=dev)
    cpu = ExactSolver(cfg).solve(*tensorize(nodes, small, {}, v_small), device="cpu")
    if not np.array_equal(card, cpu):
        bad = np.flatnonzero(card != cpu)
        raise AssertionError(f"14b: card != CPU port at {bad.size} pods, first {bad[:4]}")
    out = {"nodes": n_nodes, "pods": n_pods, "solve_s": secs, "pods_per_s": n_pods / secs,
           "threefry_launches": draws, "domain_counts_launches": dc.LAUNCHES,
           "card_equals_cpu_pods": cpu_pods,
           "launches_per_step_random": launches_per_step(dev, tie="random")["per_step"]}
    log("threefry 14b " + json.dumps(out))
    return out


def draws_by_path(grouped, sched, p13, p14) -> dict:
    """The launches of the kernels that draw the random stream
    (``tf_launches``) on the random-mode paths, each count set to 0 just
    before its path and read just after."""
    return {
        **{f"grouped {k}": r["threefry_launches"] for k, r in grouped.items()
           if k.endswith("random")},
        "scheduler 6a random": sched["6a"]["random"]["threefry_launches"],
        "scheduler 6c": sched["6c"]["threefry_launches"],
        "scheduler 6c reduced": sched["6c_reduced"]["threefry_launches"],
        **{f"sharded 13b {kt} {lbl}": r["threefry_launches"]
           for kt, runs in p13["grouped_13b"].items()
           if kt.endswith("/random") and not kt.startswith("session")
           for lbl, r in runs.items()},
        "sharded 13c north star": p13["scheduler_13c"]["north_star"]["threefry_launches"],
        "sharded 13c reduced": p13["scheduler_13c"]["reduced"]["threefry_launches"],
        "random scan 14b": p14["scan_14b"]["threefry_launches"],
    }


def threefry_records(draws, p14):
    """The kernels line's records of the threefry kernel's two entry
    points: 14a's checks and times, and the launches on the random-mode
    paths (``draws_by_path``). Raises when an entry point was launched on
    no main path."""
    records = []
    for entry, replaces in (("scan_draw", "kubernetes_tpu/solver/exact.py:352"),
                            ("grouped_draw", "kubernetes_tpu/solver/exact.py:759")):
        case = p14["checks_14a"][entry]
        by_path = {k: v[entry] for k, v in draws.items() if v[entry]}
        if not by_path:
            raise AssertionError(f"threefry_{entry}: no main path launched it")
        records.append({
            "name": f"threefry_{entry}", "route": "cuda",
            "source": "kubernetes_tpu_torch/csrc/threefry.cu", "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "exact": True, "max_abs_err": p14["checks_14a"]["max_abs_err"],
            "ms": case["ms"], "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": None,
            "library": "none: torch.rand draws another stream (torch_rand_ms, a reference)",
            **{k: v for k, v in case.items() if k not in (
                "name", "ms", "plain_ms", "bound_ms", "bound_by")},
        })
    return records


# -- phase 15: the fused spread loop ------------------------------------------

# spread5k's shape (the benchmark's configuration): 5,000 nodes of 4 CPU /
# 32Gi / 110 pods in 3 zones, pods of one hard zone spread at maxSkew 5 over
# their own label (100m / 500Mi), batches of 1,024 pods, chunks of 64
GS_NODES, GS_BATCH, GS_BATCHES, GS_GROUP = 5000, 1024, 2, 64
# a lower bound of the integer operations one iteration of the fused loop
# spends on a node: the ok test, the mask, the best score, the tie test,
# the eligibility, the acceptance, the scatter test and the flags' reset
GS_NODE_OPS = 8
# bytes the loop reads of a node once a chunk (cap, base, counted_dom, dom:
# int32; hk: bool; alloc, nonzero_used: two int64 rows each) and writes (m:
# int32)
GS_NODE_BYTES = 4 * 4 + 1 + 2 * 8 * 2 + 4


def _spread5k_workload():
    nodes = [MakeNode().name(f"node-{i:05}")
             .capacity({"cpu": "4", "memory": "32Gi", "pods": "110"})
             .label(ZONE, f"z{i % 3}").label(HOST, f"node-{i:05}").obj()
             for i in range(GS_NODES)]
    pods = [MakePod().name(f"s5-{i:05}").label("foo", "bar")
            .req({"cpu": "100m", "memory": "500Mi"})
            .spread_constraint(5, ZONE, "DoNotSchedule", {"foo": "bar"}).obj()
            for i in range(GS_BATCH * GS_BATCHES)]
    return nodes, pods


def _settled(times) -> dict:
    """A solve call's counts with the counts of its deferred device rows
    added (waits for the card)."""
    out = dict(times.counts)
    for d in times.deferred:
        for k, v in d.values().items():
            out[k] += v
    return out


def _spread_solves(dev, nodes, pods, vocab, fused, seed):
    """``pods`` in batches of GS_BATCH on one random-mode solver, each
    batch's placements bound before the next. ``fused``: the main path (the
    fused loop where it engages, the graphs on); else the eager loop
    (``gs.engages`` and the graphs forced off). Returns per batch
    (assignments, node state after, the stream's final key, the settled
    counts), per spread chunk (its m, the stream's key after it, its wall ms
    with the card synchronised before and after), and the fused kernel's
    CUDA-event pairs."""
    from kubernetes_tpu_torch.solver import graphs as sg
    from kubernetes_tpu_torch.solver import grouped as gp

    made, chunks, events = [], [], []
    real = (tf.Stream, gp.fast_chunk, gs.spread_loop, gs.engages, sg.engages)

    class Recorded(real[0]):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    def chunk(mode, *a, **k):
        _sync(dev)
        t0 = time.perf_counter()
        asg, m = yield from real[1](mode, *a, **k)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        if mode == "spread":
            chunks.append((m.cpu().numpy().copy(), k["stream"].key_words(), ms))
        return asg, m

    def loop(stream, **kw):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        real[2](stream, **kw)
        b.record()
        events.append((a, b))

    tf.Stream, gp.fast_chunk, gs.spread_loop = Recorded, chunk, loop
    if not fused:
        gs.engages = sg.engages = lambda *a: False
    try:
        solver = ExactSolver(ExactSolverConfig(tie_break="random", seed=seed,
                                               group_size=GS_GROUP, balanced_fdtype="float64"))
        placed: dict[str, list] = {}
        batches = []
        for lo in range(0, len(pods), GS_BATCH):
            bp = pods[lo : lo + GS_BATCH]
            inp = tensorize(nodes, bp, placed, vocab)
            a = solver.solve(*inp, device=dev)
            state = [getattr(inp[0], f).copy() for f in ("used", "nonzero_used", "pod_count")]
            stream = solver.graphs.stream if solver.graphs is not None else made[-1]
            batches.append((a, state, stream.key_words(), _settled(solver.times)))
            for i, s_ in enumerate(a):
                if s_ >= 0:
                    placed.setdefault(nodes[s_].name, []).append(bp[i])
    finally:
        tf.Stream, gp.fast_chunk, gs.spread_loop, gs.engages, sg.engages = real
    return batches, chunks, events


def grouped_spread_check(dev, seed=SEED):
    """15: the fused spread loop (``csrc/grouped_spread.cu``) against the
    eager loop it replaces, at spread5k's shape: two batches of 1,024 pods
    on 5,000 nodes, the second on the first's placements, solved once on
    the main path and once with the fused loop and the graphs off. Every
    batch's assignments, node state, final stream key, iterations and kept
    water-fills, and every chunk's m and stream key, must be equal exactly.
    Times: each spread chunk's wall with the card synchronised on both
    sides (median over the chunks), the kernel's own time from CUDA events
    around each launch, and its bound from the bytes it reads and a lower
    bound of its integer operations."""
    nodes, pods = _spread5k_workload()
    vocab = ResourceVocab.build(pods, nodes)
    gs.LAUNCHES = 0
    got, got_chunks, events = _spread_solves(dev, nodes, pods, vocab, True, seed)
    launches = gs.LAUNCHES
    want, want_chunks, _ = _spread_solves(dev, nodes, pods, vocab, False, seed)
    keys = ("grouped_iterations", "chunk_iterations.spread", "waterfill_iterations",
            "chunks.spread", "chunk_pods.spread")
    for b, ((a, sa, ka, ca), (w, sw, kw, cw)) in enumerate(zip(got, want)):
        if not np.array_equal(a, w):
            bad = np.flatnonzero(a != w)
            raise AssertionError(f"15 grouped_spread batch {b} (seed {seed}): assignments "
                                 f"differ at {bad.size} pods, first {bad[:5]}")
        if not (a >= 0).all():
            raise AssertionError(f"15 grouped_spread batch {b}: {(a < 0).sum()} pods unplaced")
        for name, x, y in zip(("used", "nonzero_used", "pod_count"), sa, sw):
            if not np.array_equal(x, y):
                raise AssertionError(f"15 grouped_spread batch {b}: node {name} differs")
        if ka != kw:
            raise AssertionError(f"15 grouped_spread batch {b}: stream key {ka} != {kw}")
        for k in keys:
            if ca[k] != cw[k]:
                raise AssertionError(f"15 grouped_spread batch {b}: {k} {ca[k]} != {cw[k]}")
        if not ca["fused_chunks.spread"] == ca["chunks.spread"] > 0 or cw["fused_chunks.spread"]:
            raise AssertionError(f"15 grouped_spread batch {b}: fused chunks "
                                 f"{ca['fused_chunks.spread']} / {cw['fused_chunks.spread']} "
                                 f"of {ca['chunks.spread']}")
    if len(got_chunks) != len(want_chunks):
        raise AssertionError(f"15 grouped_spread: {len(got_chunks)} != {len(want_chunks)} chunks")
    for c, ((m, k, _), (mw, kw, _)) in enumerate(zip(got_chunks, want_chunks)):
        if not np.array_equal(m, mw) or k != kw:
            raise AssertionError(f"15 grouped_spread chunk {c}: m or stream key differs")
    chunks = sum(c["fused_chunks.spread"] for _, _, _, c in got)
    if launches != chunks or len(events) != chunks:
        raise AssertionError(f"15 grouped_spread: {launches} launches, {len(events)} timed, "
                             f"for {chunks} fused chunks")
    torch.cuda.synchronize()
    kernel_ms = [a.elapsed_time(b) for a, b in events]
    iterations = sum(c["chunk_iterations.spread"] for _, _, _, c in got)
    n = got[0][1][2].shape[0]  # the padded node count the kernel walks
    bound = _bound(iterations * n * GS_NODE_OPS // chunks,
                   n * GS_NODE_BYTES + GS_GROUP * 8)
    out = {
        "shape": {"N": GS_NODES, "padded_N": n, "zones": 3, "max_skew": 5,
                  "pods": len(pods), "batch": GS_BATCH, "group": GS_GROUP},
        "exact": True, "max_abs_err": 0, "launches": launches, "chunks": chunks,
        "iterations": iterations, "iterations_per_chunk": iterations / chunks,
        "waterfill_iterations": sum(c["waterfill_iterations"] for _, _, _, c in got),
        "ms": float(np.median([ms for _, _, ms in got_chunks])),
        "plain_ms": float(np.median([ms for _, _, ms in want_chunks])),
        "device_ms": float(np.median(kernel_ms)),
        "device_us_per_iteration": 1e3 * sum(kernel_ms) / iterations,
        **bound,
        "bound_note": "bytes and a lower bound of operations; the kernel is bound by "
                      "latency, its chain of block-wide barriers an iteration",
    }
    log("grouped_spread 15 " + json.dumps(out))
    return out


def grouped_spread_record(grouped, check):
    """The kernels line's record of the fused spread loop: 15's check and
    times, and its launches on the random-mode paths, each count set to 0
    just before its path and read just after. Raises when the grouped
    spread run launched it not at all."""
    by_path = {f"grouped {k}": r["grouped_spread_launches"] for k, r in grouped.items()
               if r["grouped_spread_launches"]}
    if not by_path.get("grouped spread/random"):
        raise AssertionError(f"grouped_spread: the grouped spread run launched it not at all "
                             f"({by_path})")
    by_path["spread5k shape 15"] = check["launches"]
    return {
        "name": "grouped_spread", "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/grouped_spread.cu",
        "replaces": "kubernetes_tpu/solver/exact.py:999",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "library_ms": None, "library": "none: no library call computes the loop",
        **{k: v for k, v in check.items() if k != "launches"},
    }


def scan_step_record(full, sched, loops, draws, check):
    """The kernels line's record of the fused scan step: 16's check and
    times, and its launches on the paths that drive the scan, each count
    set to 0 just before its path and read just after: the interpod
    full-width scan, the scheduler's and the loops' drains, and the
    random-mode paths (``draws_by_path``; the sharded ones keep the torch
    step). Raises when the full-width scan launched it not at all."""
    drains = {**{f"scheduler {k}": sched[k] for k in ("6b", "6c", "6d")},
              **{f"loops {k}": r for k, r in loops.items() if isinstance(r, dict)}}
    by_path = {k: v["scan_step"] for k, v in draws.items()}
    by_path.update({k: r["scan_step_launches"] for k, r in drains.items()
                    if "scan_step_launches" in r})
    by_path["interpod full width (scan)"] = full["scan_step_launches"]
    by_path = {k: v for k, v in by_path.items() if v}
    if not by_path.get("interpod full width (scan)"):
        raise AssertionError(f"scan_step: the full-width scan launched it not at all ({by_path})")
    by_path["interpod5k shape 16"] = check["launches"]
    return {
        "name": "scan_step", "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/scan_step.cu",
        "replaces": "kubernetes_tpu_torch/solver/exact.py _make_step (no TPU kernel)",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "library_ms": None, "library": "none: no library call computes the step",
        **{k: v for k, v in check.items() if k != "launches"},
    }


# interpod5k's shape: 5,120 nodes in 3 zones, two batches of 1,024 pods of
# its four kinds (make_pod), the second on the first's placements
SS_NODES, SS_BATCH, SS_BATCHES = 5120, 1024, 2
# the card's sleep queued ahead of each timed launch, so that its event pair
# times the card alone and not the host's issue (about 100 us at 1.98 GHz)
SS_SLEEP_CYCLES = 200_000


def _scan_solves(dev, nodes, pods, vocab, fused, seed):
    """``pods`` in batches of SS_BATCH on one random-mode solver with the
    step graphs on, each batch's placements bound before the next.
    ``fused``: the main path (the fused step kernel); else the torch step
    (``ss.engages`` forced off). Returns per batch (assignments, node state
    after, the stream's final key, the counts), the CUDA-event pairs of
    every replayed step and of every eager fused launch, each queued
    behind a sleep of the card, and the profiler's kernel device times
    (name -> (microseconds, calls))."""
    from kubernetes_tpu_torch.solver import graphs as sg

    replays, eager = [], []
    real = (sg._Graph.replay, ss.Step._emit, ss.engages)

    def timed(fn, out):
        torch.cuda._sleep(SS_SLEEP_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        out.append((a, b))

    def replay(g):
        timed(lambda: real[0](g), replays)

    def emit(step, words, stream):
        if torch.cuda.is_current_stream_capturing():
            real[1](step, words, stream)
        else:
            timed(lambda: real[1](step, words, stream), eager)

    sg._Graph.replay, ss.Step._emit = replay, emit
    if not fused:
        ss.engages = lambda *a: False
    try:
        solver = ExactSolver(ExactSolverConfig(tie_break="random", seed=seed,
                                               balanced_fdtype="float64"))
        placed: dict[str, list] = {}
        batches = []
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for lo in range(0, len(pods), SS_BATCH):
                bp = pods[lo : lo + SS_BATCH]
                inp = tensorize(nodes, bp, placed, vocab)
                a = solver.solve(*inp, device=dev)
                state = [getattr(inp[0], f).copy() for f in ("used", "nonzero_used", "pod_count")]
                batches.append((a, state, solver.graphs.stream.key_words(),
                                dict(solver.times.counts)))
                for i, s_ in enumerate(a):
                    if s_ >= 0:
                        placed.setdefault(nodes[s_].name, []).append(bp[i])
        _sync(dev)
    finally:
        sg._Graph.replay, ss.Step._emit, ss.engages = real
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        for name in ("scan_step_kernel", "domain_counts_kernel"):
            if name in e.key and us:
                prev = kernels.get(name, (0.0, 0))
                kernels[name] = (prev[0] + float(us), prev[1] + int(e.count))
    return batches, replays, eager, kernels


def scan_step_check(dev, seed=SEED):
    """16: the fused scan step (``csrc/scan_step.cu``) against the torch
    step it replaces, at interpod5k's shape: two batches of 1,024 pods of
    its four kinds on 5,120 nodes, the second on the first's placements,
    solved once on the main path (the step graphs replaying the step's
    domain_counts launches and the kernel) and once with the torch step's
    graphs. Every batch's assignments, node state and final stream key must
    be equal exactly. Times, each launch queued behind a sleep of the card
    so that its CUDA-event pair times the card alone: the whole replayed
    step on both paths and the kernel's eager launches (medians), and the
    kernel's device time a launch from the profiler."""
    nodes = make_nodes(SS_NODES)
    pods = [make_pod(i) for i in range(SS_BATCH * SS_BATCHES)]
    vocab = ResourceVocab.build(pods, nodes)
    ss.LAUNCHES = 0
    got, fused_replays, eager, kernels = _scan_solves(dev, nodes, pods, vocab, True, seed)
    launches = ss.LAUNCHES
    want, torch_replays, _, torch_kernels = _scan_solves(dev, nodes, pods, vocab, False, seed)
    for b, ((a, sa, ka, ca), (w, sw, kw, cw)) in enumerate(zip(got, want)):
        if not np.array_equal(a, w):
            bad = np.flatnonzero(a != w)
            raise AssertionError(f"16 scan_step batch {b} (seed {seed}): assignments differ at "
                                 f"{bad.size} pods, first {bad[:5]}")
        for name, x, y in zip(("used", "nonzero_used", "pod_count"), sa, sw):
            if not np.array_equal(x, y):
                raise AssertionError(f"16 scan_step batch {b}: node {name} differs")
        if ka != kw:
            raise AssertionError(f"16 scan_step batch {b}: stream key {ka} != {kw}")
        if not ca["fused_scan_steps"] == ca["scan_steps"] > 0 or cw["fused_scan_steps"]:
            raise AssertionError(f"16 scan_step batch {b}: fused steps "
                                 f"{ca['fused_scan_steps']} / {cw['fused_scan_steps']} "
                                 f"of {ca['scan_steps']}")
    steps = sum(c["scan_steps"] for _, _, _, c in got)
    if launches != steps:
        raise AssertionError(f"16 scan_step: {launches} launches for {steps} steps")
    torch.cuda.synchronize()

    def us(pairs):
        return [1e3 * a.elapsed_time(b) for a, b in pairs]

    k_us, k_calls = kernels.get("scan_step_kernel", (0.0, 0))
    dc_us, dc_calls = kernels.get("domain_counts_kernel", (0.0, 0))
    out = {
        "shape": {"N": SS_NODES, "pods": len(pods), "batch": SS_BATCH,
                  "kinds": "hostPort, hard zone spread, required hostname anti, "
                           "preferred zone affinity"},
        "exact": True, "max_abs_err": 0, "launches": launches, "steps": steps,
        "replays": len(fused_replays), "eager_launches": len(eager),
        "device_us_per_launch": k_us / k_calls if k_calls else None,
        "domain_counts_device_us_per_launch": dc_us / dc_calls if dc_calls else None,
        "domain_counts_launches_per_step": dc_calls / steps,
        "torch_domain_counts_launches_per_step": torch_kernels.get(
            "domain_counts_kernel", (0.0, 0))[1] / steps,
        "eager_launch_us": float(np.median(us(eager))) if eager else None,
        "replayed_step_us": float(np.median(us(fused_replays))),
        "torch_replayed_step_us": float(np.median(us(torch_replays))),
        "profiled": sorted(kernels),
    }
    log("scan_step 16 " + json.dumps(out))
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
    gs_check = grouped_spread_check(dev)
    ss_check = scan_step_check(dev)
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
    t9 = time.perf_counter()
    sim = sim_phase(dev)
    perf = perf_phase(dev)
    serve = serve_phase(dev)
    phase9_s = time.perf_counter() - t9
    p10 = phase10(dev)
    p11 = phase11(dev)
    p12 = phase12(dev)
    p13 = phase13(dev, bindings_6b, sched["6c"]["bindings_digest"], sched["6c_reduced"])
    t14 = time.perf_counter()
    p14 = {"checks_14a": threefry_checks(dev), "scan_14b": threefry_scan(dev)}
    p14["phase_s"] = time.perf_counter() - t14
    cases.append(sharded_kernel_case(dev, interpod))
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
        "sim 9a": sim["domain_counts_launches"],
        "perf 9b": perf["domain_counts_launches"],
        "serve 9c": serve["domain_counts_launches"],
        "bulk 10c": p10["bulk_10c"]["domain_counts_launches"],
        "rebalance 10d": p10["rebalance_10d"]["domain_counts_launches"],
        **{f"fleet 11a {rid}": n for rid, n in
           p11["fleet_11a"]["domain_counts_launches_by_replica"].items()},
        "fleet 11a parity": p11["fleet_11a"]["parity"]["domain_counts_launches"],
        "fleet drain 11b": p11["fleet_drain_11b"]["domain_counts_launches"],
        "sim 11c": p11["fleet_sim_11c"]["domain_counts_launches"],
        "serve 11d": p11["fleet_serve_11d"]["domain_counts_launches"],
        **{f"cache 12a {m}": p12["cache_12a"][m]["launches"] for m in ("cold", "warm", "prebuilt")},
        **{f"oracle 12b {t}": p12["oracle_12b"][t]["domain_counts_launches"]
           for t in ("first", "random")},
        **{f"sharded 13a k={r['k']}": r["domain_counts_launches"]
           for key, r in p13["scan_13a"].items() if key.startswith("k")},
        **{f"sharded 13b {kt} {lbl}": r["domain_counts_launches"]
           for kt, runs in p13["grouped_13b"].items() if not kt.startswith("session")
           for lbl, r in runs.items()},
        **{f"sharded 13b {kt}": r["domain_counts_launches"]
           for kt, r in p13["grouped_13b"].items() if kt.startswith("session")},
        "sharded 13c mixed": p13["scheduler_13c"]["mixed"]["domain_counts_launches"],
        "sharded 13c north star": p13["scheduler_13c"]["north_star"]["domain_counts_launches"],
        "sharded 13e sim": p13["sim_13e"]["sim"]["domain_counts_launches"],
    }
    main_case = cases[0]
    # phase 9's first launches, held to plain on the path's own inputs
    held_errs = [r["max_abs_err"] for r in (sim, perf["yaml"], perf["anti"], perf["spread"],
                                            serve, p10["bulk_10c"], p10["rebalance_10d"],
                                            p11["fleet_11a"], p11["fleet_11a"]["parity"],
                                            p11["fleet_drain_11b"], p11["fleet_sim_11c"],
                                            p11["fleet_serve_11d"], p12["cache_12a"],
                                            p13["scheduler_13c"]["mixed"],
                                            p13["sim_13e"]["sim"],
                                            *[r for key, r in p13["scan_13a"].items()
                                              if key.startswith("k")],
                                            *[r for kt, runs in p13["grouped_13b"].items()
                                              if not kt.startswith("session")
                                              for r in runs.values()])
                 if r["max_abs_err"] is not None]
    max_abs_err = max([c["max_abs_err"] for c in cases] + held_errs)
    record = {
        "name": "domain_counts",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/domain_counts.cu",
        "replaces": "kubernetes_tpu/ops/pallas_kernels.py:96",
        "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path,
        "exact": max_abs_err == 0,
        "max_abs_err": max_abs_err,
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
    draws = draws_by_path(grouped, sched, p13, p14)
    records = [record] + threefry_records(draws, p14) + [
        grouped_spread_record(grouped, gs_check), scan_step_record(full, sched, loops, draws, ss_check)]
    log(json.dumps({"kernels": records}))
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
    log(json.dumps({"extender": ext, "card": smi}))
    log(json.dumps({"phase9": {"sim_9a": sim, "perf_9b": perf, "serve_9c": serve,
                               "phase_s": phase9_s},
                    "card": smi}))
    log(json.dumps({"phase10": p10, "card": smi}))
    log(json.dumps({"phase11": p11, "card": smi}))
    log(json.dumps({"phase12": p12, "card": smi}))
    log(json.dumps({"phase13": p13, "card": smi}))
    log(json.dumps({"phase14": p14, "script_s": time.perf_counter() - t_start, "card": smi}))
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
    if len(sys.argv) > 3 and sys.argv[1] == "--child" and sys.argv[3] == "--":
        sys.exit(child(sys.argv[2], sys.argv[4:]))
    sys.exit(main())
