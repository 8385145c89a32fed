"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (a failure in any of them propagates and exits nonzero):

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the build of every kernel under kubernetes_tpu_torch/csrc (one nvcc
   per source, all started together).
2. Each kernel against its plain PyTorch version on the card, exactly, at
   the main path's shapes and at the shapes that take its other paths;
   kernel, plain and library times with CUDA events (per call over runs
   of back-to-back calls, median of 20 runs after warm-up), and each one's
   own device time from torch.profiler.
3. Card against CPU at reduced depth: 1,024 nodes and one batch of 512
   pods of the workload below, solved by the port on the card and on the
   CPU; assignments and written-back node state must be identical.
4. Full width: the InterPodAffinity / anti-affinity configuration of
   BASELINE.json ("5k pods x 5k nodes"), 5,120 nodes in 3 zones and 5,120
   pods in 5 batches of 1,024, each batch tensorized against the pods the
   earlier batches placed. Every pod must place and the cluster's
   invariants must hold; the kernel launch counts are reset just before
   and read just after.
5. Torch kernel launches per scan step and the device's busy share,
   from torch.profiler on two short solves.

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
from kubernetes_tpu_torch.api.wrappers import MakeNode, MakePod  # noqa: E402
from kubernetes_tpu_torch.ops import domain_counts as dc  # noqa: E402
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


def tensorize(nodes, pods, placed_by_node, vocab):
    """The scheduler's tensorize of one batch against the placed pods."""
    nb = build_node_batch(nodes, placed_by_node, vocab=vocab)
    pb = build_pod_batch(pods, vocab)
    slot_nodes = list(nodes) + [None] * (nb.padded - len(nodes))
    placed_by_slot = {
        i: placed_by_node[n.name] for i, n in enumerate(nodes) if n.name in placed_by_node
    }
    static = build_static_tensors(pods, pb, slot_nodes, nb.padded)
    ports = build_port_tensors(pods, pb, slot_nodes, placed_by_slot, nb.padded)
    spread = build_spread_tensors(
        pods, static.reps, pb, slot_nodes, placed_by_slot, nb.padded, static.c_pad
    )
    interpod = build_interpod_tensors(
        pods, static.reps, pb, slot_nodes, placed_by_slot, nb.padded, static.c_pad
    )
    return nb, pb, static, ports, spread, interpod


# -- phase 1 ---------------------------------------------------------------


def environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
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


def kernel_case(label, dom, cnt, d_pad):
    """The kernel against its plain version (exact), and the three times.
    library_ms is one scatter_add_ over the flattened (row, domain) index,
    whose preparation is left out of the timing."""
    got = dc.domain_counts(dom, cnt, d_pad)
    want = dc.domain_counts_plain(dom, cnt, d_pad)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"domain_counts {label}: kernel != plain (max err {err})")
    t, n = dom.shape
    hk = dom >= 0
    seg = torch.where(hk, dom.to(torch.int64), d_pad) + torch.arange(
        t, device=dom.device
    )[:, None] * (d_pad + 1)
    seg = seg.reshape(-1)
    vals = cnt.reshape(-1)
    lib_out = torch.zeros(t * (d_pad + 1), dtype=torch.int32, device=dom.device)

    def library():
        lib_out.zero_()
        lib_out.scatter_add_(0, seg, vals)

    library()
    if not torch.equal(lib_out.reshape(t, d_pad + 1)[:, :d_pad], want):
        raise AssertionError(f"domain_counts {label}: scatter_add_ yardstick disagrees")
    adds = int((hk & (cnt != 0)).sum())
    bytes_moved = t * n * 8 + t * d_pad * 4
    b_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    o_ms = adds / LANE_OPS_PER_S * 1e3
    smem = dc.uses_shared_memory(d_pad, dom.device)
    case = {
        "case": label,
        "shape": {"T": t, "N": n, "d_pad": d_pad},
        "path": "shared" if smem else "global",
        "exact": True,
        "max_abs_err": err,
        "ms": time_ms(lambda: dc.domain_counts(dom, cnt, d_pad)),
        "plain_ms": time_ms(lambda: dc.domain_counts_plain(dom, cnt, d_pad)),
        "library_ms": time_ms(library),
        "device_ms": device_ms(lambda: dc.domain_counts(dom, cnt, d_pad)),
        "plain_device_ms": device_ms(lambda: dc.domain_counts_plain(dom, cnt, d_pad)),
        "library_device_ms": device_ms(library),
        "bound_ms": max(b_ms, o_ms),
        "bound_by": "bytes" if b_ms >= o_ms else "operations",
    }
    log("kernel case " + json.dumps(case))
    return case


def kernel_checks(dev, interpod):
    rng = np.random.default_rng(SEED)
    cases = []
    # the main path's shapes: the full-width batch's real term rows
    for name in ("in_dom", "ex_dom"):
        dom_np = np.ascontiguousarray(getattr(interpod, name))
        cnt_np = rng.integers(0, 4, dom_np.shape).astype(np.int32)
        cases.append(kernel_case(
            f"interpod {name}", torch.from_numpy(dom_np).to(dev),
            torch.from_numpy(cnt_np).to(dev), interpod.d_pad,
        ))
    # one spread row at an untiled node count
    dom = torch.from_numpy(rng.integers(-1, 3, (1, 5001)).astype(np.int32)).to(dev)
    cnt = torch.from_numpy(rng.integers(0, 4, (1, 5001)).astype(np.int32)).to(dev)
    cases.append(kernel_case("untiled T=1", dom, cnt, 8))
    # a d_pad beyond one block's shared memory: the global-memory path
    big = 65536
    dom = torch.from_numpy(rng.integers(-1, big, (8, 5120)).astype(np.int32)).to(dev)
    cnt = torch.from_numpy(rng.integers(0, 4, (8, 5120)).astype(np.int32)).to(dev)
    cases.append(kernel_case("global d_pad=65536", dom, cnt, big))
    paths = {c["path"] for c in cases}
    if paths != {"shared", "global"}:
        raise AssertionError(f"kernel paths exercised: {paths}")
    return cases


# -- phases 3 and 4 --------------------------------------------------------


def reduced_depth(dev):
    nodes = make_nodes(1024)
    pods = [make_pod(i) for i in range(512)]
    vocab = ResourceVocab.build(pods, nodes)
    cfg = ExactSolverConfig(tie_break="first", balanced_fdtype="float64")
    out = {}
    for where in (dev, torch.device("cpu")):
        nb, *rest = tensorize(nodes, pods, {}, vocab)
        t0 = time.perf_counter()
        a = ExactSolver(cfg).solve(nb, *rest, device=where)
        out[where.type] = (a, nb, time.perf_counter() - t0)
    (a_gpu, nb_gpu, s_gpu), (a_cpu, nb_cpu, s_cpu) = out["cuda"], out["cpu"]
    if not np.array_equal(a_gpu, a_cpu):
        bad = np.flatnonzero(a_gpu != a_cpu)
        raise AssertionError(f"card != CPU at {bad.size} pods, first {bad[:5]}")
    for k in ("used", "nonzero_used", "pod_count"):
        if not np.array_equal(getattr(nb_gpu, k), getattr(nb_cpu, k)):
            raise AssertionError(f"card != CPU in written-back {k}")
    log(f"reduced depth 1024 nodes x 512 pods: card == CPU "
        f"({int((a_gpu >= 0).sum())} placed; card {s_gpu:.3f}s, CPU {s_cpu:.3f}s)")


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


def main():
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU")
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = environment()
    log(smi)

    # the full-width batch's interpod rows give the kernel its main-path shapes
    nodes = make_nodes(5120)
    first = [make_pod(i) for i in range(1024)]
    _, _, _, _, _, interpod = tensorize(
        nodes, first, {}, ResourceVocab.build(first, nodes)
    )
    cases = kernel_checks(dev, interpod)
    reduced_depth(dev)
    full = full_width(dev)
    per_step = launches_per_step(dev)

    main_case = cases[0]
    record = {
        "name": "domain_counts",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/domain_counts.cu",
        "replaces": "kubernetes_tpu/ops/pallas_kernels.py:96",
        "launches": full["domain_counts_launches"],
        "exact": True,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"],
        "kernel_ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "library_ms": main_case["library_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "device_ms": main_case["device_ms"],
        "plain_device_ms": main_case["plain_device_ms"],
        "library_device_ms": main_case["library_device_ms"],
        "shape": main_case["shape"],
        "cases": cases,
    }
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({
        "full_width": {k: full[k] for k in ("wall_s", "pods_per_s", "placed")},
        "torch_launches_per_step": per_step["per_step"],
        "card": smi,
    }))
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
