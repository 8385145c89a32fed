"""CLI — the cmd/kube-scheduler analog (app/server.go#Setup/#Run shape):
load + validate ComponentConfig, then run one of:

  serve   extender webhook + healthz/livez/readyz + /metrics (port 10259,
          the reference's secure serving port)
  perf    scheduler_perf-compatible YAML workloads
  config  parse/validate a KubeSchedulerConfiguration and print the
          resolved settings + warnings

``--leader-elect`` runs a Lease-based elector over the embedded state
service before serving (see its help).

Copied from ``kubernetes_tpu/cli.py``. ``serve`` and ``perf`` take
``--device`` (default: the card; ``cpu`` runs on the CPU), which reaches
the webhook's evaluator, the embedded Scheduler and the perf runner's
Schedulers. ``serve --grpc-port > 0`` also serves the bulk tensor gRPC
path (``server/bulk.py``) on the same device, and ``--trace-dir`` writes a
torch.profiler trace (``utils/tracing.py``). Run it as ``python -m
kubernetes_tpu_torch``.
"""

from __future__ import annotations

import argparse
import json
import sys

from .config import types as config_types


def _load_config(path: str | None) -> config_types.KubeSchedulerConfiguration:
    if path:
        return config_types.load_file(path)
    return config_types.KubeSchedulerConfiguration()


def _feature_gates(args):
    """Parse --feature-gates (component-base/featuregate syntax); parse
    errors exit 1 like the reference's flag validation."""
    from .utils.featuregate import FeatureGates

    try:
        fg = FeatureGates.parse(getattr(args, "feature_gates", None))
    except ValueError as e:
        print(f"error: --feature-gates: {e}", file=sys.stderr)
        raise SystemExit(1)
    for w in fg.warnings:
        print(f"warning: {w}", file=sys.stderr)
    return fg


def cmd_config(args) -> int:
    cfg = _load_config(args.config)
    _feature_gates(args)  # validate the flag here too (exit 1 on error)
    # building the runtime config runs the per-profile solver validation
    # (scoring strategy shapes, disableable filters, resource weights) so
    # its warnings surface here too, not only at serve/perf time
    config_types.scheduler_config(cfg)
    out = {
        "profiles": [
            {
                "schedulerName": p.scheduler_name,
                "scoreWeights": p.score_weights,
                "scoringStrategy": p.scoring_strategy.type,
                "hardPodAffinityWeight": p.hard_pod_affinity_weight,
            }
            for p in cfg.profiles
        ],
        "extenders": len(cfg.extenders),
        "tpuSolver": {
            "batchSize": cfg.tpu_solver.batch_size,
            "tieBreak": cfg.tpu_solver.tie_break,
            "enablePreemption": cfg.tpu_solver.enable_preemption,
            "groupSize": cfg.tpu_solver.group_size,
            "meshDevices": cfg.tpu_solver.mesh_devices,
            "streamDepth": cfg.tpu_solver.stream_depth,
            "pipelineSplit": cfg.tpu_solver.pipeline_split,
            "backlogChunkPods": cfg.tpu_solver.backlog_chunk_pods,
            "pallas": cfg.tpu_solver.pallas,
        },
        "rebalance": {
            "enabled": cfg.rebalance.enabled,
            "intervalSeconds": cfg.rebalance.interval_seconds,
            "maxMovesPerCycle": cfg.rebalance.max_moves_per_cycle,
            "minPackingUtilization": cfg.rebalance.min_packing_utilization,
            "minGainPoints": cfg.rebalance.min_gain_points,
            "nominate": cfg.rebalance.nominate,
        },
        "fleet": {
            "replica": cfg.fleet.replica,
            "replicas": cfg.fleet.replicas,
            "hubAddress": cfg.fleet.hub_address,
            "meshSlice": (
                f"{cfg.fleet.mesh_slice[0]}/{cfg.fleet.mesh_slice[1]}"
                if cfg.fleet.mesh_slice is not None
                else None
            ),
            "maxRowAgeSeconds": cfg.fleet.max_row_age_seconds,
            "flushBatch": cfg.fleet.flush_batch,
        },
        "gang": {
            "enabled": cfg.gang.enabled,
            "minMemberTimeoutSeconds": cfg.gang.min_member_timeout_seconds,
            "quarantineAfter": cfg.gang.quarantine_after,
            "throughputWeight": cfg.gang.throughput_weight,
            "classThroughputWorkloads": sorted(cfg.gang.class_throughput),
            "classThroughputPath": cfg.gang.class_throughput_path,
        },
        "tuning": {
            "enabled": cfg.tuning.enabled,
            "evalBatches": cfg.tuning.eval_batches,
            "hysteresis": cfg.tuning.hysteresis,
            "settleAfter": cfg.tuning.settle_after,
            "maxProbes": cfg.tuning.max_probes,
            "shiftThreshold": cfg.tuning.shift_threshold,
            "knobs": cfg.tuning.knobs,
        },
        "warnings": cfg.warnings,
    }
    print(json.dumps(out, indent=2))
    return 0


def cmd_serve(args) -> int:
    from .server.extender import run_server
    from .state.cluster import ClusterState
    from .utils import logging as structured_logging

    # component-base logs analog (--logging-format): one JSON object per
    # line carrying the scheduler's span/batch ids, or klog-ish text
    structured_logging.setup(args.log_format)
    cfg = _load_config(args.config)
    for w in cfg.warnings:
        print(f"warning: {w}", file=sys.stderr)
    cluster = ClusterState()
    sched_cfg = config_types.scheduler_config(cfg)
    sched_cfg.feature_gates = _feature_gates(args)
    telemetry_on = bool(args.telemetry or args.bundle_dir)
    if (
        args.obs or args.obs_journal or args.obs_dump or args.slo
        or telemetry_on
    ):
        from .obs import ObsConfig, SentinelConfig, SloConfig

        sched_cfg.obs = ObsConfig(
            spans=bool(args.obs or args.obs_journal or args.obs_dump),
            journal=bool(
                args.obs or args.obs_journal or args.obs_dump
                or telemetry_on
            ),
            journal_path=args.obs_journal,
            dump_path=args.obs_dump,
            # a serving process runs indefinitely: bound the in-memory
            # journal and rely on --obs-journal streaming for history
            journal_capacity=65536,
            # live SLO engine (GET /debug/slo + scheduler_slo_*):
            # --slo OBJECTIVE enables it with that per-pod latency
            # objective in seconds. --telemetry implies it: the
            # sentinel's p99 signal reads off the SLO engine.
            slo=(
                SloConfig(latency_objective_s=args.slo)
                if args.slo
                else (SloConfig() if telemetry_on else None)
            ),
            # always-on flight telemetry (GET /debug/profile +
            # scheduler_profile_* / scheduler_anomaly_*): continuous
            # per-stage profiler, anomaly sentinel with production-
            # sized windows, capture-on-anomaly replay bundles under
            # --bundle-dir (which implies --telemetry)
            profile=telemetry_on,
            sentinel=SentinelConfig() if telemetry_on else None,
            bundle_dir=args.bundle_dir,
        )
    if args.leader_elect:
        # client-go leaderelection.RunOrDie semantics over the state
        # service's Lease store: block serving until the lease is held;
        # renew in the background; exit the process on loss (the
        # reference's OnStoppedLeading is fatal). NOTE: exclusion spans
        # electors sharing THIS ClusterState (embedded schedulers); a
        # second standalone process has its own store and self-elects —
        # the --leader-elect help documents this scope honestly.
        import os
        import socket
        import threading

        from .utils.leaderelection import LeaderElector

        elector = LeaderElector(
            cluster, identity=f"{socket.gethostname()}_{os.getpid()}"
        )
        acquired = threading.Event()

        def lost():
            print(
                "error: leader lease lost; exiting", file=sys.stderr
            )
            os._exit(1)

        t = threading.Thread(
            target=elector.run,
            args=(threading.Event(),),
            kwargs=dict(
                on_started_leading=acquired.set, on_stopped_leading=lost
            ),
            daemon=True,
        )
        t.start()
        acquired.wait()
        print(
            f"leader election: acquired lease as {elector.identity}",
            file=sys.stderr,
        )
    run_server(
        cluster,
        host=args.host,
        port=args.port,
        node_cache_capable=args.node_cache_capable,
        mode=args.mode,
        state_file=args.state,
        solver_config=sched_cfg.solver,
        grpc_port=args.grpc_port,
        scheduler_config=sched_cfg,
        device=args.device,
    )
    return 0


def cmd_perf(args) -> int:
    from .perf.runner import PerfRunner

    cfg = _load_config(args.config)
    sched_cfg = config_types.scheduler_config(cfg)
    sched_cfg.feature_gates = _feature_gates(args)
    runner = PerfRunner(sched_cfg, device=args.device)
    results = runner.run_file(args.workload, workload_filter=args.workload_name)
    failed = 0
    for r in results:
        print(
            json.dumps(
                {
                    "testCase": r.test_case,
                    "workload": r.workload,
                    "scheduled": r.scheduled,
                    "unschedulable": r.unschedulable,
                    "throughput": r.throughput_summary(),
                    "podLatency": r.latency_summary(),
                    "deviceSolveSeconds": round(r.solve_seconds, 3),
                    **(
                        {"threshold": r.threshold, "passed": r.passed}
                        if r.threshold
                        else {}
                    ),
                }
            )
        )
        if not r.passed:
            failed += 1
            print(
                f"FAIL: {r.test_case}/{r.workload}: avg "
                f"{r.measured_pods / max(r.measure_seconds, 1e-9):.0f} "
                f"pods/s below threshold {r.threshold:.0f}",
                file=sys.stderr,
            )
    # scheduler_perf.go's threshold assert: a perf regression fails the run
    return 1 if failed else 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch",
        description="batched pod->node assignment engine on PyTorch "
        "(CUDA by default)",
    )
    parser.add_argument("--config", help="KubeSchedulerConfiguration YAML")
    parser.add_argument(
        "--feature-gates",
        help='component-base style gate list, e.g. '
        '"SchedulerQueueingHints=false,PodSchedulingReadiness=true"',
    )
    parser.add_argument(
        "--trace-dir",
        help="write a torch.profiler Chrome trace of the scheduling "
        "batches here (SURVEY §6.1; the --profiling analog)",
    )
    parser.add_argument(
        "--leader-elect",
        action="store_true",
        help="Lease-based active/passive leader election over the state "
        "service (client-go tools/leaderelection semantics): serve blocks "
        "until the lease is acquired and exits if it is lost. Mutual "
        "exclusion spans schedulers SHARING one state service; this "
        "binary embeds its own store, so a standalone process self-elects "
        "(the reference's lease lives in the shared apiserver)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_serve = sub.add_parser("serve", help="run the extender webhook server")
    p_serve.add_argument("--host", default="127.0.0.1")
    p_serve.add_argument("--port", type=int, default=10259)
    p_serve.add_argument("--node-cache-capable", action="store_true")
    p_serve.add_argument(
        "--mode",
        choices=("extender", "scheduler"),
        default="extender",
        help="extender: answer webhook verbs only; scheduler: also run the "
        "batching scheduler loop over the ingested state",
    )
    p_serve.add_argument(
        "--state",
        help=(
            "initial cluster state file (JSON/YAML: nodes, pods, services, "
            "pdbs, resourceSlices, deviceClasses, resourceClaims)"
        ),
    )
    p_serve.add_argument(
        "--grpc-port",
        type=int,
        default=0,
        help="also serve the bulk tensor gRPC path on this port (0 = off)",
    )
    p_serve.add_argument(
        "--log-format",
        choices=("text", "json"),
        default="text",
        help="structured logging format (component-base --logging-format "
        "analog); json emits one object per line carrying span/batch ids",
    )
    p_serve.add_argument(
        "--obs",
        action="store_true",
        help="enable the scheduling trace layer (kubernetes_tpu_torch/obs): "
        "spans + per-pod decision journal in a bounded flight recorder, "
        "served at /debug/flightrecorder and /debug/spans",
    )
    p_serve.add_argument(
        "--obs-journal",
        metavar="PATH",
        help="also stream per-pod decision-journal JSONL here (implies "
        "--obs); explain pods later with `python -m kubernetes_tpu_torch.obs "
        "explain <pod> --trace PATH`",
    )
    p_serve.add_argument(
        "--obs-dump",
        metavar="PATH",
        help="flight-recorder dump target for crash and on-demand dumps "
        "(implies --obs)",
    )
    p_serve.add_argument(
        "--slo",
        type=float,
        metavar="SECONDS",
        default=0.0,
        help="enable the live SLO engine with this per-pod latency "
        "objective (first-enqueue -> bind): sliding-window p50/p99, "
        "bind throughput, multi-window error-budget burn — served at "
        "GET /debug/slo and exported as scheduler_slo_*",
    )
    p_serve.add_argument(
        "--telemetry",
        action="store_true",
        help="enable always-on flight telemetry (kubernetes_tpu_torch/obs): "
        "continuous per-stage profiler + anomaly sentinel (implies the "
        "SLO engine for the p99 signal), served at GET /debug/profile "
        "and exported as scheduler_profile_* / scheduler_anomaly_*",
    )
    p_serve.add_argument(
        "--bundle-dir",
        metavar="DIR",
        help="write capture-on-anomaly replay bundles into this "
        "directory (implies --telemetry); replay offline with "
        "`python -m kubernetes_tpu_torch.obs replay <bundle>`",
    )
    p_serve.add_argument(
        "--device", default=None,
        help="torch device for evaluations and solves (default: the "
        "card; 'cpu' runs on the CPU)",
    )
    p_serve.set_defaults(fn=cmd_serve)

    p_perf = sub.add_parser("perf", help="run scheduler_perf YAML workloads")
    p_perf.add_argument("workload", help="performance-config.yaml path")
    p_perf.add_argument("--workload-name", help="run only this workload")
    p_perf.add_argument(
        "--device", default=None,
        help="torch device for the solves (default: the card; 'cpu' runs "
        "on the CPU)",
    )
    p_perf.set_defaults(fn=cmd_perf)

    p_cfg = sub.add_parser("config", help="parse + print resolved config")
    p_cfg.set_defaults(fn=cmd_config)

    args = parser.parse_args(argv)
    if args.trace_dir:
        import atexit

        from .utils import tracing

        tracing.enable(args.trace_dir)
        atexit.register(tracing.stop)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
