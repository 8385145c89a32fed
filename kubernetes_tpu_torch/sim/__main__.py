"""CLI: seeded simulator runs and trace replay.

    # fresh run (deterministic: same seed+profile => identical trace)
    python -m kubernetes_tpu_torch.sim --seed 0 --profile churn_heavy
    python -m kubernetes_tpu_torch.sim --seed 7 --cycles 20 --profile bind_storms \\
        --trace /tmp/storm.jsonl

    # reproduce a recorded run bit-for-bit
    python -m kubernetes_tpu_torch.sim --replay /tmp/storm.jsonl

    # determinism self-check: run twice, compare trace digests
    python -m kubernetes_tpu_torch.sim --seed 0 --profile node_flaps --selfcheck

    python -m kubernetes_tpu_torch.sim --profile fleet_mixed --fleet 2 --selfcheck

Runs on the card unless ``--device cpu`` is given. ``--fleet N`` drives N
scheduler replicas over one cluster (``sim/fleet.py``), every replica on the
one device. ``--mesh-devices N`` shards the solve's node axis N ways: it
makes N entries of the one device visible first
(``parallel/sharding.force_device_count``, as the JAX package's sim forces
N virtual CPU devices), and the trace is byte-identical to N = 1.

Exit status: 0 clean; 1 invariant violations / failed settle / replay
divergence; 2 usage errors.

Copied from ``kubernetes_tpu/sim/__main__.py``, without its JAX setup.
"""

from __future__ import annotations

import argparse
import sys


def _configure_mesh(mesh_devices: int, device):
    """``mesh_devices > 1``: make that many entries of the solve's device
    visible (the JAX package's ``_configure_jax`` forces that many virtual
    CPU devices), so the sim drives the node-axis-sharded solve path.
    Returns the function that restores the visible list."""
    from ..parallel import sharding

    saved = sharding.forced_device_count()
    if mesh_devices > 1:
        sharding.force_device_count(mesh_devices, device)
    return lambda: sharding.force_device_count(*saved)


def _print_result(res) -> None:
    s = res.summary
    dispatcher = (
        "streaming"
        if s.get("streaming")
        else ("pipelined" if s["pipelined"] else "sync")
    )
    print(
        f"profile={res.profile} seed={res.seed} cycles={res.cycles} "
        f"pipelined={s['pipelined']} dispatcher={dispatcher}"
    )
    print(
        f"  events={s['events']} bound={s['bound']} unbound={s['unbound']} "
        f"settled={s['settled']}"
    )
    print(
        f"  faults: bind={s['bind_faults']} "
        f"watch_delivered={s['watch_delivered']} "
        f"dup={s['watch_duplicated']} extender_aborts={s['extender_aborts']} "
        f"permit_stalls={s['permit_stalls']}"
    )
    print(
        f"  pipeline: discards={s['discards']:.0f} "
        f"fallbacks={s['pipeline_fallbacks']:.0f} "
        f"stream_discards={s.get('stream_discards', 0):.0f} "
        f"preemptions={s['preemptions']:.0f}"
    )
    resil = s.get("resilience")
    if resil is not None and (
        s.get("solver_faults") or s.get("poison_hits") or resil["trips"]
    ):
        tiers = {
            name: p["tier"] for name, p in resil["profiles"].items()
        }
        print(
            f"  resilience: faults={s['solver_faults']} "
            f"poison={s['poison_hits']} trips={resil['trips']} "
            f"recloses={resil['recloses']} "
            f"quarantined={len(s['quarantined'])} tier={tiers}"
        )
    bl = s.get("backlog")
    if bl:
        print(
            f"  backlog: pods={bl['pods']} drained={bl['drained']} "
            f"chunks={bl['chunks']} chunk_pods={bl['chunk_pods']} "
            f"budget_splits={bl['budget_splits']} "
            f"stream_chained={bl['stream_chained']}"
        )
    tu = s.get("tuning")
    if tu:
        knobs = ",".join(f"{k}={v}" for k, v in sorted(tu["knobs"].items()))
        print(
            f"  tuning: probes={tu['probes']} moves={tu['moves']} "
            f"settled={tu['settled']} shifts={tu['shifts']} "
            f"guardrail_rejections={tu['guardrail_rejections']} "
            f"guardrail_breaches={tu['guardrail_breaches']} "
            f"convergence_batches={tu['convergence_batches']} "
            f"knobs[{knobs}]"
        )
    reb = s.get("rebalance")
    if reb:
        print(
            f"  rebalance: runs={reb['runs']} "
            f"evicted={reb['evicted']} "
            f"migrations_completed={reb['migrations_completed']} "
            f"max_cycle_evictions={reb['max_cycle_evictions']} "
            f"budget={reb['budget']} over_budget={reb['over_budget']} "
            f"pdb_blocked={reb['pdb_blocked']} "
            f"pdb_overruns={reb['pdb_overruns']} "
            f"final_packing={reb['final_packing']}"
        )
    g = s.get("gang")
    if g:
        print(
            f"  gang: commits={g['gang_commits']} "
            f"bound_pods={g['gang_bound_pods']} "
            f"incomplete_rounds={g['gang_incomplete_rounds']} "
            f"partial_gangs={g['partial_gangs']} "
            f"quarantined_gangs={g['quarantined_gangs']}"
        )
    mp = s.get("megaplan")
    if mp:
        # the CI megaplan smoke greps ranked/iterations/plan_valid/
        # objective_ratio off this line — keep the key=value shape
        print(
            f"  megaplan: pods={mp.get('pods', 0)} "
            f"ranked={mp.get('ranked', 0)} "
            f"iterations={mp.get('iterations', 0)} "
            f"repaired={mp.get('repaired', 0)} "
            f"relax_placed={mp.get('relax_placed', 0)} "
            f"exact_placed={mp.get('exact_placed', 0)} "
            f"objective_ratio={mp.get('objective_ratio', 0.0)} "
            f"plan_valid={mp.get('plan_valid', False)}"
        )
    tel = s.get("telemetry")
    if tel:
        # the CI telemetry smoke greps anomalies/bundles_captured
        # off this line — keep the key=value shape stable
        signals = ",".join(tel["anomaly_signals"]) or "-"
        triggers = (
            ",".join(
                f"{k}={v}" for k, v in sorted(tel["bundle_triggers"].items())
            )
            or "-"
        )
        print(
            f"  telemetry: anomalies={tel['anomalies']} "
            f"signals={signals} "
            f"bundles_captured={tel['bundles_captured']} "
            f"triggers={triggers}"
        )
    if s.get("crashes") or s.get("incarnations", 1) > 1:
        print(
            f"  lifecycle: incarnations={s['incarnations']} "
            f"crashes={s['crashes']} "
            f"recovered_records={s['recovered_records']}"
        )
    print(
        f"  journal: records={s['journal_records']} "
        f"digest={s['journal_digest'][:16]}"
    )
    print(f"  trace_digest={res.trace.digest()}")
    if res.flight_dump:
        print(f"  flight recorder dumped: {res.flight_dump}")
    if res.replay_divergence:
        print(f"  REPLAY DIVERGED: {res.replay_divergence}")
    elif res.violations:
        print(f"  {len(res.violations)} INVARIANT VIOLATION(S):")
        for v in res.violations[:20]:
            print(f"    [{v.invariant}] cycle {v.cycle}: {v.detail}")
    else:
        print("  invariants: OK")


def _print_fleet_result(res) -> None:
    s = res.summary
    print(
        f"profile={res.profile} seed={res.seed} cycles={res.cycles} "
        f"fleet={res.replicas} alive={s['alive']} "
        f"lost={s['lost_replica'] or '-'} "
        f"hub={s.get('hub', 'in-process')} "
        f"cas_conflicts={s.get('cas_conflicts', 0)}"
    )
    print(
        f"  events={s['events']} bound={s['bound']} "
        f"unbound={s['unbound']} settled={s['settled']} "
        f"binds_by_replica={s['binds_by_replica']}"
    )
    if s.get("zombie"):
        fenced = s["fenced_commits"].get(s["zombie"], 0)
        print(
            f"  partition: zombie={s['zombie']} "
            f"fenced_commits={fenced} "
            f"zombie_binds_while_fenced={s['zombie_binds_while_fenced']} "
            f"stale_rejections={s['stale_rejections']}"
        )
    ha = s.get("hub_ha")
    if ha:
        print(
            f"  hub_ha: failovers={ha['promotions']} "
            f"epoch={ha['epoch']} "
            f"blackout_cycles={ha['blackout_cycles']} "
            f"stale_writes_rejected={ha['deposed_write_rejections']} "
            f"dedup_hits={ha['flush_dedup_hits']} "
            f"client_failovers={ha['client_failovers']} "
            f"replicated_ops={ha['replication_ops']} "
            f"journal_missing={ha['hub_journal_missing']} "
            f"old_primary_reads_ok={ha['old_primary_reads_ok']} "
            f"stale_rejections={s['stale_rejections']}"
        )
    g = s.get("gang")
    if g:
        print(
            f"  gang: commits={g['gang_commits']} "
            f"bound_pods={g['gang_bound_pods']} "
            f"incomplete_rounds={g['gang_incomplete_rounds']} "
            f"partial_gangs={g['partial_gangs']} "
            f"quarantined_gangs={g['quarantined_gangs']}"
        )
    fd = s.get("fleet_drain")
    if fd:
        # the CI fleet-drain smoke greps leases_reassigned/lost/
        # double_bind off this line — keep the key=value shape
        print(
            f"  fleet_drain: pods={fd['pods']} "
            f"partitions={fd['partitions']} "
            f"residual={fd['residual']} drained={fd['drained']} "
            f"leases={fd['leases']} "
            f"leases_reassigned={fd['leases_reassigned']} "
            f"lost={fd['lost']} double_bind={fd['double_bind']}"
        )
    for rid in sorted(res.journal_digests):
        print(f"  journal[{rid}]={res.journal_digests[rid]}")
    print(
        f"  hub_journal: lines={s.get('hub_journal_lines', 0)} "
        f"digest={s.get('hub_journal_digest', '')[:16]}"
    )
    for path in sorted(res.flight_dumps):
        print(
            f"  flight recorder dumped [{res.flight_dumps[path]}]: {path}"
        )
    if res.violations:
        print(f"  {len(res.violations)} INVARIANT VIOLATION(S):")
        for v in res.violations[:20]:
            print(f"    [{v.invariant}] cycle {v.cycle}: {v.detail}")
    else:
        print("  invariants: OK")


def _run_fleet(args) -> int:
    from .fleet import run_fleet_sim

    pipelined = streaming = None
    if args.dispatcher is not None:
        pipelined = args.dispatcher == "pipelined"
        streaming = args.dispatcher == "streaming"
    try:
        res = run_fleet_sim(
            args.profile, seed=args.seed, cycles=args.cycles,
            replicas=args.fleet, pipelined=pipelined,
            streaming=streaming, grpc_hub=args.hub_grpc,
            flight_dump=args.flight_dump, device=args.device,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    _print_fleet_result(res)
    if args.journal:
        from pathlib import Path

        # the hub's aggregated journal (every replica's shipped
        # segments, one file) — the `obs explain --fleet` source
        Path(args.journal).write_text(
            "\n".join(res.hub_journal_lines) + "\n"
            if res.hub_journal_lines
            else ""
        )
        print(
            f"  hub journal written: {args.journal} "
            f"({len(res.hub_journal_lines)} lines)"
        )
        for rid, lines in sorted(res.journals.items()):
            path = f"{args.journal}.{rid}"
            Path(path).write_text("\n".join(lines) + "\n")
            print(f"  journal written: {path}")
    if args.selfcheck:
        res2 = run_fleet_sim(
            args.profile, seed=args.seed, cycles=args.cycles,
            replicas=args.fleet, pipelined=pipelined,
            streaming=streaming, grpc_hub=args.hub_grpc,
            device=args.device,
        )
        if res.journal_digests != res2.journal_digests:
            print(
                "NON-DETERMINISTIC: per-replica journal digests differ "
                f"({res.journal_digests} vs {res2.journal_digests})",
                file=sys.stderr,
            )
            return 1
        if res.hub_journal_lines != res2.hub_journal_lines:
            print(
                "NON-DETERMINISTIC: hub-aggregated journals differ "
                f"({len(res.hub_journal_lines)} vs "
                f"{len(res2.hub_journal_lines)} lines)",
                file=sys.stderr,
            )
            return 1
        if res.bindings != res2.bindings:
            print(
                "NON-DETERMINISTIC: final bindings differ",
                file=sys.stderr,
            )
            return 1
        print(
            "  selfcheck: two runs produced byte-identical per-replica "
            "journals (and hub aggregation)"
        )
    return 0 if res.ok else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch.sim",
        description="Deterministic cluster simulator + fault injection.",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cycles", type=int, default=10)
    parser.add_argument(
        "--profile", default="churn_heavy",
        help="scenario profile (see kubernetes_tpu/sim/README.md); "
        "--list-profiles",
    )
    parser.add_argument(
        "--sync", action="store_true",
        help="drive run_until_settled instead of the profile's default",
    )
    parser.add_argument(
        "--dispatcher", choices=("sync", "pipelined", "streaming"),
        default=None,
        help="override the profile's dispatch loop: sync "
        "(schedule_batch), pipelined (run_pipelined), streaming "
        "(run_streaming — the device-resident solve loop)",
    )
    parser.add_argument(
        "--trace", metavar="PATH", help="write the replayable trace here"
    )
    parser.add_argument(
        "--replay", metavar="PATH",
        help="re-execute a recorded trace instead of a fresh run",
    )
    parser.add_argument(
        "--journal", metavar="PATH",
        help="write the per-pod decision journal (kubernetes_tpu_torch/obs "
        "JSONL; explain pods with `python -m kubernetes_tpu_torch.obs "
        "explain <pod> --trace PATH`)",
    )
    parser.add_argument(
        "--flight-dump", metavar="PATH",
        help="dump the flight recorder here when an invariant fires",
    )
    parser.add_argument(
        "--bundle-dir", metavar="DIR",
        help="telemetry profiles (e.g. anomaly_storm): write capture-"
        "on-anomaly replay bundles into this directory; the telemetry "
        "invariant replays each one and asserts bit-identical "
        "assignments (`python -m kubernetes_tpu_torch.obs replay <bundle>` "
        "does the same offline)",
    )
    parser.add_argument(
        "--tuning", action="store_true",
        help="enable the closed-loop auto-tuning runtime "
        "(kubernetes_tpu_torch/tuning) on any profile: hill-climb "
        "controllers over stream_depth / pipeline_split / drain "
        "chunk with sim-sized evaluation windows; the footer's "
        "tuning line and the tuning invariant report convergence",
    )
    parser.add_argument(
        "--tuned-profile", metavar="PATH",
        help="after a --tuning run, write the converged knob values "
        "as a standard KubeSchedulerConfiguration YAML (tuned config "
        "in, standard config out)",
    )
    parser.add_argument(
        "--mesh-devices", type=int, default=1, metavar="N",
        help="SchedulerConfig.mesh_devices (the node-axis solve mesh); "
        "N > 1 makes N entries of the solve's device visible first and "
        "shards over them",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device to solve on (default: the card; 'cpu' runs "
        "on the CPU)",
    )
    parser.add_argument(
        "--selfcheck", action="store_true",
        help="run twice and verify the traces are byte-identical",
    )
    parser.add_argument(
        "--fleet", type=int, default=0, metavar="N",
        help="drive N active scheduler replicas sharding the cluster "
        "(sim/fleet.py): shard-filtered watches, occupancy exchange, "
        "no-global-overcommit + fleet journal invariants. 0 = the "
        "single-scheduler drive; use with the fleet_mixed / "
        "replica_loss profiles. --selfcheck byte-compares per-replica "
        "journal digests across two runs.",
    )
    parser.add_argument(
        "--hub-grpc", action="store_true",
        help="fleet drives only: serve the occupancy hub behind a "
        "localhost bulk gRPC server (real wire framing, typed "
        "CAS-conflict status mapping) instead of the shared in-process "
        "object — the cross-process deployment shape on one box",
    )
    parser.add_argument("--list-profiles", action="store_true")
    args = parser.parse_args(argv)

    if args.list_profiles:
        from .profiles import PROFILES

        for name in sorted(PROFILES):
            p = PROFILES[name]
            line = f"{name}: pipelined={p.pipelined} nodes={p.nodes}"
            if p.gang_rate > 0 or p.gang_short_at >= 0:
                # gang profiles carry the pod-group workload knobs
                # (kubernetes_tpu_torch/gang): surface them so the listing
                # says WHICH profiles drive the gang gate and how
                line += (
                    f" gang_rate={p.gang_rate}"
                    f" gang_sizes={p.gang_sizes}"
                    f" gang_short_at={p.gang_short_at}"
                    f" accel_classes={len(p.gang_accel_classes)}"
                )
            print(line)
        return 0

    restore = _configure_mesh(args.mesh_devices, args.device)
    try:
        return _drive(args)
    finally:
        restore()


def _drive(args) -> int:
    if args.fleet:
        if args.tuning:
            # the multi-scheduler drive builds its own replica configs;
            # silently dropping the flag would misread as "tuned fleet"
            print(
                "error: --tuning is not supported on fleet drives "
                "(the fleet_flush knob is unit-tested; per-replica "
                "tuning is future work)",
                file=sys.stderr,
            )
            return 2
        return _run_fleet(args)
    from .harness import replay_trace, run_sim
    from .trace import TraceError

    if args.replay:
        try:
            res = replay_trace(args.replay, device=args.device)
        except TraceError as e:
            print(f"replay failed: {e}", file=sys.stderr)
            return 1
        _print_result(res)
        return 0 if res.ok else 1

    # --sync must override BOTH profile defaults: a streaming profile
    # (sustained_stream) would otherwise still drive run_streaming
    pipelined = False if args.sync else None
    streaming = False if args.sync else None
    if args.dispatcher is not None:
        pipelined = args.dispatcher == "pipelined"
        streaming = args.dispatcher == "streaming"
    tuning = True if args.tuning else None
    try:
        res = run_sim(
            args.profile, seed=args.seed, cycles=args.cycles,
            pipelined=pipelined, streaming=streaming,
            flight_dump=args.flight_dump,
            mesh_devices=args.mesh_devices,
            tuning=tuning,
            bundle_dir=args.bundle_dir,
            device=args.device,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    _print_result(res)
    if args.tuned_profile and res.tuned_profile is not None:
        from pathlib import Path

        from ..tuning.profile import dump_yaml

        Path(args.tuned_profile).write_text(
            dump_yaml(res.tuned_profile)
        )
        print(f"  tuned profile written: {args.tuned_profile}")
    if args.trace:
        res.trace.dump(args.trace)
        print(f"  trace written: {args.trace}")
    if args.journal:
        from pathlib import Path

        Path(args.journal).write_text(
            "\n".join(res.journal_lines) + "\n"
        )
        print(f"  journal written: {args.journal}")
    if args.selfcheck:
        res2 = run_sim(
            args.profile, seed=args.seed, cycles=args.cycles,
            pipelined=pipelined, streaming=streaming,
            mesh_devices=args.mesh_devices,
            tuning=tuning,
            device=args.device,
        )
        if res.journal_lines != res2.journal_lines:
            print(
                "NON-DETERMINISTIC: decision journals differ "
                f"({len(res.journal_lines)} vs {len(res2.journal_lines)} "
                "records)",
                file=sys.stderr,
            )
            return 1
        if res.trace.lines != res2.trace.lines:
            for i, (a, b) in enumerate(
                zip(res.trace.lines, res2.trace.lines)
            ):
                if a != b:
                    print(
                        f"NON-DETERMINISTIC at trace line {i + 1}:\n"
                        f"  run1: {a}\n  run2: {b}",
                        file=sys.stderr,
                    )
                    break
            else:
                print(
                    "NON-DETERMINISTIC: trace lengths differ "
                    f"({len(res.trace.lines)} vs {len(res2.trace.lines)})",
                    file=sys.stderr,
                )
            return 1
        print("  selfcheck: two runs produced byte-identical traces")
    return 0 if res.ok else 1


if __name__ == "__main__":
    sys.exit(main())
