"""CLI: explain a pod's scheduling history / validate a trace file.

    # from a recorded journal or flight-recorder dump
    python -m kubernetes_tpu_torch.obs explain default/pod-3 --trace journal.jsonl
    python -m kubernetes_tpu_torch.obs explain <pod-uid> --trace dump.jsonl

    # from a live scheduler's flight recorder (serve --mode scheduler)
    python -m kubernetes_tpu_torch.obs explain pod-3 --url http://127.0.0.1:10259

    # cross-replica fleet history: merge several replicas' journals
    # (repeat --trace per file, point --trace at the hub's aggregated
    # journal, or pull it live with --hub) and order records by the
    # fleet merge/tie-break rules
    python -m kubernetes_tpu_torch.obs explain pod-3 --fleet \\
        --trace hub_journal.jsonl
    python -m kubernetes_tpu_torch.obs explain pod-3 --fleet \\
        --trace r0.jsonl --trace r1.jsonl
    python -m kubernetes_tpu_torch.obs explain pod-3 --fleet --hub 127.0.0.1:50051

    # schema-check a journal / dump (the CI obs smoke)
    python -m kubernetes_tpu_torch.obs validate journal.jsonl

    # live per-stage profile + anomaly sentinel (serve --telemetry)
    python -m kubernetes_tpu_torch.obs top --url http://127.0.0.1:10259

    # re-execute a capture-on-anomaly bundle, assert bit-identical
    # assignments (the CI telemetry smoke)
    python -m kubernetes_tpu_torch.obs replay /var/bundles/bundle-00000-sentinel

Exit status: 0 found/valid; 1 pod not found or schema errors; 2 usage.

Copied from ``kubernetes_tpu/obs/__main__.py``. ``replay`` takes
``--device`` (default: the card; ``cpu`` replays on the CPU).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _load_lines(args) -> list[str]:
    lines: list[str] = []
    for trace in args.trace or []:
        lines.extend(Path(trace).read_text().splitlines())
    if getattr(args, "hub", None):
        # the occupancy hub's append-only journal aggregation surface
        # (fleet/occupancy.py ship_journal): replicas piggyback bounded
        # journal segments on their write-behind flushes; one HubOp
        # read returns the merged lines
        from ..server.bulk import BulkClient

        client = BulkClient(args.hub, retries=0)
        try:
            lines.extend(client.hub_op("journal_lines")["lines"] or [])
        finally:
            client.close()
    if args.url:
        import json
        import urllib.request

        from .recorder import canonical

        url = args.url.rstrip("/") + "/debug/flightrecorder"
        with urllib.request.urlopen(url, timeout=10.0) as r:
            doc = json.loads(r.read().decode())
        lines.extend(
            [canonical(rec) for rec in doc.get("decisions") or []]
            + [canonical(sp) for sp in doc.get("spans") or []]
        )
    if not lines and not (args.trace or args.url or getattr(args, "hub", None)):
        raise SystemExit(
            "error: one of --trace, --url, or --hub is required"
        )
    return lines


def cmd_explain(args) -> int:
    from .explain import explain_pod, parse_stream

    decisions, spans = parse_stream(_load_lines(args))
    out = explain_pod(decisions, args.pod, spans=spans, fleet=args.fleet)
    print(out.render())
    return 0 if out.found else 1


def cmd_validate(args) -> int:
    from .journal import validate_lines

    lines = Path(args.trace).read_text().splitlines()
    errors = validate_lines(lines)
    for err in errors:
        print(f"{args.trace}: {err}", file=sys.stderr)
    n = sum(1 for ln in lines if ln.strip())
    if errors:
        print(f"{args.trace}: {len(errors)} schema error(s) in {n} record(s)")
        return 1
    print(f"{args.trace}: {n} record(s), schema OK")
    return 0


def cmd_top(args) -> int:
    from .profile import render_top

    import json

    if args.snapshot:
        doc = json.loads(Path(args.snapshot).read_text())
    else:
        import urllib.request

        url = args.url.rstrip("/") + "/debug/profile"
        if args.capture:
            url += "?capture=1"
        try:
            with urllib.request.urlopen(url, timeout=10.0) as r:
                doc = json.loads(r.read().decode())
        except OSError as e:
            print(f"error: {url}: {e}", file=sys.stderr)
            return 1
    if doc.get("error"):
        print(f"error: {doc['error']}", file=sys.stderr)
        return 1
    print(render_top(doc))
    return 0


def cmd_replay(args) -> int:
    """Re-execute a captured bundle's solve offline and compare
    against the recorded assignments. Exit 0 = bit-identical, 1 =
    diverged (the forensic artifact lies — a real bug), 3 = the solve
    was structurally non-replayable standalone (chained/split)."""
    from .bundle import replay_bundle

    try:
        rep = replay_bundle(args.bundle, device=args.device)
    except (OSError, ValueError, KeyError) as e:
        print(f"error: {args.bundle}: {e}", file=sys.stderr)
        return 1
    print(
        f"{args.bundle}: replayable={rep['replayable']} "
        f"pods={rep['pods']} parts={rep['parts']}"
    )
    print(f"  {rep['detail']}")
    if not rep["replayable"]:
        return 3
    return 0 if rep["ok"] else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch.obs",
        description="Scheduling-trace tools: explain pods, validate "
        "traces, watch the live stage profile, replay capture bundles.",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_explain = sub.add_parser(
        "explain", help="reconstruct one pod's scheduling history"
    )
    p_explain.add_argument(
        "pod", help="pod uid, ns/name key, or bare pod name"
    )
    p_explain.add_argument(
        "--trace", metavar="FILE", action="append",
        help="journal / flight-recorder JSONL to read (repeatable: "
        "--fleet merges several replicas' journals)",
    )
    p_explain.add_argument(
        "--url", metavar="URL",
        help="base URL of a live scheduler (reads /debug/flightrecorder)",
    )
    p_explain.add_argument(
        "--fleet", action="store_true",
        help="cross-replica mode: merge records from every input "
        "journal with the fleet merge/tie-break rules and render "
        "the handoff chain (replicas traversed, one journey trace)",
    )
    p_explain.add_argument(
        "--hub", metavar="HOST:PORT",
        help="bulk gRPC address of a fleet occupancy hub: read its "
        "aggregated journal surface (replicas ship bounded segments "
        "piggybacked on their write-behind flushes)",
    )
    p_explain.set_defaults(fn=cmd_explain)

    p_val = sub.add_parser(
        "validate", help="schema-check a journal / flight-recorder JSONL"
    )
    p_val.add_argument("trace", metavar="FILE")
    p_val.set_defaults(fn=cmd_validate)

    p_top = sub.add_parser(
        "top",
        help="render a live scheduler's per-stage profile + sentinel "
        "state (reads GET /debug/profile; serve --telemetry)",
    )
    p_top.add_argument(
        "--url", metavar="URL", default="http://127.0.0.1:10259",
        help="base URL of a live scheduler (default %(default)s)",
    )
    p_top.add_argument(
        "--snapshot", metavar="FILE",
        help="render a saved /debug/profile JSON document instead of "
        "fetching one (offline forensics)",
    )
    p_top.add_argument(
        "--capture", action="store_true",
        help="also trigger a manual replay-bundle capture (?capture=1)",
    )
    p_top.set_defaults(fn=cmd_top)

    p_replay = sub.add_parser(
        "replay",
        help="re-execute a capture-on-anomaly bundle offline and "
        "assert bit-identical assignments (exit 0 identical, 1 "
        "diverged, 3 not standalone-replayable)",
    )
    p_replay.add_argument(
        "bundle", metavar="DIR",
        help="bundle directory (bundle-NNNNN-<trigger>/)",
    )
    p_replay.add_argument(
        "--device", default=None,
        help="torch device to replay on (default: the card; 'cpu' "
        "replays on the CPU)",
    )
    p_replay.set_defaults(fn=cmd_replay)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
