"""CLI: the metrics reference rendered from the port's registry.

    # drift gate: exit 1 when docs/METRICS.md no longer matches the
    # port's registry
    python -m kubernetes_tpu_torch.metrics --check

    # print the reference rendered from the registry
    python -m kubernetes_tpu_torch.metrics --stdout

Copied from ``kubernetes_tpu/metrics/__main__.py``. The rows read the
port's registry (``kubernetes_tpu_torch/metrics/__init__.py``, whose
classes are ``metrics/prom.py``'s) instead of ``prometheus_client``. The
port exports the JAX package's series, so ``--check`` holds them
against the JAX package's ``docs/METRICS.md``, header included, and
never writes that file: the JAX package's ``--doc`` has no counterpart
here. The port's own series (``metrics.PORT_SERIES``) are held against
``kubernetes_tpu_torch/metrics/METRICS.md``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

# the JAX package's header, byte for byte: --check compares the whole
# file
HEADER = """\
# Metrics reference

Auto-generated from the registered series in
`kubernetes_tpu/metrics/__init__.py` (the MET001 registry) by
`python -m kubernetes_tpu.metrics --doc`. Do not edit by hand —
regenerate after adding or changing a series;
`tests/test_metrics_doc.py` asserts this file matches the registry.

| name | type | labels | help |
|---|---|---|---|
"""
PORT_HEADER = """\
# The port's own metrics

Series of `kubernetes_tpu_torch/metrics/__init__.py` (`PORT_SERIES`)
that the JAX package's `docs/METRICS.md` does not list. Rendered by
`python -m kubernetes_tpu_torch.metrics --stdout`; `--check` holds this
file to the registry.

| name | type | labels | help |
|---|---|---|---|
"""


def _rows(port: bool = False) -> list[tuple[str, str, str, str]]:
    """(series name, type, labels, help) per registered metric, sorted
    by series name: the JAX package's series, or with ``port`` the
    port's own. Reads the live module objects, not the AST, so the
    doc reflects exactly what ``metrics.render()`` exposes."""
    from .. import metrics as m
    from .prom import Counter, Gauge, Histogram

    kinds = {
        Counter: "counter",
        Gauge: "gauge",
        Histogram: "histogram",
    }
    rows = []
    for attr in dir(m):
        obj = getattr(m, attr)
        kind = kinds.get(type(obj))
        if kind is None or any(obj is p for p in m.PORT_SERIES) != port:
            continue
        name = obj._name
        if kind == "counter" and not name.endswith("_total"):
            # the registry strips the _total suffix internally (as
            # prometheus_client does); restore the exposition name
            exposed = name + "_total"
        else:
            exposed = name
        labels = ", ".join(obj._labelnames) if obj._labelnames else "-"
        help_text = " ".join(obj._documentation.split())
        rows.append((exposed, kind, labels, help_text))
    rows.sort()
    return rows


def render_doc(port: bool = False) -> str:
    lines = [(PORT_HEADER if port else HEADER).rstrip("\n")]
    for name, kind, labels, help_text in _rows(port):
        help_md = help_text.replace("|", "\\|")
        lines.append(f"| `{name}` | {kind} | {labels} | {help_md} |")
    return "\n".join(lines) + "\n"


def doc_path() -> Path:
    return (
        Path(__file__).resolve().parents[2] / "docs" / "METRICS.md"
    )


def port_doc_path() -> Path:
    return Path(__file__).resolve().parent / "METRICS.md"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch.metrics",
        description="Metrics registry tools (drift gate, rendered doc).",
    )
    parser.add_argument(
        "--check", action="store_true",
        help="exit 1 when docs/METRICS.md no longer matches the registry",
    )
    parser.add_argument(
        "--stdout", action="store_true",
        help="print the reference rendered from the registry",
    )
    args = parser.parse_args(argv)
    docs = ((doc_path(), render_doc()), (port_doc_path(), render_doc(port=True)))
    if args.stdout:
        sys.stdout.write("\n".join(doc for _, doc in docs))
        return 0
    if args.check:
        rc = 0
        for path, doc in docs:
            committed = path.read_text() if path.exists() else ""
            if committed != doc:
                print(
                    f"{path}: differs from the port's registry — the port "
                    "lacks or changed a series (`python -m "
                    "kubernetes_tpu_torch.metrics --stdout` shows its rows)",
                    file=sys.stderr,
                )
                rc = 1
            else:
                print(f"{path}: matches the registry")
        return rc
    parser.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
