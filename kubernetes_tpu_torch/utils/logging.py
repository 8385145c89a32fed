"""Structured logging for the scheduler and the extender server.

The reference component logs through klog with `--logging-format=json`
as the structured option (component-base/logs); this is the stdlib
analog: one ``setup()`` call configures the ``kubernetes_tpu_torch`` logger
tree with either a human ``text`` formatter or a ``json`` formatter
that emits one JSON object per line.

The JSON formatter carries **correlation ids**: any extra attributes a
log call passes (``extra={"step": 12, "pod": "ns/name"}``) serialize as
top-level fields — the scheduler passes its span/batch id (``step``,
the ``Scheduler._trace_step`` counter shared with obs spans and the
profiler step annotation) so log lines join against the span stream
and the decision journal on the same key.

No global side effects at import: ``setup()`` is called by ``cli.py
serve --log-format ...`` (and tests); library users who never call it
keep logging's default behavior (messages propagate to the root
logger / stay silent without handlers).

Copied from ``kubernetes_tpu/utils/logging.py``; the logger tree is the
port's own, ``kubernetes_tpu_torch``.
"""

from __future__ import annotations

import json
import logging
import sys

# LogRecord attributes that are plumbing, not payload — anything else
# found on a record came from ``extra=`` and is emitted as a field
_RESERVED = frozenset(
    {
        "name", "msg", "args", "levelname", "levelno", "pathname",
        "filename", "module", "exc_info", "exc_text", "stack_info",
        "lineno", "funcName", "created", "msecs", "relativeCreated",
        "thread", "threadName", "processName", "process", "taskName",
        "message", "asctime",
    }
)

ROOT_LOGGER = "kubernetes_tpu_torch"


class JsonLineFormatter(logging.Formatter):
    """One JSON object per line: ts, level, logger, msg, plus every
    ``extra=`` attribute (span/batch ids ride here)."""

    def format(self, record: logging.LogRecord) -> str:
        out: dict = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        for key, value in record.__dict__.items():
            if key in _RESERVED or key.startswith("_"):
                continue
            try:
                json.dumps(value)
            except (TypeError, ValueError):
                value = repr(value)
            out[key] = value
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, sort_keys=True, separators=(",", ":"))


class TextFormatter(logging.Formatter):
    """klog-ish single-line text with the extras appended as k=v."""

    def __init__(self) -> None:
        super().__init__("%(asctime)s %(levelname)s %(name)s: %(message)s")

    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        extras = " ".join(
            f"{k}={record.__dict__[k]!r}"
            for k in sorted(record.__dict__)
            if k not in _RESERVED and not k.startswith("_")
        )
        return f"{base} {extras}" if extras else base


def setup(
    log_format: str = "text",
    level: int = logging.INFO,
    stream=None,
    logger_name: str = ROOT_LOGGER,
) -> logging.Logger:
    """Configure the package logger tree. Idempotent: re-running
    replaces the previously-installed handler instead of stacking a
    duplicate (serve retries / tests)."""
    if log_format not in ("text", "json"):
        raise ValueError(f"unknown log format {log_format!r}")
    logger = logging.getLogger(logger_name)
    logger.setLevel(level)
    formatter: logging.Formatter = (
        JsonLineFormatter() if log_format == "json" else TextFormatter()
    )
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.set_name(f"{logger_name}.structured")
    handler.setFormatter(formatter)
    for h in list(logger.handlers):
        if h.get_name() == handler.get_name():
            logger.removeHandler(h)
    logger.addHandler(handler)
    logger.propagate = False
    return logger
