"""Capture-on-anomaly replay bundles: the production forensic loop.

When the sentinel fires (or the breaker trips, a gang quarantines, a
sim invariant fires, or an operator hits ``/debug/profile?capture=1``),
snapshot the most recent batch's **full solve input** — the tensorized
containers exactly as ``ExactSolver.solve`` received them, the solver
config fingerprint, the PRNG step counter, a carry-state tag — plus
the flight-recorder slice, the journal tail, and a metrics snapshot,
into one self-contained directory. ``replay_bundle(<bundle>)`` then
re-executes the solve offline and asserts bit-identical assignments: the
sim's deterministic-repro story, extended to a serving process.

Capture path (driver thread, always-on safe):

- the scheduler **arms** the capturer immediately before each device
  dispatch (``_dispatch_group``);
- the solver's ``capture_hook`` hands over the resolved inputs at the
  top of ``solve()`` (pre-PRNG-increment, so ``step_count`` is exactly
  what the replayed solve must use); arrays are copied host-side — a
  few hundred KB per batch, no device sync;
- ``note_assignments`` attaches each flight's assignment slice as it
  is read; a record whose parts cover the batch moves into a small
  ring of complete records;
- ``capture(trigger)`` snapshots the newest complete record to disk.

Carry-state tag: a session solve is only **host-determined** (and so
bit-exactly replayable offline) when the session entered the solve
fully healed and not chained on device-resident carry —
``carry_clean = (not session) or (allow_heal and not
chain_occupancy)``. The sync loop's solves are always carry-clean;
pipelined overlap (``allow_heal=False``) and streaming cross-batch
chains are captured for forensics but marked non-replayable rather
than asserted falsely. Replay additionally requires ``split == 1``
(a split solve's sub-batch chain is session machinery; the carry-clean
capture class the CI proves end-to-end dispatches unsplit).

Copied from ``kubernetes_tpu/obs/bundle.py``. The containers resolve to
the port's classes, and ``replay_bundle`` re-runs the solve through the
port's ``ExactSolver`` on ``device`` (None = the card). The format is the
JAX package's, so a bundle either package captured loads in the other.
With ``tie_break="first"`` a replay is bit-identical across the two
packages; in random mode the JAX package draws from threefry and the port
from a torch generator, so a bundle replays bit for bit within the
package that captured it.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from collections import OrderedDict, deque
from pathlib import Path

import numpy as np

from .. import metrics

BUNDLE_VERSION = 1
TRIGGERS = ("sentinel", "breaker", "quarantine", "invariant", "manual")

# containers a solve payload may carry, in manifest order. Values are
# (module relative to this package's parent, class) resolved lazily so
# importing obs never pulls torch in.
_CONTAINERS = OrderedDict(
    nodes=("..tensorize.schema", "NodeBatch"),
    pods=("..tensorize.schema", "PodBatch"),
    static=("..tensorize.plugins", "StaticPluginTensors"),
    ports=("..tensorize.plugins", "PortTensors"),
    spread=("..tensorize.spread", "SpreadTensors"),
    interpod=("..tensorize.interpod", "InterpodTensors"),
    nominated=("..tensorize.schema", "NominatedTensors"),
)

# non-tensor fields that cannot (or need not) ride the wire: the
# static reps list holds live Pod objects the solve never reads
_SKIP_FIELDS = {("static", "reps")}

# solver-config fields nulled in the fingerprint: consumed by the
# tensorizer (their effect is already IN the captured tensors), and
# not JSON-serializable when set
_CONFIG_SKIP = ("added_affinity",)


def _scalarize(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    return v


def _encode_container(name: str, obj, arrays: dict) -> dict:
    """One container -> a JSON-ready field manifest + npz array refs."""
    from ..tensorize.schema import ResourceVocab

    out: dict = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if (name, f.name) in _SKIP_FIELDS:
            out[f.name] = {"skip": True}
        elif v is None:
            out[f.name] = {"none": True}
        elif isinstance(v, np.ndarray):
            key = f"{name}.{f.name}"
            arrays[key] = v
            out[f.name] = {"array": key}
        elif isinstance(v, ResourceVocab):
            out[f.name] = {"vocab": list(v.names)}
        elif isinstance(v, (list, tuple)) and any(
            isinstance(x, tuple) for x in v
        ):
            # e.g. PortTensors.vocab: list[tuple[str, str, int]] —
            # must round-trip to TUPLES (the solver digests its repr)
            out[f.name] = {"tuples": [list(x) for x in v]}
        elif isinstance(v, (list, tuple)):
            out[f.name] = {"list": [_scalarize(x) for x in v]}
        else:
            out[f.name] = {"scalar": _scalarize(v)}
    return out


def _decode_container(name: str, spec: dict, arrays) -> object:
    import importlib

    from ..tensorize.schema import ResourceVocab

    mod_name, cls_name = _CONTAINERS[name]
    cls = getattr(importlib.import_module(mod_name, __package__), cls_name)
    declared = {f.name for f in dataclasses.fields(cls)}
    if set(spec) != declared:
        raise ValueError(
            f"bundle container {name!r} fields {sorted(spec)} do not "
            f"match {cls_name} fields {sorted(declared)} — the bundle "
            "was captured by a different schema version"
        )
    kwargs = {}
    for fname, enc in spec.items():
        if "skip" in enc:
            kwargs[fname] = []
        elif "none" in enc:
            kwargs[fname] = None
        elif "array" in enc:
            kwargs[fname] = np.array(arrays[enc["array"]])
        elif "vocab" in enc:
            kwargs[fname] = ResourceVocab(tuple(enc["vocab"]))
        elif "tuples" in enc:
            kwargs[fname] = [tuple(x) for x in enc["tuples"]]
        elif "list" in enc:
            kwargs[fname] = list(enc["list"])
        else:
            kwargs[fname] = enc["scalar"]
    return cls(**kwargs)


class BundleCapturer:
    """Bounded ring of complete solve records + the disk writer.

    ``out_dir=None`` keeps the ring in memory only (captures still
    count — the sim's determinism selfcheck re-runs without a dir and
    must see identical counts)."""

    def __init__(
        self, out_dir: str | None = None, *, keep: int = 4,
        max_bundles: int = 8,
    ) -> None:
        self.out_dir = out_dir
        self.max_bundles = max_bundles
        self._ring: deque[dict] = deque(maxlen=keep)
        self._pending: OrderedDict[int, dict] = OrderedDict()
        self._armed_step: int | None = None
        self._lock = threading.Lock()
        self._seq = 0
        self.captures = 0  # capture events that found a complete record
        self.missed = 0  # triggers with nothing complete to snapshot
        self.counts: dict[str, int] = {}
        self.written: list[str] = []

    # -- driver-thread capture seams --

    def arm(self, step: int, profile: str = "") -> None:
        """Scheduler-side: the next ``capture_hook`` payload belongs to
        this batch step."""
        with self._lock:
            self._pending[step] = {
                "step": step, "profile": profile, "payload": None,
                "parts": [],
            }
            self._armed_step = step
            while len(self._pending) > 8:
                self._pending.popitem(last=False)

    def on_solve_input(self, **payload) -> None:
        """Installed as ``ExactSolver.capture_hook``: the resolved solve
        inputs, copied host-side. Ignored unless armed (host-tier and
        out-of-scheduler solves don't capture)."""
        with self._lock:
            step = self._armed_step
            rec = self._pending.get(step) if step is not None else None
            if rec is None:
                return
            self._armed_step = None
        containers = {}
        for cname in _CONTAINERS:
            obj = payload.get(cname)
            if obj is None:
                containers[cname] = None
                continue
            copied = {}
            for f in dataclasses.fields(obj):
                v = getattr(obj, f.name)
                copied[f.name] = (
                    np.array(v) if isinstance(v, np.ndarray) else v
                )
            containers[cname] = dataclasses.replace(obj, **{
                k: v for k, v in copied.items()
                if isinstance(v, np.ndarray)
            })
        ns = payload.get("nominated_slot")
        session = payload.get("session", False)
        allow_heal = payload.get("allow_heal", True)
        chain = payload.get("chain_occupancy", False)
        rec["payload"] = {
            "containers": containers,
            "nominated_slot": None if ns is None else np.array(ns),
            "step_count": int(payload.get("step_count", 0)),
            "split": int(payload.get("split", 1)),
            "defer_read": bool(payload.get("defer_read", False)),
            "session": bool(session),
            "allow_heal": bool(allow_heal),
            "chain_occupancy": bool(chain),
            "carry_clean": (not session) or (allow_heal and not chain),
            "num_pods": int(payload["pods"].num_pods),
            "config": payload.get("config"),
        }

    def note_assignments(self, step: int, lo: int, assignments) -> None:
        """A flight of this step was read: attach its assignment slice.
        The record completes when the parts cover the batch's pods."""
        with self._lock:
            rec = self._pending.get(step)
            if rec is None or rec["payload"] is None:
                return
            arr = np.asarray(assignments).astype(np.int64).tolist()
            rec["parts"].append({"lo": int(lo), "assignments": arr})
            covered = sum(len(p["assignments"]) for p in rec["parts"])
            if covered >= rec["payload"]["num_pods"]:
                del self._pending[step]
                self._ring.append(rec)

    def drop(self, step: int) -> None:
        """The step's flights were discarded (fence) — its capture
        record dies with them."""
        with self._lock:
            self._pending.pop(step, None)
            if self._armed_step == step:
                self._armed_step = None

    # -- the trigger --

    def capture(
        self, trigger: str, *, note: str = "", journal_tail=(),
        flight_lines=(), metrics_text: bytes = b"",
    ) -> str | None:
        """Snapshot the newest complete record. Returns the bundle
        directory path (None when nothing is complete, the bundle
        budget is spent, or no ``out_dir`` is configured)."""
        with self._lock:
            rec = self._ring[-1] if self._ring else None
            if rec is None:
                self.missed += 1
                return None
            self.captures += 1
            self.counts[trigger] = self.counts.get(trigger, 0) + 1
            seq = self._seq
            self._seq += 1
        metrics.telemetry_bundles_total.labels(
            trigger if trigger in TRIGGERS else "manual"
        ).inc()
        if self.out_dir is None or seq >= self.max_bundles:
            return None
        return self._write(rec, trigger, seq, note, journal_tail,
                           flight_lines, metrics_text)

    def _write(self, rec, trigger, seq, note, journal_tail,
               flight_lines, metrics_text) -> str:
        p = rec["payload"]
        out = Path(self.out_dir) / f"bundle-{seq:05d}-{trigger}"
        out.mkdir(parents=True, exist_ok=True)
        arrays: dict = {}
        containers = {}
        for cname, obj in p["containers"].items():
            containers[cname] = (
                None if obj is None
                else _encode_container(cname, obj, arrays)
            )
        if p["nominated_slot"] is not None:
            arrays["nominated_slot"] = p["nominated_slot"]
        manifest = {
            "version": BUNDLE_VERSION,
            "trigger": trigger,
            "note": note,
            "step": rec["step"],
            "profile": rec["profile"],
            "step_count": p["step_count"],
            "split": p["split"],
            "defer_read": p["defer_read"],
            "session": p["session"],
            "allow_heal": p["allow_heal"],
            "chain_occupancy": p["chain_occupancy"],
            "carry_clean": p["carry_clean"],
            "num_pods": p["num_pods"],
            "config": p["config"],
            "config_skipped": list(_CONFIG_SKIP),
            "containers": containers,
            "parts": rec["parts"],
        }
        (out / "manifest.json").write_text(
            json.dumps(manifest, indent=1, sort_keys=True)
        )
        with (out / "solve_input.npz").open("wb") as fh:
            np.savez_compressed(fh, **arrays)
        (out / "journal_tail.jsonl").write_text(
            "\n".join(journal_tail) + ("\n" if journal_tail else "")
        )
        (out / "flight.jsonl").write_text(
            "\n".join(flight_lines) + ("\n" if flight_lines else "")
        )
        (out / "metrics.prom").write_bytes(metrics_text)
        self.written.append(str(out))
        return str(out)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "captures": self.captures,
                "missed": self.missed,
                "by_trigger": dict(sorted(self.counts.items())),
                "written": list(self.written),
                "ring_complete": len(self._ring),
                "pending": len(self._pending),
            }


def config_fingerprint(cfg) -> dict:
    """JSON-safe ExactSolverConfig snapshot (tensorizer-only fields
    nulled — their effect is already in the captured tensors)."""
    d = dataclasses.asdict(cfg)
    for k in _CONFIG_SKIP:
        d[k] = None
    return json.loads(json.dumps(d, default=str))


def _rebuild_config(d: dict):
    from ..solver.exact import ExactSolverConfig

    kwargs = dict(d)
    kwargs["rtc_shape"] = tuple(tuple(x) for x in kwargs.get("rtc_shape", ()))
    kwargs["disabled_filters"] = tuple(kwargs.get("disabled_filters", ()))
    declared = {f.name for f in dataclasses.fields(ExactSolverConfig)}
    kwargs = {k: v for k, v in kwargs.items() if k in declared}
    return ExactSolverConfig(**kwargs)


def load_bundle(path: str) -> dict:
    """Manifest + decoded containers of one bundle directory."""
    p = Path(path)
    manifest = json.loads((p / "manifest.json").read_text())
    if manifest.get("version") != BUNDLE_VERSION:
        raise ValueError(
            f"bundle version {manifest.get('version')} != {BUNDLE_VERSION}"
        )
    arrays = np.load(p / "solve_input.npz")
    containers = {}
    for cname, spec in manifest["containers"].items():
        containers[cname] = (
            None if spec is None else _decode_container(cname, spec, arrays)
        )
    nominated_slot = (
        np.array(arrays["nominated_slot"])
        if "nominated_slot" in arrays
        else None
    )
    return {
        "manifest": manifest,
        "containers": containers,
        "nominated_slot": nominated_slot,
    }


def replay_bundle(path: str, device=None) -> dict:
    """Re-execute the captured solve offline, on ``device`` (None = the
    card), and compare assignments.

    Returns ``{"replayable", "ok", "detail", "pods", "parts"}`` —
    ``ok`` is only meaningful when ``replayable``: a non-carry-clean
    capture (pipelined overlap / streaming chain) is forensic data,
    not a replay contract."""
    bundle = load_bundle(path)
    m = bundle["manifest"]
    if not m["carry_clean"] or m["split"] != 1:
        return {
            "replayable": False, "ok": False, "pods": m["num_pods"],
            "parts": len(m["parts"]),
            "detail": (
                "not host-determined: "
                + ("device-resident carry (allow_heal=False or "
                   "chain_occupancy)" if not m["carry_clean"]
                   else f"split={m['split']} sub-batch chain")
            ),
        }
    from ..solver.exact import ExactSolver

    cfg = _rebuild_config(m["config"])
    solver = ExactSolver(cfg)
    solver._step_count = m["step_count"]
    c = bundle["containers"]
    # standalone mode (col_versions=None): a carry-clean session solve
    # is host-determined, and the standalone path runs the identical
    # scan over the identical arrays with the identical PRNG key —
    # bit-identical assignments (the sharding-equivalence discipline)
    assignments = solver.solve(
        c["nodes"], c["pods"], c["static"], c["ports"], c["spread"],
        c["interpod"], nominated=c["nominated"],
        nominated_slot=bundle["nominated_slot"],
        device=device,
    )
    replayed = np.asarray(assignments).astype(np.int64)
    mismatches = []
    for part in m["parts"]:
        lo = part["lo"]
        want = np.array(part["assignments"], dtype=np.int64)
        got = replayed[lo: lo + len(want)]
        if not np.array_equal(got, want):
            bad = int(np.count_nonzero(got != want))
            mismatches.append(f"[{lo}:{lo + len(want)}]: {bad} differ")
    detail = (
        "assignments bit-identical"
        if not mismatches
        else "assignment mismatch " + "; ".join(mismatches)
    )
    return {
        "replayable": True, "ok": not mismatches,
        "pods": m["num_pods"], "parts": len(m["parts"]),
        "detail": detail,
    }
