"""Replay bundles: load a bundle captured by the JAX package's scheduler
and re-run its solve through the port.

A bundle is one self-contained directory: the most recent batch's full
solve input (the tensorized containers exactly as ``ExactSolver.solve``
received them), the solver config fingerprint, the PRNG step counter, a
carry-state tag, the assignments the captured solve made, and forensic
slices (flight recorder, journal tail, metrics). ``replay_bundle``
re-executes the solve offline and asserts bit-identical assignments.

A session solve is only host-determined (and so bit-exactly replayable
offline) when the session entered the solve fully healed and not chained
on device-resident carry: ``carry_clean = (not session) or (allow_heal
and not chain_occupancy)``. Replay also requires ``split == 1``; any
other capture is reported as not replayable rather than asserted falsely.

Copied from ``kubernetes_tpu/obs/bundle.py``, load and replay only. The
containers resolve to the port's classes, and ``replay_bundle`` re-runs
the solve through the port's ``ExactSolver`` on ``device`` (None = the
card). Capture (``BundleCapturer``) needs ``ExactSolver.capture_hook``,
which the port's solver does not have yet (ROADMAP queue 1 item 8): the
port's scheduler refuses telemetry bundles.
"""

from __future__ import annotations

import dataclasses
import json
from collections import OrderedDict
from pathlib import Path

import numpy as np

BUNDLE_VERSION = 1

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
