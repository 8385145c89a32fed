"""Feature gates — the component-base/featuregate analog (SURVEY §3.3:
[BOUNDARY] — a simple known-gate map with the reference's flag syntax).

Reference behavior mirrored (component-base/featuregate/feature_gate.go):
- gates parse from one ``--feature-gates`` string: "A=true,B=false";
- unknown gate names are an error (Set returns err upstream);
- each gate has a default; the map is queried, not scattered booleans.

Gates wired to real behavior in this framework:
- SchedulerQueueingHints (default on, upstream beta-on): when off, cluster
  events move every parked pod (the pre-hints reference behavior) instead
  of consulting the fit-gated isPodWorthRequeuing predicates.
- PodSchedulingReadiness (default on, upstream GA): when off,
  .spec.schedulingGates are ignored and gated pods enqueue normally
  (pre-1.26 behavior).
- DynamicResourceAllocation (default off, matching the upstream beta
  gate): when on, pods referencing ResourceClaims are filtered to nodes
  whose ResourceSlices satisfy the claims, devices are allocated at
  Reserve, and allocation + reservedFor are written at PreBind
  (api/dra.py, ops/oracle/dra.py, state/claim_allocator.py — scope and
  divergences documented there).

Copied from ``kubernetes_tpu/utils/featuregate.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

KNOWN_GATES: dict[str, bool] = {
    "SchedulerQueueingHints": True,
    "PodSchedulingReadiness": True,
    "DynamicResourceAllocation": False,
}


@dataclass
class FeatureGates:
    overrides: dict[str, bool] = field(default_factory=dict)
    warnings: list[str] = field(default_factory=list)

    def enabled(self, name: str) -> bool:
        if name not in KNOWN_GATES:
            raise KeyError(f"unknown feature gate {name!r}")
        return self.overrides.get(name, KNOWN_GATES[name])

    @staticmethod
    def parse(spec: str | None) -> "FeatureGates":
        """Parse "A=true,B=false" (the --feature-gates flag syntax).
        Unknown names raise ValueError, like the reference's Set()."""
        fg = FeatureGates()
        if not spec:
            return fg
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"feature gate {part!r}: expected name=bool"
                )
            name, _, val = part.partition("=")
            name = name.strip()
            if name not in KNOWN_GATES:
                raise ValueError(f"unknown feature gate {name!r}")
            lv = val.strip().lower()
            if lv not in ("true", "false"):
                raise ValueError(
                    f"feature gate {name}: invalid value {val!r}"
                )
            fg.overrides[name] = lv == "true"
        return fg
