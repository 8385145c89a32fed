"""Dynamic Resource Allocation API objects (resource.k8s.io subset).

The reference's dynamicresources plugin
(pkg/scheduler/framework/plugins/dynamicresources/ [U], the structured-
parameters model of resource.k8s.io/v1beta1) schedules pods that reference
ResourceClaims: drivers publish per-node device inventories as
ResourceSlices, DeviceClasses name a category of devices, and a claim asks
for a count of devices of a class. The scheduler allocates concrete
devices to claims during scheduling (PreFilter/Filter candidate nodes,
Reserve assumes the allocation, PreBind writes it) and records which pods
reserve the claim.

[BOUNDARY] depth, documented divergences from the upstream wire:
- DeviceClass selectors: upstream selects devices with CEL expressions
  (``spec.selectors[].cel.expression``); this implementation supports the
  structural equivalent — an optional ``driver`` name plus exact-match
  ``matchAttributes`` — and records any CEL expression it cannot
  interpret as an opaque mismatch (the class then matches no devices,
  the conservative direction). CEL evaluation is out of scope.
- Device capacity/consumable-counter models and partitionable devices
  are out of scope: a device is allocated whole, to one claim.
- ``allocationMode: All`` and management-access requests are parsed and
  rejected at admission with a clear error rather than half-supported.

Copied from ``kubernetes_tpu/api/dra.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping


@dataclass
class Device:
    """One device row of a ResourceSlice (resource.k8s.io Device, basic
    shape: name + flat string attributes)."""

    name: str
    attributes: dict[str, str] = field(default_factory=dict)

    @staticmethod
    def from_dict(d: Mapping) -> "Device":
        attrs: dict[str, str] = {}
        # upstream: attributes: {key: {"string": .., "int": .., "bool": ..,
        # "version": ..}} under .basic; accept both that and a flat map
        basic = d.get("basic") or d
        for k, v in (basic.get("attributes") or {}).items():
            if isinstance(v, Mapping):
                for typ in ("string", "int", "bool", "version"):
                    if typ in v:
                        attrs[k] = str(v[typ]).lower() if typ == "bool" else str(v[typ])
                        break
            else:
                # flat form must normalize bools the same way the typed
                # form does (str(True) is "True", not "true")
                attrs[k] = str(v).lower() if isinstance(v, bool) else str(v)
        return Device(name=d.get("name") or "", attributes=attrs)

    def to_dict(self) -> dict:
        out: dict[str, Any] = {"name": self.name}
        if self.attributes:
            out["basic"] = {
                "attributes": {k: {"string": v} for k, v in self.attributes.items()}
            }
        return out


@dataclass
class ResourceSlice:
    """resource.k8s.io ResourceSlice: one driver's device inventory on one
    node (spec.nodeName + spec.driver + spec.devices)."""

    name: str
    node_name: str = ""
    driver: str = ""
    pool: str = ""
    devices: tuple[Device, ...] = ()
    resource_version: int = 0

    @property
    def key(self) -> str:
        return self.name

    @staticmethod
    def from_dict(d: Mapping) -> "ResourceSlice":
        meta = d.get("metadata") or {}
        spec = d.get("spec") or {}
        return ResourceSlice(
            name=meta.get("name") or "",
            node_name=spec.get("nodeName") or "",
            driver=spec.get("driver") or "",
            pool=(spec.get("pool") or {}).get("name") or "",
            devices=tuple(
                Device.from_dict(x) for x in spec.get("devices") or ()
            ),
            resource_version=int(meta.get("resourceVersion") or 0),
        )

    def to_dict(self) -> dict:
        spec: dict[str, Any] = {
            "nodeName": self.node_name,
            "driver": self.driver,
            "devices": [dv.to_dict() for dv in self.devices],
        }
        if self.pool:
            spec["pool"] = {"name": self.pool}
        return {
            "apiVersion": "resource.k8s.io/v1beta1",
            "kind": "ResourceSlice",
            "metadata": {"name": self.name},
            "spec": spec,
        }


@dataclass
class DeviceClass:
    """resource.k8s.io DeviceClass: a named device category. Selector
    support is structural (driver + exact attribute matches) — see the
    module docstring's CEL divergence note."""

    name: str
    driver: str = ""  # "" = any driver
    match_attributes: dict[str, str] = field(default_factory=dict)
    # a CEL expression we could not interpret: the class matches nothing
    opaque_selector: str = ""
    resource_version: int = 0

    @property
    def key(self) -> str:
        return self.name

    def matches(self, driver: str, device: Device) -> bool:
        if self.opaque_selector:
            return False
        if self.driver and driver != self.driver:
            return False
        for k, v in self.match_attributes.items():
            # device attributes are normalized strings (bools lowercase);
            # normalize the wanted value the same way so a YAML bool in
            # matchAttributes compares equal
            want = str(v).lower() if isinstance(v, bool) else str(v)
            if device.attributes.get(k) != want:
                return False
        return True

    @staticmethod
    def from_dict(d: Mapping) -> "DeviceClass":
        meta = d.get("metadata") or {}
        spec = d.get("spec") or {}
        driver = spec.get("driver") or ""
        match: dict[str, str] = dict(spec.get("matchAttributes") or {})
        opaque = ""
        for sel in spec.get("selectors") or ():
            cel = (sel.get("cel") or {}).get("expression") or ""
            if not cel:
                continue
            parsed = _parse_simple_cel(cel)
            if parsed is None:
                opaque = cel  # uninterpretable: match nothing (conservative)
            else:
                kind, key, val = parsed
                if kind == "driver":
                    if driver and driver != val:
                        # contradictory conjunction: matches nothing —
                        # keep the original driver so the opaque state
                        # round-trips through to_dict/from_dict
                        opaque = cel
                    else:
                        driver = val
                elif key in match and match[key] != val:
                    # two selectors pinning one attribute to different
                    # values is an unsatisfiable AND, not last-wins
                    opaque = cel
                else:
                    match[key] = val
        return DeviceClass(
            name=meta.get("name") or "",
            driver=driver,
            match_attributes=match,
            opaque_selector=opaque,
            resource_version=int(meta.get("resourceVersion") or 0),
        )

    def to_dict(self) -> dict:
        spec: dict[str, Any] = {}
        if self.driver:
            spec["driver"] = self.driver
        if self.match_attributes:
            spec["matchAttributes"] = dict(self.match_attributes)
        if self.opaque_selector:
            spec["selectors"] = [{"cel": {"expression": self.opaque_selector}}]
        return {
            "apiVersion": "resource.k8s.io/v1beta1",
            "kind": "DeviceClass",
            "metadata": {"name": self.name},
            "spec": spec,
        }


def _parse_simple_cel(expr: str):
    """Interpret the two ubiquitous CEL selector shapes:
    ``device.driver == "x"`` and ``device.attributes["k"] == "v"``
    (whitespace-insensitive). Returns ("driver", None, value) or
    ("attr", key, value), or None when the expression is anything else.
    """
    import re

    e = expr.strip()
    m = re.fullmatch(r'device\.driver\s*==\s*"([^"]*)"', e)
    if m:
        return ("driver", None, m.group(1))
    m = re.fullmatch(
        r'device\.attributes\[\s*"([^"]*)"\s*\]\s*==\s*"([^"]*)"', e
    )
    if m:
        return ("attr", m.group(1), m.group(2))
    return None


@dataclass
class DeviceRequest:
    """One entry of claim.spec.devices.requests: count devices of a
    class."""

    name: str
    device_class_name: str
    count: int = 1

    @staticmethod
    def from_dict(d: Mapping) -> "DeviceRequest":
        mode = d.get("allocationMode") or "ExactCount"
        if mode != "ExactCount":
            raise ValueError(
                f"deviceRequest {d.get('name')!r}: allocationMode {mode!r} "
                "is out of scope (only ExactCount is supported)"
            )
        if d.get("adminAccess"):
            raise ValueError(
                f"deviceRequest {d.get('name')!r}: adminAccess is out of scope"
            )
        raw = d.get("count")
        count = 1 if raw is None else int(raw)
        if count < 1:
            raise ValueError(
                f"deviceRequest {d.get('name')!r}: count must be >= 1, "
                f"got {count}"
            )
        return DeviceRequest(
            name=d.get("name") or "",
            device_class_name=d.get("deviceClassName") or "",
            count=count,
        )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "deviceClassName": self.device_class_name,
            "allocationMode": "ExactCount",
            "count": self.count,
        }


@dataclass
class DeviceResult:
    """One allocated device in claim.status.allocation. Identity is
    (driver, pool, device) — per-pool device names routinely repeat."""

    request: str
    driver: str
    device: str
    pool: str = ""

    @staticmethod
    def from_dict(d: Mapping) -> "DeviceResult":
        return DeviceResult(
            request=d.get("request") or "",
            driver=d.get("driver") or "",
            device=d.get("device") or "",
            pool=d.get("pool") or "",
        )

    def to_dict(self) -> dict:
        return {
            "request": self.request,
            "driver": self.driver,
            "device": self.device,
            "pool": self.pool,
        }


@dataclass
class ResourceClaim:
    """resource.k8s.io ResourceClaim: device requests + (status) the
    allocation and the pods reserving it."""

    name: str
    namespace: str = "default"
    requests: tuple[DeviceRequest, ...] = ()
    # status.allocation (node_name "" = unallocated)
    allocated_node: str = ""
    results: tuple[DeviceResult, ...] = ()
    # status.reservedFor pod keys (ns/name)
    reserved_for: tuple[str, ...] = ()
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    @property
    def allocated(self) -> bool:
        return bool(self.allocated_node)

    @staticmethod
    def from_dict(d: Mapping) -> "ResourceClaim":
        meta = d.get("metadata") or {}
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        alloc = status.get("allocation") or {}
        node = ""
        # upstream records the chosen node as a nodeSelector with one term;
        # accept both that and a plain nodeName
        node = alloc.get("nodeName") or ""
        if not node:
            for term in (
                (alloc.get("nodeSelector") or {}).get("nodeSelectorTerms")
                or ()
            ):
                for f in term.get("matchFields") or ():
                    if f.get("key") == "metadata.name" and f.get("values"):
                        node = f["values"][0]
        return ResourceClaim(
            name=meta.get("name") or "",
            namespace=meta.get("namespace") or "default",
            requests=tuple(
                DeviceRequest.from_dict(r)
                for r in (spec.get("devices") or {}).get("requests") or ()
            ),
            allocated_node=node,
            results=tuple(
                DeviceResult.from_dict(r)
                for r in (alloc.get("devices") or {}).get("results") or ()
            ),
            reserved_for=tuple(
                f"{r.get('namespace') or meta.get('namespace') or 'default'}"
                f"/{r.get('name')}"
                for r in status.get("reservedFor") or ()
                if r.get("name")
            ),
            resource_version=int(meta.get("resourceVersion") or 0),
        )

    def to_dict(self) -> dict:
        out: dict[str, Any] = {
            "apiVersion": "resource.k8s.io/v1beta1",
            "kind": "ResourceClaim",
            "metadata": {"name": self.name, "namespace": self.namespace},
            "spec": {
                "devices": {"requests": [r.to_dict() for r in self.requests]}
            },
        }
        status: dict[str, Any] = {}
        if self.allocated:
            status["allocation"] = {
                "nodeName": self.allocated_node,
                "nodeSelector": {
                    "nodeSelectorTerms": [
                        {
                            "matchFields": [
                                {
                                    "key": "metadata.name",
                                    "operator": "In",
                                    "values": [self.allocated_node],
                                }
                            ]
                        }
                    ]
                },
                "devices": {
                    "results": [r.to_dict() for r in self.results]
                },
            }
        if self.reserved_for:
            status["reservedFor"] = [
                {
                    "resource": "pods",
                    "namespace": k.split("/", 1)[0],
                    "name": k.split("/", 1)[1],
                }
                for k in self.reserved_for
            ]
        if status:
            out["status"] = status
        return out
