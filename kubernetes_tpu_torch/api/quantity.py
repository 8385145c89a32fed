"""Kubernetes resource.Quantity parsing to canonical fixed-point integers.

Reference semantics: staging/src/k8s.io/apimachinery/pkg/api/resource/quantity.go
(`Quantity.Value()`, `Quantity.MilliValue()`, suffix handling in suffix.go).

The reference keeps arbitrary-precision decimal quantities and converts lazily.
TPU kernels need fixed-point int64, so we convert eagerly at the API boundary:

- ``cpu``                    -> integer *milli*-cores  (``MilliValue()``)
- ``memory``/``*storage*``   -> integer bytes          (``Value()``)
- everything else (pods, hugepages, extended resources) -> integer units
  (``Value()``)

Rounding matches the reference: values scale *up* (ceiling away from zero),
so "0.5m" CPU becomes 1 milli-unit, "1.5" bytes becomes 2 bytes
(quantity.go#Value rounds up via ScaledValue/infDecAmount.AsScale).

Values are saturated to int64 range; overflow is impossible downstream.
"""

from __future__ import annotations

import re
from fractions import Fraction

MAX_INT64 = (1 << 63) - 1
MIN_INT64 = -(1 << 63)

# Binary SI (Ki=1024^1 ...) and decimal SI suffixes, per
# apimachinery/pkg/api/resource/suffix.go#fastLookup.
_BINARY_SUFFIXES = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}
_DECIMAL_SUFFIXES = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 1000),
    "": Fraction(1),
    "k": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
}

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<digits>[0-9]+(?:\.[0-9]*)?|\.[0-9]+)"
    r"(?:[eE](?P<exp>[+-]?[0-9]+)|(?P<suffix>[a-zA-Z]{1,2}))?$"
)


class QuantityError(ValueError):
    """Raised for malformed quantity strings."""


def parse_quantity(s: str | int | float) -> Fraction:
    """Parse a Kubernetes quantity into an exact Fraction of base units."""
    if isinstance(s, int):
        return Fraction(s)
    if isinstance(s, float):
        return Fraction(s).limit_denominator(10**9)
    s = s.strip()
    m = _QUANTITY_RE.match(s)
    if not m:
        raise QuantityError(f"invalid quantity: {s!r}")
    digits = m.group("digits")
    value = Fraction(digits)
    if m.group("sign") == "-":
        value = -value
    exp = m.group("exp")
    suffix = m.group("suffix")
    if exp is not None:
        e = int(exp)
        value *= Fraction(10) ** e
    elif suffix:
        if suffix in _BINARY_SUFFIXES:
            value *= _BINARY_SUFFIXES[suffix]
        elif suffix in _DECIMAL_SUFFIXES:
            value *= _DECIMAL_SUFFIXES[suffix]
        else:
            raise QuantityError(f"invalid suffix in quantity: {s!r}")
    return value


def _ceil(f: Fraction) -> int:
    # Quantity.Value()/MilliValue() round up (toward +inf). Negative resource
    # quantities are rejected by API validation, so ceiling is safe everywhere.
    n, d = f.numerator, f.denominator
    q = n // d
    return q if n % d == 0 else q + 1


def _saturate(v: int) -> int:
    return max(MIN_INT64, min(MAX_INT64, v))


def quantity_value(s: str | int | float) -> int:
    """Integer base units, rounding up — Quantity.Value()."""
    return _saturate(_ceil(parse_quantity(s)))


def quantity_milli_value(s: str | int | float) -> int:
    """Integer milli-units, rounding up — Quantity.MilliValue()."""
    return _saturate(_ceil(parse_quantity(s) * 1000))


def canonical(resource_name: str, s: str | int | float) -> int:
    """Canonical int for a named resource: cpu -> milli, otherwise -> Value().

    Mirrors how the scheduler reads quantities in
    pkg/scheduler/framework/types.go#Resource.Add (MilliCPU vs Value).
    """
    if resource_name == "cpu":
        return quantity_milli_value(s)
    return quantity_value(s)


def canonical_requests(raw: dict[str, str | int | float] | None) -> dict[str, int]:
    """Canonicalize a resource map (e.g. container requests)."""
    if not raw:
        return {}
    return {k: canonical(k, v) for k, v in raw.items()}


def format_canonical(resource_name: str, v: int) -> str:
    """Format a canonical int back to a wire quantity string."""
    if resource_name == "cpu":
        if v % 1000 == 0:
            return str(v // 1000)
        return f"{v}m"
    return str(v)
