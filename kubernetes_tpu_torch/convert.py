"""Carry the JAX package's tensorized state across to the port.

The counterpart of carrying weights across: ``NodeBatch``, ``PodBatch``,
``StaticPluginTensors``, ``PortTensors``, ``SpreadTensors``,
``InterpodTensors`` and ``ExactSolverConfig`` made by ``kubernetes_tpu``
become the port's objects of the same names, so both solvers can be fed
the same arrays. The source objects are read by their field names (duck
typing): this module cannot import their classes. Every array is copied,
so the port never aliases the reference's buffers.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .api.objects import NodeAffinity
from .solver.exact import ExactSolverConfig
from .tensorize.interpod import InterpodTensors
from .tensorize.plugins import PortTensors, StaticPluginTensors
from .tensorize.schema import NodeBatch, PodBatch, ResourceVocab
from .tensorize.spread import SpreadTensors


def _copy(v):
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, list):
        return list(v)
    return v


def _convert(cls, src, **override):
    kw = {
        f.name: _copy(getattr(src, f.name))
        for f in dataclasses.fields(cls)
        if f.name not in override
    }
    return cls(**kw, **override)


def vocab(src) -> ResourceVocab:
    return ResourceVocab(tuple(src.names))


def node_batch(src) -> NodeBatch:
    return _convert(NodeBatch, src, vocab=vocab(src.vocab))


def pod_batch(src) -> PodBatch:
    return _convert(PodBatch, src, vocab=vocab(src.vocab))


def static_tensors(src) -> StaticPluginTensors:
    # ``reps`` are the reference's Pod objects, read only by its own
    # tensorizers; the converted tables carry none
    return _convert(StaticPluginTensors, src, reps=[])


def port_tensors(src) -> PortTensors:
    return _convert(PortTensors, src)


def spread_tensors(src) -> SpreadTensors:
    return _convert(SpreadTensors, src)


def interpod_tensors(src) -> InterpodTensors:
    return _convert(InterpodTensors, src)


def solver_config(src) -> ExactSolverConfig:
    """The reference's config minus its TPU-only ``pallas`` field."""
    added = getattr(src, "added_affinity", None)
    if added is not None:
        added = NodeAffinity.from_dict(added.to_dict())
    return _convert(ExactSolverConfig, src, added_affinity=added)


def solve_inputs(nodes, pods, static=None, ports=None, spread=None, interpod=None):
    """The six solve inputs converted at once (None stays None)."""
    return (
        node_batch(nodes),
        pod_batch(pods),
        None if static is None else static_tensors(static),
        None if ports is None else port_tensors(ports),
        None if spread is None else spread_tensors(spread),
        None if interpod is None else interpod_tensors(interpod),
    )
