"""Copied from ``kubernetes_tpu/framework/__init__.py``."""

from .interface import (  # noqa: F401
    MAX_NODE_SCORE,
    MIN_NODE_SCORE,
    CycleState,
    FilterPlugin,
    Plugin,
    PreFilterPlugin,
    ScorePlugin,
    Status,
    StatusCode,
)
from .runtime import Framework  # noqa: F401
