"""KubeSchedulerConfiguration types: the subset the port's scheduler reads.

Only ``Extender`` (``extenders[]``: urlPrefix, filterVerb / prioritizeVerb
/ preemptVerb / bindVerb, weight, nodeCacheCapable, ignorable,
managedResources), which ``server/extender_client.py`` takes. The YAML
``load`` and the bridge from a ``KubeSchedulerConfiguration`` to the
scheduler's config (``_solver_config``, ``scheduler_config``) are not
ported yet (ROADMAP queue 1 item 8, the CLI slice), so this module needs
no YAML parser.

Copied in part from ``kubernetes_tpu/config/types.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Extender:
    url_prefix: str = ""
    filter_verb: str = ""
    prioritize_verb: str = ""
    preempt_verb: str = ""
    bind_verb: str = ""
    weight: int = 1
    node_cache_capable: bool = False
    ignorable: bool = False
    managed_resources: list[dict] = field(default_factory=list)
