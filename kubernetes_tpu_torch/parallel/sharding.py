"""Node-axis mesh resolution for the port's scheduler.

The JAX package shards the node axis of a solve over a device mesh
(``kubernetes_tpu/parallel/sharding.py``), and its results are bit-exactly
invariant in the device count (``tests/test_sharding.py``). The port runs
on one card: ``mesh_devices`` 0 (all visible devices) and 1 (force the
single-device path) both resolve to that card, which ``resolve_mesh``
returns as None, the JAX package's "unsharded" value. A mesh of more than
one device, or an exclusive mesh slice, is not ported yet (ROADMAP queue 1
item 11) and raises.
"""

from __future__ import annotations


def resolve_mesh(mesh_devices: int = 0, mesh_slice: tuple | None = None):
    """None (the single card) for ``mesh_devices`` 0 or 1; raises
    NotImplementedError for a multi-device mesh or a mesh slice."""
    if mesh_slice is not None:
        raise NotImplementedError(
            "mesh_slice is not ported: the port runs on one card "
            "(ROADMAP queue 1 item 11, multi-device)"
        )
    if mesh_devices > 1:
        raise NotImplementedError(
            f"mesh_devices={mesh_devices} is not ported: the port runs on "
            "one card (ROADMAP queue 1 item 11, multi-device)"
        )
    return None
