"""Mesh data plane package. `fanout` (the host-thread lane pool +
`compaction_mesh_devices` demand registry) and `boundaries` (token
boundary planning + mesh.* shard metrics) are device-free; fanout is
imported eagerly. The device mesh (sharded merge over several cards)
is kernel K8 and is not ported yet (ROADMAP queue 2, K8); the planner
symbols resolve lazily from `boundaries`.
"""
from . import fanout  # noqa: F401

_BOUNDARY_EXPORTS = ("plan_token_boundaries", "boundaries_from_indexes",
                     "shard_imbalance")


def __getattr__(name):
    if name in _BOUNDARY_EXPORTS:
        from . import boundaries
        return getattr(boundaries, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
