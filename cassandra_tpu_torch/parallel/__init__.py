"""Mesh data plane package. `fanout` (the host-thread lane pool +
`compaction_mesh_devices` demand registry) and `boundaries` (token
boundary planning + mesh.* shard metrics) are device-free; fanout is
imported eagerly. The device mesh (`mesh`: the sharded merge over
several shards, kernel K8) and the planner symbols resolve lazily
(PEP 562), as in the JAX package.
"""
from . import fanout  # noqa: F401

_BOUNDARY_EXPORTS = ("plan_token_boundaries", "boundaries_from_indexes",
                     "shard_imbalance")
_MESH_EXPORTS = ("make_mesh", "sharded_merge_step", "shard_batch")


def __getattr__(name):
    if name in _BOUNDARY_EXPORTS:
        from . import boundaries
        return getattr(boundaries, name)
    if name in _MESH_EXPORTS:
        from . import mesh
        return getattr(mesh, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
