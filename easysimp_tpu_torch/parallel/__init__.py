"""Device meshes and the sharded SIMP path: one process drives a mesh of
torch devices, each shard's fields on its own device, with explicit halo
exchanges (voxel grids) or an element split (imported meshes)."""

from .halo import HaloVoxelOperator, extend
from .sharding import (
    DeviceMesh,
    ElementLayout,
    GridLayout,
    ShardedField,
    best_mesh_shape,
    make_element_mesh,
    make_mesh,
    round_robin_cards,
)

__all__ = [
    "DeviceMesh", "ElementLayout", "GridLayout", "ShardedField",
    "HaloVoxelOperator", "best_mesh_shape", "extend", "make_element_mesh",
    "make_mesh", "round_robin_cards",
]
