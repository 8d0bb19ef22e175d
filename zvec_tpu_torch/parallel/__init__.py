"""Multi-GPU scale-out: corpus sharding over a grid of devices (`mesh.py`)."""

from .mesh import (
    make_mesh,
    sharded_flat_search,
    sharded_kmeans_step,
)

__all__ = ["make_mesh", "sharded_flat_search", "sharded_kmeans_step"]
