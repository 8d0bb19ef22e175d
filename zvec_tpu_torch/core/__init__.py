"""Core index engines (the reference's `src/core/` equivalent).

Each engine owns device-resident search state for one vector column of one
segment and answers batched top-k queries through `zvec_tpu_torch.ops` kernels.
Engines are constructed through `create_engine` (the factory role of the
reference's `IndexFactory`, `src/core/framework/index_factory.h:173-210`).
"""

from .interface import VectorIndexEngine, create_engine

__all__ = ["VectorIndexEngine", "create_engine"]
