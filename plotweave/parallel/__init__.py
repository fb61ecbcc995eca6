"""Device-mesh scaling.

The reference's only parallelism is a fork pool across 4 color layers
(03_edge_detect.py:42-48) and process-per-step isolation; there is no
distributed backend (SURVEY §2.9).  The device-mesh replacements:

- layers           → ``jax.vmap`` inside one compiled program (ops.frontend)
- batch of images  → ``shard_map`` over a ``data`` mesh axis (batch.py) —
  embarrassingly parallel, no cross-image collectives
- one huge image   → spatial row-sharding over a ``space`` axis with 1-px
  halo exchange via ``jax.lax.ppermute`` for the stencil stages (spatial.py)
"""

from .mesh import make_mesh, data_sharding
from .batch import frontend_batch
from .spatial import fit_shard_rows, sharded_chain, spatial_frontend

__all__ = [
    "make_mesh",
    "data_sharding",
    "frontend_batch",
    "fit_shard_rows",
    "sharded_chain",
    "spatial_frontend",
]
