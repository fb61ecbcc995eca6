"""Image-batch data parallelism: shard a batch of images across the mesh.

Each image's full front-end runs on its shard's device; there is no
cross-image dependence, so the only communication is the initial scatter /
final gather (BASELINE config 4: batch of 64 mixed images).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.frontend import raster_frontend


def frontend_batch(mesh: Mesh, images, centers, *, axis: str = "data", **kw):
    """(B, H, W, 3) uint8 + shared (k, 3) centers → (B, k, H, W) edges, skels.

    B must divide by the mesh axis size; each device runs its sub-batch
    through the natively-batched fused front-end (no vmap, no collectives).
    """

    def local(imgs, ctrs):
        return raster_frontend(imgs, ctrs, **kw)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=(P(axis), P(axis)),
        check_vma=False,
    )
    return jax.jit(fn)(images, centers)
