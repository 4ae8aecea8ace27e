"""Multi-chip scaling via jax.sharding meshes.

The reference's only parallelism is shared-memory rayon (SURVEY.md section
2.6); the analogue here is SPMD over a device mesh. The natural
shardings for this workload (section 5.8 of SURVEY.md):

* **RHS sharding** ("rhs" axis): multi-RHS matvecs and batched domain solves
  are embarrassingly parallel over right-hand-side columns;
* **cell/domain sharding** ("sp" axis): level-batched FMM coefficient
  tensors and Schwarz leaf buckets shard over their leading (cell / domain)
  axis, with XLA inserting the gather/scatter collectives over ICI;
* the coarse solve is small and replicated.
"""

from .sharding import (
    active_mesh,
    make_mesh,
    replicate,
    shard_axis_size,
    shard_leading_axis,
    use_mesh,
)

__all__ = [
    "active_mesh",
    "make_mesh",
    "replicate",
    "shard_axis_size",
    "shard_leading_axis",
    "use_mesh",
]
