"""Mesh construction and sharding helpers.

Thin wrappers over ``jax.sharding`` so the solver / FMM layers can annotate
their batched tensors without caring about device topology. All collectives
are left to GSPMD: we annotate leading-axis shardings on the big batched
tensors (FMM coefficient blocks, Schwarz leaf buckets, RHS columns) and XLA
partitions the einsums/scatters and inserts ICI collectives.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def make_mesh(n_devices: int | None = None, axis_names=("sp",)) -> Mesh:
    """A 1D (or reshaped) device mesh over the first ``n_devices`` devices."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"requested a {n_devices}-device mesh but only {len(devices)} "
            f"devices are visible; provision a virtual CPU mesh with "
            f"XLA_FLAGS=--xla_force_host_platform_device_count={n_devices} "
            f"before JAX backend initialisation"
        )
    devices = np.asarray(devices[:n_devices])
    if len(axis_names) == 1:
        shape = (n_devices,)
    else:
        # split factors as evenly as possible over the requested axes
        shape = []
        rem = n_devices
        for _ in axis_names[:-1]:
            f = _largest_factor_leq(rem, int(round(rem ** (1 / len(axis_names)))))
            shape.append(f)
            rem //= f
        shape.append(rem)
        shape = tuple(shape)
    return Mesh(devices.reshape(shape), axis_names)


def _largest_factor_leq(n: int, k: int) -> int:
    k = max(1, min(k, n))
    for f in range(k, 0, -1):
        if n % f == 0:
            return f
    return 1


def shard_leading_axis(mesh: Mesh, axis: str, x):
    """Shard an array (or pytree) over its leading axis along ``axis``."""

    def put(arr):
        if not hasattr(arr, "ndim") or arr.ndim == 0:
            return arr
        spec = PartitionSpec(axis, *([None] * (arr.ndim - 1)))
        return jax.device_put(arr, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, x)


def replicate(mesh: Mesh, x):
    """Fully replicate an array (or pytree) over the mesh."""

    def put(arr):
        if not hasattr(arr, "ndim"):
            return arr
        return jax.device_put(arr, NamedSharding(mesh, PartitionSpec()))

    return jax.tree_util.tree_map(put, x)


# --------------------------------------------------------------------------
# Active mesh: lets the solver layers shard their batched tensors without
# threading a mesh argument through every constructor. GSPMD then partitions
# the jitted programs over the committed shardings — no pjit annotations
# needed at the call sites.

_ACTIVE_MESH: Mesh | None = None


def active_mesh() -> Mesh | None:
    """The mesh installed by :func:`use_mesh`, or ``None`` (single device)."""
    return _ACTIVE_MESH


class use_mesh:
    """Context manager: shard solver state built inside over ``mesh``.

    While active, ``DDMTree`` commits its Schwarz leaf buckets with the
    domain (leading) axis sharded over the mesh's ``"sp"`` axis, so the
    batched QTAQ Cholesky back-solves — the per-iteration preconditioner
    cost — are partitioned across devices (the SPMD replacement for the
    reference's rayon loop at ``schwarz.rs:92-110``).
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._prev = None

    def __enter__(self):
        global _ACTIVE_MESH
        self._prev = _ACTIVE_MESH
        _ACTIVE_MESH = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _ACTIVE_MESH
        _ACTIVE_MESH = self._prev
        return False


def shard_axis_size(mesh: Mesh | None, axis: str) -> int:
    """Size of ``axis`` in ``mesh`` (1 when absent / no mesh)."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(axis, 1))
