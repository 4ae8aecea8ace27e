"""Overlapping Schwarz preconditioner over the DDM hierarchy.

Maps ``ferreus_rbf/src/preconditioning/schwarz.rs``: restricted additive
Schwarz within each fine level (all leaf domains solved on the current
residual, only internal-point coefficients scattered back), multiplicative
between levels, with the coarse level smoothing after every fine level and
contributing the polynomial tail only on the last pass; fine-level
corrections are orthogonalised against the global thin-Q polynomial basis
so the P^T lambda = 0 constraint is preserved.

Device-resident: residuals, corrections, the batched leaf Cholesky solves
and the thin-Q orthogonalisation all stay on the device; only the small coarse
domain crosses to the host for its direct solve.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..interpolant_config import InterpolantSettings
from .ddm import DDMTree


def schwarz_preconditioner(
    rg,
    ddm_tree: DDMTree,
    matvec_partial,
    interpolant_settings: InterpolantSettings,
    ortho_poly_matrix,
) -> jnp.ndarray:
    """Apply the multilevel Schwarz preconditioner to residual ``rg``.

    ``matvec_partial(weights, level_idx_or_None)`` computes the system
    operator restricted to the given level's target rows (full-size output,
    zeros elsewhere). ``rg`` may be a host or device array; the result is a
    device array.
    """
    rg = jnp.asarray(rg)
    sl = jnp.zeros_like(rg)
    coarse_idx = len(ddm_tree.levels) - 1

    if coarse_idx > 0:
        first = True
        for i in range(coarse_idx):
            # matvec(0) == 0: skip the first restricted matvec
            res = rg if first else rg - matvec_partial(sl, i)
            first = False
            sl = sl + _solve_fine_level(
                res, ddm_tree, i, interpolant_settings, ortho_poly_matrix
            )
            res = rg - matvec_partial(sl, "coarse")
            sl = sl + ddm_tree.solve_coarse(res, add_poly=(i == coarse_idx - 1))
    else:
        sl = sl + ddm_tree.solve_coarse(rg, add_poly=True)

    return sl


def _solve_fine_level(residuals, ddm_tree, level_idx, settings, ortho_poly_matrix):
    s1 = ddm_tree.solve_fine_level(level_idx, residuals)
    if settings.basis_size != 0:
        n = s1.shape[0] - settings.basis_size
        q = jnp.asarray(ortho_poly_matrix)
        proj = q.T @ s1[:n]
        s1 = s1.at[:n].add(-(q @ proj))
    return s1
