"""Domain solver tests: QTAQ vs naive dense saddle-point solve.

Ports the testing philosophy of ``domain.rs:470-763``: the reduced
strictly-SPD QTAQ solve must match a naive dense LU solve of the full
saddle-point system to ~1e-10, and the fitted interpolant must reproduce the
inputs at the sources.
"""

import numpy as np
import pytest

from ferreus_rbf import (
    InterpolantSettings,
    RBFKernelType,
    RBFTestFunctions,
    generate_random_points,
)
from ferreus_rbf.ops.dense import get_a_matrix, get_a_matrix_symmetric_solver
from ferreus_rbf.ops.polynomials import evaluate_monomials
from ferreus_rbf.solver.domain import Domain
from ferreus_rbf.utils.common import get_cheb_cube_scaling_factors


def naive_rbf_solve(points, values, settings):
    """Dense LU of the full saddle-point system [[A, P], [P^T, 0]]."""
    values = np.asarray(values).reshape(points.shape[0], -1)
    a = np.asarray(get_a_matrix_symmetric_solver(points, settings.kernel_params(), settings.nugget, xp=np))
    if settings.basis_size != 0:
        t, s = get_cheb_cube_scaling_factors(points)
        p = evaluate_monomials(points, settings.polynomial_degree, settings.basis_size, t, s)
        n, m = a.shape[0], settings.basis_size
        lhs = np.block([[a, p], [p.T, np.zeros((m, m))]])
        rhs = np.concatenate([values, np.zeros((m, values.shape[1]))])
        sol = np.linalg.solve(lhs, rhs)
        return sol[:n], sol[n:]
    return np.linalg.solve(a, values), None


def naive_rbf_evaluate(points, targets, settings, point_coef, poly_coef):
    vals = np.asarray(get_a_matrix(targets, points, settings.kernel_params(), xp=np)) @ point_coef
    if settings.basis_size != 0:
        t, s = get_cheb_cube_scaling_factors(points)
        p = evaluate_monomials(targets, settings.polynomial_degree, settings.basis_size, t, s)
        vals = vals + p @ poly_coef
    return vals


def solve_domain(points, values, settings):
    values = np.asarray(values).reshape(points.shape[0], -1)
    n = points.shape[0]
    domain = Domain(np.arange(n))
    domain.internal_points_mask = np.ones(n, dtype=bool)
    domain.factorise(points, settings, settings.basis_size != 0, None)
    sol = domain.solve(values)
    coef = np.zeros((n, values.shape[1]))
    coef[domain.overlapping_point_indices] = sol.point_coefficients
    return coef, sol.poly_coefficients


def _settings(kernel_type):
    s = InterpolantSettings(kernel_type=kernel_type)
    s.set_basis_size(2)
    return s


def _check_reproduces_inputs(settings, points, values):
    values = np.asarray(values).reshape(points.shape[0], -1)
    coef, poly = solve_domain(points, values, settings)
    fitted = naive_rbf_evaluate(points, points, settings, coef, poly)
    err = np.max(np.abs(fitted - values))
    scale = max(np.max(np.abs(values)), 1.0)
    assert err <= 1e-12 + 1e-10 * scale, err


@pytest.mark.parametrize(
    "kernel_type",
    [
        RBFKernelType.Spheroidal,
        RBFKernelType.Linear,
        RBFKernelType.ThinPlateSpline,
        RBFKernelType.Cubic,
    ],
)
def test_domain_solve_reproduces_inputs(kernel_type):
    points = generate_random_points(100, 2, seed=42)
    values = RBFTestFunctions.franke_2d(points)
    settings = _settings(kernel_type)
    _check_reproduces_inputs(settings, points, values)


def test_domain_solve_non_unisolvent():
    """Coplanar 3D points: rank-deficient monomials (Cherrie's procedure)."""
    pts2 = generate_random_points(100, 2, seed=42)
    values = RBFTestFunctions.franke_2d(pts2)[:, None]
    points = np.concatenate([pts2, np.zeros((100, 1))], axis=1)
    settings = InterpolantSettings(kernel_type=RBFKernelType.Linear)
    settings.set_basis_size(3)
    coef, poly = solve_domain(points, values, settings)
    fitted = naive_rbf_evaluate(points, points, settings, coef, poly)
    err = np.max(np.abs(fitted - values))
    assert err <= 1e-12 + 1e-10 * max(np.max(np.abs(values)), 1.0), err


def test_domain_solve_matches_naive():
    points = generate_random_points(100, 2, seed=42)
    values = RBFTestFunctions.franke_2d(points)
    settings = _settings(RBFKernelType.ThinPlateSpline)

    coef, poly = solve_domain(points, values, settings)
    naive_coef, naive_poly = naive_rbf_solve(points, values, settings)

    np.testing.assert_allclose(coef, naive_coef, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(poly, naive_poly, rtol=1e-8, atol=1e-10)
