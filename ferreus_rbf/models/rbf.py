"""The RBF interpolator: fit, evaluate, isosurface, save/load.

Maps ``ferreus_rbf/src/rbf.rs`` (orchestrator). The fit pipeline is:

1. optional kernel-aware duplicate removal (``rbf.rs:1391-1467``),
2. optional global-trend transform of the inputs (``rbf.rs:361-370``),
3. ``N < naive_solve_threshold`` -> one direct ``Domain`` factor+solve
   (``rbf.rs:423-455``); otherwise FGMRES (restart 20x5) or stationary DDM
   iteration preconditioned by the multilevel Schwarz hierarchy over
   FMM matvecs (``rbf.rs:456-576``).

Host/device split: steps 1-2 and all setup combinatorics run on the host; the
iterative hot loop (FMM matvec + batched domain solves) is jitted device
code. Evaluation goes through an evaluator object — the FMM evaluator with
its amortised set_local_coefficients/leaf-eval split when available, a dense
chunked device matvec as the small-problem path.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import scipy.optimize
import scipy.spatial

from .. import progress as progress_mod
from ..config import Params, Solvers
from ..interpolant_config import InterpolantSettings
from ..ops import dense as dense_ops
from ..ops import kernels as kernels_mod
from ..ops import polynomials
from ..progress import (
    DuplicatesRemoved,
    Message,
    Progress,
)
from ..solver.domain import Domain
from ..utils import common
from .global_trend import GlobalTrend, GlobalTrendTransform

JSON_FORMAT_NAME = "ferreus_rbf.json"
JSON_VERSION = 1


class Coefficients:
    """Solved coefficients of an RBF system (``rbf.rs:49-70``)."""

    def __init__(self, point_coefficients, poly_coefficients=None):
        self.point_coefficients = np.asarray(point_coefficients, np.float64)
        self.poly_coefficients = (
            None if poly_coefficients is None else np.asarray(poly_coefficients, np.float64)
        )

    def to_dict(self) -> dict:
        return {
            "point_coefficients": self.point_coefficients.tolist(),
            "poly_coefficients": None
            if self.poly_coefficients is None
            else self.poly_coefficients.tolist(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Coefficients":
        return cls(
            np.asarray(d["point_coefficients"], np.float64),
            None
            if d.get("poly_coefficients") is None
            else np.asarray(d["poly_coefficients"], np.float64),
        )


def duplicate_cutoff_distance(h_ref: float, interpolant_settings: InterpolantSettings) -> float:
    """Kernel-aware duplicate cutoff (``rbf.rs:1391-1415``).

    Probes |phi(r) - phi(0)| near r = 0 and finds the radius where it rises
    above machine epsilon relative to phi(h_ref), keeping the QTAQ systems
    strictly positive definite.
    """
    kparams = interpolant_settings.kernel_params()
    kernel = kernels_mod.make_kernel(kparams, xp=np)

    def phi(r):
        return float(kernel.phi(np.asarray([r]))[0])

    eps = np.finfo(np.float64).eps
    phi0 = phi(0.0)
    target = eps * abs(phi(h_ref) - phi0)

    def resid(r):
        return abs(phi(r) - phi0) - target

    if resid(h_ref) <= 0.0:
        return h_ref
    try:
        return scipy.optimize.brentq(resid, 0.0, h_ref, rtol=1e-12)
    except ValueError:
        return h_ref


def remove_duplicates(points: np.ndarray, interpolant_settings: InterpolantSettings) -> np.ndarray:
    """Indices of unique points under the kernel-aware infinity-norm radius.

    Greedy first-in-group-wins grouping via a KD-tree, identical in effect to
    ``rbf.rs:1430-1467``.
    """
    pts = np.asarray(points, np.float64)
    extents = common.get_pointarray_extents(pts)
    d = pts.shape[1]
    max_length = float(np.max(np.abs(extents[d:] - extents[:d])))
    tol = duplicate_cutoff_distance(max_length, interpolant_settings)

    tree = scipy.spatial.cKDTree(pts)
    groups = tree.query_ball_point(pts, tol, p=np.inf, workers=-1)
    visited = np.zeros(pts.shape[0], dtype=bool)
    unique = []
    for i in range(pts.shape[0]):
        if visited[i]:
            continue
        unique.append(i)
        visited[groups[i]] = True
    return np.asarray(unique, np.int64)


def _scalar_or_matrix(values: np.ndarray) -> np.ndarray:
    """Single-column value blocks come back 1-D, like the reference's
    ``mat_to_numpy_scalar_or_matrix`` (``python_bindings.rs:81-99``); true
    multi-RHS results stay 2-D. Gradients are always 2-D."""
    v = np.asarray(values)
    return v[:, 0] if v.ndim == 2 and v.shape[1] == 1 else v


class _DenseEvaluator:
    """Direct chunked device matvec evaluator (small problems / oracle)."""

    def __init__(self, source_points, kparams: kernels_mod.KernelParams):
        self.source_points = np.asarray(source_points, np.float64)
        self.kernel = kernels_mod.make_kernel(kparams)

    def set_weights(self, weights) -> None:
        pass  # the dense evaluator takes weights per evaluate call

    def set_local_coefficients(self, weights) -> None:
        pass

    def evaluate(self, weights, targets):
        return np.asarray(dense_ops.dense_matvec(self.kernel, targets, self.source_points, weights))

    def evaluate_with_gradients(self, weights, targets):
        vals, grads = dense_ops.dense_matvec_with_gradients(
            self.kernel, targets, self.source_points, weights
        )
        return np.asarray(vals), np.asarray(grads)

    # leaf-mode == full mode for the dense evaluator
    evaluate_leaves = evaluate
    evaluate_leaves_with_gradients = evaluate_with_gradients


class RBFInterpolator:
    """Radial basis function interpolator (fitted on construction)."""

    def __init__(
        self,
        points,
        values,
        interpolant_settings: InterpolantSettings,
        params: Optional[Params] = None,
        global_trend: Optional[GlobalTrend] = None,
        progress_callback: Optional[Progress] = None,
        _skip_solve: bool = False,
    ):
        solver_start = time.perf_counter()

        points = np.asarray(points, np.float64)
        values = np.asarray(values, np.float64)
        if values.ndim == 1:
            values = values[:, None]

        dimensions = points.shape[1]
        if not 1 <= dimensions <= 3:
            raise ValueError(f"Unsupported number of dimensions: {dimensions}")

        import dataclasses as _dc

        settings = _dc.replace(interpolant_settings)
        settings.set_basis_size(dimensions)
        self.interpolant_settings = settings
        self.params = params if params is not None else Params.new_defaults(settings.kernel_type)
        self.progress_callback = progress_callback

        if self.params.test_unique and not _skip_solve:
            idx = remove_duplicates(points, settings)
            if idx.shape[0] != points.shape[0]:
                progress_mod.emit(
                    progress_callback,
                    DuplicatesRemoved(num_duplicates=points.shape[0] - idx.shape[0]),
                )
                points = points[idx]
                values = values[idx]

        self.global_trend = None
        if global_trend is not None:
            center = points.mean(axis=0)
            self.global_trend = GlobalTrendTransform(center, global_trend)
            points = self.global_trend.transform_points(points)

        self.points = points
        self.point_values = values
        self.coefficients = Coefficients(np.zeros((0, values.shape[1])))
        self.translation_factor = np.zeros(0)
        self.scale_factor = np.ones(0)
        self._evaluator = None

        if not _skip_solve:
            self._setup_and_solve()
            duration = time.perf_counter() - solver_start
            progress_mod.emit(
                progress_callback,
                Message(
                    message=(
                        f"Took {duration:.3f}s to solve RBF for {self.points.shape[0]} points "
                        f"using the following settings:\n"
                        f"Kernel: {settings.kernel_type.value}, "
                        f"Polynomial degree: {settings.polynomial_degree}\n"
                        f"Fitting accuracy: {settings.fitting_accuracy.tolerance}, "
                        f"Tolerance type: {settings.fitting_accuracy.tolerance_type.value}"
                    )
                ),
            )

    @classmethod
    def builder(cls, points, values, interpolant_settings: InterpolantSettings):
        return _RBFInterpolatorBuilder(points, values, interpolant_settings)

    # ------------------------------------------------------------------ fit
    def _setup_and_solve(self) -> None:
        num_points = self.points.shape[0]

        if self.interpolant_settings.basis_size != 0:
            self.translation_factor, self.scale_factor = common.get_cheb_cube_scaling_factors(
                self.points
            )

        if num_points < self.params.naive_solve_threshold:
            domain = Domain(np.arange(num_points))
            domain.internal_points_mask = np.ones(num_points, dtype=bool)
            domain.factorise(self.points, self.interpolant_settings, True, self.global_trend)
            sol = domain.solve(self.point_values)
            point_coefficients = np.zeros_like(sol.point_coefficients)
            point_coefficients[domain.overlapping_point_indices] = sol.point_coefficients
            self.coefficients = Coefficients(point_coefficients, sol.poly_coefficients)
        else:
            from ..solver.iterative import iterative_fit

            self.coefficients = iterative_fit(self)

        if self.global_trend is not None:
            self.points = self.global_trend.inverse_transform_points(self.points)

    # ----------------------------------------------------------- properties
    @property
    def source_points(self) -> np.ndarray:
        return self.points

    @property
    def source_values(self) -> np.ndarray:
        return self.point_values

    # ----------------------------------------------------------- evaluation
    def _make_evaluator(self, adaptive: bool, sparse: bool, extents=None):
        """Build an FMM evaluator over trend-transformed points/extents.

        Maps ``rbf.rs:594-631``; extents corners are transformed through the
        trend before the union AABB is taken.
        """
        pts = self.points
        evaluator_extents = extents
        if self.global_trend is not None:
            pts = self.global_trend.transform_points(pts)
            if evaluator_extents is not None:
                d = self.points.shape[1]
                corners = common.bounding_box_corners(
                    np.asarray(evaluator_extents)[:d], np.asarray(evaluator_extents)[d:]
                )
                evaluator_extents = common.get_pointarray_extents(
                    self.global_trend.transform_points(corners)
                )
        if evaluator_extents is None:
            evaluator_extents = common.get_pointarray_extents(pts)

        try:
            from ..ops.fmm.api import FmmTree
        except ImportError:
            # FMM engine not available: fall back to the dense direct
            # evaluator (exact, O(N*M); fine for small models).
            return _DenseEvaluator(pts, self.interpolant_settings.kernel_params())

        return FmmTree(
            pts,
            self.params.fmm_params.interpolation_order,
            self.interpolant_settings.kernel_params(),
            adaptive_tree=adaptive,
            sparse=sparse,
            extents=np.asarray(evaluator_extents, np.float64),
            params=self.params.fmm_params,
        )

    def _evaluator_union_extents(self, target_points=None, target_extents=None) -> np.ndarray:
        source_extents = common.get_pointarray_extents(self.points)
        if target_points is not None:
            return common.union_extents(
                source_extents, common.get_pointarray_extents(target_points)
            )
        if target_extents is not None:
            return common.union_extents(source_extents, target_extents)
        return source_extents

    def _evaluate(
        self,
        evaluator,
        target_points,
        evaluate_gradients: bool,
        add_nugget: bool,
        leaves_mode: bool,
    ):
        """Shared evaluation epilogue (``rbf.rs:1180-1270``)."""
        targets = np.asarray(target_points, np.float64)
        eval_points = targets
        if self.global_trend is not None:
            eval_points = self.global_trend.transform_points(targets)

        weights = self.coefficients.point_coefficients
        if evaluate_gradients:
            fn = evaluator.evaluate_leaves_with_gradients if leaves_mode else evaluator.evaluate_with_gradients
            values, gradients = fn(weights, eval_points)
            values = np.array(values)
            gradients = np.array(gradients)
        else:
            fn = evaluator.evaluate_leaves if leaves_mode else evaluator.evaluate
            values = np.array(fn(weights, eval_points))
            gradients = None

        dims = targets.shape[1]
        nrhs = weights.shape[1]

        if self.global_trend is not None and gradients is not None:
            # x' = x B + b  =>  grad_x f = grad_{x'} f B^T (row-vector form).
            bt = self.global_trend.linear_part(dims).T
            g = gradients.reshape(-1, nrhs, dims)
            gradients = np.einsum("nrj,jk->nrk", g, bt).reshape(-1, nrhs * dims)

        if add_nugget:
            values = values + weights * self.interpolant_settings.nugget

        if self.interpolant_settings.basis_size != 0:
            monomials = polynomials.evaluate_monomials(
                targets,
                self.interpolant_settings.polynomial_degree,
                self.interpolant_settings.basis_size,
                self.translation_factor,
                self.scale_factor,
            )
            values = values + monomials @ self.coefficients.poly_coefficients
            if gradients is not None:
                gradients = gradients + polynomials.evaluate_monomial_gradients(
                    targets,
                    self.coefficients.poly_coefficients,
                    self.interpolant_settings.polynomial_degree,
                    self.translation_factor,
                    self.scale_factor,
                )

        return _scalar_or_matrix(values), gradients

    def evaluate(self, target_points) -> np.ndarray:
        """One-shot evaluation over the union of source/target extents."""
        extents = self._evaluator_union_extents(target_points=target_points)
        tree = self._make_evaluator(adaptive=True, sparse=False, extents=extents)
        tree.set_weights(self.coefficients.point_coefficients)
        values, _ = self._evaluate(tree, target_points, False, False, leaves_mode=False)
        return values

    def evaluate_with_gradients(self, target_points):
        extents = self._evaluator_union_extents(target_points=target_points)
        tree = self._make_evaluator(adaptive=True, sparse=False, extents=extents)
        tree.set_weights(self.coefficients.point_coefficients)
        values, gradients = self._evaluate(tree, target_points, True, False, leaves_mode=False)
        return values, gradients

    def evaluate_at_source(self, add_nugget: bool = False) -> np.ndarray:
        """Evaluate at the training sites (convergence diagnostics)."""
        tree = self._make_evaluator(adaptive=True, sparse=True, extents=None)
        tree.set_weights(self.coefficients.point_coefficients)
        values, _ = self._evaluate(tree, self.points, False, add_nugget, leaves_mode=False)
        return values

    def build_evaluator(self, extents=None) -> None:
        """Build + store an evaluator (full downward pass once) for repeated eval."""
        tree = self._make_evaluator(adaptive=True, sparse=False, extents=extents)
        tree.set_weights(self.coefficients.point_coefficients)
        tree.set_local_coefficients(self.coefficients.point_coefficients)
        self._evaluator = tree

    def evaluate_targets(self, target_points) -> np.ndarray:
        """Leaf-only fast path against the stored evaluator."""
        if self._evaluator is None:
            raise RuntimeError("call build_evaluator before evaluate_targets")
        values, _ = self._evaluate(self._evaluator, target_points, False, False, leaves_mode=True)
        return values

    def evaluate_targets_with_gradients(self, target_points):
        if self._evaluator is None:
            raise RuntimeError("call build_evaluator before evaluate_targets_with_gradients")
        return self._evaluate(self._evaluator, target_points, True, False, leaves_mode=True)

    # ---------------------------------------------------------- isosurface
    def build_isosurface(self, extents, resolution: float, isovalue: float, boundary_closure=None):
        meshes = self.build_isosurfaces(extents, resolution, [isovalue], boundary_closure)
        return meshes[0]

    def build_isosurfaces(self, extents, resolution: float, isovalues, boundary_closure=None):
        """Surface-following RMT extraction (``rbf.rs:954-1069``)."""
        from ..isosurfacing import BoundaryClosure, ClusterMethod
        from ..rmt.isosurface import build_isosurface as rmt_build

        if boundary_closure is None:
            boundary_closure = BoundaryClosure.None_

        dims = self.points.shape[1]
        if dims != 3:
            raise ValueError("Only supported for 3D isosurfacing")

        extents = np.asarray(extents, np.float64)
        evaluator_extents = self._evaluator_union_extents(target_extents=extents)
        evaluator_extents[:dims] -= resolution * 10.0
        evaluator_extents[dims:] += resolution * 10.0
        self.build_evaluator(evaluator_extents)

        def surface_fn(targets):
            return self.evaluate_targets(targets)

        def gradient_fn(targets):
            return self.evaluate_targets_with_gradients(targets)

        sink = self.progress_callback

        meshes = []
        for isovalue in isovalues:
            meshes.append(
                rmt_build(
                    self.points,
                    extents,
                    resolution,
                    isovalue,
                    surface_fn,
                    gradient_fn,
                    ClusterMethod.CurvatureWeighted,
                    boundary_closure,
                    sink,
                )
            )
        return meshes

    # ------------------------------------------------------------- model IO
    def _model_dict(self) -> dict:
        return {
            "format": JSON_FORMAT_NAME,
            "version": JSON_VERSION,
            "points": self.points.tolist(),
            "point_values": self.point_values.tolist(),
            "coefficients": self.coefficients.to_dict(),
            "interpolant_settings": self.interpolant_settings.to_dict(),
            "translation_factor": np.asarray(self.translation_factor).tolist(),
            "scale_factor": np.asarray(self.scale_factor).tolist(),
            "params": self.params.to_dict(),
            "global_trend": None if self.global_trend is None else self.global_trend.to_dict(),
        }

    def save_model(self, path) -> None:
        """Save to the versioned JSON envelope ``{format, version, ...model}``."""
        with open(path, "w") as fh:
            json.dump(self._model_dict(), fh)

    @classmethod
    def load_model(cls, path, progress_callback: Optional[Progress] = None) -> "RBFInterpolator":
        """Load + validate the JSON envelope (``rbf.rs:1131-1171``)."""
        with open(path) as fh:
            env = json.load(fh)
        if env.get("format") != JSON_FORMAT_NAME:
            raise ValueError(
                f"unsupported format {env.get('format')!r} (expected {JSON_FORMAT_NAME!r})"
            )
        if env.get("version") != JSON_VERSION:
            raise ValueError(
                f"unsupported version {env.get('version')} (expected {JSON_VERSION})"
            )

        settings = InterpolantSettings.from_dict(env["interpolant_settings"])
        model = cls.__new__(cls)
        model.interpolant_settings = settings
        model.params = Params.from_dict(env["params"])
        model.points = np.asarray(env["points"], np.float64)
        model.point_values = np.asarray(env["point_values"], np.float64)
        model.coefficients = Coefficients.from_dict(env["coefficients"])
        model.translation_factor = np.asarray(env["translation_factor"], np.float64)
        model.scale_factor = np.asarray(env["scale_factor"], np.float64)
        model.global_trend = (
            None
            if env.get("global_trend") is None
            else GlobalTrendTransform.from_dict(env["global_trend"])
        )
        model.progress_callback = progress_callback
        model._evaluator = None
        return model


class _RBFInterpolatorBuilder:
    """Fluent builder mirroring ``RBFInterpolatorBuilder`` (``rbf.rs:198-263``)."""

    def __init__(self, points, values, interpolant_settings: InterpolantSettings):
        self._points = points
        self._values = values
        self._settings = interpolant_settings
        self._params: Optional[Params] = None
        self._global_trend: Optional[GlobalTrend] = None
        self._progress: Optional[Progress] = None

    def params(self, params: Params):
        self._params = params
        return self

    def global_trend(self, global_trend: GlobalTrend):
        self._global_trend = global_trend
        return self

    def progress_callback(self, progress: Progress):
        self._progress = progress
        return self

    def build(self) -> RBFInterpolator:
        return RBFInterpolator(
            self._points,
            self._values,
            self._settings,
            params=self._params,
            global_trend=self._global_trend,
            progress_callback=self._progress,
        )
