"""Solver / DDM / FMM configuration types.

Mirrors ``ferreus_rbf/src/config.rs`` including all default values:
DDM {leaf 1024, overlap 0.5, coarse ratio 0.125, coarse threshold 4096},
FMM interpolation order 7/9/11 by kernel, 256 pts/cell, ACA compression with
epsilon 10^-order, eval chunk 1024, naive-solve threshold 4096.
"""

from __future__ import annotations

import dataclasses
import enum

from .interpolant_config import RBFKernelType


@dataclasses.dataclass
class DDMParams:
    """Domain-decomposition hierarchy parameters (``config.rs:42-69``)."""

    leaf_threshold: int = 1024
    overlap_quota: float = 0.5
    coarse_ratio: float = 0.125
    coarse_threshold: int = 4096

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DDMParams":
        return cls(**d)


class FmmCompressionType(enum.Enum):
    """M2L operator compression methods (``config.rs:72-84``)."""

    None_ = "None"
    SVD = "SVD"
    ACA = "ACA"


def get_default_fmm_interpolation_order(kernel_type: RBFKernelType) -> int:
    """Empirical accuracy defaults (``config.rs:200-207``)."""
    return {
        RBFKernelType.Linear: 7,
        RBFKernelType.ThinPlateSpline: 9,
        RBFKernelType.Cubic: 11,
    }.get(kernel_type, 7)


@dataclasses.dataclass
class FmmParams:
    """FMM tuning parameters (``config.rs:209-252``).

    ``eval_chunk_size`` mirrors the reference's leaf-pass target chunking
    (``bbfmm.rs:1277,1369``). Here the leaf pass is scanned over row
    chunks whose transient device-memory footprint is bounded by fixed
    element budgets;
    this knob scales those budgets (and hence the chunk sizes) linearly,
    with 1024 reproducing the defaults. Smaller values bound peak memory
    tighter at the cost of more scan steps.
    """

    interpolation_order: int = 7
    max_points_per_cell: int = 256
    compression_type: FmmCompressionType = FmmCompressionType.ACA
    epsilon: float = 1e-7
    eval_chunk_size: int = 1024

    @classmethod
    def new_defaults(cls, kernel_type: RBFKernelType) -> "FmmParams":
        order = get_default_fmm_interpolation_order(kernel_type)
        return cls(
            interpolation_order=order,
            max_points_per_cell=256,
            compression_type=FmmCompressionType.ACA,
            epsilon=10.0 ** (-order),
            eval_chunk_size=1024,
        )

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["compression_type"] = self.compression_type.value
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FmmParams":
        d = dict(d)
        d["compression_type"] = FmmCompressionType(d["compression_type"])
        return cls(**d)


class Solvers(enum.Enum):
    """Available iterative solvers (``config.rs:256-263``)."""

    DDM = "DDM"
    FGMRES = "FGMRES"


@dataclasses.dataclass
class Params:
    """Top-level solver parameters (``config.rs:96-191``)."""

    solver_type: Solvers = Solvers.FGMRES
    ddm_params: DDMParams = dataclasses.field(default_factory=DDMParams)
    fmm_params: FmmParams = dataclasses.field(default_factory=FmmParams)
    naive_solve_threshold: int = 4096
    test_unique: bool = True

    # Run the solver's inner iterations with float32 FMM contractions and
    # recover full f64 accuracy by iterative refinement on exact f64
    # residuals; the refined solve converges to the same tolerance,
    # measured in f64. False runs every iteration in f64.
    mixed_precision: bool = True

    # dtype of the stored Schwarz leaf Cholesky factors. "f32" (default)
    # halves the preconditioner's memory, and right-preconditioned
    # *flexible* GMRES tolerates the inexact apply; "f64" for exact-parity
    # studies.
    precond_factor_dtype: str = "f32"

    @classmethod
    def builder(cls, kernel_type: RBFKernelType) -> "ParamsBuilder":
        return ParamsBuilder(kernel_type)

    @classmethod
    def new_defaults(cls, kernel_type: RBFKernelType) -> "Params":
        return cls(fmm_params=FmmParams.new_defaults(kernel_type))

    def to_dict(self) -> dict:
        return {
            "solver_type": self.solver_type.value,
            "ddm_params": self.ddm_params.to_dict(),
            "fmm_params": self.fmm_params.to_dict(),
            "naive_solve_threshold": self.naive_solve_threshold,
            "test_unique": self.test_unique,
            "mixed_precision": self.mixed_precision,
            "precond_factor_dtype": self.precond_factor_dtype,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Params":
        return cls(
            solver_type=Solvers(d["solver_type"]),
            ddm_params=DDMParams.from_dict(d["ddm_params"]),
            fmm_params=FmmParams.from_dict(d["fmm_params"]),
            naive_solve_threshold=d["naive_solve_threshold"],
            test_unique=d["test_unique"],
            mixed_precision=d.get("mixed_precision", True),
            precond_factor_dtype=d.get("precond_factor_dtype", "f32"),
        )


class ParamsBuilder:
    """Fluent builder mirroring ``ParamsBuilder``."""

    def __init__(self, kernel_type: RBFKernelType):
        self._params = Params.new_defaults(kernel_type)

    def solver_type(self, solver_type: Solvers):
        self._params.solver_type = solver_type
        return self

    def ddm_params(self, ddm_params: DDMParams):
        self._params.ddm_params = ddm_params
        return self

    def fmm_params(self, fmm_params: FmmParams):
        self._params.fmm_params = fmm_params
        return self

    def naive_solve_threshold(self, threshold: int):
        self._params.naive_solve_threshold = threshold
        return self

    def test_unique(self, test_unique: bool):
        self._params.test_unique = test_unique
        return self

    def build(self) -> Params:
        return dataclasses.replace(self._params)
