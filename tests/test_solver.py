"""Iterative solver stack tests: FGMRES units, DDM hierarchy invariants
(ports of ``domain_decomposition.rs:361-597``), and end-to-end iterative
fits through the public interpolator."""

import numpy as np
import pytest

import ferreus_rbf as frt
from ferreus_rbf.config import DDMParams, Params, Solvers
from ferreus_rbf.interpolant_config import FittingAccuracy, FittingAccuracyType
from ferreus_rbf.solver.ddm import DDMTree
from ferreus_rbf.solver.fgmres import fgmres, givens_rotation, schwarz_ddm_solver


# ------------------------------------------------------------------ FGMRES
def test_givens_rotation_annihilates():
    rng = np.random.default_rng(0)
    for f, g in rng.standard_normal((20, 2)):
        c, s, r = givens_rotation(f, g)
        np.testing.assert_allclose(c * f + s * g, r, atol=1e-12)
        np.testing.assert_allclose(-s * f + c * g, 0.0, atol=1e-12)
        np.testing.assert_allclose(c * c + s * s, 1.0, atol=1e-12)


def test_fgmres_solves_dense_system():
    rng = np.random.default_rng(1)
    n = 60
    a = rng.standard_normal((n, n))
    a = a @ a.T + n * np.eye(n)
    b = rng.standard_normal((n, 1))

    x = fgmres(
        lambda v: a @ v,
        b,
        m=None,
        max_outer_iterations=50,
        max_inner_iterations=20,
        tolerance=FittingAccuracy(1e-12, FittingAccuracyType.Relative),
    )
    np.testing.assert_allclose(a @ x, b, atol=1e-8)


def test_fgmres_with_preconditioner_converges_faster():
    rng = np.random.default_rng(2)
    n = 80
    d = np.linspace(1, 1e4, n)
    a = np.diag(d)
    b = rng.standard_normal((n, 1))
    counts = {"plain": 0, "precond": 0}

    def mk_counter(key):
        def mv(v):
            counts[key] += 1
            return a @ v

        return mv

    tol = FittingAccuracy(1e-10, FittingAccuracyType.Relative)
    fgmres(mk_counter("plain"), b, None, max_outer_iterations=100,
           max_inner_iterations=10, tolerance=tol)
    fgmres(mk_counter("precond"), b, m=lambda v: v / d[:, None],
           max_outer_iterations=100, max_inner_iterations=10, tolerance=tol)
    assert counts["precond"] < counts["plain"]


def test_device_fgmres_matches_host_mgs_iterations():
    """SURVEY hard-part #5: the device path's batched CGS2 orthogonalisation
    must track the host reference's sequential MGS iteration-for-iteration,
    including on an ill-conditioned system where one-pass classical
    Gram-Schmidt visibly loses orthogonality."""
    from ferreus_rbf.solver.fgmres import fgmres_device

    rng = np.random.default_rng(7)
    n = 120
    # condition number 1e8: a unit cluster plus small outlier eigenvalues —
    # GMRES resolves the outliers in a few iterations, but only if the
    # Krylov basis stays orthogonal while doing so
    d = np.concatenate([np.ones(n - 10), np.logspace(-8, -1, 10)])
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * d) @ q.T
    a = 0.5 * (a + a.T)
    b = rng.standard_normal((n, 1))

    def count_iters(solver, mv):
        iters = []
        from ferreus_rbf.progress import Progress

        cb = Progress(lambda msg: iters.append(msg))
        x = solver(
            mv, b, None,
            max_outer_iterations=10, max_inner_iterations=25,
            tolerance=FittingAccuracy(1e-10, FittingAccuracyType.Relative),
            callback=cb,
        )
        return np.asarray(x).reshape(-1, 1), len(iters)

    x_host, it_host = count_iters(fgmres, lambda v: a @ v)

    import jax.numpy as jnp

    a_dev = jnp.asarray(a)
    x_dev, it_dev = count_iters(fgmres_device, lambda v: a_dev @ v)

    r_host = np.linalg.norm(a @ x_host - b) / np.linalg.norm(b)
    r_dev = np.linalg.norm(a @ np.asarray(x_dev) - b) / np.linalg.norm(b)
    assert r_host < 1e-7 and r_dev < 1e-7
    # identical restart structure: same inner/outer schedule within 1 restart
    assert abs(it_dev - it_host) <= 5, (it_dev, it_host)


def test_refined_fgmres_escalates_on_stiff_system():
    """Iterative refinement contracts only while kappa(A) * eps_inner < 1.
    On a kappa ~ 3e8 system an f32 inner operator amplifies its own noise
    through the near-singular modes (the 2D-TPS failure mode);
    the refined solver must detect the non-contraction, escalate the
    inner operator to a_f64, and still converge."""
    import jax.numpy as jnp

    from ferreus_rbf.solver.fgmres import refined_fgmres_device

    rng = np.random.default_rng(3)
    n = 100
    d = np.logspace(-8, 0.5, n)  # kappa ~ 3e8
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * d) @ q.T
    a = 0.5 * (a + a.T)
    a_dev = jnp.asarray(a)
    x_true = rng.standard_normal((n, 1))
    b = a @ x_true

    def a_f64(v):
        return a_dev @ v

    def a_f32(v):
        # f32-grade operator: inputs/outputs rounded through float32
        v32 = jnp.asarray(v, jnp.float32)
        return (jnp.asarray(a, jnp.float32) @ v32).astype(jnp.float64)

    # strong preconditioner (the Schwarz analogue): the exact inverse
    a_inv = jnp.asarray(np.linalg.inv(a))

    def m(v):
        return a_inv @ v

    sol = refined_fgmres_device(
        a_f64, a_f32, jnp.asarray(b), m=m,
        max_outer_iterations=10, max_inner_iterations=10,
        tolerance=FittingAccuracy(1e-10, FittingAccuracyType.Relative),
        max_refinements=10,
    )
    res = np.linalg.norm(a @ np.asarray(sol) - b) / np.linalg.norm(b)
    assert res < 1e-9, res


def test_stationary_solver_with_exact_preconditioner():
    rng = np.random.default_rng(3)
    n = 40
    a = rng.standard_normal((n, n))
    a = a @ a.T + n * np.eye(n)
    ainv = np.linalg.inv(a)
    b = rng.standard_normal((n, 1))
    x = schwarz_ddm_solver(
        lambda v: a @ v, b, m=lambda r: ainv @ r, max_iterations=10,
        tolerance=FittingAccuracy(1e-12, FittingAccuracyType.Relative),
    )
    np.testing.assert_allclose(a @ x, b, atol=1e-9)


# ------------------------------------------------------------- DDM invariants
def _ddm(n=800, d=2, **kw):
    pts = frt.generate_random_points(n, d, seed=42)
    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Spheroidal)
    settings.set_basis_size(d)
    params = DDMParams(**kw)
    return DDMTree(pts, settings, params), pts


@pytest.mark.parametrize("d", [1, 2, 3])
def test_ddm_union_and_disjoint_internal(d):
    tree, _ = _ddm(400, d, leaf_threshold=40, overlap_quota=0.5,
                   coarse_ratio=0.5, coarse_threshold=60)
    for level in tree.levels[:-1]:
        seen = set()
        union = []
        for plan in level.leaf_plans:
            internal = plan.point_indices[plan.internal_mask]
            for gi in internal:
                assert gi not in seen, "internal index in multiple domains"
                seen.add(gi)
            union.extend(internal.tolist())
        assert sorted(union) == sorted(level.point_indices.tolist())


@pytest.mark.parametrize("d", [1, 2, 3])
def test_ddm_overlap_bound_and_tail(d):
    tree, _ = _ddm(400, d, leaf_threshold=45, overlap_quota=0.25,
                   coarse_ratio=0.3, coarse_threshold=70)
    lvl0 = tree.levels[0]
    for plan in lvl0.leaf_plans:
        internal = int(plan.internal_mask.sum())
        overlap = plan.internal_mask.size - internal
        bound = int(np.ceil(2.0 * internal * 0.25))
        assert overlap <= bound
        # without a drift the mask keeps internals first, overlap at the tail
        first_false = np.argmin(plan.internal_mask) if overlap else None
        if overlap:
            assert not plan.internal_mask[first_false:].any()


@pytest.mark.parametrize("d", [1, 2, 3])
def test_ddm_monotone_levels_and_coarse(d):
    tree, _ = _ddm(480, d, leaf_threshold=40, overlap_quota=0.2,
                   coarse_ratio=0.25, coarse_threshold=80)
    for a, b in zip(tree.levels[:-1], tree.levels[1:]):
        assert b.point_indices.size <= a.point_indices.size
        assert set(b.point_indices.tolist()) <= set(a.point_indices.tolist())
    for level in tree.levels:
        idx = level.point_indices
        assert np.array_equal(idx, np.unique(idx))
    coarse = tree.levels[-1]
    assert hasattr(coarse, "coarse_domain")
    assert coarse.coarse_domain.internal_points_mask.all()


def test_ddm_threshold_short_circuit():
    tree, _ = _ddm(100, 2, leaf_threshold=40, overlap_quota=0.2,
                   coarse_ratio=0.5, coarse_threshold=100)
    assert len(tree.levels) == 1


def test_ddm_per_level_leaf_sizing(monkeypatch):
    """Memory autoscaling is PER LEVEL (regression for the >=1M stall):
    only levels whose factor bytes exceed their HBM share shrink their
    leaf threshold; coarser levels (coarse_ratio x fewer points) keep the
    large domains the multilevel Schwarz scheme needs, and the cap
    recovers monotonically as the level point count drops."""
    import jax.numpy as jnp

    # hermetic: the thresholds below assume the default 5.0 GB budget and
    # the shrink-to-fit mode (recompute off)
    monkeypatch.delenv("FERREUS_RBF_DDM_MEM_GB", raising=False)
    monkeypatch.setenv("FERREUS_RBF_DDM_RECOMPUTE", "0")

    tree = DDMTree.__new__(DDMTree)
    tree.params = DDMParams(leaf_threshold=1024, overlap_quota=0.5)
    tree.factor_dtype = jnp.float32

    t_fine, rc_fine = tree._leaf_threshold_for(3_000_000)
    t_mid, _ = tree._leaf_threshold_for(375_000)   # one coarse_ratio=0.125 step
    t_small, rc_small = tree._leaf_threshold_for(50_000)
    assert t_fine < tree.params.leaf_threshold  # finest level is memory-bound
    assert t_fine >= 128                        # never below the floor
    assert t_fine <= t_mid <= t_small           # recovers with level size
    assert t_small == tree.params.leaf_threshold  # small levels: user cap
    assert not rc_fine and not rc_small         # recompute disabled

    # f64 factors cost 2x the bytes -> the same level sizes no larger
    tree.factor_dtype = jnp.float64
    assert tree._leaf_threshold_for(3_000_000)[0] <= t_fine

    # default mode: a level whose cap cannot fit even the 128-pt floor
    # switches to recompute-from-points at FULL leaf strength (3M: cap=74);
    # levels whose floor fits keep stored factors (1M: cap=222 -> leaf 128)
    monkeypatch.delenv("FERREUS_RBF_DDM_RECOMPUTE", raising=False)
    tree.factor_dtype = jnp.float32
    t_rc, rc = tree._leaf_threshold_for(3_000_000)
    assert rc and t_rc == tree.params.leaf_threshold
    t_1m, rc_1m = tree._leaf_threshold_for(1_000_000)
    assert not rc_1m and t_1m == 128
    t_ok, rc_ok = tree._leaf_threshold_for(50_000)
    assert not rc_ok and t_ok == tree.params.leaf_threshold
    # forced mode: any capped level recomputes
    monkeypatch.setenv("FERREUS_RBF_DDM_RECOMPUTE", "1")
    t_f, rc_f = tree._leaf_threshold_for(1_000_000)
    assert rc_f and t_f == tree.params.leaf_threshold


# ------------------------------------------------------ end-to-end iterative
def _iter_params(kernel_type, leaf=300, coarse=800):
    params = Params.builder(kernel_type).naive_solve_threshold(1000).build()
    params.ddm_params = DDMParams(
        leaf_threshold=leaf, overlap_quota=0.5, coarse_ratio=0.25,
        coarse_threshold=coarse,
    )
    return params


def test_iterative_fit_linear_3d():
    pts = frt.generate_random_points(5000, 3, seed=42)
    vals = frt.RBFTestFunctions.f1_3d(pts)
    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    rbfi = frt.RBFInterpolator(
        pts, vals, settings, params=_iter_params(frt.RBFKernelType.Linear)
    )
    resid = np.max(np.abs(rbfi.evaluate_at_source(True) - vals))
    assert resid < 5e-6, resid


def test_iterative_fit_tps_drift_2d():
    pts = frt.generate_random_points(6000, 2, seed=1)
    vals = frt.RBFTestFunctions.franke_2d(pts)
    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.ThinPlateSpline)
    rbfi = frt.RBFInterpolator(
        pts, vals, settings, params=_iter_params(frt.RBFKernelType.ThinPlateSpline)
    )
    resid = np.max(np.abs(rbfi.evaluate_at_source(True) - vals))
    assert resid < 5e-6, resid
    # evaluation away from the data is smooth/finite
    grid = frt.create_evaluation_grid([(0.2, 0.8), (0.2, 0.8)], [15, 15])
    vals_g = rbfi.evaluate(grid)
    ref = frt.RBFTestFunctions.franke_2d(grid)
    assert np.max(np.abs(vals_g - ref)) < 5e-2


def test_iterative_fit_stationary_ddm_solver():
    pts = frt.generate_random_points(5000, 2, seed=5)
    vals = frt.RBFTestFunctions.franke_2d(pts)
    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.ThinPlateSpline)
    params = _iter_params(frt.RBFKernelType.ThinPlateSpline)
    params.solver_type = Solvers.DDM
    rbfi = frt.RBFInterpolator(pts, vals, settings, params=params)
    resid = np.max(np.abs(rbfi.evaluate_at_source(True) - vals))
    assert resid < 5e-6, resid


def test_iterative_fit_spheroidal_nugget():
    pts = frt.generate_random_points(5000, 3, seed=9)
    vals = frt.RBFTestFunctions.f4_3d(pts)
    settings = frt.InterpolantSettings(
        kernel_type=frt.RBFKernelType.Spheroidal, base_range=0.6,
        total_sill=0.5, nugget=1e-8,
    )
    rbfi = frt.RBFInterpolator(
        pts, vals, settings, params=_iter_params(frt.RBFKernelType.Spheroidal)
    )
    resid = np.max(np.abs(rbfi.evaluate_at_source(True) - vals))
    assert resid < 5e-6, resid


def test_iterative_matches_dense_solution():
    """Iterative and direct solves agree on the interpolant they produce."""
    pts = frt.generate_random_points(4500, 2, seed=11)
    vals = frt.RBFTestFunctions.franke_2d(pts)
    settings = frt.InterpolantSettings(
        kernel_type=frt.RBFKernelType.ThinPlateSpline,
        fitting_accuracy=FittingAccuracy(1e-10, FittingAccuracyType.Relative),
    )
    it = frt.RBFInterpolator(
        pts, vals, settings, params=_iter_params(frt.RBFKernelType.ThinPlateSpline)
    )
    direct_params = Params.builder(frt.RBFKernelType.ThinPlateSpline).naive_solve_threshold(10000).build()
    direct = frt.RBFInterpolator(pts, vals, settings, params=direct_params)
    grid = frt.create_evaluation_grid([(0.1, 0.9), (0.1, 0.9)], [12, 12])
    np.testing.assert_allclose(it.evaluate(grid), direct.evaluate(grid), atol=1e-7)


def test_f32_matvec_accuracy_and_refined_convergence():
    """The f32 FMM matvec is ~1e-6 accurate; mixed-precision refinement
    still converges the f64 residual to a tight tolerance."""
    import jax.numpy as jnp

    from ferreus_rbf.solver.iterative import DeviceSystem

    pts = frt.generate_random_points(5000, 3, seed=21)
    vals = frt.RBFTestFunctions.f1_3d(pts)
    settings = frt.InterpolantSettings(
        kernel_type=frt.RBFKernelType.Linear,
        fitting_accuracy=FittingAccuracy(1e-9, FittingAccuracyType.Relative),
    )
    params = _iter_params(frt.RBFKernelType.Linear)
    params.mixed_precision = True
    rbfi = frt.RBFInterpolator(pts, vals, settings, params=params)

    # f32 vs f64 matvec agreement
    system = DeviceSystem(rbfi)
    w = jnp.asarray(np.random.default_rng(0).standard_normal((system.n + system.m, 1)))
    v64 = np.asarray(system.matvec(w, precision="f64"))
    v32 = np.asarray(system.matvec(w, precision="f32"))
    rel = np.max(np.abs(v64 - v32)) / np.max(np.abs(v64))
    assert rel < 1e-4, rel
    assert rel > 0  # actually took the reduced-precision path

    # refined solve reached 1e-9 measured in f64
    resid = np.max(np.abs(rbfi.evaluate_at_source(True) - vals))
    assert resid < 5e-9, resid


def test_fused_fgmres_matches_host_loop_fit():
    """The fused device-resident restart cycle (lax.while_loop inner loop,
    one host transfer per restart — solver/fused.py) must reproduce the
    per-iteration host-loop fit on the same system: both converge to the
    fitting tolerance and agree to preconditioner-noise level."""
    import os

    rng = np.random.default_rng(21)
    pts = rng.random((1500, 3))
    vals = np.sin(4 * pts[:, 0]) * np.cos(3 * pts[:, 1]) + 0.5 * pts[:, 2]
    settings = frt.InterpolantSettings(
        kernel_type=frt.RBFKernelType.ThinPlateSpline,
        fitting_accuracy=FittingAccuracy(1e-6, FittingAccuracyType.Relative),
    )
    params = Params(
        ddm_params=DDMParams(leaf_threshold=128, coarse_ratio=0.5,
                             coarse_threshold=400),
        naive_solve_threshold=0,  # force the iterative path
    )

    from ferreus_rbf.solver import fused as fused_mod

    seen = {}
    orig_init = fused_mod.FusedSystem.__init__

    def spy(self, system):
        orig_init(self, system)
        seen["ok"] = self.ok

    fused_mod.FusedSystem.__init__ = spy
    try:
        r_fused = frt.RBFInterpolator(pts, vals, settings, params)
        assert seen.get("ok") is True  # the fused path actually ran
        os.environ["FERREUS_RBF_FUSED"] = "0"
        r_host = frt.RBFInterpolator(pts, vals, settings, params)
    finally:
        fused_mod.FusedSystem.__init__ = orig_init
        os.environ.pop("FERREUS_RBF_FUSED", None)

    scale = float(np.max(np.abs(vals)))
    for r in (r_fused, r_host):
        resid = float(np.max(np.abs(r.evaluate_at_source(add_nugget=True) - vals)))
        assert resid < 1e-5 * scale
    c_f = r_fused.coefficients.point_coefficients
    c_h = r_host.coefficients.point_coefficients
    # both are tolerance-converged solutions of the same SPD system; they
    # agree far below the data scale (not bitwise: CGS2 vs while-loop order)
    assert float(np.max(np.abs(c_f - c_h))) < 1e-2 * float(np.max(np.abs(c_h)) + 1)


def test_host_refactor_indefinite_block_falls_back_spd():
    """A genuinely indefinite leaf block (TPS without QTAQ reduction, k=0)
    must still come back as a finite SPD Cholesky factor: the jitter loop
    cannot rescue it, so the spectral-clip fallback has to engage
    (reference escalates Llt -> Lblt, domain.rs:63)."""
    from ferreus_rbf.solver.ddm import LeafPlan

    n = 24
    pts = np.asarray(frt.generate_random_points(n, 2, seed=3))
    settings = frt.InterpolantSettings(
        kernel_type=frt.RBFKernelType.ThinPlateSpline)

    class _Stub:
        points = pts

    stub = _Stub()
    stub.settings = settings  # basis_size deliberately unset: raw TPS block
    plan = LeafPlan(np.arange(n), np.ones(n, bool),
                    np.concatenate([pts.min(0), pts.max(0)]), None, 0)
    s_pad = 32
    chol = np.full((1, s_pad, s_pad), np.nan)
    out = DDMTree._host_refactor(stub, [plan], chol, np.array([0]), 0)
    assert np.isfinite(out).all()
    l = out[0, :n, :n]
    # lower-triangular with strictly positive diagonal = usable SPD factor
    assert np.allclose(l, np.tril(l))
    assert (np.diag(l) > 0).all()


def test_stall_exit_then_escalation_telemetry():
    """Pins the stall machinery end to end:
    an inner operator with a deterministic accuracy floor must (a) trip
    ``stall_cycle_factor`` inside the f32 rounds instead of grinding all
    20 restarts at the floor (the 3M-point failure mode: ~100 iterations
    x ~20 s each making no progress), (b) escalate the inner operator to
    the f64-grade tier, and (c) still converge — with every step visible
    in the ``history`` list and the telemetry event stream the bench
    records. Scale-shaped: n = 2000, well-conditioned so convergence
    isolates the stall logic rather than the Krylov method."""
    import jax.numpy as jnp

    from ferreus_rbf.solver.fgmres import refined_fgmres_device
    from ferreus_rbf.utils import telemetry

    rng = np.random.default_rng(11)
    n = 2000
    diag = np.linspace(1.0, 3.0, n)
    a = np.diag(diag)  # benign spectrum: the TRUE system is easy
    a_dev = jnp.asarray(a)
    x_true = rng.standard_normal((n, 1))
    b = a @ x_true

    def a_f64(v):
        return a_dev @ v

    # Broken "f32" operator: A32 = A (I + 1.5 D) with D a random diagonal
    # in [-1, 1]. Right-preconditioned by the exact inverse, the inner
    # operator's spectrum {1 + 1.5 d_i} spreads through zero — restarted
    # GMRES(5) cannot contract it, which is exactly the stall the
    # ill-conditioned 3M fits showed (an f32 operator whose noise the
    # preconditioner amplifies through near-singular modes).
    dvec = jnp.asarray(1.0 + 1.5 * rng.uniform(-1.0, 1.0, size=(n, 1)))

    def a_broken32(v):
        return a_dev @ (dvec * v)

    m_inv = jnp.asarray(np.diag(1.0 / diag))

    def m(v):
        return m_inv @ v

    history = []
    tracer = telemetry.enable_global_tracer()
    try:
        sol = refined_fgmres_device(
            a_f64, a_broken32, jnp.asarray(b), m=m,
            max_outer_iterations=20, max_inner_iterations=5,
            tolerance=FittingAccuracy(1e-10, FittingAccuracyType.Relative),
            max_refinements=8, history=history,
        )
        events = list(tracer.events)
    finally:
        telemetry.disable_global_tracer()

    res = np.linalg.norm(a @ np.asarray(sol) - b) / np.linalg.norm(b)
    assert res < 1e-10, res
    # (a) the floored rounds tripped the stall exit (no 20-restart grind)
    assert any(e["event"] == "stall_exit" for e in events), events
    # (b) rounds escalated f32 -> f64 and the escalation stuck
    tiers = [h["inner_tier"] for h in history]
    assert tiers[0] == "f32", tiers
    assert "f64" in tiers, tiers
    assert tiers[tiers.index("f64"):] == ["f64"] * tiers.count("f64"), tiers
    # (c) the final solve_done event reports convergence at tolerance
    done = [e for e in events if e["event"] == "solve_done"]
    assert done and done[-1]["converged"] is True, done


def test_ddm_recompute_matches_stored_factors(monkeypatch):
    """Storage-free Schwarz: with the memory budget
    forced tiny, the fine level re-assembles + re-factors per application
    (zero resident factor bytes) and the fit still converges to the same
    tolerance as the stored-factor fit."""
    import jax.numpy as jnp

    import ferreus_rbf as frt

    pts = frt.generate_random_points(3000, 3, seed=13)
    vals = frt.RBFTestFunctions.f1_3d(pts)
    s = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    params = _iter_params(frt.RBFKernelType.Linear)

    monkeypatch.setenv("FERREUS_RBF_DDM_RECOMPUTE", "0")
    r_stored = frt.RBFInterpolator(pts, vals, s, params)

    # tiny budget: the finest level's cap falls below leaf/2 -> recompute
    monkeypatch.setenv("FERREUS_RBF_DDM_MEM_GB", "0.00001")
    monkeypatch.delenv("FERREUS_RBF_DDM_RECOMPUTE", raising=False)
    r_rc = frt.RBFInterpolator(pts, vals, s, params)

    from ferreus_rbf.solver.iterative import DeviceSystem  # noqa: F401

    vref = np.asarray(vals).reshape(-1)
    for rbfi, label in ((r_stored, "stored"), (r_rc, "recompute")):
        pred = rbfi.evaluate_at_source(add_nugget=True)
        rel = np.max(np.abs(pred - vref)) / np.max(np.abs(vref))
        assert rel < 1e-5, (label, rel)

    # the recompute fit really ran storage-free on its fine levels
    ddm = frt.solver.ddm.DDMTree(
        pts, s, params.ddm_params, factor_dtype=jnp.float32)
    assert any(lv.recompute for lv in ddm.levels[:-1])
    for lv in ddm.levels[:-1]:
        if lv.recompute:
            for b in lv.device.buckets:
                assert "chol" not in b
