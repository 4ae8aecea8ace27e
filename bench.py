"""Driver benchmark suite: all five BASELINE.md configs in ONE JSON line.

Runs on one GPU and exits non-zero without one. Every printed line carries
the device (platform, device_kind, count) and the card's name and power
limit from nvidia-smi.

Headline metric (config 2): BBFMM matvec throughput — 3D biharmonic
(Linear kernel), 100k uniform points, Chebyshev order 5, 8 RHS, uniform
tree, device-resident, mixed-precision (f32) mode. The ``extra`` field
carries the same matvec at the f64 tier plus the other configs (2D TPS
fit, albatite fit, 1M-pt fit, 3M-pt fit + RMT), each with wall-clock and
residual. Configs run inside a wall-clock budget (``FERREUS_BENCH_BUDGET``
seconds, default 2100) and report "skipped" when it runs out.

The cumulative result line is re-printed after EVERY config (a reader of
the LAST JSON line always sees the best-so-far), and SIGTERM/SIGALRM
handlers dump the cumulative line if the process is killed mid-config.

``vs_baseline`` anchor (reference publishes NO numbers; BASELINE.md §
"published" is empty): derived from a COMPILED measurement —
  measured on this image: fused C++ -O3 -march=native single-core P2P
  (f64 biharmonic, 8 RHS; ferreus_rbf/native/p2p_proxy.cpp) =
  2.1e8 pairs/s — replacing round 2's ASSUMED "numpy x4 SIMD" per-core
  factor (the measured compiled gain over numpy is ~11-19x, so the r2
  anchor UNDERSTATED the reference ~3x). Still assumed (the bench host
  exposes one core): rayon scaling to the target machine's 64 cores at
  0.7 efficiency -> 9.2e9 pairs/s. Config 2 has 4.8e8 near-field pairs
  + ~25% far-field time -> ~0.065 s/matvec ->
  **1.5e6 pts/s estimated for the Rust reference on a 64-core CPU**
  (uncertainty band ~[8e5, 2.6e6]: efficiency 0.5-0.9 x per-core
  proxy-vs-reference spread +-30%). Derivation in BASELINE.md v3.
"""

import json
import os
import re
import signal
import sys
import time

import numpy as np

_ANSI_RE = re.compile(r"\x1b\[[0-9;?]*[A-Za-z]|\x1b\][^\x07\x1b]*(?:\x07|\x1b\\)?")


def _clean_err(e, cap=160):
    """ANSI-strip + de-control + cap an exception string (a long ANSI-laden
    error must not blow the final line past a 2,000-byte tail capture)."""
    s = f"{type(e).__name__}: {e}" if isinstance(e, BaseException) else str(e)
    s = _ANSI_RE.sub("", s)
    s = "".join(c if c.isprintable() else " " for c in s)
    s = re.sub(r"\s+", " ", s).strip()
    return s[:cap]

BUDGET = float(os.environ.get("FERREUS_BENCH_BUDGET", 2100))
_T0 = time.perf_counter()
BASELINE_PTS_PER_S = 1.5e6  # derived estimate (v3, measured compiled core)
DETAIL_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out", "bench_detail.json")


def budget_left():
    return BUDGET - (time.perf_counter() - _T0)


def _pull(x):
    """Wait until the device has finished computing ``x``."""
    return x.block_until_ready()


def _card():
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def device_tag():
    """What every result line is tagged with."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": _card()}


def _program_count():
    try:
        from ferreus_rbf.utils.telemetry import compiled_program_counts

        return int(sum(compiled_program_counts().values()))
    except Exception:
        return -1


def _modeled_flops_config2(tree, binned, n, nrhs, times_s):
    """Modeled FLOPs for the dominant matvec passes and the rate achieved.

    Near field: per true (target, source-slot) pair the kernel does d
    sub+mul+add for r^2 (3d ops) + ~4 ops for phi (sqrt chain) + 2*nrhs MAC
    for the contraction. Far field: the M2L level einsums' dot FLOPs. No
    share of a peak is reported: that needs a peak table per device kind
    and a measured trace, neither of which this harness has yet."""
    tree._ensure_tile_tables(binned)
    nbr = np.asarray(binned["nbr_tab"])  # (U, R) leaf-tile rows, sentinel=nsl
    tmax = binned["tgt_idx"].shape[1]
    true_nbrs = (nbr != tree.nsl).sum()
    s_pad = tree.smax
    pair_flops = float(true_nbrs) * tmax * s_pad * (3 * 3 + 4 + 2 * nrhs)
    m2l_flops = 0.0
    for u_stack, vt_stack, src_r, _src_cells, level_cells in tree._dev["m2l_levels"]:
        g, pd_, k = u_stack.shape
        c = src_r.shape[0] * src_r.shape[1]
        m2l_flops += 2.0 * g * c * k * (pd_ + (vt_stack.shape[2] if vt_stack is not None else 0)) * nrhs
    med = sorted(times_s)[len(times_s) // 2]
    total = pair_flops + m2l_flops
    return {
        "near_field_gflop": round(pair_flops / 1e9, 2),
        "m2l_gflop": round(m2l_flops / 1e9, 2),
        "achieved_gflop_s": round(total / med / 1e9, 1),
        "note": "modeled op counts over the median matvec time",
    }


def _per_pass_config2(tree, w_dev, prec, fused_ms, times_fn):
    """Per-pass ms table: upward and downward timed as separate chained
    dispatches; the leaf pass (P2P+M2P+L2P+unbucket) is the
    fused-program remainder — it has no standalone jitted entry point."""
    import jax.numpy as jnp

    from ferreus_rbf.ops.fmm import api

    dev, kp = tree._dev, tree.kernel_params
    mult, w_sorted = api._upward(dev, w_dev, prec=prec)
    _pull(mult)
    up_ms = times_fn(
        lambda x: api._upward(
            dev, w_dev * (1.0 + 1e-15 * jnp.ravel(x)[0]), prec=prec)[0],
        mult,
    )
    local = api._downward(dev, mult, w_sorted, kparams=kp, prec=prec)
    _pull(local)
    down_ms = times_fn(
        lambda x: api._downward(
            dev, mult * (1.0 + 1e-15 * jnp.ravel(x)[0]), w_sorted,
            kparams=kp, prec=prec),
        local,
    )
    return {
        "upward_p2m_m2m_ms": round(up_ms, 1),
        "downward_m2l_p2l_l2l_ms": round(down_ms, 1),
        "leaf_p2p_m2p_l2p_ms": round(max(fused_ms - up_ms - down_ms, 0.0), 1),
        "fused_total_ms": round(fused_ms, 1),
        "note": "leaf = fused - upward - downward (remainder of the single "
                "fused program; parts timed as chained separate dispatches)",
    }


def config2_matvec(extra):
    import jax.numpy as jnp

    from ferreus_rbf.config import FmmCompressionType, FmmParams
    from ferreus_rbf.ops.fmm.api import FmmTree
    from ferreus_rbf.ops.kernels import KernelParams, KernelType

    n, nrhs, p = 100_000, 8, 5
    rng = np.random.default_rng(42)
    pts = rng.random((n, 3))
    weights = rng.standard_normal((n, nrhs))
    params = FmmParams(interpolation_order=p, max_points_per_cell=256,
                       compression_type=FmmCompressionType.ACA, epsilon=10.0**-p)
    t0 = time.perf_counter()
    tree = FmmTree(pts, p, KernelParams(KernelType.LinearRbf),
                   adaptive_tree=False, sparse=True, params=params)
    tree.prepare_targets(pts, "src")
    extra["config2_plan_s"] = round(time.perf_counter() - t0, 2)
    w_dev = jnp.asarray(weights)

    out = {}
    K = 8  # matvecs per timed chain
    for prec, label in (("f32", "mixedprec"), ("f64", "f64grade")):
        t0 = time.perf_counter()
        _pull(tree.evaluate_device(w_dev, "src", precision=prec))
        extra[f"config2_first_dispatch_{label}_s"] = round(time.perf_counter() - t0, 2)
        # Throughput over a CHAIN of K device-resident matvecs with a
        # serialising data dependency, one sync per chain — exactly how
        # the fused solver issues them. The single-dispatch latency is
        # reported separately:
        lat = []
        for i in range(5):
            t0 = time.perf_counter()
            _pull(tree.evaluate_device(w_dev * (1.0 + 1e-15 * i), "src", precision=prec))
            lat.append(time.perf_counter() - t0)
        extra[f"config2_single_dispatch_ms_{label}"] = round(
            sorted(lat)[len(lat) // 2] * 1e3, 1)
        times = []
        for _rep in range(5):
            t0 = time.perf_counter()
            w = w_dev
            for _k in range(K):
                v = tree.evaluate_device(w, "src", precision=prec)
                w = w_dev * (1.0 + 1e-15 * v[0, 0])
            _pull(v)
            times.append((time.perf_counter() - t0) / K)
        times.sort()
        out[label] = n / times[len(times) // 2]

        def _chain_ms(fn, x0, K=K):
            reps = []
            for _rep in range(3):
                t0 = time.perf_counter()
                x = x0
                for _k in range(K):
                    x = fn(x)
                _pull(x)
                reps.append((time.perf_counter() - t0) / K)
            reps.sort()
            return reps[len(reps) // 2] * 1e3

        fused_ms = times[len(times) // 2] * 1e3
        extra[f"config2_per_pass_ms_{label}"] = _per_pass_config2(
            tree, w_dev, prec, fused_ms, _chain_ms)
        if prec == "f32":
            extra["modeled_flops"] = _modeled_flops_config2(
                tree, tree._target_cache["src"], n, nrhs, times)
    extra["fmm_matvec_pts_per_s_f64grade"] = round(out["f64grade"], 1)
    return out["mixedprec"]


def _oracle_check(rbfi, pred_at_source, vals, n_sample, seed=3):
    """Interpolant values vs a TRUE-f64 host oracle.

    Dense numpy-f64 evaluation (kernel block + nugget + polynomial drift —
    no FMM) at ``n_sample`` source points, compared to
    the framework's own FMM evaluation at the same points. Reports the max
    relative error against the 1e-8 north-star goal, plus the TRUE solution
    residual at the sample (independent of evaluator truncation).
    Reference tolerance semantics: ``iterative_solvers.rs:56-59,137-140``.
    """
    from ferreus_rbf.ops.kernels import make_kernel
    from ferreus_rbf.ops.polynomials import evaluate_monomials

    src = np.asarray(rbfi.points, np.float64)
    w = rbfi.coefficients.point_coefficients  # (n, 1)
    n = src.shape[0]
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(n, size=min(n_sample, n), replace=False))
    targets = src[idx]
    kernel = make_kernel(rbfi.interpolant_settings.kernel_params(), xp=np)
    chunk = max(1, int(2e7 // n))  # ~0.5 GB of f64 diffs per chunk
    oracle = np.concatenate([
        kernel.pair(targets[s : s + chunk], src) @ w
        for s in range(0, targets.shape[0], chunk)
    ])
    oracle = oracle + rbfi.interpolant_settings.nugget * w[idx]
    pc = rbfi.coefficients.poly_coefficients
    if pc is not None and pc.size:
        mon = evaluate_monomials(
            targets, rbfi.interpolant_settings.polynomial_degree, pc.shape[0],
            rbfi.translation_factor, rbfi.scale_factor)
        oracle = oracle + mon @ pc
    oracle = oracle.reshape(-1)
    scale = max(float(np.max(np.abs(oracle))), 1e-300)
    vals = np.asarray(vals, np.float64).reshape(-1)
    return {
        "n_sample": int(idx.size),
        "value_vs_f64_oracle": float(
            f"{np.max(np.abs(pred_at_source[idx] - oracle)) / scale:.3e}"),
        "true_residual_rel_max": float(
            f"{np.max(np.abs(oracle - vals[idx])) / max(np.max(np.abs(vals)), 1e-300):.3e}"),
        "note": "oracle = dense numpy-f64 kernel+drift eval of the fitted "
                "coefficients at a source subsample; value_vs_f64_oracle "
                "isolates evaluator (FMM) error, goal 1e-8; "
                "true_residual_rel_max is solution quality sans evaluator "
                "truncation (max-norm)",
    }


def _fit_config(extra, key, pts, vals, settings, check_tol, warm_fit=True,
                n_oracle=1024):
    """Shared fit-config runner.

    Reports the COLD fit wall-clock (includes all tracing/compiles not
    served by the persistent cache), a WARM re-fit at identical shapes
    (in-process program cache hit: the steady-state cost a production
    process pays), the compiled-program count, the solver's own l2-relative
    residual (``solver_residual_rel`` — the reference's stopping semantics,
    target 1e-6), the source residual through the FMM evaluator, the
    true-f64 oracle comparison, and the stall/escalation + m-step telemetry.
    ``max_residual_rel`` is the SOLVER residual re-evaluated through the
    FMM at the sources — it includes the evaluator's FMM truncation error,
    so it is an end-to-end figure, not the raw Krylov residual.
    """
    import ferreus_rbf as frt
    from ferreus_rbf.utils import telemetry

    n_prog0 = _program_count()
    tracer = telemetry.enable_global_tracer()
    t0 = time.perf_counter()
    rbfi = frt.RBFInterpolator(pts, vals, settings)
    fit_s = time.perf_counter() - t0  # raw wall-clock
    stage_totals = {k: round(v, 2) for k, v in tracer.totals.items()}
    events = list(tracer.events)
    telemetry.disable_global_tracer()
    # one-M-step diagnostic, OUTSIDE the timed fit (stashed by the solver;
    # all programs it dispatches are warm by now)
    m_step = None
    diag = getattr(rbfi, "m_step_diagnostic", None)
    if diag is not None:
        t0 = time.perf_counter()
        try:
            m_step = diag()
        except Exception as e:
            m_step = {"error": _clean_err(e)}
        stage_totals["m_step_diag"] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()
    pred = rbfi.evaluate_at_source(add_nugget=True)
    resid = float(np.max(np.abs(pred - np.asarray(vals).reshape(-1))))
    eval_s = time.perf_counter() - t0
    rel = resid / max(float(np.max(np.abs(vals))), 1e-300)
    solve_done = [e for e in events if e["event"] == "solve_done"]
    solver_res = solve_done[-1]["residual"] if solve_done else None
    entry = {
        "n": int(np.asarray(pts).shape[0]),
        "fit_cold_s": round(fit_s, 2),
        "eval_at_source_s": round(eval_s, 2),
        "n_programs": _program_count() - n_prog0,
        "solver_residual_rel": solver_res,
        "solver_converged": solve_done[-1]["converged"] if solve_done else None,
        "max_residual_rel": float(f"{rel:.3e}"),
        "residual_kind": "solver residual re-evaluated through FMM at sources "
                         "(max-norm incl. evaluator truncation); "
                         "solver_residual_rel is the l2 Krylov figure "
                         "(reference stopping semantics, target 1e-6)",
        "converged": bool(rel < check_tol),
        "fit_stages_s": stage_totals,
        "refinement_history": [
            {k: v for k, v in e.items() if k != "event"}
            for e in events if e["event"] == "refine_round"],
        "m_step": m_step,
    }
    stalls = [e for e in events if e["event"] == "stall_exit"]
    if stalls:
        entry["stall_exits"] = [
            {k: v for k, v in e.items() if k != "event"} for e in stalls]
    if n_oracle:
        t0 = time.perf_counter()
        entry["oracle"] = _oracle_check(rbfi, pred, vals, n_oracle)
        entry["oracle"]["oracle_s"] = round(time.perf_counter() - t0, 1)
    if warm_fit:
        t0 = time.perf_counter()
        frt.RBFInterpolator(pts, vals, settings)
        entry["fit_warm_s"] = round(time.perf_counter() - t0, 2)
    extra[key] = entry
    return rbfi


def config1_tps2d(extra):
    import ferreus_rbf as frt

    pts = frt.generate_random_points(10_000, 2, seed=7)
    vals = frt.RBFTestFunctions.franke_2d(pts)
    s = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.ThinPlateSpline)
    _fit_config(extra, "config1_tps_2d_10k", pts, vals, s, 1e-4)


def config3_albatite(extra):
    import ferreus_rbf as frt

    csv = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "datasets", "albatite_SD_points.csv")
    pts, vals = frt.csv_to_point_arrays(csv, has_headers=True)
    span = float(np.max(pts.max(axis=0) - pts.min(axis=0)))
    # same settings as examples/isosurface_spheroidal.py
    s = frt.InterpolantSettings(
        kernel_type=frt.RBFKernelType.Spheroidal,
        spheroidal_order=frt.SpheroidalOrder.Five,
        base_range=span / 4.0, total_sill=span / 4.0,
    )
    _fit_config(extra, "config3_albatite_fit", pts, np.asarray(vals).reshape(-1), s, 1e-4)


def config2_gradients(extra):
    """f64 gradient evaluation vs value-only throughput.

    100k adaptive-tree Spheroidal5 evaluation (accuracy against the dense
    kernel sum is asserted in tests/test_fmm.py)."""
    import jax.numpy as jnp

    from ferreus_rbf.ops.fmm.api import FmmTree
    from ferreus_rbf.ops.kernels import KernelParams, KernelType

    n = 100_000
    rng = np.random.default_rng(7)
    pts = rng.random((n, 3))
    w = jnp.asarray(rng.standard_normal((n, 2)))
    kp = KernelParams(KernelType.Spheroidal5Rbf, base_range=1.2, total_sill=0.9)
    tree = FmmTree(pts, 5, kp, adaptive_tree=True, sparse=True)
    tree.set_weights(np.asarray(w))

    def _med(fn, reps=5):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        ts.sort()
        return ts[len(ts) // 2]

    tree.evaluate_with_gradients(w, pts, reuse_key="src")  # warm
    grad_s = _med(lambda: tree.evaluate_with_gradients(w, pts, reuse_key="src"))
    tree.evaluate(w, pts, reuse_key="src")  # warm
    val_s = _med(lambda: tree.evaluate(w, pts, reuse_key="src"))
    extra["config2_gradient_tier"] = {
        "n": n,
        "grad_pts_per_s": round(n / grad_s, 1),
        "val_pts_per_s": round(n / val_s, 1),
        "grad_over_val": round(grad_s / val_s, 2),
        "note": "host-returning eval incl. device->host pull; adaptive tree, "
                "Spheroidal5, 2 RHS, f64",
    }


def _synthetic_sd(n, seed=11):
    """Signed-distance-style samples in a volumetric shell around a bumpy
    unit sphere (zero level = the bumpy sphere). Radii are CONTINUOUS:
    discrete shells (r1/r2 used {0.8, 1.0, 1.2}) collapse the point
    spacing onto three parallel surfaces, and at 3M points the biharmonic
    system becomes so stiff the f32-preconditioned solver stagnates —
    volumetric sampling is both better conditioned and closer to how SDF
    inputs are actually collected (on- plus off-surface samples)."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    bump = 1.0 + 0.15 * np.sin(4 * dirs[:, 0]) * np.cos(3 * dirs[:, 1])
    radii = 0.7 + 0.6 * rng.random(n)
    pts = dirs * (bump * radii)[:, None]
    sd = (radii - 1.0) * bump
    return pts, sd


def config4_million(extra):
    import ferreus_rbf as frt

    pts, sd = _synthetic_sd(1_000_000)
    s = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    _fit_config(extra, "config4_1m_biharmonic_fit", pts, sd, s, 1e-4, warm_fit=False)


def config4_error_budget(extra):
    """Truncation-vs-precision attribution at 200k.

    Runs the ops.fmm.diagnostics sweep on the config-4 point distribution:
    p in {5,7,9} x {f64, f32}, every variant against one dense numpy-f64
    oracle. Decides whether the at-scale oracle gap is Chebyshev truncation
    (shared with the reference) or arithmetic precision."""
    from ferreus_rbf.ops.fmm.diagnostics import fmm_error_budget
    from ferreus_rbf.ops.kernels import KernelParams, KernelType

    n = 200_000
    pts, _sd = _synthetic_sd(n)
    rng = np.random.default_rng(9)
    w = rng.standard_normal((n, 1))
    budget = fmm_error_budget(pts, w, KernelParams(KernelType.LinearRbf),
                              orders=(5, 7, 9), n_sample=256)
    extra["error_budget_full"] = budget
    by = {(e["p"], e["prec"]): e["err"] for e in budget["entries"]}
    extra["error_budget_c4"] = {
        **{f"p{p}": [by.get((p, "f64")), by.get((p, "f32"))]
           for p in (5, 7, 9)},
        "order": "[f64,f32]",
        "verdict": budget["verdict"],
    }


def config5_3m_rmt(extra):
    """3M fit + RMT isosurface of the fitted signed distance."""
    import ferreus_rbf as frt

    pts, sd = _synthetic_sd(3_000_000)
    s = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    rbfi = _fit_config(extra, "config5_3m_fit", pts, sd, s, 1e-3,
                       warm_fit=False, n_oracle=512)
    t0 = time.perf_counter()
    mesh = rbfi.build_isosurface([-1.4, -1.4, -1.4, 1.4, 1.4, 1.4], 0.02, 0.0,
                                 frt.BoundaryClosure.None_)
    extra["config5_3m_fit"]["rmt_s"] = round(time.perf_counter() - t0, 2)
    extra["config5_3m_fit"]["mesh_vertices"] = int(mesh.num_vertices)
    extra["config5_3m_fit"]["mesh_facets"] = int(mesh.num_facets)


class _State:
    """Cumulative bench state, emittable at any instant."""

    def __init__(self, device=None):
        self.headline = None
        self.extra = {"budget_s": BUDGET, "device": device, "measurement": (
            "headline = median over 5 chains of 8 serialised device-resident "
            "matvecs, one sync per chain (the fused solver's issue "
            "pattern); single-dispatch latency is in "
            "config2_single_dispatch_ms_*"), "baseline_anchor": {
            "pts_per_s": BASELINE_PTS_PER_S,
            "provenance": "derived v3: MEASURED compiled C++ 1-core fused P2P "
                          "2.1e8 pairs/s (native/p2p_proxy.cpp, -O3 -march=native) "
                          "x64 cores x0.7 scaling (assumed); band [8e5, 2.6e6]; "
                          "see bench.py docstring + BASELINE.md v3",
        }}

    def _full(self):
        self.extra["elapsed_s"] = round(time.perf_counter() - _T0, 1)
        return {
            "metric": "fmm_matvec_pts_per_s_100k_p5_rhs8_mixedprec",
            "value": round(self.headline, 1) if self.headline else None,
            "unit": "pts/s",
            "vs_baseline": round(self.headline / BASELINE_PTS_PER_S, 3)
                           if self.headline else None,
            "extra": self.extra,
        }

    def compact(self):
        """Compact driver summary: MUST serialise under ~1,500 bytes.

        A reader that keeps only a 2,000-byte tail of stdout parses the
        LAST JSON line in it; a cumulative line of ~8 KB would be truncated
        mid-string. The full detail line is printed one line earlier and
        mirrored to ``DETAIL_PATH`` for humans."""
        x = self.extra
        cfgs = {}
        for key, short in (("config1_tps_2d_10k", "c1_10k"),
                           ("config3_albatite_fit", "c3_alb"),
                           ("config4_1m_biharmonic_fit", "c4_1m"),
                           ("config5_3m_fit", "c5_3m")):
            e = x.get(key)
            if not isinstance(e, dict):
                continue
            c = {"cold_s": e.get("fit_cold_s"),
                 "res_l2": e.get("solver_residual_rel"),
                 "res_max": e.get("max_residual_rel"),
                 "conv": e.get("converged")}
            if "fit_warm_s" in e:
                c["warm_s"] = e["fit_warm_s"]
            o = e.get("oracle") or {}
            if "value_vs_f64_oracle" in o:
                c["oracle"] = o["value_vs_f64_oracle"]
                c["true_res_max"] = o.get("true_residual_rel_max")
            for k_src, k_dst in (("rmt_s", "rmt_s"), ("mesh_vertices", "verts"),
                                 ("mesh_facets", "facets")):
                if k_src in e:
                    c[k_dst] = e[k_src]
            cfgs[short] = c
        out = {
            "f64grade_pts_per_s": x.get("fmm_matvec_pts_per_s_f64grade"),
            "grad_pts_per_s": (x.get("config2_gradient_tier") or {}).get(
                "grad_pts_per_s"),
            "configs": cfgs,
            "elapsed_s": x.get("elapsed_s"),
            "device": x.get("device"),
        }
        if "scaling_sp_matvec_ms" in x:
            out["scaling_sp_matvec_ms"] = x["scaling_sp_matvec_ms"]
        if "error_budget_c4" in x:
            out["error_budget_c4"] = x["error_budget_c4"]
        errs = {k[:-6]: _clean_err(v) for k, v in x.items()
                if k.endswith("_error")}
        skips = {k[:-8]: _clean_err(v, 60) for k, v in x.items()
                 if k.endswith("_skipped")}
        if errs:
            out["errors"] = errs
        if skips:
            out["skipped"] = skips
        if "killed_by" in x:
            out["killed_by"] = x["killed_by"]
        line = {
            "metric": "fmm_matvec_pts_per_s_100k_p5_rhs8_mixedprec",
            "value": round(self.headline, 1) if self.headline else None,
            "unit": "pts/s",
            "vs_baseline": round(self.headline / BASELINE_PTS_PER_S, 3)
                           if self.headline else None,
            "extra": out,
        }
        # hard cap: drop optional blocks largest-first until it fits a
        # 2,000-byte tail with margin
        drop_order = ["error_budget_c4", "scaling_sp_matvec_ms", "errors",
                      "skipped", "configs"]
        s = json.dumps(line, separators=(",", ":"))
        while len(s) > 1900 and drop_order:
            out.pop(drop_order.pop(0), None)
            s = json.dumps(line, separators=(",", ":"))
        return s

    def emit(self):
        """Emit cumulative state: the FULL detail line first (humans +
        ``DETAIL_PATH``), then the COMPACT line LAST. Re-printed after every
        config so a mid-config kill loses only the in-flight config."""
        full = self._full()
        print(json.dumps(full), flush=True)
        try:
            os.makedirs(os.path.dirname(DETAIL_PATH), exist_ok=True)
            with open(DETAIL_PATH, "w") as f:
                json.dump(full, f, indent=1)
        except OSError:
            pass
        print(self.compact(), flush=True)


def main():
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {jax.default_backend()!r}")
    state = _State(device_tag())
    extra = state.extra

    def _on_signal(signum, frame):
        extra["killed_by"] = signal.Signals(signum).name
        state.emit()
        sys.stdout.flush()
        os._exit(124 if signum == signal.SIGALRM else 143)

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    # Self-imposed deadline 45 s before the budget: dump the cumulative line
    # even if a config is stuck inside a single long XLA compile/dispatch
    # (Python-level budget checks can't interrupt those).
    signal.signal(signal.SIGALRM, _on_signal)
    signal.alarm(max(int(BUDGET) - 45, 60))

    # Cheap configs run first (~20 min incl. headline, warm-cached), then
    # the two at-scale fits: config 4 before config 5, which gets
    # everything left — the 3M fit + RMT is the longest single config and
    # must not starve the rest (it did in r1/r2 when ordered differently).
    steps = [
        ("headline", lambda: config2_matvec(extra), 300),
        ("config3", lambda: config3_albatite(extra), 300),
        ("config1", lambda: config1_tps2d(extra), 200),
        ("gradients", lambda: config2_gradients(extra), 250),
        ("errbudget", lambda: config4_error_budget(extra), 300),
        ("config4", lambda: config4_million(extra), 600),
        ("config5", lambda: config5_3m_rmt(extra), 600),
    ]
    import gc

    for name, fn, need in steps:
        # drop the previous config's device buffers (tree tables, Schwarz
        # factors) before the next one sizes itself to the device —
        # reference cycles otherwise keep them alive into the at-scale
        # configs
        gc.collect()
        if budget_left() < need:
            extra[f"{name}_skipped"] = f"budget ({budget_left():.0f}s left < {need}s)"
            state.emit()
            continue
        try:
            r = fn()
            if name == "headline":
                state.headline = r
        except Exception as e:  # record, keep going
            extra[f"{name}_error"] = _clean_err(e, 600)
        state.emit()

    signal.alarm(0)
    state.emit()


if __name__ == "__main__":
    main()
