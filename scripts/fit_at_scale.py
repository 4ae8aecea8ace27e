"""At-scale fit: one N-point fit with full forensics.

Reports fit wall-clock, stage split, solver residual, peak device memory,
and a TRUE-f64 dense-oracle residual at a source subsample (independent of
the FMM evaluator's truncation).

Usage:
    python scripts/fit_at_scale.py 10000000
    python scripts/fit_at_scale.py 1000000 --order 9

Prints one JSON line at the end. Scale claim of the reference: its
README ("millions of points").
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _hbm_stats():
    import jax

    try:
        s = jax.local_devices()[0].memory_stats() or {}
        return {
            "peak_hbm_gb": round(s.get("peak_bytes_in_use", 0) / 2**30, 2),
            "hbm_in_use_gb": round(s.get("bytes_in_use", 0) / 2**30, 2),
            "hbm_limit_gb": round(s.get("bytes_limit", 0) / 2**30, 2),
        }
    except Exception as e:  # a backend may not expose memory_stats
        return {"memory_stats_error": f"{type(e).__name__}: {e}"[:120]}


def _dense_oracle_residual(rbfi, vals, n_sample=512, seed=3):
    """TRUE-f64 residual at a source subsample: dense numpy kernel block +
    nugget + drift of the fitted coefficients vs the input data. No FMM —
    solution quality independent of evaluator truncation."""
    from ferreus_rbf.ops.kernels import make_kernel
    from ferreus_rbf.ops.polynomials import evaluate_monomials

    src = np.asarray(rbfi.points, np.float64)
    w = rbfi.coefficients.point_coefficients
    n = src.shape[0]
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(n, size=min(n_sample, n), replace=False))
    targets = src[idx]
    kernel = make_kernel(rbfi.interpolant_settings.kernel_params(), xp=np)
    chunk = max(1, int(2e7 // n))
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
    vals = np.asarray(vals, np.float64).reshape(-1)
    return {
        "n_sample": int(idx.size),
        "true_residual_rel_max": float(
            f"{np.max(np.abs(oracle - vals[idx])) / np.max(np.abs(vals)):.3e}"),
        "idx": idx,
        "oracle": oracle,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, help="number of points")
    ap.add_argument("--order", type=int, default=None,
                    help="FMM interpolation order override (default: kernel default)")
    ap.add_argument("--oracle-sample", type=int, default=512)
    ap.add_argument("--fmm-check", action="store_true",
                    help="also evaluate the FMM evaluator at the oracle subsample "
                         "(adds value_vs_f64_oracle; compiles a fresh eval tree)")
    ap.add_argument("--rmt", action="store_true",
                    help="extract the zero isosurface after the fit (driver "
                         "config-5 semantics: res 0.02, extents +-1.4, no "
                         "boundary closure) and report mesh counts")
    ap.add_argument("--save-model", metavar="PATH", default=None,
                    help="save the fitted model JSON (lets later processes "
                         "evaluate/isosurface without refitting)")
    ap.add_argument("--eval-chunk", type=int, default=None,
                    help="FmmParams.eval_chunk_size override: linearly "
                         "scales the leaf-pass transient budgets (memory vs "
                         "step count; default 1024)")
    ap.add_argument("--progress", action="store_true",
                    help="print solver iteration residuals as they happen "
                         "(evidence of convergence even if the run is cut)")
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from bench import _synthetic_sd

    import ferreus_rbf as frt
    from ferreus_rbf.config import FmmCompressionType, FmmParams, Params
    from ferreus_rbf.utils import telemetry

    n = args.n
    print(f"[fit_at_scale] generating {n:,} synthetic SD points", flush=True)
    pts, sd = _synthetic_sd(n)
    s = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    params = None
    if args.order is not None or args.eval_chunk is not None:
        from ferreus_rbf.config import get_default_fmm_interpolation_order

        order = args.order or get_default_fmm_interpolation_order(
            frt.RBFKernelType.Linear)
        params = Params(fmm_params=FmmParams(
            interpolation_order=order, max_points_per_cell=256,
            compression_type=FmmCompressionType.ACA, epsilon=10.0 ** -order,
            eval_chunk_size=args.eval_chunk or 1024))

    out = {"n": n, "order": args.order or "default",
           "kernel": "Linear (biharmonic)"}
    progress = None
    if args.progress:
        t_start = time.perf_counter()

        def _cb(msg):
            print(f"[fit_at_scale +{time.perf_counter() - t_start:7.1f}s] "
                  f"{msg}", flush=True)

        progress = frt.Progress(_cb)
    tracer = telemetry.enable_global_tracer()
    t0 = time.perf_counter()
    rbfi = (frt.RBFInterpolator(pts, sd, s, params, progress_callback=progress)
            if params is not None
            else frt.RBFInterpolator(pts, sd, s, progress_callback=progress))
    out["fit_s"] = round(time.perf_counter() - t0, 1)
    out["fit_stages_s"] = {k: round(v, 1) for k, v in tracer.totals.items()}
    events = list(tracer.events)
    telemetry.disable_global_tracer()
    solve_done = [e for e in events if e["event"] == "solve_done"]
    if solve_done:
        out["solver_residual_rel"] = solve_done[-1]["residual"]
        out["solver_converged"] = solve_done[-1]["converged"]
    out["refinement_rounds"] = len(
        [e for e in events if e["event"] == "refine_round"])
    stalls = [e for e in events if e["event"] == "stall_exit"]
    if stalls:
        out["stall_exits"] = len(stalls)
    out.update(_hbm_stats())
    print(f"[fit_at_scale] fit done in {out['fit_s']} s; "
          f"solver residual {out.get('solver_residual_rel')}", flush=True)

    t0 = time.perf_counter()
    oc = _dense_oracle_residual(rbfi, sd, args.oracle_sample)
    out["oracle_s"] = round(time.perf_counter() - t0, 1)
    out["true_residual_rel_max"] = oc["true_residual_rel_max"]
    out["oracle_n_sample"] = oc["n_sample"]

    if args.fmm_check:
        t0 = time.perf_counter()
        pred = rbfi.evaluate(np.asarray(rbfi.points)[oc["idx"]]).reshape(-1)
        out["fmm_eval_s"] = round(time.perf_counter() - t0, 1)
        scale = float(np.max(np.abs(oc["oracle"])))
        out["value_vs_f64_oracle"] = float(
            f"{np.max(np.abs(pred - oc['oracle'])) / scale:.3e}")

    if args.save_model:
        t0 = time.perf_counter()
        rbfi.save_model(args.save_model)
        out["save_model_s"] = round(time.perf_counter() - t0, 1)

    if args.rmt:
        print("[fit_at_scale] extracting isosurface (res 0.02)", flush=True)
        t0 = time.perf_counter()
        mesh = rbfi.build_isosurface(
            [-1.4, -1.4, -1.4, 1.4, 1.4, 1.4], 0.02, 0.0,
            frt.BoundaryClosure.None_)
        out["rmt_s"] = round(time.perf_counter() - t0, 1)
        out["mesh_vertices"] = int(mesh.num_vertices)
        out["mesh_facets"] = int(mesh.num_facets)

    out.update({k: v for k, v in _hbm_stats().items() if "peak" in k})
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
