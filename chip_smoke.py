#!/usr/bin/env python3
"""Smoke run of the library's main path on one GPU.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --multi    # four GPUs: the sharded fit only

Phases (one JSON line each, tagged with the card's name and power limit):

1. device: JAX must run on a GPU; the device-derived memory budgets.
2. fit: ``RBFInterpolator`` on 1M signed-distance samples (3D biharmonic,
   default settings); solver residual, source residual through the FMM,
   value error against a dense f64 oracle, fit time, stage split, compiled
   program count, peak device memory.
3. evaluate: ``evaluate_with_gradients`` on a 64^3 grid against the dense
   f64 kernel sum on 2,048 grid points; ``save_model``/``load_model`` must
   give bitwise-equal ``evaluate``.
4. near field: the u-list near field of a 100k-point p=5 8-RHS tree, in
   both XLA forms and both precisions, against a numpy f64 direct sum on
   4,096 targets; device times and the near field's share of one fused
   matvec from a profiler trace.
5. isosurface: the albatite fit + ``build_isosurface``, and the unit-sphere
   golden mesh (540 vertices / 1,076 facets).

``--multi`` fits the phase-2 data on a 4-device mesh and compares it with a
one-device fit: one f64 FMM matvec (<= 1e-12 relative) and evaluations at
4,096 points (<= 10x the solver tolerance), plus one multi-RHS
preconditioned step sharded over ("sp", "rhs").

Exits non-zero, printing no result, when JAX finds no GPU. Any failed check
exits non-zero. The last line is ``{"ok": true, "device": {...}}``.
Longer artifacts (trace summaries) go to ``chiprun_out/``.
"""

from __future__ import annotations

import argparse
import gc
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out")
TMP = os.path.join(ROOT, ".smoke_tmp")

CARD = None
FAILED = []


def card_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields, "card": CARD}, default=float),
          flush=True)


def check(results, name, value, limit, ok=None):
    """Record ``value <= limit`` (or an explicit ``ok``) under ``name``."""
    ok = bool(value <= limit) if ok is None else bool(ok)
    results[name] = {"value": value, "limit": limit, "ok": ok}
    if not ok:
        FAILED.append(name)
    return ok


def median_time(fn, reps=5):
    """Median wall time of ``fn()`` (which must block until done)."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def peak_bytes():
    import jax

    return int((jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", -1))


# ------------------------------------------------------------------ phases
def phase_device():
    import jax

    from ferreus_rbf.utils import memory

    d = jax.devices()[0]
    emit("device", platform=d.platform, kind=d.device_kind,
         count=len(jax.devices()), jax=jax.__version__,
         bytes_limit=memory.device_bytes_limit(),
         ddm_factor_budget_bytes=memory.ddm_factor_budget_bytes(),
         fused_factor_budget_bytes=memory.fused_factor_budget_bytes())


def phase_fit(n):
    import bench
    import ferreus_rbf as frt

    pts, sd = bench._synthetic_sd(n)
    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    extra = {}
    rbfi = bench._fit_config(extra, "fit", pts, sd, settings, 1e-4,
                             warm_fit=False, n_oracle=1024)
    e = extra["fit"]
    res = {}
    check(res, "solver_residual_rel", e["solver_residual_rel"], 1e-6)
    check(res, "source_residual_rel_max", e["max_residual_rel"], 1e-4)
    emit("fit", n=n, fit_s=e["fit_cold_s"], eval_at_source_s=e["eval_at_source_s"],
         n_programs=e["n_programs"], stages_s=e["fit_stages_s"],
         value_vs_f64_oracle=e["oracle"]["value_vs_f64_oracle"],
         refinement=e["refinement_history"], peak_bytes_in_use=peak_bytes(),
         checks=res)
    return rbfi


def _dense_reference(rbfi, targets):
    """Dense f64 kernel sum (values, gradients) at ``targets`` plus the
    drift, and the sums of absolute terms that bound the FMM's truncation:
    sum_j |c_j| |phi(x - s_j)| and the same for each gradient component."""
    import jax
    import jax.numpy as jnp

    from ferreus_rbf.ops import polynomials
    from ferreus_rbf.ops.kernels import make_kernel

    kernel = make_kernel(rbfi.interpolant_settings.kernel_params())
    src = jnp.asarray(rbfi.points)
    c = jnp.asarray(rbfi.coefficients.point_coefficients[:, 0])

    @jax.jit
    def block(t):
        k, g = kernel.pair_with_grad(t, src)  # (m, n), (m, n, d)
        return (k @ c, jnp.einsum("mnd,n->md", g, c),
                jnp.abs(k) @ jnp.abs(c), jnp.einsum("mnd,n->md", jnp.abs(g), jnp.abs(c)))

    outs = [block(jnp.asarray(targets[i:i + 16])) for i in range(0, len(targets), 16)]
    v, g, sv, sg = (np.concatenate([np.asarray(o[k]) for o in outs]) for k in range(4))
    s = rbfi.interpolant_settings
    if s.basis_size:
        pc = rbfi.coefficients.poly_coefficients
        v = v + (polynomials.evaluate_monomials(
            targets, s.polynomial_degree, s.basis_size, rbfi.translation_factor,
            rbfi.scale_factor) @ pc)[:, 0]
        g = g + polynomials.evaluate_monomial_gradients(
            targets, pc, s.polynomial_degree, rbfi.translation_factor,
            rbfi.scale_factor)
    return v, g, sv, sg


def phase_evaluate(rbfi):
    import ferreus_rbf as frt

    pts = rbfi.points
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    grid = frt.create_evaluation_grid(list(zip(lo, hi)), [64, 64, 64])
    t0 = time.perf_counter()
    vals, grads = rbfi.evaluate_with_gradients(grid)
    eval_s = time.perf_counter() - t0
    vals = np.asarray(vals).reshape(-1)
    grads = np.asarray(grads)
    res = {}
    check(res, "grid_shapes", 0, 0, ok=vals.shape == (grid.shape[0],)
          and grads.shape == (grid.shape[0], 3)
          and np.all(np.isfinite(vals)) and np.all(np.isfinite(grads)))

    idx = np.sort(np.random.default_rng(5).choice(grid.shape[0], 2048, replace=False))
    rv, rg, sv, sg = _dense_reference(rbfi, grid[idx])
    fp = rbfi.params.fmm_params
    eps = fp.epsilon
    # FMM truncation bounds each sum relative to its absolute terms. The
    # gradients differentiate degree-(p-1) Chebyshev interpolants, and
    # Markov's inequality lets a derivative grow an interpolation error by
    # up to (p-1)^2: their bound is the values' times (p-1)^2.
    err_v = float(np.max(np.abs(vals[idx] - rv) / sv))
    err_g = float(np.max(np.abs(grads[idx] - rg) / sg))
    check(res, "values_vs_dense_over_abs_sum", err_v, 10 * eps)
    check(res, "gradients_vs_dense_over_abs_sum", err_g,
          10 * eps * (fp.interpolation_order - 1) ** 2)

    sub = grid[idx]
    before = np.asarray(rbfi.evaluate(sub))
    again = np.asarray(rbfi.evaluate(sub))
    os.makedirs(TMP, exist_ok=True)
    path = os.path.join(TMP, "model.json")
    rbfi.save_model(path)
    loaded = frt.RBFInterpolator.load_model(path)
    after = np.asarray(loaded.evaluate(sub))
    shutil.rmtree(TMP, ignore_errors=True)
    check(res, "repeat_evaluate_bitwise", 0, 0, ok=np.array_equal(before, again))
    check(res, "save_load_evaluate_bitwise", 0, 0, ok=np.array_equal(before, after))
    emit("evaluate", grid=int(grid.shape[0]), eval_with_gradients_s=eval_s,
         values_rel_to_max=float(np.max(np.abs(vals[idx] - rv)) / np.max(np.abs(rv))),
         gradients_rel_to_max=float(np.max(np.abs(grads[idx] - rg)) / np.max(np.abs(rg))),
         save_load_max_abs_diff=float(np.max(np.abs(before - after))),
         epsilon=eps, peak_bytes_in_use=peak_bytes(), checks=res)


def _hlo_scopes(hlo_text):
    """HLO instruction name -> op_name metadata (carries named scopes)."""
    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')
    out = {}
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def _trace_scope_share(fn, args, scopes, tag):
    """Run ``fn(*args)`` once under the profiler and attribute device
    kernel time to named scopes through the compiled HLO's metadata.

    The program is compiled for this run with XLA's command buffers (CUDA
    graphs) off: inside a command buffer the trace shows one event for all
    kernels, which no scope can be read from. ``graphs_off_s`` is that
    program's time, to set beside the normal one.
    Returns {scope: seconds, "device_busy_s", "window_s", "unattributed_s"}."""
    import jax

    fn = fn.lower(*args).compile(
        compiler_options={"xla_gpu_enable_command_buffer": ""})
    names = _hlo_scopes(fn.as_text())
    graphs_off_s = median_time(lambda: fn(*args).block_until_ready())
    tdir = os.path.join(OUT, f"trace_{tag}")
    shutil.rmtree(tdir, ignore_errors=True)
    t0 = time.perf_counter()
    with jax.profiler.trace(tdir):
        fn(*args).block_until_ready()
    window = time.perf_counter() - t0
    pb = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"), recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(pb)
    per = {s: 0.0 for s in scopes}
    total, unattr, intervals, top = 0.0, 0.0, [], {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                if op is None:
                    continue
                dur = ev.duration_ns * 1e-9
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                total += dur
                scope = names.get(str(op), "")
                hit = [s for s in scopes if f"/{s}/" in scope + "/"]
                if hit:
                    per[hit[0]] += dur
                else:
                    unattr += dur
                top[str(op)] = top.get(str(op), 0.0) + dur
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    with open(os.path.join(OUT, f"trace_{tag}_top.json"), "w") as f:
        json.dump(sorted(top.items(), key=lambda kv: -kv[1])[:40], f, indent=1)
    shutil.rmtree(tdir, ignore_errors=True)
    span = (max(b for _, b in intervals) - min(a for a, _ in intervals)) * 1e-9
    return {**{k: v for k, v in per.items()}, "kernel_sum_s": total,
            "device_busy_s": busy * 1e-9, "device_span_s": span,
            "idle_share_of_span": 1.0 - busy * 1e-9 / max(span, 1e-30),
            "window_s": window, "unattributed_s": unattr,
            "graphs_off_s": graphs_off_s}


def phase_near_field(n=100_000):
    import jax
    import jax.numpy as jnp

    from ferreus_rbf.config import FmmCompressionType, FmmParams
    from ferreus_rbf.ops.fmm import api as fmm_api
    from ferreus_rbf.ops.fmm.diagnostics import near_field_reference
    from ferreus_rbf.ops.kernels import KernelParams, KernelType

    nrhs, p = 8, 5  # bench.py config 2 (n = 100k)
    rng = np.random.default_rng(42)
    pts = rng.random((n, 3))
    w = jnp.asarray(rng.standard_normal((n, nrhs)))
    params = FmmParams(interpolation_order=p, max_points_per_cell=256,
                       compression_type=FmmCompressionType.ACA, epsilon=10.0**-p)
    tree = fmm_api.FmmTree(pts, p, KernelParams(KernelType.LinearRbf),
                           adaptive_tree=False, sparse=True, params=params)
    tree.prepare_targets(pts, "src")
    idx = np.sort(rng.choice(n, 4096, replace=False))
    ref = near_field_reference(tree, np.asarray(w), pts[idx])
    scale = float(np.max(np.abs(ref)))
    tol = {"f64": 1e-12, "f32": 1e-5}
    res, times = {}, {}
    for prec in ("f64", "f32"):
        for form in ("rows", "tiles"):
            fn = lambda: tree.near_field_device(w, "src", prec, form).block_until_ready()
            got = np.asarray(fn())
            check(res, f"near_{form}_{prec}_rel",
                  float(np.max(np.abs(got[idx] - ref)) / scale), tol[prec])
            times[f"near_{form}_{prec}_s"] = median_time(fn)
        times[f"matvec_{prec}_s"] = median_time(
            lambda: tree.evaluate_device(w, "src", prec).block_until_ready())

    binned = tree._ensure_scan_tables(tree._target_cache["src"])
    shares = {}
    for prec in ("f32", "f64"):
        fused = jax.jit(lambda wd, prec=prec: fmm_api._matvec_fused(
            tree._dev, wd, binned["targets_pad"], binned["tgt_idx"],
            binned["tgt_mask"], binned["tcells"], binned["p2p_groups"],
            binned["m2p_groups"], binned["inv_row"], binned["inv_slot"],
            kparams=tree.kernel_params, d=3, p=p, n_pad=binned["n_pad"],
            p2p_meta=binned["p2p_meta"], m2p_meta=binned["m2p_meta"], prec=prec,
            ecs=int(tree.params.eval_chunk_size))[0])
        try:
            sh = _trace_scope_share(fused, (w,), ("upward", "downward", "l2p",
                                                 "p2p", "m2p"), f"matvec_{prec}")
            sh["p2p_share_of_kernel_time"] = sh["p2p"] / max(sh["kernel_sum_s"], 1e-30)
        except Exception as exc:  # the trace is a measurement, not a check
            sh = {"error": f"{type(exc).__name__}: {exc}"[:300]}
        shares[prec] = sh
    emit("near_field", n=n, p=p, nrhs=nrhs, n_check=int(idx.size),
         times_s=times, trace=shares, peak_bytes_in_use=peak_bytes(), checks=res)


def phase_isosurface():
    import ferreus_rbf as frt
    from ferreus_rbf.isosurfacing import BoundaryClosure, ClusterMethod
    from ferreus_rbf.rmt.isosurface import build_isosurface

    res = {}
    points, values = frt.csv_to_point_arrays(
        os.path.join(ROOT, "datasets", "albatite_SD_points.csv"), has_headers=True)
    values = np.asarray(values).reshape(-1)
    extents = np.concatenate([points.min(axis=0), points.max(axis=0)])
    span = float(np.max(extents[3:] - extents[:3]))
    settings = frt.InterpolantSettings(
        kernel_type=frt.RBFKernelType.Spheroidal,
        spheroidal_order=frt.SpheroidalOrder.Five,
        base_range=span / 4.0, total_sill=span / 4.0,
    )
    t0 = time.perf_counter()
    rbfi = frt.RBFInterpolator(points, values, settings)
    fit_s = time.perf_counter() - t0
    resid = float(np.max(np.abs(np.asarray(rbfi.evaluate_at_source(True)).reshape(-1)
                                - values)) / np.max(np.abs(values)))
    check(res, "albatite_source_residual_rel_max", resid, 1e-4)
    t0 = time.perf_counter()
    mesh = rbfi.build_isosurface(extents, span / 100.0, 0.0, frt.BoundaryClosure.None_)
    iso_s = time.perf_counter() - t0
    edges = {}
    for tri in np.asarray(mesh.facets):
        for a, b in ((tri[0], tri[1]), (tri[1], tri[2]), (tri[2], tri[0])):
            k = (min(a, b), max(a, b))
            edges[k] = edges.get(k, 0) + 1
    counts = np.array(list(edges.values()))
    check(res, "albatite_mesh_nonempty", 0, 0, ok=mesh.num_facets > 0)
    check(res, "albatite_edges_manifold", 0, 0, ok=bool(np.all(counts <= 2)))

    def sphere_sdf(p):
        return np.linalg.norm(p, axis=1, keepdims=True) - 1.0

    def sphere_grad(p):
        r = np.linalg.norm(p, axis=1, keepdims=True)
        return r - 1.0, p / np.maximum(r, 1e-12)

    golden = build_isosurface(np.array([[1.0, 0.0, 0.0]]), [-1.5] * 3 + [1.5] * 3,
                              0.2, 0.0, sphere_sdf, sphere_grad,
                              ClusterMethod.CurvatureWeighted, BoundaryClosure.None_)
    check(res, "sphere_540_1076", 0, 0,
          ok=(golden.num_vertices, golden.num_facets) == (540, 1076))
    emit("isosurface", albatite_n=int(points.shape[0]), albatite_fit_s=fit_s,
         isosurface_s=iso_s, vertices=int(mesh.num_vertices),
         facets=int(mesh.num_facets), closed=bool(np.all(counts == 2)),
         boundary_edges=int(np.sum(counts == 1)),
         sphere=[int(golden.num_vertices), int(golden.num_facets)], checks=res)


def run_multi(n):
    """Phase-2 data on a 4-device mesh against one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bench
    import ferreus_rbf as frt
    from ferreus_rbf.ops.fmm.api import FmmTree
    from ferreus_rbf.parallel import make_mesh, use_mesh
    from ferreus_rbf.solver.iterative import DeviceSystem
    from ferreus_rbf.utils import common

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--multi needs 4 GPUs, found {len(jax.devices())}")
    pts, sd = bench._synthetic_sd(n)
    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    res = {}

    t0 = time.perf_counter()
    fit1 = frt.RBFInterpolator(pts, sd, settings)
    fit1_s = time.perf_counter() - t0
    mesh = make_mesh(4, ("sp",))
    t0 = time.perf_counter()
    with use_mesh(mesh):
        fit4 = frt.RBFInterpolator(pts, sd, settings)
    fit4_s = time.perf_counter() - t0

    # one f64 FMM matvec at the sources, sharded against unsharded, with
    # the same weights
    c = fit1.coefficients.point_coefficients
    fp = fit1.params.fmm_params
    tree1 = FmmTree(fit1.points, fp.interpolation_order,
                    settings.kernel_params(), adaptive_tree=True, sparse=True,
                    params=fp)
    tree1.prepare_targets(fit1.points, "src")
    with use_mesh(mesh):
        tree4 = FmmTree(fit1.points, fp.interpolation_order,
                        settings.kernel_params(), adaptive_tree=True,
                        sparse=True, params=fp)
    tree4.prepare_targets(fit1.points, "src")
    w = jnp.asarray(c)
    v1 = np.asarray(tree1.evaluate_device(w, "src", "f64"))
    v4_dev = tree4.evaluate_device(w, "src", "f64")
    v4 = np.asarray(v4_dev)
    check(res, "matvec_f64_sharded_vs_one_rel",
          float(np.max(np.abs(v4 - v1)) / np.max(np.abs(v1))), 1e-12)
    check(res, "matvec_ran_sharded", 0, 0,
          ok="nbr_tab" in tree4._target_cache["src"] and tree4._mesh is not None)
    mult_devs = {d.id for d in tree4._multipole.sharding.device_set}
    check(res, "matvec_on_4_devices", 0, 0, ok=len(mult_devs) == 4)

    rng = np.random.default_rng(8)
    targets = pts[rng.choice(pts.shape[0], 4096, replace=False)] * 0.97
    e1 = np.asarray(fit1.evaluate(targets)).reshape(-1)
    e4 = np.asarray(fit4.evaluate(targets)).reshape(-1)
    tol = settings.fitting_accuracy.tolerance
    check(res, "evaluate_sharded_vs_one_rel",
          float(np.max(np.abs(e4 - e1)) / np.max(np.abs(e1))), 10 * tol)

    # one multi-RHS preconditioned step sharded over ("sp", "rhs")
    mesh2 = make_mesh(4, ("sp", "rhs"))
    nrhs = int(mesh2.shape["rhs"])
    vals = np.stack([sd * (1.0 + 0.1 * k) for k in range(nrhs)], axis=1)
    with use_mesh(mesh2):
        rbfi2 = frt.RBFInterpolator(pts, vals, settings, _skip_solve=True)
        rbfi2.translation_factor, rbfi2.scale_factor = (
            common.get_cheb_cube_scaling_factors(rbfi2.points))
        system = DeviceSystem(rbfi2)
        m = system.m
        rhs_sharding = NamedSharding(mesh2, P(None, "rhs"))
        b = jax.device_put(jnp.asarray(np.concatenate(
            [vals, np.zeros((m, nrhs))])), rhs_sharding)
        x = jax.device_put(jnp.zeros_like(b), rhs_sharding)
        x = (x + system.precon(b - system.matvec(x))).block_until_ready()
    step_devs = {d.id for d in x.sharding.device_set}
    # where the Schwarz leaf factors of the sharded system live
    ddm_devs = set()
    for level in system.ddm_tree.levels:
        if level.device is not None:
            for bk in level.device.buckets:
                ddm_devs |= {d.id for d in bk["chol"].sharding.device_set}
    check(res, "schwarz_factors_on_4_devices", 0, 0, ok=len(ddm_devs) == 4)
    check(res, "rhs_step_finite_on_4_devices", 0, 0,
          ok=bool(jnp.all(jnp.isfinite(x))) and len(step_devs) == 4)
    emit("multi", n=n, fit_one_s=fit1_s, fit_mesh_s=fit4_s,
         mesh=dict(mesh.shape), ddm_factor_devices=sorted(ddm_devs),
         matvec_devices=sorted(mult_devs), step_devices=sorted(step_devs),
         checks=res)


def main():
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the 4-GPU sharded comparison and nothing else")
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="points of the phase-2 fit (default 1,000,000)")
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu" or jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    import ferreus_rbf  # noqa: F401  (x64, matmul precision, compile cache)

    CARD = card_name_and_limit()
    os.makedirs(OUT, exist_ok=True)
    print(f"card: {CARD}", flush=True)
    if args.multi:
        phases = [("multi", lambda: run_multi(args.n))]
    else:
        state = {}
        phases = [
            ("device", phase_device),
            ("fit", lambda: state.update(rbfi=phase_fit(args.n))),
            ("evaluate", lambda: phase_evaluate(state["rbfi"])),
            ("near_field", lambda: (state.clear(), gc.collect(), phase_near_field())),
            ("isosurface", phase_isosurface),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as exc:
            FAILED.append(name)
            emit(name, error=f"{type(exc).__name__}: {exc}"[:2000],
                 traceback=traceback.format_exc()[-3000:])
        print(f"# phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        gc.collect()
    d = jax.devices()[0]
    device = {"platform": d.platform, "kind": d.device_kind,
              "count": len(jax.devices())}
    if FAILED:
        print(json.dumps({"ok": False, "failed": FAILED, "device": device}),
              flush=True)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
