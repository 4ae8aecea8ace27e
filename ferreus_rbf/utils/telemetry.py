"""Stage timing + profiling hooks (the reference's observability analogue).

The reference reports coarse solve timing through its progress sink
(``rbf.rs:325,390-409``) and streams per-iteration residuals; this module
adds the device-side equivalents recommended in SURVEY.md section 5.1: named
stage timers that accumulate into a report, and an optional
``jax.profiler`` trace context for XLA-level inspection.

Usage::

    tracer = Tracer()
    with tracer.stage("tree_build"):
        ...
    with tracer.stage("fgmres"):
        ...
    print(tracer.report())

    with xla_trace("/tmp/ferreus-trace"):   # view in TensorBoard/XProf
        rbfi.evaluate(targets)
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict


class Tracer:
    """Accumulating named stage timers (host wall-clock)."""

    def __init__(self):
        self._totals = OrderedDict()
        self._counts = OrderedDict()
        # structured solver events (refinement rounds, stall exits, m-step
        # diagnostics): list of {"event": name, **payload} dicts in
        # occurrence order — the bench surfaces these per fit config
        self.events = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._totals[name] = self._totals.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1

    def add(self, name: str, seconds: float) -> None:
        self._totals[name] = self._totals.get(name, 0.0) + seconds
        self._counts[name] = self._counts.get(name, 0) + 1

    @property
    def totals(self) -> dict:
        return dict(self._totals)

    def report(self) -> str:
        lines = ["stage                          calls      total"]
        for name, total in self._totals.items():
            lines.append(f"{name:<30} {self._counts[name]:>5} {total:>9.3f}s")
        return "\n".join(lines)


# A process-global tracer the library components write into when enabled.
_GLOBAL_TRACER: Tracer | None = None


def enable_global_tracer() -> Tracer:
    global _GLOBAL_TRACER
    _GLOBAL_TRACER = Tracer()
    return _GLOBAL_TRACER


def disable_global_tracer() -> None:
    global _GLOBAL_TRACER
    _GLOBAL_TRACER = None


def global_tracer() -> Tracer | None:
    return _GLOBAL_TRACER


def record_event(name: str, payload: dict) -> None:
    """Append a structured event to the global tracer (no-op when disabled).

    Used by the solvers for stall/escalation telemetry (which precision tier
    each refinement round ran, the f64 outer residual at the round start)
    and by the fit path for the one-M-step preconditioner diagnostic."""
    tracer = _GLOBAL_TRACER
    if tracer is not None:
        tracer.events.append({"event": name, **payload})


_TRACE_PRINT = os.environ.get("FERREUS_RBF_TRACE_PRINT", "") not in ("", "0")


@contextlib.contextmanager
def traced_stage(name: str):
    """Record into the global tracer when enabled; no-op otherwise.

    ``FERREUS_RBF_TRACE_PRINT=1`` additionally prints stage enter/exit
    with wall-clock to stderr — live visibility into long setups (the
    tracer totals only become readable after the stage returns)."""
    if _TRACE_PRINT:
        import sys
        import time as _time

        t0 = _time.perf_counter()
        print(f"[stage] {name} ...", file=sys.stderr, flush=True)
    tracer = _GLOBAL_TRACER
    try:
        if tracer is None:
            yield
        else:
            with tracer.stage(name):
                yield
    finally:
        if _TRACE_PRINT:
            print(f"[stage] {name} done {_time.perf_counter() - t0:.1f}s",
                  file=sys.stderr, flush=True)


@contextlib.contextmanager
def xla_trace(log_dir: str):
    """Capture a jax.profiler trace (TensorBoard/XProf compatible)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def compiled_program_counts() -> dict:
    """Per-entry-point jit-cache sizes (compiled XLA program counts).

    Each entry counts distinct (shape, static-arg) signatures compiled for
    one of the framework's jitted pass functions — the quantity the
    high-water-mark shape padding exists to bound. Useful for cold-start
    accounting: ``sum(compiled_program_counts().values())`` after a fit is
    the number of XLA compilations the fit triggered in this process.
    """
    from ..ops.fmm import api as fmm_api

    counts = {}
    for name in ("_upward", "_downward", "_leaf_all", "_matvec_fused",
                 "_matvec_fused_sharded"):
        size = getattr(getattr(fmm_api, name), "_cache_size", None)
        if callable(size):
            counts[name] = int(size())
    return counts
