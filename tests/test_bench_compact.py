"""bench.py's last line must parse from a 2,000-byte stdout tail.

A cumulative line of ~8 KB would be truncated mid-string. These tests pin
the contract: bench.py's compact line
stays under 1,900 bytes even with every config populated, every error slot
filled, and the optional blocks present — and it is the LAST line emit()
prints.
"""

import importlib.util
import io
import json
import os
import sys

import pytest

_BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "bench.py")


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location("bench_under_test", _BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _worst_case_state(bench):
    st = bench._State({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                       "count": 1, "card": "NVIDIA H100 80GB HBM3, 700.00 W"})
    st.headline = 5251234.5
    x = st.extra
    oracle = {"n_sample": 1024, "value_vs_f64_oracle": 1.265e-05,
              "true_residual_rel_max": 1.19e-05, "oracle_s": 88.4,
              "note": "x" * 200}
    for key in ("config1_tps_2d_10k", "config3_albatite_fit",
                "config4_1m_biharmonic_fit", "config5_3m_fit"):
        x[key] = {
            "n": 3_000_000, "fit_cold_s": 1296.42, "fit_warm_s": 28.31,
            "eval_at_source_s": 149.9, "n_programs": 38,
            "solver_residual_rel": 8.13e-08, "solver_converged": True,
            "max_residual_rel": 6.8e-06, "converged": True,
            "residual_kind": "y" * 180,
            "fit_stages_s": {f"stage_{i}": 12.34 for i in range(14)},
            "refinement_history": [{"round": i, "residual": 1e-3 / (i + 1),
                                    "m_steps": 5} for i in range(8)],
            "m_step": {"one_m_step_residual_f32": 3.5e-3,
                       "one_m_step_residual_f64grade": 3.4e-3,
                       "matvec_tier_discrepancy_on_Mb": 1.1e-6},
            "oracle": dict(oracle),
            "stall_exits": [{"round": 2, "residual": 5e-5}],
            "rmt_s": 812.5, "mesh_vertices": 1234567, "mesh_facets": 2469134,
        }
    x["fmm_matvec_pts_per_s_f64grade"] = 1512345.6
    x["config2_gradient_tier"] = {"n": 100000, "grad_pts_per_s": 203456.7,
                                  "val_pts_per_s": 553456.7,
                                  "grad_over_val": 2.72, "note": "z" * 100}
    x["scaling_sp_matvec_ms"] = {"1": 19.0, "2": 14.2, "4": 11.8, "8": 10.9}
    x["error_budget_c4"] = {"per_level_rel": [1.2e-7, 3.4e-7, 8.1e-7, 2.0e-6],
                            "dominant": "cheb_truncation_p5"}
    # worst case: every step ALSO recorded an ANSI-laden error + a skip
    ansi_err = ("\x1b[1;31mRuntimeError\x1b[0m: remote_compile HTTP 500 "
                "\x1b[2m<traceback chatter>\x1b[0m " + "t" * 900)
    for name in ("headline", "config3", "config1", "gradients",
                 "config4", "config5"):
        x[f"{name}_error"] = bench._clean_err(ansi_err, 600)
        x[f"{name}_skipped"] = "budget (123s left < 300s)"
    x["killed_by"] = "SIGALRM"
    return st


def test_compact_line_fits_driver_tail(bench):
    st = _worst_case_state(bench)
    line = st.compact()
    assert len(line.encode()) < 1900, f"compact line {len(line)} bytes"
    parsed = json.loads(line)
    assert parsed["metric"] == "fmm_matvec_pts_per_s_100k_p5_rhs8_mixedprec"
    assert parsed["value"] == pytest.approx(5251234.5)
    assert parsed["vs_baseline"] == pytest.approx(3.501, abs=1e-3)
    # the driver-facing essentials survive the size cap
    assert "c4_1m" in parsed["extra"].get("configs", {})
    c5 = parsed["extra"]["configs"]["c5_3m"]
    assert c5["rmt_s"] == 812.5 and c5["verts"] == 1234567
    assert parsed["extra"]["device"]["platform"] == "gpu"


def test_compact_line_is_last_and_parseable_from_tail(bench, tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "DETAIL_PATH", str(tmp_path / "bench_detail.json"))
    st = _worst_case_state(bench)
    buf = io.StringIO()
    monkeypatch.setattr(sys, "stdout", buf)
    st.emit()
    out = buf.getvalue()
    tail = out[-2000:]  # the driver's exact capture
    last_json = None
    for ln in tail.splitlines():
        try:
            last_json = json.loads(ln)
        except ValueError:
            continue
    assert last_json is not None, "no parseable JSON line in the 2KB tail"
    assert last_json["value"] == pytest.approx(5251234.5)


def test_clean_err_strips_ansi(bench):
    s = bench._clean_err("\x1b[31mboom\x1b[0m\x1b]0;title\x07 multi\n line\t!")
    assert "\x1b" not in s and "\n" not in s
    assert s == "boom multi line !"


def test_empty_state_compact_is_valid(bench):
    st = bench._State()
    line = st.compact()
    parsed = json.loads(line)
    assert parsed["value"] is None and len(line.encode()) < 1900
