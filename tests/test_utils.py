"""Utils tests: scaling, metrics logging, FLOP model."""

import json

import numpy as np

import jax.numpy as jnp

from pycllp_jax import SolverOptions
from pycllp_jax.io.generate import random_equality_lp
from pycllp_jax.solvers.hsd import hsd_solve
from pycllp_jax.utils.logging import metrics_to_jsonl, set_metrics_sink
from pycllp_jax.utils.profiling import achieved_tflops, ipm_iteration_flops, solve_flops
from pycllp_jax.utils.scaling import ruiz_equilibrate, scale_problem


class TestScaling:
    def test_ruiz_equilibrates(self):
        rng = np.random.default_rng(0)
        A = jnp.asarray(rng.normal(size=(10, 25)) * rng.lognormal(0, 3, size=(10, 1)))
        sc = ruiz_equilibrate(A)
        As, _, _ = scale_problem(A, jnp.ones(10), jnp.ones(25), sc)
        row_norm = np.max(np.abs(np.asarray(As)), axis=1)
        col_norm = np.max(np.abs(np.asarray(As)), axis=0)
        assert row_norm.max() / row_norm.min() < 2.0
        assert col_norm.max() / col_norm.min() < 4.0

    def test_zero_rows_cols_stable(self):
        A = jnp.zeros((4, 6)).at[0, 0].set(2.0)
        sc = ruiz_equilibrate(A)
        assert np.isfinite(np.asarray(sc.row)).all()
        assert np.isfinite(np.asarray(sc.col)).all()
        assert np.abs(np.asarray(sc.row)).max() < 1e3


class TestMetrics:
    def test_iteration_records_emitted(self, tmp_path):
        A, b, c = random_equality_lp(6, 15, seed=1)
        path = str(tmp_path / "metrics.jsonl")
        with metrics_to_jsonl(path):
            hsd_solve(A, b, c, SolverOptions(tol=1e-8, log_every=1))
        records = [json.loads(line) for line in open(path)]
        assert len(records) >= 3
        r = records[0]
        assert r["event"] == "ipm_iteration"
        assert r["active"] == 1
        assert r["rho_p_max"] >= 0
        # residuals decrease over the solve
        assert records[-1]["rho_p_max"] < records[0]["rho_p_max"]

    def test_sink_restored(self, tmp_path):
        import pycllp_jax.utils.logging as L

        with metrics_to_jsonl(str(tmp_path / "x.jsonl")):
            pass
        assert L._sink is None
        set_metrics_sink(None)


class TestFlopModel:
    def test_iteration_flops_scale(self):
        f64 = ipm_iteration_flops(64, 128)
        f32_ = ipm_iteration_flops(32, 64)
        assert f64 > 6 * f32_  # roughly cubic/quadratic growth
        assert f64 > 2 * 64 * 64 * 128  # at least the normal-eq matmul

    def test_solve_flops(self):
        iters = np.array([10, 20, 30])
        assert solve_flops(8, 16, iters) == 60 * ipm_iteration_flops(8, 16)

    def test_achieved(self):
        assert achieved_tflops(2e12, 2.0) == 1.0


class TestCheckedSolve:
    def test_clean_solve_no_report(self):
        from pycllp_jax.utils.debug import checked_solve

        A, b, c = random_equality_lp(6, 15, seed=2)
        out, report = checked_solve(A, b[None], c[None], SolverOptions(tol=1e-8))
        assert report == []
        assert int(out["status"][0]) == 0

    def test_diagnosis_shape(self):
        """Force a NUMERICAL lane via a pathologically scaled instance
        in f32 with zero regularization."""
        import numpy as np
        from pycllp_jax.utils.debug import checked_solve
        from pycllp_jax import Status

        A, b, c = random_equality_lp(8, 20, seed=3)
        A = A * np.logspace(-6, 6, 20)[None, :]  # wreck the column scaling
        opts = SolverOptions(
            tol=1e-10, dtype="float32", scale=False, reg_eps=1e-30,
            stall_patience=1000, maxiter=60,
        )
        out, report = checked_solve(
            A.astype(np.float32), b[None].astype(np.float32), c[None].astype(np.float32), opts
        )
        if int(out["status"][0]) == int(Status.NUMERICAL):
            assert len(report) == 1
            r = report[0]
            assert {"lane", "f64_status", "first_bad_f32_iteration", "hint"} <= set(r)
        # if f32 survives this instance, the test still passed its purpose
