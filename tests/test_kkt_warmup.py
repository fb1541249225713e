"""kkt_warmup schedule tests: the warmup split must not change answers.

The narrow phase may run its first ``kkt_warmup`` iterations with
``kkt_refine=0`` (KKT refinement is an end-quality knob — see
options.py); these tests pin the invariants: identical optima, warmup
inert when kkt_refine is off, and a clean interaction with the scan
path's capped/compacted stages.
"""

import numpy as np
import pytest

from pycllp_jax import SolverOptions, Status
from pycllp_jax.io.generate import random_equality_lp, random_standard_lp
from pycllp_jax.solvers.hsd import hsd_solve_batched, hsd_solve_scan


@pytest.fixture()
def batch_problem():
    m, n, B = 6, 15, 48
    A, _, _ = random_equality_lp(m, n, seed=50)
    rng = np.random.default_rng(51)
    b = rng.uniform(0.1, 1.0, size=(B, n)) @ A.T
    c = rng.normal(size=(B, m)) @ A + rng.uniform(0.1, 1.0, size=(B, n))
    return A, b, c


class TestKKTWarmup:
    def test_batched_same_optima(self, batch_problem):
        A, b, c = batch_problem
        base = SolverOptions(tol=1e-8, maxiter=60, kkt_refine=2)
        ref = hsd_solve_batched(A, b, c, base)
        out = hsd_solve_batched(A, b, c, base.replace(kkt_warmup=4))
        assert (np.asarray(out["status"]) == int(Status.OPTIMAL)).all()
        np.testing.assert_allclose(
            np.asarray(out["objective"]), np.asarray(ref["objective"]), rtol=1e-6
        )

    def test_pred_schedule_same_optima(self, batch_problem):
        """Asymmetric refinement (kkt_refine_pred < kkt_refine): same
        optima to solver tol; pred=kkt_refine is bitwise the default."""
        A, b, c = batch_problem
        base = SolverOptions(tol=1e-8, maxiter=60, kkt_refine=3)
        ref = hsd_solve_batched(A, b, c, base)
        for pred in (0, 1):
            out = hsd_solve_batched(A, b, c, base.replace(kkt_refine_pred=pred))
            assert (np.asarray(out["status"]) == int(Status.OPTIMAL)).all()
            np.testing.assert_allclose(
                np.asarray(out["objective"]), np.asarray(ref["objective"]), rtol=1e-6
            )
        same = hsd_solve_batched(A, b, c, base.replace(kkt_refine_pred=3))
        np.testing.assert_array_equal(
            np.asarray(same["objective"]), np.asarray(ref["objective"])
        )

    def test_inert_without_kkt_refine(self, batch_problem):
        """kkt_refine=0 ⇒ the warmup split must not even change the trace
        (both sub-phases would be identical); answers are bitwise equal."""
        A, b, c = batch_problem
        base = SolverOptions(tol=1e-8, maxiter=60, kkt_refine=0)
        ref = hsd_solve_batched(A, b, c, base)
        out = hsd_solve_batched(A, b, c, base.replace(kkt_warmup=4))
        np.testing.assert_array_equal(
            np.asarray(out["objective"]), np.asarray(ref["objective"])
        )
        np.testing.assert_array_equal(
            np.asarray(out["iterations"]), np.asarray(ref["iterations"])
        )

    def test_scan_finish_path(self):
        """Bench-shaped config (f32 narrow + crossover finish) with a
        warmup: every lane still lands OPTIMAL at the contract tol."""
        lp = random_standard_lp(12, 12, nlp=64, seed=3, dtype=np.float32)
        eq = lp.to_equality_form()
        opts = SolverOptions(
            tol=1e-6, maxiter=40, dtype="float32", stall_patience=3,
            stall_rtol=0.05, refine_steps=0, kkt_refine=3, kkt_warmup=5,
            init_point="mehrotra", finish_dtype="float64", switch_tol=1e-5,
            finish_mode="crossover", finish_kkt_refine=0,
        )
        out = hsd_solve_scan(
            np.asarray(eq.A, np.float32), np.asarray(eq.b, np.float32),
            np.asarray(eq.c, np.float32), opts,
            chunk=32, keys=("objective", "status"),
            compact_cap=12, compact_bucket=16, finish_cap=3, finish_bucket=16,
        )
        assert (np.asarray(out["status"]) == int(Status.OPTIMAL)).all()
