"""Two-pass compaction tests: cap/compact/re-solve must match single-pass."""

import numpy as np
import pytest

from pycllp_jax import SolverOptions, Status
from pycllp_jax.io.generate import random_equality_lp
from pycllp_jax.solvers.hsd import hsd_solve_batched
from pycllp_jax.solvers.twopass import hsd_solve_two_pass


@pytest.fixture()
def batch_problem():
    m, n, B = 6, 15, 48
    A, _, _ = random_equality_lp(m, n, seed=50)
    rng = np.random.default_rng(51)
    b = rng.uniform(0.1, 1.0, size=(B, n)) @ A.T
    c = rng.normal(size=(B, m)) @ A + rng.uniform(0.1, 1.0, size=(B, n))
    return A, b, c


class TestTwoPass:
    def test_matches_single_pass(self, batch_problem):
        A, b, c = batch_problem
        opts = SolverOptions(tol=1e-8, maxiter=60)
        ref = hsd_solve_batched(A, b, c, opts)
        # cap low enough that some lanes genuinely need pass 2
        out = hsd_solve_two_pass(A, b, c, opts, pass1_maxiter=6, min_bucket=4)
        assert (out["status"] == int(Status.OPTIMAL)).all()
        np.testing.assert_allclose(out["objective"], np.asarray(ref["objective"]), rtol=1e-6)

    def test_remnant_lanes_get_full_budget(self, batch_problem):
        A, b, c = batch_problem
        opts = SolverOptions(tol=1e-8, maxiter=60)
        out1 = hsd_solve_batched(A, b, c, opts.replace(maxiter=6))
        n_unfinished = int((np.asarray(out1["status"]) == int(Status.ITERATION_LIMIT)).sum())
        assert n_unfinished > 0, "fixture must exercise the remnant path"
        out = hsd_solve_two_pass(A, b, c, opts, pass1_maxiter=6, min_bucket=4)
        # remnant lanes report their from-scratch pass-2 iteration counts
        assert (out["iterations"] > 6).any()

    def test_no_remnant_short_circuits(self, batch_problem):
        A, b, c = batch_problem
        opts = SolverOptions(tol=1e-8, maxiter=60)
        out = hsd_solve_two_pass(A, b, c, opts, pass1_maxiter=60)
        assert (out["status"] == int(Status.OPTIMAL)).all()

    def test_chunked_pass1(self, batch_problem):
        A, b, c = batch_problem
        opts = SolverOptions(tol=1e-8, maxiter=60)
        out = hsd_solve_two_pass(A, b, c, opts, chunk=16, pass1_maxiter=6, min_bucket=4)
        ref = hsd_solve_batched(A, b, c, opts)
        np.testing.assert_allclose(out["objective"], np.asarray(ref["objective"]), rtol=1e-6)

    def test_batched_A(self):
        m, n, B = 5, 12, 24
        rng = np.random.default_rng(52)
        As, bs, cs = [], [], []
        for i in range(B):
            A, _, _ = random_equality_lp(m, n, seed=100 + i)
            x0 = rng.uniform(0.1, 1.0, size=n)
            y0 = rng.normal(size=m)
            As.append(A)
            bs.append(A @ x0)
            cs.append(y0 @ A + rng.uniform(0.1, 1.0, size=n))
        A = np.stack(As)
        b = np.stack(bs)
        c = np.stack(cs)
        opts = SolverOptions(tol=1e-8, maxiter=60)
        ref = hsd_solve_batched(A, b, c, opts)
        out = hsd_solve_two_pass(A, b, c, opts, pass1_maxiter=6, min_bucket=4)
        np.testing.assert_allclose(out["objective"], np.asarray(ref["objective"]), rtol=1e-6)

    def test_bad_chunk_raises(self, batch_problem):
        A, b, c = batch_problem
        with pytest.raises(ValueError, match="multiple of chunk"):
            hsd_solve_two_pass(A, b, c, SolverOptions(), chunk=13)


class TestScanSolve:
    def test_matches_batched(self, batch_problem):
        from pycllp_jax.solvers.hsd import hsd_solve_scan

        A, b, c = batch_problem
        opts = SolverOptions(tol=1e-8, maxiter=60)
        ref = hsd_solve_batched(A, b, c, opts)
        out = hsd_solve_scan(A, b, c, opts, chunk=16)
        assert out["objective"].shape == (b.shape[0],)
        np.testing.assert_allclose(
            np.asarray(out["objective"]), np.asarray(ref["objective"]), rtol=1e-9
        )
        np.testing.assert_array_equal(np.asarray(out["status"]), np.asarray(ref["status"]))

    def test_pads_ragged_tail(self, batch_problem):
        from pycllp_jax.solvers.hsd import hsd_solve_scan

        A, b, c = batch_problem  # B=48; chunk 20 -> pad 12, trim back to 48
        opts = SolverOptions(tol=1e-8, maxiter=60)
        ref = hsd_solve_batched(A, b, c, opts)
        out = hsd_solve_scan(A, b, c, opts, chunk=20, keys=("objective", "status"))
        assert out["objective"].shape == (48,)
        assert "iterations" not in out
        np.testing.assert_allclose(
            np.asarray(out["objective"]), np.asarray(ref["objective"]), rtol=1e-9
        )

    def test_batched_A_rejected(self, batch_problem):
        from pycllp_jax.solvers.hsd import hsd_solve_scan

        A, b, c = batch_problem
        with pytest.raises(ValueError, match="2-D"):
            hsd_solve_scan(np.broadcast_to(A, (48, *A.shape)), b, c, SolverOptions())


class TestCompactScan:
    """Fused cap/compact/warm-resume sweep (single device program)."""

    def test_matches_plain_scan_exactly(self, batch_problem):
        from pycllp_jax.solvers.hsd import hsd_solve_scan

        A, b, c = batch_problem
        opts = SolverOptions(tol=1e-8, maxiter=60)
        ref = hsd_solve_scan(A, b, c, opts, chunk=16)
        # warm resume continues the identical iterate trajectory, so the
        # result must be BIT-identical to the uncompacted solve
        out = hsd_solve_scan(
            A, b, c, opts, chunk=16, compact_cap=6, compact_bucket=48
        )
        np.testing.assert_array_equal(
            np.asarray(out["objective"]), np.asarray(ref["objective"])
        )
        np.testing.assert_array_equal(np.asarray(out["status"]), np.asarray(ref["status"]))
        np.testing.assert_array_equal(
            np.asarray(out["iterations"]), np.asarray(ref["iterations"])
        )

    def test_cap_actually_bites(self, batch_problem):
        from pycllp_jax.solvers.hsd import hsd_solve_batched

        A, b, c = batch_problem
        opts = SolverOptions(tol=1e-8, maxiter=60)
        capped = hsd_solve_batched(A, b, c, opts.replace(maxiter=6))
        n_unfinished = int(
            (np.asarray(capped["status"]) == int(Status.ITERATION_LIMIT)).sum()
        )
        assert n_unfinished > 0, "fixture must exercise the resume path"

    def test_bucket_overflow_keeps_capped_rows(self, batch_problem):
        from pycllp_jax.solvers.hsd import hsd_solve_scan

        A, b, c = batch_problem
        opts = SolverOptions(tol=1e-8, maxiter=60)
        out = hsd_solve_scan(
            A, b, c, opts, chunk=16, compact_cap=6, compact_bucket=2
        )
        status = np.asarray(out["status"])
        # at most 2 lanes resumed; overflow rows keep ITERATION_LIMIT
        assert (status == int(Status.ITERATION_LIMIT)).any()
        # every resumed/finished lane is optimal
        done = status == int(Status.OPTIMAL)
        ref = hsd_solve_scan(A, b, c, opts, chunk=16)
        np.testing.assert_allclose(
            np.asarray(out["objective"])[done],
            np.asarray(ref["objective"])[done],
            rtol=1e-9,
        )

    def test_registry_solver_scan_knobs(self):
        """get_solver(..., chunk/compact_cap) routes through the scan."""
        import pycllp_jax as tp
        from pycllp_jax.io.generate import random_standard_lp

        lp = random_standard_lp(6, 10, nlp=40, seed=77, dtype=np.float64)
        plain = tp.get_solver("hsd", tol=1e-8, maxiter=60)
        plain.init(lp)
        ref = plain.solve()
        fast = tp.get_solver(
            "hsd", tol=1e-8, maxiter=60, chunk=16, compact_cap=6, compact_bucket=40
        )
        fast.init(lp)
        sol = fast.solve()
        assert (np.asarray(sol.status) == int(Status.OPTIMAL)).all()
        np.testing.assert_allclose(
            np.asarray(sol.objective), np.asarray(ref.objective), rtol=1e-7
        )

    def test_finish_dtype_on_compact_scan(self, batch_problem):
        """Compact scan + wide finish stages meet the full 1e-6 contract.

        Stage 1/2 run the narrow f32 sweep; stages 3/4 re-open every
        lane in the wide dtype and polish to ``opts.tol`` (the
        configuration that makes the throughput headline honest —
        BASELINE.md "Correctness" row).
        """
        from pycllp_jax.solvers.hsd import hsd_solve_scan

        A, b, c = batch_problem
        opts = SolverOptions(
            tol=1e-7, maxiter=40, dtype="float32", finish_dtype="float64"
        )
        ref = hsd_solve_batched(A, b, c, opts.replace(dtype="float64", finish_dtype=None))
        out = hsd_solve_scan(
            A, b, c, opts, chunk=16, compact_cap=6, compact_bucket=16, finish_cap=8
        )
        assert (np.asarray(out["status"]) == int(Status.OPTIMAL)).all()
        np.testing.assert_allclose(
            np.asarray(out["objective"]), np.asarray(ref["objective"]), rtol=1e-6, atol=1e-8
        )


class TestStallRtol:
    def test_default_zero_is_noop(self, batch_problem):
        A, b, c = batch_problem
        opts = SolverOptions(tol=1e-8, maxiter=60)
        a = hsd_solve_batched(A, b, c, opts)
        bb = hsd_solve_batched(A, b, c, opts.replace(stall_rtol=0.0))
        np.testing.assert_array_equal(np.asarray(a["iterations"]), np.asarray(bb["iterations"]))

    def test_rtol_freezes_floor_jitter_sooner(self, batch_problem):
        A, b, c = batch_problem
        # unreachable tol => every lane rides the stall clock; a material-
        # progress requirement must never take MORE iterations
        opts = SolverOptions(tol=1e-16, maxiter=80, stall_patience=5)
        a = hsd_solve_batched(A, b, c, opts)
        bb = hsd_solve_batched(A, b, c, opts.replace(stall_rtol=0.10))
        assert np.asarray(bb["iterations"]).max() <= np.asarray(a["iterations"]).max()
        # and the answers stay equally good (best iterate is unaffected)
        np.testing.assert_allclose(
            np.asarray(bb["objective"]), np.asarray(a["objective"]), rtol=1e-5
        )
