"""Warm-start re-solve: same structure, perturbed scenario data.

The upstream init-once / re-solve pattern (SURVEY.md §3.5) solves long
sequences of nearby LPs (pywr time-stepping).  Warm-starting each solve
from the previous solution must (a) converge to the same optimum and
(b) spend fewer IPM iterations than a cold start on correlated data.
"""

import numpy as np
from scipy.optimize import linprog

from pycllp_jax import SolverOptions, Status, get_solver
from pycllp_jax.io.generate import random_equality_lp, random_standard_lp
from pycllp_jax.solvers.hsd import hsd_solve_batched


def _batch_problem(m=12, n=30, B=24, seed=0):
    A, _, _ = random_equality_lp(m, n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    x0 = rng.uniform(0.1, 1.0, size=(B, n))
    y0 = rng.normal(size=(B, m))
    z0 = rng.uniform(0.1, 1.0, size=(B, n))
    b = x0 @ A.T
    c = y0 @ A + z0
    return A, b, c


class TestWarmStartCore:
    def test_warm_matches_cold_and_saves_iterations(self):
        A, b, c = _batch_problem()
        opts = SolverOptions(tol=1e-8)
        base = hsd_solve_batched(A, b, c, opts)
        assert np.all(np.asarray(base["status"]) == int(Status.OPTIMAL))

        rng = np.random.default_rng(42)
        b2 = b * (1.0 + 0.01 * rng.normal(size=b.shape))
        cold = hsd_solve_batched(A, b2, c, opts)
        warm = hsd_solve_batched(
            A, b2, c, opts, warm=(base["x"], base["y"], base["z"])
        )
        assert np.all(np.asarray(warm["status"]) == int(Status.OPTIMAL))
        np.testing.assert_allclose(
            np.asarray(warm["objective"]),
            np.asarray(cold["objective"]),
            rtol=1e-6,
            atol=1e-6,
        )
        cold_it = np.asarray(cold["iterations"], np.float64).mean()
        warm_it = np.asarray(warm["iterations"], np.float64).mean()
        assert warm_it < cold_it, (warm_it, cold_it)

    def test_warm_point_on_identical_problem_converges_fast(self):
        A, b, c = _batch_problem(seed=3)
        opts = SolverOptions(tol=1e-8)
        base = hsd_solve_batched(A, b, c, opts)
        again = hsd_solve_batched(A, b, c, opts, warm=(base["x"], base["y"], base["z"]))
        assert np.all(np.asarray(again["status"]) == int(Status.OPTIMAL))
        # re-solving the SAME problem from its own solution is nearly free
        assert np.asarray(again["iterations"]).mean() <= 5.0
        np.testing.assert_allclose(
            np.asarray(again["objective"]), np.asarray(base["objective"]), rtol=1e-6
        )


class TestWarmStartRegistry:
    def test_sequential_resolve_fewer_iterations(self):
        lp = random_standard_lp(10, 25, nlp=16, seed=5)
        rng = np.random.default_rng(6)

        warm_solver = get_solver("hsd", tol=1e-8, warm_start=True)
        warm_solver.init(lp)
        cold_solver = get_solver("hsd", tol=1e-8)
        cold_solver.init(lp)

        first = warm_solver.solve()
        assert first.converged.all()

        warm_iters, cold_iters = [], []
        for _ in range(3):
            lp.b = np.asarray(lp.b) * (1.0 + 0.005 * rng.normal(size=lp.b.shape))
            ws = warm_solver.solve()
            cs = cold_solver.solve()
            assert ws.converged.all()
            np.testing.assert_allclose(
                np.asarray(ws.objective), np.asarray(cs.objective), rtol=1e-6, atol=1e-6
            )
            warm_iters.append(np.asarray(ws.iterations, np.float64).mean())
            cold_iters.append(np.asarray(cs.iterations, np.float64).mean())
        assert np.mean(warm_iters) < np.mean(cold_iters), (warm_iters, cold_iters)

    def test_warm_solution_still_matches_scipy(self):
        lp = random_standard_lp(8, 18, nlp=4, seed=11)
        solver = get_solver("hsd", tol=1e-8, warm_start=True)
        solver.init(lp)
        solver.solve()
        lp.b = np.asarray(lp.b) * 1.01
        sol = solver.solve()
        for i in range(4):
            res = linprog(
                -np.asarray(lp.c)[i],
                A_ub=np.asarray(lp.A),
                b_ub=np.asarray(lp.b)[i],
                bounds=[(0, None)] * 18,
                method="highs",
            )
            assert res.status == 0
            np.testing.assert_allclose(
                float(sol.objective[i]), -res.fun, rtol=1e-6, atol=1e-6
            )

    def test_scan_warm_chain_fewer_iterations_same_solutions(self):
        """hsd_solve_scan(warm_chain=True): chunk k+1 lane j starts from
        chunk k lane j on a correlated stream — fewer mean iterations,
        unchanged solutions (VERDICT r1 item 6)."""
        from pycllp_jax.solvers.hsd import hsd_solve_scan

        A, b0, c = _batch_problem(m=10, n=24, B=8, seed=9)
        rng = np.random.default_rng(10)
        K = 6  # time steps (chunks); a slowly drifting b stream per lane
        bs = [b0]
        for _ in range(K - 1):
            bs.append(bs[-1] * (1.0 + 0.01 * rng.normal(size=b0.shape)))
        b = np.concatenate(bs, 0)
        cc = np.tile(c, (K, 1))
        opts = SolverOptions(tol=1e-8)
        kw = dict(chunk=8, keys=("objective", "status", "iterations"))
        cold = hsd_solve_scan(A, b, cc, opts, **kw)
        warm = hsd_solve_scan(A, b, cc, opts, warm_chain=True, **kw)
        assert np.all(np.asarray(warm["status"]) == int(Status.OPTIMAL))
        np.testing.assert_allclose(
            np.asarray(warm["objective"]), np.asarray(cold["objective"]),
            rtol=1e-6, atol=1e-6,
        )
        # exclude chunk 0 (cold in both); later chunks must get cheaper
        ci = np.asarray(cold["iterations"], np.float64)[8:].mean()
        wi = np.asarray(warm["iterations"], np.float64)[8:].mean()
        assert wi < ci, (wi, ci)

    def test_scan_warm_chain_compact_path(self):
        """warm_chain composes with the fused cap/compact sweep."""
        from pycllp_jax.solvers.hsd import hsd_solve_scan

        A, b0, c = _batch_problem(m=10, n=24, B=8, seed=12)
        rng = np.random.default_rng(13)
        bs = [b0]
        for _ in range(3):
            bs.append(bs[-1] * (1.0 + 0.01 * rng.normal(size=b0.shape)))
        b = np.concatenate(bs, 0)
        cc = np.tile(c, (4, 1))
        opts = SolverOptions(tol=1e-8)
        kw = dict(chunk=8, keys=("objective", "status"), compact_cap=8,
                  compact_bucket=16)
        cold = hsd_solve_scan(A, b, cc, opts, **kw)
        warm = hsd_solve_scan(A, b, cc, opts, warm_chain=True, **kw)
        np.testing.assert_allclose(
            np.asarray(warm["objective"]), np.asarray(cold["objective"]),
            rtol=1e-6, atol=1e-6,
        )

    def test_init_invalidates_warm_point(self):
        solver = get_solver("hsd", tol=1e-8, warm_start=True)
        solver.init(random_standard_lp(10, 25, nlp=8, seed=1))
        solver.solve()
        assert solver._warm is not None
        # a new structure (different n) must drop the stale warm point
        solver.init(random_standard_lp(12, 30, nlp=8, seed=2))
        assert solver._warm is None
        sol = solver.solve()
        assert sol.converged.all()
