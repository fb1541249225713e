"""HSD core correctness vs the scipy oracle (SURVEY.md §4 oracle chain).

Cross-backend equivalence in the upstream style: the jitted JAX solver
must match ``scipy.linprog`` objectives to the 1e-6 relative-gap contract
on random planted-certificate LPs and on classic hand-known examples.
"""

import numpy as np
import pytest
from scipy.optimize import linprog

import jax.numpy as jnp

from pycllp_jax import SolverOptions, Status, get_solver
from pycllp_jax.io.generate import random_equality_lp, random_standard_lp
from pycllp_jax.solvers.hsd import hsd_solve, hsd_solve_batched


def scipy_objective(A, b, c):
    res = linprog(c, A_eq=A, b_eq=b, bounds=[(0, None)] * A.shape[1], method="highs")
    assert res.status == 0, res.message
    return res.fun, res.x


class TestHSDEquality:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    @pytest.mark.parametrize("shape", [(5, 12), (30, 50), (64, 128)])
    def test_random_matches_scipy(self, seed, shape):
        m, n = shape
        A, b, c = random_equality_lp(m, n, seed=seed)
        out = hsd_solve(A, b, c, SolverOptions(tol=1e-8))
        ref_obj, _ = scipy_objective(A, b, c)
        assert int(out["status"]) == int(Status.OPTIMAL)
        np.testing.assert_allclose(
            float(out["objective"]), ref_obj, rtol=1e-6, atol=1e-6
        )
        # primal feasibility of the recovered point
        x = np.asarray(out["x"])
        assert np.all(x >= -1e-7)
        np.testing.assert_allclose(A @ x, b, rtol=1e-5, atol=1e-5)

    def test_batch_shared_A(self):
        m, n, B = 10, 25, 16
        A, _, _ = random_equality_lp(m, n, seed=7)
        rng = np.random.default_rng(8)
        x0 = rng.uniform(0.1, 1.0, size=(B, n))
        y0 = rng.normal(size=(B, m))
        z0 = rng.uniform(0.1, 1.0, size=(B, n))
        b = x0 @ A.T
        c = y0 @ A + z0
        out = hsd_solve_batched(A, b, c, SolverOptions(tol=1e-8))
        assert np.all(np.asarray(out["status"]) == int(Status.OPTIMAL))
        for i in range(B):
            ref_obj, _ = scipy_objective(A, b[i], c[i])
            np.testing.assert_allclose(
                float(out["objective"][i]), ref_obj, rtol=1e-6, atol=1e-6
            )

    def test_batched_A(self):
        m, n, B = 8, 20, 5
        A, b, c = random_equality_lp(m, n, nlp=B, seed=3, shared_A=False)
        out = hsd_solve_batched(A, b, c, SolverOptions(tol=1e-8))
        assert np.all(np.asarray(out["status"]) == int(Status.OPTIMAL))
        for i in range(B):
            ref_obj, _ = scipy_objective(A[i], b[i], c[i])
            np.testing.assert_allclose(
                float(out["objective"][i]), ref_obj, rtol=1e-6, atol=1e-6
            )

    def test_infeasible_detected(self):
        # x1 + x2 = -1 with x >= 0 is infeasible
        A = np.array([[1.0, 1.0]])
        b = np.array([-1.0])
        c = np.array([1.0, 1.0])
        out = hsd_solve(A, b, c, SolverOptions(tol=1e-8))
        assert int(out["status"]) == int(Status.INFEASIBLE)

    def test_unbounded_detected(self):
        # min −x1 s.t. x1 − x2 = 0, x ≥ 0 → unbounded below
        A = np.array([[1.0, -1.0]])
        b = np.array([0.0])
        c = np.array([-1.0, 0.0])
        out = hsd_solve(A, b, c, SolverOptions(tol=1e-8))
        assert int(out["status"]) == int(Status.UNBOUNDED)

    def test_float32_pure(self):
        """Pure f32: best-iterate tracking must deliver a good point even
        though the iteration eventually hits the f32 floor."""
        m, n = 16, 40
        A, b, c = random_equality_lp(m, n, seed=11)
        out = hsd_solve(
            A.astype(np.float32),
            b.astype(np.float32),
            c.astype(np.float32),
            SolverOptions(tol=1e-6, dtype="float32"),
        )
        ref_obj, _ = scipy_objective(A, b, c)
        assert int(out["status"]) in (int(Status.OPTIMAL), int(Status.STALLED))
        # f32 contract: 1e-6 relative gap on the objective (BASELINE.md)
        rel = abs(float(out["objective"]) - ref_obj) / max(1.0, abs(ref_obj))
        assert rel < 1e-5
        # and the point is feasible at the f32 level (no divergence blowup)
        x = np.asarray(out["x"], np.float64)
        pinf = np.linalg.norm(A @ x - b) / max(1.0, np.linalg.norm(b))
        assert pinf < 1e-3

    def test_float32_finish_float64(self):
        """Mixed precision: f32 bulk + f64 polish meets the full 1e-6
        indicator contract (SURVEY.md §7 hard part 1 disposition)."""
        m, n = 16, 40
        A, b, c = random_equality_lp(m, n, seed=11)
        # f64 inputs: phase 1 rounds internally; the polish phase must see
        # the true data, so the full 1e-6 contract holds end to end.
        out = hsd_solve(
            A, b, c,
            SolverOptions(tol=1e-7, dtype="float32", finish_dtype="float64"),
        )
        ref_obj, _ = scipy_objective(A, b, c)
        assert int(out["status"]) == int(Status.OPTIMAL)
        rel = abs(float(out["objective"]) - ref_obj) / max(1.0, abs(ref_obj))
        assert rel < 1e-6
        x = np.asarray(out["x"], np.float64)
        pinf = np.linalg.norm(A @ x - b) / max(1.0, np.linalg.norm(b))
        assert pinf < 1e-5

    def test_mixed_batch_statuses(self):
        """One batch containing optimal + infeasible + unbounded lanes."""
        A = np.array([[1.0, 1.0]])
        bs = np.array([[2.0], [-1.0], [0.0]])
        cs = np.array([[1.0, 2.0], [1.0, 1.0], [-1.0, -2.0]])
        # lane 2: min −x1−2x2 s.t. x1+x2=0 → x=0 only; actually bounded.
        # use a clearly unbounded lane instead:
        A2 = np.array([[1.0, -1.0]])
        out = hsd_solve_batched(
            np.broadcast_to(A, (3, 1, 2)).copy(), bs, cs, SolverOptions(tol=1e-8)
        )
        st = np.asarray(out["status"])
        assert st[0] == int(Status.OPTIMAL)
        assert st[1] == int(Status.INFEASIBLE)

    def test_dual_solution(self):
        m, n = 10, 24
        A, b, c = random_equality_lp(m, n, seed=5)
        out = hsd_solve(A, b, c, SolverOptions(tol=1e-9))
        # strong duality: b·y == c·x at optimum; dual feasibility Aᵀy ≤ c
        x, y = np.asarray(out["x"]), np.asarray(out["y"])
        np.testing.assert_allclose(b @ y, c @ x, rtol=1e-6, atol=1e-6)
        assert np.all(A.T @ y - c <= 1e-6)

    def test_iteration_limit(self):
        A, b, c = random_equality_lp(20, 50, seed=9)
        out = hsd_solve(A, b, c, SolverOptions(tol=1e-10, maxiter=2))
        assert int(out["status"]) == int(Status.ITERATION_LIMIT)
        assert int(out["iterations"]) == 2


class TestRegistrySolvers:
    """Upstream-style registry-parametrized cross-backend equivalence."""

    @pytest.mark.parametrize("name", ["hsd", "scipy"])
    def test_standard_lp_roundtrip(self, name):
        lp = random_standard_lp(12, 18, seed=21)
        solver = get_solver(name, tol=1e-8)
        solver.init(lp)
        sol = solver.solve()
        ref = linprog(
            -np.asarray(lp.c),
            A_ub=np.asarray(lp.A),
            b_ub=np.asarray(lp.b),
            bounds=[(0, None)] * lp.ncols,
            method="highs",
        )
        assert ref.status == 0
        assert int(np.asarray(sol.status)) == int(Status.OPTIMAL)
        np.testing.assert_allclose(float(sol.objective), -ref.fun, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("name", ["hsd", "scipy"])
    def test_batched_standard(self, name):
        lp = random_standard_lp(8, 12, nlp=6, seed=2)
        solver = get_solver(name, tol=1e-8)
        solver.init(lp)
        sol = solver.solve()
        assert sol.x.shape == (6, 12)
        assert np.all(np.asarray(sol.status) == int(Status.OPTIMAL))
        for i in range(6):
            ref = linprog(
                -np.asarray(lp.c)[i],
                A_ub=np.asarray(lp.A),
                b_ub=np.asarray(lp.b)[i],
                bounds=[(0, None)] * lp.ncols,
                method="highs",
            )
            np.testing.assert_allclose(
                float(sol.objective[i]), -ref.fun, rtol=1e-6, atol=1e-6
            )

    @pytest.mark.parametrize("name", ["hsd", "scipy"])
    def test_init_once_resolve_with_mutated_b(self, name):
        """The stochastic re-solve pattern: init once, mutate the held
        problem's b between no-arg solve() calls — results must track the
        CURRENT arrays, not an init-time snapshot (upstream pywr usage)."""
        lp = random_standard_lp(8, 12, nlp=5, seed=23)
        solver = get_solver(name, tol=1e-8)
        solver.init(lp)
        obj1 = np.asarray(solver.solve().objective).copy()
        lp.b = np.asarray(lp.b) * 1.7
        sol2 = solver.solve()
        obj2 = np.asarray(sol2.objective)
        assert not np.allclose(obj1, obj2), "re-solve ignored the mutated b"
        ref = linprog(
            -np.asarray(lp.c)[0],
            A_ub=np.asarray(lp.A),
            b_ub=np.asarray(lp.b)[0],
            bounds=[(0, None)] * lp.ncols,
            method="highs",
        )
        np.testing.assert_allclose(float(obj2[0]), -ref.fun, rtol=1e-6, atol=1e-6)

    def test_cross_backend_agreement(self):
        """All available backends agree on the same batch (the core
        upstream QA idea, SURVEY.md §4)."""
        from pycllp_jax import available_solvers

        lp = random_standard_lp(10, 15, nlp=4, seed=33)
        objs = {}
        for name in available_solvers():
            s = get_solver(name, tol=1e-8)
            s.init(lp)
            objs[name] = np.asarray(s.solve().objective)
        names = list(objs)
        for a in names[1:]:
            np.testing.assert_allclose(objs[a], objs[names[0]], rtol=1e-6, atol=1e-6)


class TestGeneralLPSolve:
    """Solving a GeneralLP end-to-end through the registry must return
    the solution in GENERAL coordinates (recovery map applied)."""

    def test_general_roundtrip(self):
        from pycllp_jax import GeneralLP

        # min x+y s.t. x+2y >= 2, 3x+y >= 3 → x=(0.8, 0.6), obj 1.4
        glp = GeneralLP(A=[[1, 2], [3, 1]], row_lb=[2, 3], c=[1, 1], sense="min")
        s = get_solver("hsd", tol=1e-9)
        s.init(glp)
        sol = s.solve()
        np.testing.assert_allclose(np.asarray(sol.x), [0.8, 0.6], atol=1e-6)
        np.testing.assert_allclose(float(sol.objective), 1.4, atol=1e-7)

    def test_general_with_bounds_and_sense(self):
        from pycllp_jax import GeneralLP

        glp = GeneralLP(
            A=[[1, 1, 1], [2, 1, 0]],
            row_ub=[10, 8],
            c=[3, 2, 1],
            ub=[4, 4, 4],
            sense="max",
        )
        s = get_solver("hsd", tol=1e-9)
        s.init(glp)
        sol = s.solve()
        np.testing.assert_allclose(float(sol.objective), 18.0, atol=1e-6)
        x = np.asarray(sol.x)
        assert np.all(x <= 4 + 1e-7)
        # duals in general-row coordinates
        assert np.asarray(sol.y).shape == (2,)


class TestGondzioCorrectors:
    def test_correctors_preserve_correctness(self):
        m, n = 20, 45
        A, b, c = random_equality_lp(m, n, seed=13)
        ref_obj, _ = scipy_objective(A, b, c)
        plain = hsd_solve(A, b, c, SolverOptions(tol=1e-8))
        gz = hsd_solve(A, b, c, SolverOptions(tol=1e-8, gondzio_correctors=2))
        assert int(gz["status"]) == int(Status.OPTIMAL)
        np.testing.assert_allclose(float(gz["objective"]), ref_obj, rtol=1e-6, atol=1e-6)
        # correctors must not blow up the iteration count
        assert int(gz["iterations"]) <= int(plain["iterations"]) + 1

    def test_correctors_batch(self):
        m, n, B = 10, 25, 8
        A, _, _ = random_equality_lp(m, n, seed=14)
        rng = np.random.default_rng(15)
        b = rng.uniform(0.1, 1.0, size=(B, n)) @ A.T
        c = rng.normal(size=(B, m)) @ A + rng.uniform(0.1, 1.0, size=(B, n))
        out = hsd_solve_batched(A, b, c, SolverOptions(tol=1e-8, gondzio_correctors=3))
        assert np.all(np.asarray(out["status"]) == int(Status.OPTIMAL))


class TestMehrotraStart:
    def test_reduces_or_matches_iterations(self):
        m, n = 24, 60
        A, b, c = random_equality_lp(m, n, seed=17)
        ref_obj, _ = scipy_objective(A, b, c)
        plain = hsd_solve(A, b, c, SolverOptions(tol=1e-8))
        warm = hsd_solve(A, b, c, SolverOptions(tol=1e-8, init_point="mehrotra"))
        assert int(warm["status"]) == int(Status.OPTIMAL)
        np.testing.assert_allclose(float(warm["objective"]), ref_obj, rtol=1e-6, atol=1e-6)
        assert int(warm["iterations"]) <= int(plain["iterations"]) + 1

    def test_batch_iteration_stats(self):
        m, n, B = 16, 40, 16
        A, _, _ = random_equality_lp(m, n, seed=18)
        rng = np.random.default_rng(19)
        b = rng.uniform(0.1, 1.0, size=(B, n)) @ A.T
        c = rng.normal(size=(B, m)) @ A + rng.uniform(0.1, 1.0, size=(B, n))
        plain = hsd_solve_batched(A, b, c, SolverOptions(tol=1e-8))
        warm = hsd_solve_batched(A, b, c, SolverOptions(tol=1e-8, init_point="mehrotra"))
        assert np.all(np.asarray(warm["status"]) == int(Status.OPTIMAL))
        assert np.asarray(warm["iterations"]).mean() <= np.asarray(plain["iterations"]).mean() + 0.5
        print("plain", np.asarray(plain["iterations"]).mean(), "warm", np.asarray(warm["iterations"]).mean())


class TestNumericalBestIterate:
    """VERDICT r2 item 4: a lane whose wide phase breaks down numerically
    must still answer with its tracked best iterate — never worse than
    the narrow phase alone."""

    def test_poisoned_finish_keeps_narrow_best(self):
        from pycllp_jax.ops.reference import REFERENCE_KERNELS, KernelSet

        class PoisonedFinish(KernelSet):
            """Delegates to the reference kernels but returns NaN solves —
            a deterministic stand-in for a wide-phase numerical breakdown."""

            name = "poisoned_finish"

            def prepare(self, A):
                return REFERENCE_KERNELS.prepare(A)

            def mv(self, ctx, x):
                return REFERENCE_KERNELS.mv(ctx, x)

            def rmv(self, ctx, y):
                return REFERENCE_KERNELS.rmv(ctx, y)

            def factor(self, ctx, d, reg_eps):
                return REFERENCE_KERNELS.factor(ctx, d, reg_eps)

            def solve(self, fac, rs):
                return tuple(jnp.full_like(r, jnp.nan) for r in rs)

        class NarrowWithPoisonedFinish(KernelSet):
            name = "narrow_poisoned"

            def __init__(self):
                self._poison = PoisonedFinish()

            def prepare(self, A):
                return REFERENCE_KERNELS.prepare(A)

            def mv(self, ctx, x):
                return REFERENCE_KERNELS.mv(ctx, x)

            def rmv(self, ctx, y):
                return REFERENCE_KERNELS.rmv(ctx, y)

            def factor(self, ctx, d, reg_eps):
                return REFERENCE_KERNELS.factor(ctx, d, reg_eps)

            def solve(self, fac, rs):
                return REFERENCE_KERNELS.solve(fac, rs)

            def finish_kernels(self):
                return self._poison

        m, n, B = 16, 40, 16
        A, _, _ = random_equality_lp(m, n, seed=21)
        rng = np.random.default_rng(22)
        b = rng.uniform(0.1, 1.0, size=(B, n)) @ A.T
        c = rng.normal(size=(B, m)) @ A + rng.uniform(0.1, 1.0, size=(B, n))
        # the narrow baseline mirrors what phase 1 of the finish config
        # sees: with a finish phase, phase 1 runs at switch_tol (1e-5)
        narrow_opts = SolverOptions(tol=1e-5, dtype="float32", maxiter=30)
        narrow = hsd_solve_batched(
            np.asarray(A, np.float32), np.asarray(b, np.float32),
            np.asarray(c, np.float32), narrow_opts,
        )
        poisoned_opts = narrow_opts.replace(
            tol=1e-6, finish_dtype="float64", switch_tol=1e-5, finish_maxiter=10
        )
        kset = NarrowWithPoisonedFinish()
        out = hsd_solve_batched(
            np.asarray(A, np.float32), np.asarray(b, np.float32),
            np.asarray(c, np.float32), poisoned_opts, kset,
        )
        status = np.asarray(out["status"])
        # every lane's first wide step NaNs -> NUMERICAL (none can have
        # met the 1e-6 contract before the wide phase at f32)
        assert np.all(status == int(Status.NUMERICAL)), status
        # ...but the batch answers at the narrow phase's quality floor.
        # (Per-lane equality with a separate narrow run is not testable:
        # the finish config computes Ruiz scaling in f64 and rounds,
        # which perturbs the f32 trajectory at the ulp level.)
        errs_p, errs_n = [], []
        for i in range(B):
            ref_obj, _ = scipy_objective(A, b[i], c[i])
            scale = max(1.0, abs(ref_obj))
            errs_p.append(abs(float(out["objective"][i]) - ref_obj) / scale)
            errs_n.append(abs(float(narrow["objective"][i]) - ref_obj) / scale)
        assert max(errs_p) <= max(errs_n) * 2.5 + 1e-7, (
            f"poisoned-finish max err {max(errs_p):.2e} vs narrow {max(errs_n):.2e}"
        )

    def test_finalize_numerical_takes_best(self):
        """Unit test of the fix: _finalize must answer with the tracked
        best iterate for NUMERICAL lanes and re-open them (OPTIMAL if the
        best point meets tol after all)."""
        from pycllp_jax.ops.reference import REFERENCE_KERNELS
        from pycllp_jax.solvers.hsd import HSDState, _finalize, _fresh_state, _run_phase

        m, n = 12, 30
        A, b, c = random_equality_lp(m, n, seed=23)
        A, b, c = (jnp.asarray(v) for v in (A, b, c))
        bB, cB = b[None], c[None]
        ctx = REFERENCE_KERNELS.prepare(A)
        opts = SolverOptions(tol=1e-9, maxiter=50)
        s = _fresh_state(ctx, bB, cB, opts, REFERENCE_KERNELS, jnp.float64)
        s = _run_phase(
            ctx, bB, cB, s, opts, REFERENCE_KERNELS, jnp.float64, 1e-9, 50, jnp.any
        )
        assert int(s.status[0]) == int(Status.OPTIMAL)
        good = s  # converged state: its iterate meets 1e-9
        # build a NUMERICAL state whose CURRENT iterate is garbage but
        # whose best trackers hold the converged point
        bad = good._replace(
            x=jnp.abs(good.x) + 17.0,
            y=good.y + 3.0,
            z=jnp.abs(good.z) + 5.0,
            status=jnp.full_like(good.status, int(Status.NUMERICAL)),
            best_x=good.x,
            best_y=good.y,
            best_z=good.z,
            best_tau=good.tau,
            best_kappa=good.kappa,
            best_score=jnp.full_like(good.best_score, 1e-10),
        )
        x, yv, zv, tau, kappa, status, ind = _finalize(
            ctx, bB, cB, bad, REFERENCE_KERNELS, 1e-6
        )
        np.testing.assert_allclose(np.asarray(x), np.asarray(good.x))
        # the best point meets tol -> re-opened and classified OPTIMAL
        assert int(status[0]) == int(Status.OPTIMAL)
        # and a NUMERICAL lane whose best does NOT meet tol stays NUMERICAL
        _, _, _, _, _, status2, _ = _finalize(
            ctx, bB, cB, bad, REFERENCE_KERNELS, 1e-15
        )
        assert int(status2[0]) == int(Status.NUMERICAL)


class TestRestartStallClock:
    """Round-3 on-chip find: a restarted lane keeps its OLD best trackers
    as insurance, so the stall clock's baseline is the old best_score —
    which a cold start cannot beat until it has nearly converged.  With a
    finite patience the clock killed exactly the lanes needing more than
    `patience` iterations (2/256 bench lanes stall-killed at k=8 that
    converge at k=9-10).  Restart phases must run with the stall cutoff
    disabled (they are budget-capped already)."""

    def test_compact_restart_survives_unbeatable_old_best(self):
        from pycllp_jax.ops.reference import REFERENCE_KERNELS
        from pycllp_jax.solvers.hsd import _compact_resume, _fresh_state

        m, n, B = 16, 40, 8
        A, _, _ = random_equality_lp(m, n, seed=31)
        rng = np.random.default_rng(32)
        b = (rng.uniform(0.1, 1.0, size=(B, n)) @ A.T).astype(np.float64)
        c = (rng.normal(size=(B, m)) @ A + rng.uniform(0.1, 1.0, size=(B, n))).astype(
            np.float64
        )
        opts = SolverOptions(tol=1e-9, dtype="float64", stall_patience=2)
        ctx = REFERENCE_KERNELS.prepare(jnp.asarray(A))
        bj, cj = jnp.asarray(b), jnp.asarray(c)
        state = _fresh_state(ctx, bj, cj, opts, REFERENCE_KERNELS, jnp.float64)
        # every lane: STALLED, with an old best_score no fresh run can
        # beat before `stall_patience` runs out
        state = state._replace(
            status=jnp.full_like(state.status, int(Status.STALLED)),
            best_score=jnp.full_like(state.best_score, 1e-12),
        )
        out = _compact_resume(
            ctx, bj, cj, state, opts, REFERENCE_KERNELS, jnp.float64,
            1e-9, 40, bucket=B, restart=True,
        )
        # convergence from the cold restart takes ~10 iterations; with
        # the stall cutoff active at patience 2 every lane would be
        # killed at k=2 and stay STALLED
        assert np.all(np.asarray(out.status) == int(Status.OPTIMAL)), np.asarray(
            out.status
        )



class TestFinishTolerance:
    """Lanes the wide IPM finishes stop at ``opts.finish_tol()``, a decade
    under ``tol``: ρ ≤ tol bounds the residuals, not the objective error
    (bench-workload lanes accepted at ρ ≤ tol were up to 1.15e-6 off
    scipy)."""

    def test_finish_tol_is_a_decade_under_tol(self):
        assert SolverOptions(tol=1e-6).finish_tol() == pytest.approx(1e-7)

    @pytest.mark.parametrize("path", ["batched", "scan"])
    def test_ipm_finished_lanes_meet_finish_tol(self, path):
        from pycllp_jax.solvers.hsd import hsd_solve_scan

        lp = random_standard_lp(16, 24, nlp=64, seed=21, dtype=np.float32)
        eq = lp.to_equality_form()
        A, b, c = (np.asarray(v, np.float32) for v in (eq.A, eq.b, eq.c))
        opts = SolverOptions(
            tol=1e-6, dtype="float32", finish_dtype="float64", switch_tol=1e-4,
            init_point="mehrotra", finish_mode="ipm",
        )
        if path == "batched":
            out = hsd_solve_batched(A, b, c, opts)
        else:
            out = hsd_solve_scan(
                A, b, c, opts, chunk=32, compact_cap=8, compact_bucket=32,
                keys=("status", "tau", "rho_p", "rho_d", "rho_gap"),
            )
        out = {k: np.asarray(v) for k, v in out.items()}
        assert np.all(out["status"] == int(Status.OPTIMAL))
        rho = np.maximum(np.maximum(out["rho_p"], out["rho_d"]), out["rho_gap"])
        ipm = np.abs(out["tau"] - 1.0) > 1e-12  # IPM iterates, not vertices
        assert ipm.sum() > 32
        assert rho[ipm].max() <= opts.tol / 10, rho[ipm].max()
