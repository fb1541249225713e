"""Vertex crossover finish (solvers/crossover.py).

The crossover replaces the wide IPM continuation with ONE wide basis
solve per lane: basis identification from the narrow interior point,
exact vertex recovery from the basis normal equations, per-lane
verification with an IPM fallback for rejects.  Tests cover the basis
indicator, candidate recovery on known LPs, end-to-end accuracy vs
scipy through both solve paths, and the reject-fallback guarantee.
"""

import numpy as np
import pytest
from scipy.optimize import linprog

from pycllp_jax import SolverOptions, Status
from pycllp_jax.io.generate import random_standard_lp
from pycllp_jax.ops.reference import REFERENCE_KERNELS
from pycllp_jax.solvers.crossover import basis_indicator, crossover_candidate
from pycllp_jax.solvers.hsd import hsd_solve_batched, hsd_solve_scan


def _finish_opts(mode, **kw):
    return SolverOptions(
        tol=2e-7,
        maxiter=40,
        dtype="float32",
        finish_dtype="float64",
        switch_tol=1e-5,
        stall_patience=3,
        stall_rtol=0.05,
        refine_steps=0,
        init_point="mehrotra",
        finish_mode=mode,
        **kw,
    )


def _scipy_rel_errs(lp, objective, n):
    rels = []
    for i in range(np.asarray(lp.b).shape[0]):
        res = linprog(
            -np.asarray(lp.c)[i],
            A_ub=np.asarray(lp.A),
            b_ub=np.asarray(lp.b)[i],
            bounds=[(0, None)] * n,
            method="highs",
        )
        if res.status == 0:
            rels.append(abs(-float(objective[i]) + res.fun) / max(1, abs(res.fun)))
    assert rels, "no scipy-feasible lanes to audit"
    return np.asarray(rels)


class TestBasisIndicator:
    def test_separated_partition(self):
        # basic: x large / z tiny; nonbasic: x tiny / z large
        x = np.array([[1.0, 2.0, 1e-8, 1e-9, 3.0]])
        z = np.array([[1e-8, 1e-9, 1.0, 2.0, 1e-7]])
        d = np.asarray(basis_indicator(x, z, 3))
        np.testing.assert_array_equal(d, [[1.0, 1.0, 0.0, 0.0, 1.0]])

    def test_exactly_m_per_lane(self):
        rng = np.random.default_rng(0)
        x = rng.uniform(size=(7, 12))
        z = rng.uniform(size=(7, 12))
        d = np.asarray(basis_indicator(x, z, 5))
        np.testing.assert_array_equal(d.sum(axis=-1), np.full(7, 5.0))

    def test_nan_lanes_still_yield_m(self):
        x = np.array([[np.nan, 1.0, 2.0, np.nan]])
        z = np.array([[1.0, 1.0, 1.0, 1.0]])
        d = np.asarray(basis_indicator(x, z, 2))
        assert d.sum() == 2.0
        # the finite ratios win the top-k over the NaN-poisoned ones
        np.testing.assert_array_equal(d, [[0.0, 1.0, 1.0, 0.0]])


class TestCrossoverCandidate:
    def test_recovers_known_vertex(self):
        # min -x1-x2  s.t. x1+2x2<=2, 3x1+x2<=3  → vertex x=(0.8, 0.6)
        A = np.array([[1.0, 2.0, 1.0, 0.0], [3.0, 1.0, 0.0, 1.0]])
        b = np.array([[2.0, 3.0]])
        c = np.array([[-1.0, -1.0, 0.0, 0.0]])
        # a near-converged interior point: basic {x1, x2}, nonbasic slacks
        x = np.array([[0.8, 0.6, 1e-7, 1e-7]])
        z = np.array([[1e-7, 1e-7, 0.2, 0.2]])
        ctx = REFERENCE_KERNELS.prepare(A)
        xv, yv, zv, ok, _, _ = crossover_candidate(
            ctx, b, c, x, z, REFERENCE_KERNELS, refine=2, feas_tol=1e-9
        )
        assert bool(np.asarray(ok)[0])
        np.testing.assert_allclose(
            np.asarray(xv)[0], [0.8, 0.6, 0.0, 0.0], atol=1e-12
        )
        # exact complementary duals: z_B = 0, reduced costs nonnegative
        np.testing.assert_allclose(np.asarray(zv)[0, :2], 0.0, atol=1e-12)
        assert np.all(np.asarray(zv)[0, 2:] >= -1e-12)

    def test_wrong_basis_rejected(self):
        # same LP, but the "interior point" votes the slacks basic →
        # the candidate vertex (x=0, s=b) is feasible but NOT optimal;
        # its reduced costs go negative and verification must hold it to
        # the sign test, while the caller's rho test kills optimality.
        A = np.array([[1.0, 2.0, 1.0, 0.0], [3.0, 1.0, 0.0, 1.0]])
        b = np.array([[2.0, 3.0]])
        c = np.array([[-1.0, -1.0, 0.0, 0.0]])
        x = np.array([[1e-7, 1e-7, 2.0, 3.0]])
        z = np.array([[0.2, 0.2, 1e-7, 1e-7]])
        ctx = REFERENCE_KERNELS.prepare(A)
        xv, yv, zv, ok, _, _ = crossover_candidate(
            ctx, b, c, x, z, REFERENCE_KERNELS, refine=2, feas_tol=1e-9
        )
        # y = 0 for the slack basis → z = c, which has negative entries
        assert not bool(np.asarray(ok)[0])


class TestBasisRepair:
    def test_repair_fixes_off_by_one_basis(self):
        # same known-vertex LP, but the interior point's ratio ordering
        # votes a slack basic in place of x2 (off-by-one guess): the
        # first candidate fails the sign test and one repair round must
        # swap the violated pair and accept.
        A = np.array([[1.0, 2.0, 1.0, 0.0], [3.0, 1.0, 0.0, 1.0]])
        b = np.array([[2.0, 3.0]])
        c = np.array([[-1.0, -1.0, 0.0, 0.0]])
        # basis guess {x1, s1}: ratios put x2 third
        x = np.array([[0.9, 1e-6, 0.4, 1e-7]])
        z = np.array([[1e-7, 1e-5, 1e-7, 0.3]])
        ctx = REFERENCE_KERNELS.prepare(A)
        _, _, _, ok0, _, _ = crossover_candidate(
            ctx, b, c, x, z, REFERENCE_KERNELS, refine=2, feas_tol=1e-9, repair=0
        )
        assert not bool(np.asarray(ok0)[0])
        xv, yv, zv, ok, _, _ = crossover_candidate(
            ctx, b, c, x, z, REFERENCE_KERNELS, refine=2, feas_tol=1e-9, repair=2
        )
        assert bool(np.asarray(ok)[0])
        np.testing.assert_allclose(np.asarray(xv)[0], [0.8, 0.6, 0.0, 0.0], atol=1e-10)

    def test_repair_raises_acceptance_on_random_batch(self):
        # random batch, interior points truncated early (capped narrow
        # phase analogue): repair must strictly raise the accept count,
        # and accepted lanes must carry contract-grade vertices.
        from pycllp_jax.solvers.hsd import hsd_solve_batched as _solve

        lp = random_standard_lp(16, 24, nlp=64, seed=11, dtype=np.float32)
        eq = lp.to_equality_form()
        A = np.asarray(eq.A, np.float64)
        b = np.asarray(eq.b, np.float64)
        c = np.asarray(eq.c, np.float64)
        # a half-converged interior point: few IPM iterations only
        out = _solve(A, b, c, SolverOptions(tol=1e-2, maxiter=7, dtype="float64"))
        x = np.asarray(out["x"])
        z = np.asarray(out["z"])
        from pycllp_jax.utils.scaling import ruiz_equilibrate, scale_problem

        sc = ruiz_equilibrate(A)
        A_s, b_s, c_s = scale_problem(A, b, c, sc)
        xs = x / np.asarray(sc.col)
        zs = z * np.asarray(sc.col)
        ctx = REFERENCE_KERNELS.prepare(np.asarray(A_s))
        accs = []
        for rep in (0, 3):
            _, _, _, ok, _, _ = crossover_candidate(
                ctx, np.asarray(b_s), np.asarray(c_s), xs, zs,
                REFERENCE_KERNELS, refine=2, feas_tol=1e-9, repair=rep,
            )
            accs.append(int(np.asarray(ok).sum()))
        assert accs[1] > accs[0], accs

    def test_mixed_kset_crossover_matches_reference(self):
        # the shipping config: basis solves on f32 factors + Triton
        # solves + f64 refinement ("mixed") must accept the same lanes as
        # the f64 oracle on a well-conditioned batch, with the same
        # vertices.
        from pycllp_jax.ops.gpu import TritonKernels

        mixed = TritonKernels(interpret=True).crossover_kernels("mixed")
        lp = random_standard_lp(24, 36, nlp=32, seed=12, dtype=np.float32)
        eq = lp.to_equality_form()
        A = np.asarray(eq.A, np.float64)
        b = np.asarray(eq.b, np.float64)
        c = np.asarray(eq.c, np.float64)
        out = hsd_solve_batched(A, b, c, SolverOptions(tol=1e-5, dtype="float64"))
        tau = np.maximum(np.asarray(out["tau"]), 1e-300)
        x = np.asarray(out["x"])  # already de-embedded by _package
        z = np.asarray(out["z"])
        ctx_r = REFERENCE_KERNELS.prepare(A)
        ctx_m = mixed.prepare(A)
        xr, _, _, okr, _, _ = crossover_candidate(
            ctx_r, b, c, x, z, REFERENCE_KERNELS, refine=2, repair=2
        )
        xm, _, _, okm, _, _ = crossover_candidate(ctx_m, b, c, x, z, mixed, refine=2, repair=2)
        okr, okm = np.asarray(okr), np.asarray(okm)
        assert okr.mean() > 0.8, okr.mean()
        # mixed must accept (nearly) everything the oracle accepts…
        agree = (okm & okr).sum() / max(okr.sum(), 1)
        assert agree >= 0.95, (okr.sum(), okm.sum())
        # …and agree on the accepted vertices to f64-refinement accuracy
        both = okm & okr
        np.testing.assert_allclose(
            np.asarray(xm)[both], np.asarray(xr)[both], atol=1e-8
        )


class TestCrossoverEndToEnd:
    def test_batched_meets_contract(self):
        lp = random_standard_lp(24, 36, nlp=48, seed=5, dtype=np.float32)
        eq = lp.to_equality_form()
        out = hsd_solve_batched(
            np.asarray(eq.A, np.float32),
            np.asarray(eq.b, np.float32),
            np.asarray(eq.c, np.float32),
            _finish_opts("crossover"),
        )
        st = np.asarray(out["status"])
        assert np.all(st == int(Status.OPTIMAL)), np.unique(st, return_counts=True)
        rels = _scipy_rel_errs(lp, np.asarray(out["objective"]), 36)
        assert rels.max() <= 1e-6, rels.max()

    def test_scan_compact_meets_contract(self):
        lp = random_standard_lp(24, 36, nlp=64, seed=6, dtype=np.float32)
        eq = lp.to_equality_form()
        out = hsd_solve_scan(
            np.asarray(eq.A, np.float32),
            np.asarray(eq.b, np.float32),
            np.asarray(eq.c, np.float32),
            _finish_opts("crossover"),
            chunk=32,
            compact_cap=8,
            compact_bucket=32,
            finish_cap=3,
            finish_bucket=16,
        )
        st = np.asarray(out["status"])
        assert np.all(st == int(Status.OPTIMAL)), np.unique(st, return_counts=True)
        rels = _scipy_rel_errs(lp, np.asarray(out["objective"]), 36)
        assert rels.max() <= 1e-6, rels.max()

    def test_rejects_fall_back_to_ipm(self):
        # crossover disabled from ever accepting (impossible feas_tol) →
        # every lane must still finish through the wide IPM fallback at
        # the same contract: the crossover is an accelerator, never a
        # correctness gate.
        lp = random_standard_lp(16, 24, nlp=16, seed=7, dtype=np.float32)
        eq = lp.to_equality_form()
        out = hsd_solve_batched(
            np.asarray(eq.A, np.float32),
            np.asarray(eq.b, np.float32),
            np.asarray(eq.c, np.float32),
            _finish_opts("crossover", crossover_feas_tol=1e-300),
        )
        st = np.asarray(out["status"])
        assert np.all(st == int(Status.OPTIMAL)), np.unique(st, return_counts=True)
        rels = _scipy_rel_errs(lp, np.asarray(out["objective"]), 24)
        assert rels.max() <= 1e-6, rels.max()

    def test_batched_A_crossover_finish(self):
        # per-instance (B, m, n) A through the DEFAULT crossover config
        # (mixed1 basis engine → k=2 RHS per basis solve): the stacked
        # IR sweep in MixedPrecisionKernels.solve used to broadcast the
        # einsum batch B against k·B and fail at trace time (ADVICE r3).
        lp = random_standard_lp(12, 18, nlp=6, seed=8, dtype=np.float32)
        eq = lp.to_equality_form()
        A2 = np.asarray(eq.A, np.float32)
        A3 = np.broadcast_to(A2, (6,) + A2.shape).copy()
        out = hsd_solve_batched(
            A3,
            np.asarray(eq.b, np.float32),
            np.asarray(eq.c, np.float32),
            _finish_opts("crossover"),
        )
        st = np.asarray(out["status"])
        assert np.all(st == int(Status.OPTIMAL)), np.unique(st, return_counts=True)
        rels = _scipy_rel_errs(lp, np.asarray(out["objective"]), 18)
        assert rels.max() <= 1e-6, rels.max()

    def test_infeasible_lanes_not_hijacked(self):
        # an infeasible instance mixed into the batch must stay
        # INFEASIBLE through the crossover finish (eligibility mask)
        A = np.array([[1.0, 1.0, 1.0, 0.0], [1.0, 1.0, 0.0, -1.0]], np.float32)
        b_feas = np.array([2.0, 1.0], np.float32)
        b_inf = np.array([1.0, 2.0], np.float32)  # x1+x2<=1 & x1+x2>=2
        c = np.array([-1.0, -2.0, 0.0, 0.0], np.float32)
        out = hsd_solve_batched(
            A,
            np.stack([b_feas, b_inf]),
            np.stack([c, c]),
            _finish_opts("crossover"),
        )
        st = np.asarray(out["status"])
        assert st[0] == int(Status.OPTIMAL)
        assert st[1] == int(Status.INFEASIBLE)
