"""Column-sharded (big-LP / model-parallel) HSD tests on the 8-device
CPU mesh: the psum-assembled normal matrix must reproduce the unsharded
solve exactly (same algorithm, same arithmetic up to reduction order)."""

import numpy as np
import pytest
from scipy.optimize import linprog

import jax

from pycllp_jax import SolverOptions, Status
from pycllp_jax.io.generate import random_equality_lp
from pycllp_jax.parallel import column_sharded_hsd_solve, model_mesh
from pycllp_jax.solvers.hsd import hsd_solve


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8
    return model_mesh(8)


class TestColumnSharded:
    @pytest.mark.parametrize("shape", [(10, 40), (24, 64)])
    def test_matches_scipy(self, mesh8, shape):
        m, n = shape
        A, b, c = random_equality_lp(m, n, seed=m)
        out = column_sharded_hsd_solve(A, b, c, SolverOptions(tol=1e-8, scale=False), mesh=mesh8)
        assert int(np.asarray(out["status"])) == int(Status.OPTIMAL)
        res = linprog(c, A_eq=A, b_eq=b, bounds=[(0, None)] * n, method="highs")
        np.testing.assert_allclose(
            float(np.asarray(out["objective"])), res.fun, rtol=1e-6, atol=1e-6
        )
        x = np.asarray(out["x"])
        assert x.shape == (n,)
        np.testing.assert_allclose(A @ x, b, rtol=1e-6, atol=1e-6)

    def test_matches_unsharded(self, mesh8):
        m, n = 12, 48
        A, b, c = random_equality_lp(m, n, seed=61)
        opts = SolverOptions(tol=1e-9, scale=False)
        ref = hsd_solve(A, b, c, opts)
        out = column_sharded_hsd_solve(A, b, c, opts, mesh=mesh8)
        np.testing.assert_allclose(
            float(np.asarray(out["objective"])),
            float(ref["objective"]),
            rtol=1e-9,
            atol=1e-10,
        )
        assert int(np.asarray(out["iterations"])) <= int(ref["iterations"]) + 2

    def test_infeasible(self, mesh8):
        A = np.zeros((1, 8))
        A[0, :] = 1.0
        b = np.array([-1.0])
        c = np.ones(8)
        out = column_sharded_hsd_solve(A, b, c, SolverOptions(tol=1e-8, scale=False), mesh=mesh8)
        assert int(np.asarray(out["status"])) == int(Status.INFEASIBLE)

    def test_indivisible_raises(self, mesh8):
        A, b, c = random_equality_lp(5, 14, seed=3)
        with pytest.raises(ValueError, match="divisible"):
            column_sharded_hsd_solve(A, b, c, SolverOptions(), mesh=mesh8)

    def test_one_device(self):
        m, n = 8, 24
        A, b, c = random_equality_lp(m, n, seed=5)
        out = column_sharded_hsd_solve(
            A, b, c, SolverOptions(tol=1e-8, scale=False), mesh=model_mesh(1)
        )
        assert int(np.asarray(out["status"])) == int(Status.OPTIMAL)


class TestBatchedSchur:
    """VERDICT r1 item 4: batch axis + registry + big-LP cross-check."""

    def test_batched_matches_per_lane_scipy(self, mesh8):
        m, n, B = 12, 48, 5
        rng = np.random.default_rng(71)
        A, b0, c0 = random_equality_lp(m, n, seed=71)
        b = np.stack([b0 * (1 + 0.1 * rng.random(m)) for _ in range(B)])
        c = np.stack([c0 + 0.05 * rng.random(n) for _ in range(B)])
        out = column_sharded_hsd_solve(
            A, b, c, SolverOptions(tol=1e-8, scale=False), mesh=mesh8
        )
        assert np.all(np.asarray(out["status"]) == int(Status.OPTIMAL))
        assert np.asarray(out["x"]).shape == (B, n)
        for i in range(B):
            res = linprog(c[i], A_eq=A, b_eq=b[i], bounds=[(0, None)] * n, method="highs")
            np.testing.assert_allclose(
                float(np.asarray(out["objective"])[i]), res.fun, rtol=1e-6, atol=1e-6
            )

    def test_registry_schur_pads_columns(self, mesh8):
        from pycllp_jax import get_solver
        from pycllp_jax.io.generate import random_standard_lp

        # n_structural + m slacks not divisible by 8 → exercises padding
        lp = random_standard_lp(9, 21, nlp=3, seed=17)
        s = get_solver("schur", tol=1e-8, mesh=mesh8)
        s.init(lp)
        sol = s.solve()
        assert sol.converged.all()
        assert np.asarray(sol.x).shape == (3, 21)
        for i in range(3):
            res = linprog(
                -np.asarray(lp.c)[i], A_ub=np.asarray(lp.A), b_ub=np.asarray(lp.b)[i],
                bounds=[(0, None)] * 21, method="highs",
            )
            np.testing.assert_allclose(
                float(sol.objective[i]), -res.fun, rtol=1e-6, atol=1e-6
            )

    def test_big_lp_m128_n1024(self, mesh8):
        """The big-LP target shape: m=128, n=1024, sharded over 8 devices."""
        m, n = 128, 1024
        A, b, c = random_equality_lp(m, n, seed=128)
        out = column_sharded_hsd_solve(
            A, b, c, SolverOptions(tol=1e-8, scale=False), mesh=mesh8
        )
        assert int(np.asarray(out["status"])) == int(Status.OPTIMAL)
        res = linprog(c, A_eq=A, b_eq=b, bounds=[(0, None)] * n, method="highs")
        np.testing.assert_allclose(
            float(np.asarray(out["objective"])), res.fun, rtol=1e-6, atol=1e-6
        )
        x = np.asarray(out["x"])
        np.testing.assert_allclose(A @ x, b, rtol=1e-6, atol=1e-6)

    def test_m256_f32_finish_meets_contract(self, mesh8):
        """The round-3 bench case that iteration-capped: m=256 in f32.

        VERDICT r3 item 6 / BENCH_ALL_r03's schur line: every m=256
        instance ended ITERATION_LIMIT at f32/tol 1e-5 because the
        sharded loop ran unscaled from a blind start with no stall
        insurance.  With the batched-path playbook ported in (Ruiz
        scaling, Mehrotra start, best-iterate + stall clock, wide
        finish), the same configuration must now reach OPTIMAL at the
        1e-6 contract vs scipy.
        """
        m, n, B = 256, 2048, 2
        rng = np.random.default_rng(0)
        A, b0, c0 = random_equality_lp(m, n, seed=9)
        b = np.stack([b0 * (1 + 0.05 * rng.random(m)) for _ in range(B)]).astype(
            np.float32
        )
        c = np.stack([c0 + 0.02 * rng.random(n) for _ in range(B)]).astype(np.float32)
        out = column_sharded_hsd_solve(
            A.astype(np.float32), b, c,
            SolverOptions(
                tol=1e-6, dtype="float32", maxiter=60, init_point="mehrotra",
                stall_patience=6, finish_dtype="float64", switch_tol=1e-4,
                finish_maxiter=30,
            ),
            mesh=mesh8,
        )
        st = np.asarray(out["status"])
        assert np.all(st == int(Status.OPTIMAL)), st
        for i in range(B):
            res = linprog(
                c[i].astype(np.float64), A_eq=A, b_eq=b[i].astype(np.float64),
                bounds=[(0, None)] * n, method="highs",
            )
            rel = abs(float(np.asarray(out["objective"])[i]) - res.fun) / max(
                1, abs(res.fun)
            )
            assert rel < 1e-6, (i, rel)


class TestShardedFactor:
    """Distributed blocked Cholesky (parallel/dchol.py): VERDICT r2
    item 10 — the big-m path where the m×m factor itself is sharded."""

    def test_dchol_matches_numpy(self, mesh8):
        from functools import partial

        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        from pycllp_jax.parallel.dchol import (
            rowshard_cholesky,
            rowshard_cholesky_solve,
        )

        m, B = 64, 3
        rng = np.random.default_rng(0)
        X = rng.normal(size=(B, m, 2 * m))
        M = np.einsum("bij,bkj->bik", X, X) + m * np.eye(m)
        r = rng.normal(size=(B, m))

        @partial(
            jax.shard_map,
            mesh=mesh8,
            in_specs=(P(None, "model", None), P()),
            out_specs=(P(None, "model", None), P()),
            check_vma=False,
        )
        def run(Mw, r):
            Lw, kks = rowshard_cholesky(Mw, "model", 8)
            return Lw, rowshard_cholesky_solve(Lw, kks, r, "model", 8)

        Lw, x = run(jnp.asarray(M), jnp.asarray(r))
        np.testing.assert_allclose(np.asarray(Lw), np.linalg.cholesky(M), atol=1e-12)
        x_ref = np.linalg.solve(M, r[..., None])[..., 0]
        np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-12, atol=1e-12)

    def test_sharded_factor_matches_replicated(self, mesh8):
        # m divisible by the mesh: rows shard 8 ways; the solve must
        # agree with the replicated-factor path to reduction-order noise
        m, n = 16, 64
        A, b, c = random_equality_lp(m, n, seed=77)
        opts = SolverOptions(tol=1e-9, scale=False)
        ref = column_sharded_hsd_solve(A, b, c, opts, mesh=mesh8)
        out = column_sharded_hsd_solve(A, b, c, opts, mesh=mesh8, factor="sharded")
        assert int(np.asarray(out["status"])) == int(Status.OPTIMAL)
        np.testing.assert_allclose(
            float(np.asarray(out["objective"])),
            float(np.asarray(ref["objective"])),
            rtol=1e-8,
            atol=1e-9,
        )

    def test_sharded_factor_batched_vs_scipy(self, mesh8):
        m, n, B = 32, 128, 4
        A, b0, c0 = random_equality_lp(m, n, seed=5)
        rng = np.random.default_rng(6)
        b = np.stack([b0 * (1 + 0.1 * rng.random(m)) for _ in range(B)])
        c = np.stack([c0 + 0.05 * rng.random(n) for _ in range(B)])
        out = column_sharded_hsd_solve(
            A, b, c, SolverOptions(tol=1e-8, scale=False), mesh=mesh8, factor="sharded"
        )
        st = np.asarray(out["status"])
        assert np.all(st == int(Status.OPTIMAL)), st
        for i in range(B):
            res = linprog(c[i], A_eq=A, b_eq=b[i], bounds=[(0, None)] * n, method="highs")
            assert res.status == 0
            np.testing.assert_allclose(
                float(np.asarray(out["objective"])[i]), res.fun, rtol=1e-6, atol=1e-6
            )

    def test_indivisible_m_raises(self, mesh8):
        A, b, c = random_equality_lp(12, 48, seed=3)
        with pytest.raises(ValueError, match="divisible"):
            column_sharded_hsd_solve(
                A, b, c, SolverOptions(), mesh=mesh8, factor="sharded"
            )
