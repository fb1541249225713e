"""Sharded-solve tests on the virtual 8-device CPU mesh (SURVEY.md §4.2)."""

import numpy as np
import pytest
from scipy.optimize import linprog

import jax

from pycllp_jax import SolverOptions, Status
from pycllp_jax.io.generate import random_equality_lp
from pycllp_jax.parallel import scenario_mesh, sharded_hsd_solve
from pycllp_jax.solvers.hsd import hsd_solve_batched


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8
    return scenario_mesh(8)


class TestShardedSolve:
    @pytest.mark.parametrize("termination", ["collective", "local"])
    def test_matches_unsharded(self, mesh8, termination):
        m, n, B = 8, 20, 32
        A, _, _ = random_equality_lp(m, n, seed=17)
        rng = np.random.default_rng(18)
        x0 = rng.uniform(0.1, 1.0, size=(B, n))
        y0 = rng.normal(size=(B, m))
        z0 = rng.uniform(0.1, 1.0, size=(B, n))
        b = x0 @ A.T
        c = y0 @ A + z0
        opts = SolverOptions(tol=1e-8)
        ref = hsd_solve_batched(A, b, c, opts)
        out = sharded_hsd_solve(A, b, c, opts, mesh=mesh8, termination=termination)
        assert np.all(np.asarray(out["status"]) == int(Status.OPTIMAL))
        np.testing.assert_allclose(
            np.asarray(out["objective"]), np.asarray(ref["objective"]), rtol=1e-8, atol=1e-9
        )

    def test_matches_scipy(self, mesh8):
        m, n, B = 6, 15, 16
        A, _, _ = random_equality_lp(m, n, seed=4)
        rng = np.random.default_rng(5)
        b = rng.uniform(0.1, 1.0, size=(B, n)) @ A.T
        c = rng.normal(size=(B, m)) @ A + rng.uniform(0.1, 1.0, size=(B, n))
        out = sharded_hsd_solve(A, b, c, SolverOptions(tol=1e-8), mesh=mesh8)
        for i in range(0, B, 5):
            res = linprog(c[i], A_eq=A, b_eq=b[i], bounds=[(0, None)] * n, method="highs")
            np.testing.assert_allclose(
                float(np.asarray(out["objective"])[i]), res.fun, rtol=1e-6, atol=1e-6
            )

    def test_batched_A_shards(self, mesh8):
        m, n, B = 5, 12, 16
        A, b, c = random_equality_lp(m, n, nlp=B, seed=9, shared_A=False)
        out = sharded_hsd_solve(A, b, c, SolverOptions(tol=1e-8), mesh=mesh8)
        assert np.all(np.asarray(out["status"]) == int(Status.OPTIMAL))

    def test_single_device_mesh_degrades(self):
        mesh1 = scenario_mesh(1)
        m, n, B = 5, 12, 4
        A, b, c = random_equality_lp(m, n, nlp=B, seed=2, shared_A=False)
        out = sharded_hsd_solve(A, b, c, SolverOptions(tol=1e-8), mesh=mesh1)
        assert np.all(np.asarray(out["status"]) == int(Status.OPTIMAL))

    def test_indivisible_batch_raises(self, mesh8):
        A, b, c = random_equality_lp(5, 12, nlp=12, seed=2, shared_A=False)
        with pytest.raises(ValueError, match="divisible"):
            sharded_hsd_solve(A, b, c, SolverOptions(), mesh=mesh8)

    def test_mixed_statuses_across_shards(self, mesh8):
        """Infeasible + optimal lanes spread over devices: the collective
        gate must keep looping until the slowest shard finishes."""
        A = np.array([[1.0, 1.0]])
        B = 16
        rng = np.random.default_rng(0)
        bs = rng.uniform(0.5, 2.0, size=(B, 1))
        bs[::4] = -1.0  # every 4th lane infeasible
        cs = np.broadcast_to(np.array([1.0, 2.0]), (B, 2)).copy()
        out = sharded_hsd_solve(
            np.broadcast_to(A, (B, 1, 2)).copy(), bs, cs, SolverOptions(tol=1e-8), mesh=mesh8
        )
        st = np.asarray(out["status"])
        assert np.all(st[::4] == int(Status.INFEASIBLE))
        mask = np.ones(B, bool)
        mask[::4] = False
        assert np.all(st[mask] == int(Status.OPTIMAL))


class TestShardedScan:
    """sharded_hsd_solve_scan: the compaction sweep over a mesh (round 4
    — the sharded path previously had no cap/compact/finish story)."""

    def test_matches_unsharded_scan(self, mesh8):
        from pycllp_jax.io.generate import random_standard_lp
        from pycllp_jax.parallel import sharded_hsd_solve_scan
        from pycllp_jax.solvers.hsd import hsd_solve_scan

        lp = random_standard_lp(12, 18, nlp=64, seed=21, dtype=np.float64)
        eq = lp.to_equality_form()
        A = np.asarray(eq.A)
        b = np.asarray(eq.b)
        c = np.asarray(eq.c)
        opts = SolverOptions(tol=1e-8, maxiter=40, dtype="float64")
        # buckets sized to cover every still-running lane on both paths:
        # an OVERFLOWING bucket legitimately diverges (the unsharded
        # gather spans all lanes, the sharded one only its shard)
        ref = hsd_solve_scan(A, b, c, opts, chunk=8, compact_cap=6, compact_bucket=64)
        out = sharded_hsd_solve_scan(
            A, b, c, opts, mesh=mesh8, chunk=8, compact_cap=6, compact_bucket=64,
        )
        np.testing.assert_array_equal(
            np.asarray(out["status"]), np.asarray(ref["status"])
        )
        np.testing.assert_allclose(
            np.asarray(out["objective"]), np.asarray(ref["objective"]),
            rtol=1e-9, atol=1e-10,
        )

    def test_finish_crossover_meets_contract(self, mesh8):
        from scipy.optimize import linprog

        from pycllp_jax.io.generate import random_standard_lp
        from pycllp_jax.parallel import sharded_hsd_solve_scan

        lp = random_standard_lp(16, 24, nlp=64, seed=22, dtype=np.float32)
        eq = lp.to_equality_form()
        out = sharded_hsd_solve_scan(
            np.asarray(eq.A, np.float32),
            np.asarray(eq.b, np.float32),
            np.asarray(eq.c, np.float32),
            SolverOptions(
                tol=2e-7, maxiter=40, dtype="float32", stall_patience=3,
                stall_rtol=0.05, refine_steps=0, init_point="mehrotra",
                finish_dtype="float64", switch_tol=1e-5,
                finish_mode="crossover",
            ),
            mesh=mesh8, chunk=8, compact_cap=8, compact_bucket=8,
            finish_cap=3, finish_bucket=8,
        )
        st = np.asarray(out["status"])
        assert np.all(st == int(Status.OPTIMAL)), np.unique(st, return_counts=True)
        rels = []
        for i in range(0, 64, 8):
            res = linprog(
                -np.asarray(lp.c)[i], A_ub=np.asarray(lp.A),
                b_ub=np.asarray(lp.b)[i], bounds=[(0, None)] * 24,
                method="highs",
            )
            rels.append(
                abs(-float(out["objective"][i]) + res.fun) / max(1, abs(res.fun))
            )
        assert max(rels) <= 1e-6, max(rels)


class TestDistributedHelpers:
    def test_single_process_noop(self):
        from pycllp_jax.parallel import initialize, is_distributed

        assert initialize() is False
        assert is_distributed() is False

    def test_global_mesh(self):
        from pycllp_jax.parallel import global_scenario_mesh

        mesh = global_scenario_mesh()
        assert mesh.devices.size == 8
        assert mesh.axis_names == ("scenario",)

    def test_host_local_batch(self):
        from pycllp_jax.parallel import host_local_batch

        lo, count = host_local_batch(100)
        assert (lo, count) == (0, 100)  # single process owns everything
