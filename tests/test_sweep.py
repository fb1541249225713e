"""Scenario-sweep chunking + checkpoint/resume tests (SURVEY.md §5)."""

import numpy as np
import pytest

from pycllp_jax import SolverOptions, Status
from pycllp_jax.io.generate import random_equality_lp
from pycllp_jax.utils.sweep import scenario_sweep


@pytest.fixture()
def sweep_problem():
    m, n, N = 6, 15, 50
    A, _, _ = random_equality_lp(m, n, seed=40)
    rng = np.random.default_rng(41)
    b = rng.uniform(0.1, 1.0, size=(N, n)) @ A.T
    c = rng.normal(size=(N, m)) @ A + rng.uniform(0.1, 1.0, size=(N, n))
    return A, b, c


class TestSweep:
    def test_chunked_matches_single(self, sweep_problem):
        A, b, c = sweep_problem
        opts = SolverOptions(tol=1e-8)
        res16 = scenario_sweep(A, b, c, opts, chunk=16)
        res50 = scenario_sweep(A, b, c, opts, chunk=50)
        assert res16.n_chunks == 4
        np.testing.assert_allclose(res16.objective, res50.objective, rtol=1e-9)
        assert (res16.status == int(Status.OPTIMAL)).all()

    def test_resume_skips_completed(self, sweep_problem, tmp_path):
        A, b, c = sweep_problem
        opts = SolverOptions(tol=1e-8)
        d = str(tmp_path / "sweep")
        first = scenario_sweep(A, b, c, opts, chunk=16, out_dir=d)
        assert first.n_resumed == 0
        second = scenario_sweep(A, b, c, opts, chunk=16, out_dir=d)
        assert second.n_resumed == 4
        np.testing.assert_allclose(first.objective, second.objective)

    def test_partial_resume(self, sweep_problem, tmp_path):
        A, b, c = sweep_problem
        opts = SolverOptions(tol=1e-8)
        d = str(tmp_path / "sweep")
        full = scenario_sweep(A, b, c, opts, chunk=16, out_dir=d)
        # delete one chunk: only that chunk should recompute
        (tmp_path / "sweep" / "chunk_000002.npz").unlink()
        redo = scenario_sweep(A, b, c, opts, chunk=16, out_dir=d)
        assert redo.n_resumed == 3
        np.testing.assert_allclose(full.objective, redo.objective, rtol=1e-9)

    def test_config_mismatch_raises(self, sweep_problem, tmp_path):
        A, b, c = sweep_problem
        d = str(tmp_path / "sweep")
        scenario_sweep(A, b, c, SolverOptions(tol=1e-8), chunk=16, out_dir=d)
        with pytest.raises(ValueError, match="different configuration"):
            scenario_sweep(A, b, c, SolverOptions(tol=1e-6), chunk=16, out_dir=d)

    def test_save_x(self, sweep_problem, tmp_path):
        A, b, c = sweep_problem
        d = str(tmp_path / "sweep")
        scenario_sweep(
            A, b, c, SolverOptions(tol=1e-8), chunk=25, out_dir=d, save_x=True
        )
        data = np.load(tmp_path / "sweep" / "chunk_000000.npz")
        assert data["x"].shape == (25, A.shape[1])

    def test_window_sizes_agree(self, sweep_problem):
        A, b, c = sweep_problem
        opts = SolverOptions(tol=1e-8)
        one = scenario_sweep(A, b, c, opts, chunk=16, window_chunks=1)
        win = scenario_sweep(A, b, c, opts, chunk=16, window_chunks=4)
        # the tail chunk is padded differently (2-lane vs 16-lane batch),
        # which changes SIMD reduction order — tolerance-level, not exact
        np.testing.assert_allclose(one.objective, win.objective, rtol=1e-6)
        np.testing.assert_array_equal(one.status, win.status)

    def test_window_with_compaction(self, sweep_problem, tmp_path):
        A, b, c = sweep_problem
        opts = SolverOptions(tol=1e-8, maxiter=60)
        d = str(tmp_path / "sweep")
        plain = scenario_sweep(A, b, c, opts, chunk=16)
        comp = scenario_sweep(
            A, b, c, opts, chunk=16, out_dir=d,
            compact_cap=6, compact_bucket=50,
        )
        # warm resume is trajectory-identical
        np.testing.assert_array_equal(plain.objective, comp.objective)
        # interleaved partial resume across a window boundary
        (tmp_path / "sweep" / "chunk_000001.npz").unlink()
        (tmp_path / "sweep" / "chunk_000003.npz").unlink()
        redo = scenario_sweep(
            A, b, c, opts, chunk=16, out_dir=d,
            compact_cap=6, compact_bucket=50,
        )
        assert redo.n_resumed == 2
        np.testing.assert_array_equal(plain.objective, redo.objective)

    def test_sharded_sweep(self, sweep_problem):
        from pycllp_jax.parallel import scenario_mesh

        A, b, c = sweep_problem
        # 48 of the 50 scenarios in 3 chunks of 16 over 8 devices
        res = scenario_sweep(
            A, b[:48], c[:48], SolverOptions(tol=1e-8), chunk=16, mesh=scenario_mesh(8)
        )
        assert (res.status == int(Status.OPTIMAL)).all()
        ref = scenario_sweep(A, b[:48], c[:48], SolverOptions(tol=1e-8), chunk=48)
        np.testing.assert_allclose(res.objective, ref.objective, rtol=1e-8)
