"""x64 misconfiguration guard + Jacobi-scaled mixed preconditioner.

VERDICT r4 items 1/3: requesting a float64 phase with ``jax_enable_x64``
off must be a hard error (JAX otherwise silently truncates every wide
array to f32 and the solve returns garbage — the round-4 multichip
dryrun failure mode).  The Jacobi tests pin the mixed engine's scaled
f32 preconditioner (on the Triton kernel set, interpret mode) to the
same answers as the unscaled one, and to the f64 reference, on systems
with badly scaled rows.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pycllp_jax import SolverOptions
from pycllp_jax.io.generate import random_equality_lp
from pycllp_jax.solvers.hsd import hsd_solve_batched, hsd_solve_scan


def _tiny_problem(dtype=np.float32, B=4):
    A, b0, c0 = random_equality_lp(6, 14, seed=3, dtype=dtype)
    b = np.broadcast_to(b0, (B, 6)).copy()
    c = np.broadcast_to(c0, (B, 14)).copy()
    return A, b, c


class TestX64Guard:
    @pytest.fixture
    def x64_off(self):
        # conftest enables x64 globally; flip it off just for the guard
        jax.config.update("jax_enable_x64", False)
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", True)

    def test_batched_raises_without_x64(self, x64_off):
        A, b, c = _tiny_problem()
        opts = SolverOptions(dtype="float32", finish_dtype="float64")
        with pytest.raises(ValueError, match="jax_enable_x64"):
            hsd_solve_batched(A, b, c, opts)

    def test_scan_raises_without_x64(self, x64_off):
        A, b, c = _tiny_problem()
        opts = SolverOptions(dtype="float32", finish_dtype="float64")
        with pytest.raises(ValueError, match="jax_enable_x64"):
            hsd_solve_scan(A, b, c, opts, chunk=4)

    def test_wide_dtype_raises_without_x64(self, x64_off):
        A, b, c = _tiny_problem()
        with pytest.raises(ValueError, match="float64"):
            hsd_solve_batched(A, b, c, SolverOptions(dtype="float64"))

    def test_narrow_only_still_solves_without_x64(self, x64_off):
        A, b, c = _tiny_problem()
        out = hsd_solve_batched(A, b, c, SolverOptions(dtype="float32", tol=1e-5))
        assert np.isfinite(np.asarray(out["objective"])).all()

    def test_f64_passes_with_x64_on(self):
        A, b, c = _tiny_problem(np.float64)
        out = hsd_solve_batched(A, b, c, SolverOptions(dtype="float64"))
        assert np.asarray(out["status"]).max() <= 1


class TestJacobiMixed:
    """The Jacobi-equilibrated f32 factor is a drop-in preconditioner."""

    def _system(self, row_spread, B=8, m=12, n=28, seed=0):
        # Row spreads up to ~1e2 (diag(M) spread 1e4): the regime the
        # engine is specified for — the uniform shift δ = reg_eps·max
        # diag stays subdominant on every row, so the IR target is ≈ M.
        # (At extreme spreads the uniform δ itself becomes an O(1)
        # relative shift on small rows — a property of the engine's
        # system definition, not of the preconditioner.)
        rng = np.random.default_rng(seed)
        A = rng.standard_normal((m, n))
        # badly scaled rows: the exact population Jacobi scaling targets
        A *= np.logspace(0, row_spread, m)[:, None]
        d = rng.uniform(0.5, 2.0, (B, n))
        r = rng.standard_normal((B, m))
        M = np.stack([(A * dd) @ A.T for dd in d])
        v_ref = np.stack([np.linalg.solve(Mi + 1e-12 * np.max(np.diag(Mi)) * np.eye(m), ri)
                          for Mi, ri in zip(M, r)])
        return A, d, r, v_ref

    @pytest.mark.parametrize("row_spread", [0, 2])
    def test_matches_direct_solve(self, row_spread):
        from pycllp_jax.ops.gpu import TritonKernels
        from pycllp_jax.ops.mixed import MixedPrecisionKernels

        A, d, r, v_ref = self._system(row_spread)
        kset = MixedPrecisionKernels(TritonKernels(interpret=True), ir_steps=3, jacobi=True)
        ctx = kset.prepare(jnp.asarray(A, jnp.float64))
        fac = kset.factor(ctx, jnp.asarray(d, jnp.float64), 1e-12)
        assert fac.s is not None  # the scaled path was taken
        (v,) = kset.solve(fac, (jnp.asarray(r, jnp.float64),))
        rel = np.abs(np.asarray(v) - v_ref).max() / np.abs(v_ref).max()
        assert rel < 1e-9, rel

    def test_beats_unscaled_on_row_scaled_system(self):
        """With badly scaled rows and ONE refinement sweep, the scaled
        preconditioner must land orders closer than the unscaled one."""
        from pycllp_jax.ops.gpu import TritonKernels
        from pycllp_jax.ops.mixed import MixedPrecisionKernels

        A, d, r, v_ref = self._system(row_spread=2, seed=2)
        errs = {}
        for jac in (False, True):
            kset = MixedPrecisionKernels(TritonKernels(interpret=True), ir_steps=1, jacobi=jac)
            ctx = kset.prepare(jnp.asarray(A, jnp.float64))
            fac = kset.factor(ctx, jnp.asarray(d, jnp.float64), 1e-12)
            (v,) = kset.solve(fac, (jnp.asarray(r, jnp.float64),))
            errs[jac] = np.abs(np.asarray(v) - v_ref).max() / np.abs(v_ref).max()
        assert errs[True] < 1e-6, errs
        assert errs[True] < errs[False] * 1e-2 or errs[False] < 1e-9, errs
