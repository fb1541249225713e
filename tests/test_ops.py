"""Kernel-set tests (the upstream cross-backend QA pattern): the Triton
solve kernel (interpret mode on CPU) and its wrapper against the XLA
reference, the kernel-set choice, and the mixed engine built on it.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pycllp_jax.ops import gpu
from pycllp_jax.ops.gpu import (
    TRITON_KERNELS, TritonFactor, TritonKernels, resolve_kernels, select_kernels,
)
from pycllp_jax.ops.mixed import MixedPrecisionKernels
from pycllp_jax.ops.reference import REFERENCE_KERNELS, NormalFactor

INTERP = TritonKernels(interpret=True)


def _random_spd_problem(m, n, B, seed, k=2, dtype=np.float32):
    rng = np.random.default_rng(seed)
    A = jnp.asarray(rng.normal(size=(m, n)), dtype)
    d = jnp.asarray(rng.uniform(0.5, 2.0, size=(B, n)), dtype)
    rs = tuple(jnp.asarray(rng.normal(size=(B, m)), dtype) for _ in range(k))
    return A, d, rs


def _f64_solutions(A, d, reg, rs):
    """Dense f64 ground truth of (A·diag(d)·Aᵀ + reg·I) v = r per lane."""
    A64 = np.asarray(A, np.float64)
    d64 = np.asarray(d, np.float64)
    out = []
    for r in rs:
        r64 = np.asarray(r, np.float64)
        vs = []
        for i in range(d64.shape[0]):
            Ai = A64[i] if A64.ndim == 3 else A64
            M = (Ai * d64[i]) @ Ai.T + float(reg[i]) * np.eye(Ai.shape[0])
            vs.append(np.linalg.solve(M, r64[i]))
        out.append(np.stack(vs))
    return out


class TestTritonSolve:
    @pytest.mark.parametrize("k_rhs", [1, 3])
    @pytest.mark.parametrize("m,n", [(8, 20), (13, 30), (32, 64), (64, 128)])
    def test_factor_solve_matches_f64(self, m, n, k_rhs):
        """m=13 pads to 16 with an identity block; k=3 pads to 4 RHS."""
        A, d, rs = _random_spd_problem(m, n, 5, seed=m + k_rhs, k=k_rhs)
        fac = INTERP.factor(INTERP.prepare(A), d, 1e-7)
        assert isinstance(fac, TritonFactor)
        assert fac.L.shape == (5, gpu._pow2(m), gpu._pow2(m))
        vs = INTERP.solve(fac, rs)
        assert len(vs) == k_rhs
        for v, ref in zip(vs, _f64_solutions(A, d, np.asarray(fac.reg), rs)):
            assert v.shape == (5, m) and v.dtype == jnp.float32
            np.testing.assert_allclose(np.asarray(v), ref, rtol=2e-3, atol=2e-4)

    @pytest.mark.parametrize("B", [1, 37])
    def test_ragged_batch_matches_reference(self, B):
        A, d, rs = _random_spd_problem(12, 30, B, seed=B)
        fac = INTERP.factor(INTERP.prepare(A), d, 1e-7)
        fac_r = REFERENCE_KERNELS.factor(REFERENCE_KERNELS.prepare(A), d, 1e-7)
        for a, b in zip(INTERP.solve(fac, rs), REFERENCE_KERNELS.solve(fac_r, rs)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-5)

    def test_nonpsd_lane_produces_nan(self):
        """A lane whose normal matrix is not PSD must NaN (caught by the
        solver's numerical guard), not silently corrupt others."""
        A, d, rs = _random_spd_problem(6, 15, 4, seed=9)
        d = d.at[2].set(-d[2])  # negative scaling → indefinite M on lane 2
        fac = INTERP.factor(INTERP.prepare(A), d, 0.0)
        v = np.asarray(INTERP.solve(fac, rs)[0])
        assert np.isnan(v[2]).any()
        assert np.isfinite(v[[0, 1, 3]]).all()

    def test_batched_A(self):
        """Per-instance (3-D) A: einsum formation, kernel solve."""
        rng = np.random.default_rng(44)
        B, m, n = 6, 10, 24
        A3 = jnp.asarray(rng.normal(size=(B, m, n)), jnp.float32)
        d = jnp.asarray(rng.uniform(0.5, 2.0, size=(B, n)), jnp.float32)
        rs = (jnp.asarray(rng.normal(size=(B, m)), jnp.float32),)
        ctx = INTERP.prepare(A3)
        assert not isinstance(ctx, gpu.PreparedW)
        fac = INTERP.factor(ctx, d, 1e-7)
        assert isinstance(fac, TritonFactor)
        (v,) = INTERP.solve(fac, rs)
        (ref,) = _f64_solutions(A3, d, np.asarray(fac.reg), rs)
        np.testing.assert_allclose(np.asarray(v), ref, rtol=2e-3, atol=2e-4)

    def test_shared_A_formation_matches_einsum(self):
        A, d, _ = _random_spd_problem(9, 21, 4, seed=2)
        with jax.default_matmul_precision("highest"):
            M = INTERP.normal_matrix(INTERP.prepare(A), d)
            M_ref = REFERENCE_KERNELS.normal_matrix(REFERENCE_KERNELS.prepare(A), d)
        assert M.shape == (4, 9, 9)
        np.testing.assert_allclose(np.asarray(M), np.asarray(M_ref), rtol=1e-5, atol=1e-5)

    def test_matvec_M_identity(self):
        """matvec_M must reproduce M @ v including the δ shift."""
        m, n, B = 10, 25, 6
        A, d, rs = _random_spd_problem(m, n, B, seed=7)
        fac = INTERP.factor(INTERP.prepare(A), d, 1e-5)
        v = rs[0]
        mv = np.asarray(INTERP.matvec_M(fac, v))
        An, dn, vn = np.asarray(A, np.float64), np.asarray(d, np.float64), np.asarray(v, np.float64)
        reg = np.asarray(fac.reg, np.float64)
        for i in range(B):
            M = (An * dn[i]) @ An.T + reg[i] * np.eye(m)
            np.testing.assert_allclose(mv[i], M @ vn[i], rtol=1e-4, atol=1e-4)


class TestWrapperShapes:
    def test_stack_rhs_pads_k_and_m(self):
        rs = tuple(jnp.full((5, 13), float(i + 1)) for i in range(3))
        R = gpu.stack_rhs(rs, 16)
        assert R.shape == (5, 4, 16)
        np.testing.assert_array_equal(np.asarray(R[:, :3, :13]), np.stack([np.asarray(r) for r in rs], 1))
        assert not np.asarray(R[:, 3]).any() and not np.asarray(R[:, :, 13:]).any()

    def test_pad_matrix_identity_block(self):
        rng = np.random.default_rng(0)
        X = rng.normal(size=(3, 5, 5))
        M = jnp.asarray(X @ np.swapaxes(X, 1, 2) + 5 * np.eye(5), jnp.float32)
        Mp = gpu.pad_matrix(M, 8)
        assert Mp.shape == (3, 8, 8)
        np.testing.assert_array_equal(np.asarray(Mp[:, 5:, 5:]), np.broadcast_to(np.eye(3), (3, 3, 3)))
        assert not np.asarray(Mp[:, :5, 5:]).any()
        # the factor of the padded matrix is the padded factor
        np.testing.assert_allclose(
            np.asarray(jnp.linalg.cholesky(Mp)),
            np.asarray(gpu.pad_matrix(jnp.linalg.cholesky(M), 8)), rtol=1e-5, atol=1e-6,
        )

    def test_solve_padded_shapes(self):
        L = jnp.broadcast_to(jnp.eye(16, dtype=jnp.float32) * 2.0, (3, 16, 16))
        R = jnp.ones((3, 2, 16), jnp.float32)
        V = gpu.solve_padded(L, R, interpret=True)
        assert V.shape == (3, 2, 16)
        np.testing.assert_allclose(np.asarray(V), 0.25)


class TestKernelRouting:
    def test_f64_routes_to_reference(self):
        A, d, rs = _random_spd_problem(8, 20, 4, seed=3, dtype=np.float64)
        fac = INTERP.factor(INTERP.prepare(A), d, 1e-12)
        assert type(fac) is NormalFactor
        for a, b in zip(INTERP.solve(fac, rs), REFERENCE_KERNELS.solve(fac, rs)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b))

    def test_large_m_routes_to_reference(self):
        m = gpu.MAX_M + 1
        A, d, rs = _random_spd_problem(m, m + 8, 2, seed=4, k=1)
        fac = INTERP.factor(INTERP.prepare(A), d, 1e-7)
        assert type(fac) is NormalFactor

    def test_backend_choice(self):
        assert select_kernels("gpu") is TRITON_KERNELS
        assert select_kernels("cpu") is REFERENCE_KERNELS
        assert select_kernels() is REFERENCE_KERNELS  # the tests run on CPU

    @pytest.mark.parametrize("given", [None, "interp", "reference"])
    def test_entry_point_default_is_the_backend_set(self, given):
        kset = {None: None, "interp": INTERP, "reference": REFERENCE_KERNELS}[given]
        want = REFERENCE_KERNELS if kset is None else kset  # the tests run on CPU
        assert resolve_kernels(kset) is want

    def test_interpret_only_when_asked(self):
        assert TRITON_KERNELS.interpret is False
        assert INTERP.interpret is True and INTERP != TRITON_KERNELS
        assert INTERP == TritonKernels(interpret=True)
        assert hash(INTERP) == hash(TritonKernels(interpret=True))

    def test_kernel_on_non_gpu_backend_raises(self):
        A, d, rs = _random_spd_problem(8, 20, 3, seed=5)
        fac = TRITON_KERNELS.factor(TRITON_KERNELS.prepare(A), d, 1e-7)
        with pytest.raises(RuntimeError, match="GPU backend"):
            TRITON_KERNELS.solve(fac, rs)

    def test_finish_and_crossover_sets(self):
        assert INTERP.finish_kernels() is REFERENCE_KERNELS
        assert INTERP.crossover_kernels("wide") is REFERENCE_KERNELS
        mixed1 = INTERP.crossover_kernels("mixed1")
        assert isinstance(mixed1, MixedPrecisionKernels) and mixed1.ir_steps == 1
        # one shared instance: kernel sets are static jit arguments
        assert INTERP.crossover_kernels("mixed1") is mixed1
        assert INTERP.crossover_kernels("mixed").ir_steps == 3
        # sets without a float32 fast path keep their float64 finish set
        assert REFERENCE_KERNELS.crossover_kernels("mixed1") is REFERENCE_KERNELS
        with pytest.raises(ValueError):
            INTERP.crossover_kernels("df64")


class TestSolverWithTritonKernels:
    def test_hsd_with_triton_matches_reference(self):
        from pycllp_jax import SolverOptions, Status
        from pycllp_jax.io.generate import random_equality_lp
        from pycllp_jax.solvers.hsd import hsd_solve_batched

        m, n, B = 12, 30, 16
        A, _, _ = random_equality_lp(m, n, seed=21)
        rng = np.random.default_rng(22)
        b = rng.uniform(0.1, 1.0, size=(B, n)) @ A.T
        c = rng.normal(size=(B, m)) @ A + rng.uniform(0.1, 1.0, size=(B, n))
        opts = SolverOptions(tol=1e-6, dtype="float32")
        Af, bf, cf = (v.astype(np.float32) for v in (A, b, c))
        ref = hsd_solve_batched(Af, bf, cf, opts, REFERENCE_KERNELS)
        out = hsd_solve_batched(Af, bf, cf, opts, INTERP)
        np.testing.assert_allclose(
            np.asarray(out["objective"]), np.asarray(ref["objective"]), rtol=5e-4, atol=5e-4
        )
        ok = np.isin(np.asarray(out["status"]), [int(Status.OPTIMAL), int(Status.STALLED)])
        assert ok.all()

    def test_crossover_finish_meets_contract(self):
        """f32 Triton bulk + mixed1 crossover on the same kernel + f64
        XLA finish matches scipy to 1e-6 through the scan path."""
        from scipy.optimize import linprog

        from pycllp_jax import SolverOptions, Status
        from pycllp_jax.io.generate import random_standard_lp
        from pycllp_jax.solvers.hsd import hsd_solve_scan

        lp = random_standard_lp(12, 16, nlp=32, seed=13, dtype=np.float32)
        eq = lp.to_equality_form()
        opts = SolverOptions(
            tol=1e-6, maxiter=40, dtype="float32", init_point="mehrotra",
            stall_patience=3, stall_rtol=0.05, refine_steps=0, kkt_refine=3,
            finish_dtype="float64", switch_tol=1e-5, finish_mode="crossover",
        )
        out = hsd_solve_scan(
            np.asarray(eq.A, np.float32), np.asarray(eq.b, np.float32),
            np.asarray(eq.c, np.float32), opts, INTERP, chunk=16,
            keys=("objective", "status"), compact_cap=8, compact_bucket=16,
            finish_cap=3, finish_bucket=8,
        )
        assert np.all(np.asarray(out["status"]) == int(Status.OPTIMAL))
        for i in range(0, 32, 5):
            res = linprog(-np.asarray(lp.c)[i].astype(np.float64),
                          A_ub=np.asarray(lp.A, np.float64),
                          b_ub=np.asarray(lp.b)[i].astype(np.float64),
                          bounds=[(0, None)] * 16, method="highs")
            rel = abs(-float(out["objective"][i]) + res.fun) / max(1.0, abs(res.fun))
            assert rel <= 1e-6, (i, rel)


class TestFinishContract:
    @pytest.mark.slow
    def test_scan_compact_f64_finish_meets_tol(self):
        """f32 bulk + native-f64 IPM finish reaches 1e-6 vs scipy."""
        from scipy.optimize import linprog

        from pycllp_jax import SolverOptions
        from pycllp_jax.io.generate import random_standard_lp
        from pycllp_jax.solvers.hsd import hsd_solve_scan

        total = 64
        m = n = 16
        lp = random_standard_lp(m, n, nlp=total, seed=7, dtype=np.float32)
        eq = lp.to_equality_form()
        opts = SolverOptions(
            tol=1e-7, maxiter=40, dtype="float32", init_point="mehrotra",
            finish_dtype="float64", switch_tol=1e-4, finish_maxiter=25,
        )
        out = hsd_solve_scan(
            np.asarray(eq.A, np.float32), np.asarray(eq.b, np.float32),
            np.asarray(eq.c, np.float32), opts, INTERP,
            chunk=32, keys=("objective", "status"),
            compact_cap=10, compact_bucket=32, finish_cap=8,
        )
        obj = np.asarray(out["objective"])
        rels = []
        for i in range(0, total, 7):
            res = linprog(
                -np.asarray(lp.c)[i].astype(np.float64),
                A_ub=np.asarray(lp.A, np.float64),
                b_ub=np.asarray(lp.b)[i].astype(np.float64),
                bounds=[(0, None)] * n, method="highs",
            )
            if res.status == 0:
                rels.append(abs(-float(obj[i]) + res.fun) / max(1.0, abs(res.fun)))
        assert max(rels) < 1e-6, f"max rel {max(rels):.2e}"
