"""Tests that need the card: the Triton solve kernel compiled for the GPU.

Each test takes the ``gpu`` fixture, which skips where JAX has no GPU
backend; ``chip_smoke.py`` runs them on the card (``pytest -m gpu``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pycllp_jax.ops.gpu import TRITON_KERNELS, TritonFactor, select_kernels
from pycllp_jax.ops.reference import REFERENCE_KERNELS

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU backend (JAX backend is {jax.default_backend()!r})")


def _problem(m, n, B, seed):
    rng = np.random.default_rng(seed)
    A = jnp.asarray(rng.normal(size=(m, n)), jnp.float32)
    d = jnp.asarray(10.0 ** rng.uniform(-3, 3, (B, n)), jnp.float32)
    rs = tuple(jnp.asarray(rng.normal(size=(B, m)), jnp.float32) for _ in range(3))
    return A, d, rs


def test_backend_selects_triton(gpu):
    assert select_kernels() is TRITON_KERNELS


@pytest.mark.parametrize("m,n", [(64, 128), (13, 30)])
def test_compiled_solve_matches_f64_reference(gpu, m, n):
    A, d, rs = _problem(m, n, 4096, seed=m)
    with jax.default_matmul_precision("highest"):
        fac = TRITON_KERNELS.factor(TRITON_KERNELS.prepare(A), d, 2e-6)
        vs = TRITON_KERNELS.solve(fac, rs)
    assert isinstance(fac, TritonFactor)
    A64, d64 = A.astype(jnp.float64), d.astype(jnp.float64)
    ctx = REFERENCE_KERNELS.prepare(A64)
    M = REFERENCE_KERNELS.normal_matrix(ctx, d64) + fac.reg.astype(jnp.float64)[:, None, None] * jnp.eye(m)
    for r, v in zip(rs, vs):
        res = jnp.einsum("bij,bj->bi", M, v.astype(jnp.float64)) - r
        bwd = jnp.max(jnp.abs(res), -1) / (
            jnp.max(jnp.sum(jnp.abs(M), -1), -1) * jnp.max(jnp.abs(v), -1) + jnp.max(jnp.abs(r), -1))
        # ~m·ε_f32 backward error for a stable factor + substitution
        assert float(jnp.max(bwd)) <= 1e-5


def test_entry_points_default_to_triton(gpu):
    from pycllp_jax import SolverOptions
    from pycllp_jax.io.generate import random_standard_lp
    from pycllp_jax.solvers.dense_path import dense_path_solve_batched
    from pycllp_jax.solvers.hsd import hsd_solve_batched

    eq = random_standard_lp(24, 36, nlp=256, seed=4, dtype=np.float32).to_equality_form()
    A, b, c = (jnp.asarray(v, jnp.float32) for v in (eq.A, eq.b, eq.c))
    opts = SolverOptions(tol=1e-5, dtype="float32", init_point="mehrotra")
    for solve in (hsd_solve_batched, dense_path_solve_batched):
        default = solve(A, b, c, opts)
        explicit = solve(A, b, c, opts, TRITON_KERNELS)
        np.testing.assert_array_equal(
            np.asarray(default["objective"]), np.asarray(explicit["objective"]))


def test_compiled_solve_nonpsd_lane_is_nan(gpu):
    A, d, rs = _problem(16, 40, 64, seed=1)
    d = d.at[5].set(-d[5])
    fac = TRITON_KERNELS.factor(TRITON_KERNELS.prepare(A), d, 0.0)
    v = np.asarray(TRITON_KERNELS.solve(fac, rs)[0])
    assert np.isnan(v[5]).any() and np.isfinite(np.delete(v, 5, 0)).all()
