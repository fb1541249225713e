"""Reference (pure-jnp/XLA) implementation of the IPM hot-path kernel set.

Defines the kernel interface contract; the Pallas Triton kernels in
:mod:`pycllp_jax.ops.gpu` implement the same interface (the upstream
analogue is the NumPy-vs-vendored-C-vs-OpenCL backend split).

Interface (all arrays carry a leading instance axis ``...`` unless
stated; ``A`` may omit it — shared structure across scenarios):

* ``prepare(A) -> ctx`` — once per structure, outside the IPM loop
  (precomputed products live here).
* ``mv(ctx, x)`` / ``rmv(ctx, y)`` — ``A @ x`` / ``Aᵀ @ y``.
* ``normal_matrix(ctx, d)`` — ``M = A·diag(d)·Aᵀ``, batch-first
  ``(..., m, m)``.
* ``factor_matrix(ctx, M, d, reg) -> fac`` — factorize an already
  formed ``M + reg·I`` (``reg`` per instance); ``d`` is kept for
  ``matvec_M``.
* ``factor(ctx, d, reg_eps) -> fac`` — form and factorize the normal
  matrix ``M = A·diag(d)·Aᵀ + δI`` with ``δ = reg_eps · max(diag)`` per
  instance (the analogue of dynamic small-pivot regularization in
  sparse LDLᵀ codes).  ``fac`` is opaque.
* ``solve(fac, rs) -> tuple`` — apply ``M⁻¹`` to each RHS in the tuple
  (multi-RHS so factorization traffic is shared).
* ``matvec_M(fac, v)`` — apply ``M`` (for iterative refinement), via
  the identity ``M v = A(d ⊙ Aᵀv) + δv`` so M is never materialised.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp
from jax import lax

__all__ = ["KernelSet", "ReferenceKernels", "REFERENCE_KERNELS"]


class PreparedA(NamedTuple):
    A: Any  # (..., m, n)
    Asq: Any  # (..., m, n) — elementwise A², for diag(M) = A²·d


class NormalFactor(NamedTuple):
    ctx: PreparedA
    L: Any  # (..., m, m) lower Cholesky factor
    d: Any  # (..., n) scaling at factorization
    reg: Any  # (...,) diagonal shift δ


class KernelSet:
    """Abstract hot-path kernel bundle consumed by the HSD core.

    Implementations must be hashable singletons (used as static jit
    args); statelessness is assumed.
    """

    name = "abstract"

    def prepare(self, A) -> PreparedA:
        raise NotImplementedError

    def mv(self, ctx: PreparedA, x):
        raise NotImplementedError

    def rmv(self, ctx: PreparedA, y):
        raise NotImplementedError

    def normal_matrix(self, ctx: PreparedA, d):
        raise NotImplementedError

    def factor_matrix(self, ctx: PreparedA, M, d, reg) -> NormalFactor:
        raise NotImplementedError

    def factor(self, ctx: PreparedA, d, reg_eps: float) -> NormalFactor:
        diag = jnp.einsum("...mn,...n->...m", ctx.Asq, d)
        reg = (reg_eps * jnp.max(diag, axis=-1)).astype(d.dtype)
        return self.factor_matrix(ctx, self.normal_matrix(ctx, d), d, reg)

    def solve(self, fac: NormalFactor, rs: tuple) -> tuple:
        raise NotImplementedError

    def factor_and_solve(self, ctx: PreparedA, d, reg_eps: float, rs: tuple):
        """Factorize and solve the first RHS batch."""
        fac = self.factor(ctx, d, reg_eps)
        return fac, self.solve(fac, rs)

    def matvec_M(self, fac: NormalFactor, v):
        ctx = fac.ctx
        return self.mv(ctx, fac.d * self.rmv(ctx, v)) + fac.reg[..., None] * v

    def finish_kernels(self) -> "KernelSet":
        """Kernel set for the float64 finish phase (default: self).

        Implementations whose fast path is float32-only return their
        float64-capable sibling."""
        return self

    def crossover_kernels(self, which: str) -> "KernelSet":
        """Kernel set for the crossover basis solves
        (``SolverOptions.crossover_kset``; default: the finish set).

        Sets with a float32 fast path return the mixed-precision engine
        built on it for ``"mixed"``/``"mixed1"``; ``"wide"`` is always the
        finish set."""
        return self.finish_kernels()

    def __repr__(self):
        return f"KernelSet({self.name})"


class ReferenceKernels(KernelSet):
    """XLA-native implementation: einsum + lax.linalg batched primitives."""

    name = "reference"

    def prepare(self, A) -> PreparedA:
        return PreparedA(A=A, Asq=A * A)

    def mv(self, ctx, x):
        return jnp.einsum("...mn,...n->...m", ctx.A, x)

    def rmv(self, ctx, y):
        return jnp.einsum("...mn,...m->...n", ctx.A, y)

    def normal_matrix(self, ctx, d):
        A = ctx.A
        return jnp.einsum("...mn,...n,...kn->...mk", A, d, A)

    def factor_matrix(self, ctx, M, d, reg):
        m = M.shape[-1]
        M = M + reg[..., None, None] * jnp.eye(m, dtype=M.dtype)
        return NormalFactor(ctx=ctx, L=lax.linalg.cholesky(M), d=d, reg=reg)

    def solve(self, fac, rs):
        L = fac.L
        out = []
        for r in rs:
            r2 = r[..., None]
            t = lax.linalg.triangular_solve(L, r2, left_side=True, lower=True)
            v = lax.linalg.triangular_solve(
                L, t, left_side=True, lower=True, transpose_a=True
            )
            out.append(v[..., 0])
        return tuple(out)


REFERENCE_KERNELS = ReferenceKernels()
