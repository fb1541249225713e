"""Mixed-precision kernel set: float32 factorizations, float64 refinement.

Two roles (upstream contract: pycllp's default 1e-6 relative optimality
tolerance on its test LP set; BASELINE.md "Correctness" row):

* **Shipping role — the crossover basis-solve engine**
  (``SolverOptions.crossover_kset`` default "mixed1"): the vertex-crossover
  finish solves ``B·Bᵀ``-systems whose diagonal is a 0/1 basis
  indicator, so cond(M) = κ(B)² stays moderate and the f32-factor +
  f64-IR scheme below converges well past the 1e-9 vertex verification
  bound.
* **Documented negative result — the wide IPM finish**: for the
  late-IPM normal matrix (D = x/z spans ~1/μ²), the f32 PSD-safety
  shift makes IR stagnate at ~3e-4 — the IPM finish therefore factors
  in float64 (the base set's ``finish_kernels``).

This kernel set implements the :class:`KernelSet` contract at f64
working precision while running the factorization and the triangular
substitutions in the float32 base set.  Each solve is three-precision
iterative refinement (Carson & Higham 2018 structure):

    v₀ = P⁻¹ r                      (P = f32 Cholesky of M+δI, rounded)
    vₖ₊₁ = vₖ + P⁻¹ (r − M̂ vₖ)      (residual in f64, M̂ = A·D·Aᵀ + δI)

where the f64 residual costs two O(m·n·B) matvecs — cheap next to the
O(m³·B/3) factorization that stays in f32.  Convergence: the error
contracts by ~cond(M̂)·ε_f32 per sweep, and the relative regularization
δ = reg_eps·max(diag) bounds cond(M̂+δI) ≤ ~1/reg_eps ≈ 5e5, giving
≥1.5 digits per sweep; ``ir_steps=2`` reaches f64-level backward error
on the δ-regularized system.
"""

from __future__ import annotations

import functools
import typing

import jax.numpy as jnp

from pycllp_jax.ops.reference import KernelSet

__all__ = ["MixedPrecisionKernels"]


class PreparedMixed(typing.NamedTuple):
    """Wide-precision operator data + the base kernel set's f32 context."""

    A: typing.Any  # (…, m, n) wide (f64) — residual/matvec precision
    Asq: typing.Any  # (…, m, n) wide, elementwise A² for diag(M)
    lo: typing.Any  # base.prepare(A.astype(f32)) — factorization context


class MixedFactor(typing.NamedTuple):
    ctx: PreparedMixed
    fac_lo: typing.Any  # base kernel set's f32 factorization
    d: typing.Any  # (…, n) wide scaling at factorization
    reg: typing.Any  # (…,) wide diagonal shift δ (same relative ε as f32)
    s: typing.Any = None  # (…, m) wide Jacobi row scale of the f32 factor
    # (None = unscaled): the factor holds chol(S·M·S + δI) and the
    # preconditioner application is P⁻¹r = S·(LLᵀ)⁻¹·(S·r)


class MixedPrecisionKernels(KernelSet):
    """f64-interface kernels whose O(m³) work runs in the f32 base set."""

    name = "mixed_finish"

    def __init__(
        self,
        base: KernelSet,
        ir_steps: int = 3,
        lo_reg_floor: float = 2e-6,
        jacobi: bool = True,
    ):
        self.base = base
        self.ir_steps = ir_steps
        # The f32 factor needs enough diagonal shift to stay PSD under
        # f32 rounding regardless of how tiny the wide phase's δ is; IR
        # then converges THROUGH the floor: the factor is only a
        # preconditioner, the residual operator (wide δ) defines the
        # system, and the contraction ‖I−P⁻¹M̂‖ ≈ δ_lo/(λ_min+δ_lo) < 1.
        self.lo_reg_floor = lo_reg_floor
        # Jacobi (symmetric diagonal) equilibration of the f32 factor:
        # factor S·M·S + δI with S = diag(M)^(-1/2) instead of M + δ·
        # max(diag)·I.  Two effects on the IR contraction: (a) van der
        # Sluis — κ(SMS) is within a factor m of the best diagonally
        # scaled κ, so scaling-induced conditioning (unbalanced basis
        # row norms: diag(M)ᵢ = ‖Bᵢ,·‖²) disappears from the ε_f32·κ
        # term; (b) the PSD-safety shift δ becomes RELATIVE per row
        # (S⁻¹δS⁻¹ in the unscaled space) instead of max-diag-uniform,
        # so small-row lanes stop being drowned by a shift sized for
        # their largest row.  Intrinsic near-degeneracy (near linearly
        # dependent basis columns) is NOT fixed by any diagonal scaling
        # — those lanes fall through to the float64 drain tiers.
        self.jacobi = jacobi
        self.name = f"mixed_finish({base.name}, ir={ir_steps}{', jacobi' if jacobi else ''})"

    @classmethod
    @functools.cache
    def on(cls, base: KernelSet, ir_steps: int) -> "MixedPrecisionKernels":
        """One shared instance per (base, ir_steps): kernel sets are
        static jit arguments, so a fresh instance per call would
        retrace every program that takes it."""
        return cls(base, ir_steps=ir_steps)

    # -- wide-precision operator ------------------------------------------
    def prepare(self, A):
        A = jnp.asarray(A)
        return PreparedMixed(A=A, Asq=A * A, lo=self.base.prepare(A.astype(jnp.float32)))

    def mv(self, ctx, x):
        return jnp.einsum("...mn,...n->...m", ctx.A, x)

    def rmv(self, ctx, y):
        return jnp.einsum("...mn,...m->...n", ctx.A, y)

    # -- factor in f32, refine in f64 --------------------------------------
    def factor(self, ctx, d, reg_eps):
        if not isinstance(ctx, PreparedMixed):  # plain context (oracle path)
            ctx = PreparedMixed(A=ctx.A, Asq=ctx.Asq, lo=self.base.prepare(
                ctx.A.astype(jnp.float32)))
        diag = jnp.einsum("...mn,...n->...m", ctx.Asq, d)
        reg = reg_eps * jnp.max(diag, axis=-1)
        lo = ctx.lo
        d32 = d.astype(jnp.float32)
        shift = max(reg_eps, self.lo_reg_floor)
        if not self.jacobi:
            return MixedFactor(ctx=ctx, fac_lo=self.base.factor(lo, d32, shift), d=d, reg=reg)
        tiny = jnp.asarray(jnp.finfo(d.dtype).tiny, d.dtype)
        s = 1.0 / jnp.sqrt(jnp.maximum(diag, tiny))
        s32 = s.astype(jnp.float32)
        M = self.base.normal_matrix(lo, d32)
        M = M * s32[..., :, None] * s32[..., None, :]
        # scaled diag(SMS) = 1 exactly → the PSD-safety shift is the
        # relative floor itself
        shift = jnp.full(M.shape[:-2], shift, jnp.float32)
        fac_lo = self.base.factor_matrix(lo, M, d32, shift)
        return MixedFactor(ctx=ctx, fac_lo=fac_lo, d=d, reg=reg, s=s)

    def _lo_solve(self, fac, rs):
        """Apply the f32 preconditioner to wide residuals (f32 out).

        Unscaled: (M+δI)⁻¹ via the base solve.  Jacobi: the factor holds
        chol(S·M·S + δI), so P⁻¹r = S·(LLᵀ)⁻¹·(S·r).
        """
        if fac.s is None:
            return self.base.solve(
                fac.fac_lo, tuple(r.astype(jnp.float32) for r in rs)
            )
        s32 = fac.s.astype(jnp.float32)
        vs = self.base.solve(
            fac.fac_lo, tuple((r * fac.s).astype(jnp.float32) for r in rs)
        )
        return tuple(v * s32 for v in vs)

    def solve(self, fac, rs):
        wide = rs[0].dtype
        vs = tuple(v.astype(wide) for v in self._lo_solve(fac, rs))
        for _ in range(self.ir_steps):
            es = tuple(r - self.matvec_M(fac, v) for r, v in zip(rs, vs))
            cs = self._lo_solve(fac, es)
            vs = tuple(v + c.astype(wide) for v, c in zip(vs, cs))
        return vs

    # matvec_M: inherited — runs in wide precision via self.mv/rmv on
    # fac.ctx (A, d, reg all wide), defining the system IR converges to.
