"""Dense infeasible primal-dual path-following solver (batched).

Parity target: the upstream's simpler dense path-following solver (the
LP-book Ch.17/18 algorithm alongside ``hsd`` — SURVEY.md §2.1; reference
mount empty this build — SURVEY.md §0).  Classic Kojima–Megiddo–Mizuno /
Mehrotra infeasible-start method WITHOUT the homogeneous embedding:
simpler per iteration, separate primal/dual step lengths, but no
infeasibility certificates — an infeasible/unbounded instance runs to
the iteration limit.  The HSD solver is the robust default; this one is
the cross-check (the upstream cross-backend testing pattern).

Problem form: ``min cᵀx  s.t.  Ax = b, x ≥ 0`` with residuals
``r_p = b − Ax``, ``r_d = c − Aᵀy − z``, ``μ = xᵀz/n``.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from pycllp_jax.ops.gpu import resolve_kernels
from pycllp_jax.ops.reference import KernelSet
from pycllp_jax.solvers.base import BaseSolver, register_solver
from pycllp_jax.solvers.options import Solution, SolverOptions, Status
from pycllp_jax.utils.scaling import ruiz_equilibrate, scale_problem, unscale_solution

__all__ = ["dense_path_solve_batched", "DensePathSolver"]

_RUNNING = np.int32(int(Status.RUNNING))  # numpy scalar: no device init at import


class PFState(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray
    status: jnp.ndarray
    iterations: jnp.ndarray
    k: jnp.ndarray


def _ratio(v, dv):
    big = jnp.asarray(jnp.finfo(v.dtype).max, v.dtype)
    r = jnp.where(dv < 0, v / jnp.where(dv < 0, -dv, 1.0), big)
    return jnp.min(r, axis=-1)


@partial(jax.jit, static_argnames=("opts", "kset", "reduce_any"))
def dense_path_solve_batched(
    A,
    b,
    c,
    opts: SolverOptions = SolverOptions(),
    kset: KernelSet | None = None,
    reduce_any: Callable = jnp.any,
):
    """Batched path-following solve; same output dict as hsd_solve_batched."""
    with jax.default_matmul_precision("highest"):
        return _impl(A, b, c, opts, resolve_kernels(kset), reduce_any)


def _impl(A, b, c, opts, kset, reduce_any):
    dtype = jnp.dtype(opts.dtype) if opts.dtype else jnp.result_type(A, b, c)
    A = jnp.asarray(A, dtype)
    b = jnp.asarray(b, dtype)
    c = jnp.asarray(c, dtype)
    B, m = b.shape
    n = c.shape[-1]
    if opts.scale:
        scaling = ruiz_equilibrate(A)
        A, b, c = scale_problem(A, b, c, scaling)
    else:
        scaling = None

    ctx = kset.prepare(A)
    reg_eps = opts.resolved_reg_eps(dtype)
    bnorm = 1.0 + jnp.linalg.norm(b, axis=-1)
    cnorm = 1.0 + jnp.linalg.norm(c, axis=-1)

    state = PFState(
        x=jnp.ones((B, n), dtype),
        y=jnp.zeros((B, m), dtype),
        z=jnp.ones((B, n), dtype),
        status=jnp.full((B,), _RUNNING, jnp.int32),
        iterations=jnp.zeros((B,), jnp.int32),
        k=jnp.int32(0),
    )

    def cond(s):
        return (s.k < opts.maxiter) & reduce_any(s.status == _RUNNING)

    def classify(s):
        rp = b - kset.mv(ctx, s.x)
        rd = c - kset.rmv(ctx, s.y) - s.z
        gap = jnp.abs(
            jnp.sum(c * s.x, axis=-1) - jnp.sum(b * s.y, axis=-1)
        ) / (1.0 + jnp.abs(jnp.sum(c * s.x, axis=-1)))
        ok = (
            (jnp.linalg.norm(rp, axis=-1) / bnorm <= opts.tol)
            & (jnp.linalg.norm(rd, axis=-1) / cnorm <= opts.tol)
            & (gap <= opts.tol)
        )
        return rp, rd, gap, ok

    def body(s):
        rp, rd, gap, ok = classify(s)
        status = jnp.where(
            (s.status == _RUNNING) & ok, jnp.int32(int(Status.OPTIMAL)), s.status
        )
        active = status == _RUNNING

        x, y, z = s.x, s.y, s.z
        mu = jnp.sum(x * z, axis=-1) / n
        dinv = x / z
        fac = kset.factor(ctx, dinv, reg_eps)

        def newton(rxs):
            r1 = rd - rxs / x
            (dy,) = kset.solve(fac, (rp + kset.mv(ctx, dinv * r1),))
            dx = dinv * (kset.rmv(ctx, dy) - r1)
            dz = (rxs - z * dx) / x
            return dx, dy, dz

        if opts.mehrotra:
            dxa, dya, dza = newton(-x * z)
            ap = jnp.minimum(1.0, _ratio(x, dxa))
            ad = jnp.minimum(1.0, _ratio(z, dza))
            mu_aff = jnp.sum(
                (x + ap[..., None] * dxa) * (z + ad[..., None] * dza), axis=-1
            ) / n
            gamma = jnp.clip((mu_aff / mu) ** 3, 0.0, 1.0)
            dx, dy, dz = newton((gamma * mu)[..., None] - x * z - dxa * dza)
        else:
            gamma = jnp.full_like(mu, opts.gamma)
            dx, dy, dz = newton((gamma * mu)[..., None] - x * z)

        ap = jnp.minimum(1.0, opts.alpha0 * _ratio(x, dx))
        ad = jnp.minimum(1.0, opts.alpha0 * _ratio(z, dz))
        xn = x + ap[..., None] * dx
        yn = y + ad[..., None] * dy
        zn = z + ad[..., None] * dz

        finite = (
            jnp.all(jnp.isfinite(xn), axis=-1)
            & jnp.all(jnp.isfinite(yn), axis=-1)
            & jnp.all(jnp.isfinite(zn), axis=-1)
        )
        status = jnp.where(active & ~finite, jnp.int32(int(Status.NUMERICAL)), status)
        take = (active & finite)[..., None]
        return PFState(
            x=jnp.where(take, xn, x),
            y=jnp.where(take, yn, y),
            z=jnp.where(take, zn, z),
            status=status,
            iterations=jnp.where(active & finite, s.iterations + 1, s.iterations),
            k=s.k + 1,
        )

    s = lax.while_loop(cond, body, state)
    rp, rd, gap, ok = classify(s)
    status = jnp.where(
        (s.status == _RUNNING) & ok, jnp.int32(int(Status.OPTIMAL)), s.status
    )
    status = jnp.where(
        status == _RUNNING, jnp.int32(int(Status.ITERATION_LIMIT)), status
    )
    x, y, z = s.x, s.y, s.z
    if scaling is not None:
        x, y, z = unscale_solution(x, y, z, scaling)
    objective = jnp.sum(jnp.asarray(c) * s.x, axis=-1)  # scaled-c·scaled-x == c·x
    return {
        "x": x,
        "y": y,
        "z": z,
        "tau": jnp.ones((B,), dtype),
        "kappa": jnp.zeros((B,), dtype),
        "objective": objective,
        "status": status,
        "iterations": s.iterations,
        "rho_p": jnp.linalg.norm(rp, axis=-1) / bnorm,
        "rho_d": jnp.linalg.norm(rd, axis=-1) / cnorm,
        "rho_gap": gap,
    }


@register_solver
class DensePathSolver(BaseSolver):
    """Batched dense path-following backend (registry: ``dense_path``)."""

    name = "dense_path"
    aliases = ("dense",)

    def _solve_impl(self, A, b, c) -> Solution:
        out = dense_path_solve_batched(
            jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), self.options
        )
        out = {k: np.asarray(v) for k, v in out.items()}
        return Solution(
            x=out["x"],
            y=out["y"],
            z=out["z"],
            objective=out["objective"],
            status=out["status"],
            iterations=out["iterations"],
            rho_p=out["rho_p"],
            rho_d=out["rho_d"],
            rho_gap=out["rho_gap"],
        )
