"""Homogeneous self-dual interior-point core (batched, jit-native).

The batched, jit-native re-design of the upstream solver stack
(upstream: ``pycllp/solvers/hsd.py`` NumPy oracle, vendored Vanderbei
``hsd.c``, and the OpenCL per-work-item kernel).  Algorithm: the
homogeneous self-dual embedding of Andersen & Andersen / Xu–Hung–Ye
with Mehrotra predictor-corrector — the
same family as the Vanderbei ``hsd`` lineage and scipy's
``_linprog_ip.py``, which serves as the local correctness oracle.

Design (SURVEY.md §3.2/§7):

* the host-side driver loop becomes jitted ``lax.while_loop`` phases over
  a batched state — no host round-trips inside the solve;
* pycllp's per-instance OpenCL convergence flags become a per-lane
  ``status`` vector; finished lanes are frozen by masking;
* the loop predicate reduces the lane mask with a pluggable ``reduce_any``
  so the sharded path can substitute a cross-device collective
  (psum-gated termination, SURVEY.md §5);
* all hot ops route through a :class:`~pycllp_jax.ops.reference.KernelSet`
  so Pallas kernels swap in without touching the math.

f32 strategy (SURVEY.md §7 hard part 1): Ruiz-equilibrated data,
relative diagonal regularization of the normal matrix, optional KKT-level
iterative refinement of each Newton direction, per-lane best-iterate
tracking with stall cutoff (an f32 IPM eventually emits garbage
directions once μ ≲ ε_machine·cond — we keep the best point instead of
the last), and an optional mixed-precision finish phase that continues
the *same* interior state in a wider dtype for the last few iterations.

Problem form: ``min cᵀx  s.t.  Ax = b, x ≥ 0`` (EqualityLP).  HSD
embedding variables: x ≥ 0, y free, z ≥ 0, τ ≥ 0, κ ≥ 0; residuals

    r_p = bτ − Ax,   r_d = cτ − Aᵀy − z,   r_g = cᵀx − bᵀy + κ,
    μ = (xᵀz + τκ)/(n+1).
"""

from __future__ import annotations

import os
import sys
import time
from functools import partial
from typing import Callable, NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from pycllp_jax.ops.gpu import resolve_kernels
from pycllp_jax.ops.reference import KernelSet
from pycllp_jax.solvers.options import SolverOptions, Status
from pycllp_jax.utils.scaling import ruiz_equilibrate, scale_problem, unscale_solution

__all__ = ["HSDState", "hsd_solve_batched", "hsd_solve", "hsd_solve_scan"]

_RUNNING = np.int32(int(Status.RUNNING))  # numpy scalar: no device init at import


def _require_x64(opts: SolverOptions) -> None:
    """Hard-error when a float64 phase is requested but x64 is disabled.

    Without ``jax_enable_x64``, JAX silently truncates every f64 array
    request to f32 — the "wide" finish then runs narrow, the crossover
    verification breaks down, and every lane returns NUMERICAL garbage
    behind a stream of truncation warnings (exactly how the round-4
    driver dryrun failed; SURVEY.md §7 ranks precision the top build
    risk).  Raising here makes the misconfiguration impossible to miss.
    """
    wants_f64 = "float64" in (str(opts.dtype), str(opts.finish_dtype))
    if wants_f64 and not jax.config.jax_enable_x64:
        raise ValueError(
            "SolverOptions requests float64 "
            f"(dtype={opts.dtype!r}, finish_dtype={opts.finish_dtype!r}) "
            "but jax_enable_x64 is off — JAX would silently truncate the "
            "wide phase to float32 and the solve would return garbage. "
            'Fix: jax.config.update("jax_enable_x64", True) before '
            "solving (or set JAX_ENABLE_X64=1), or drop the f64 request."
        )


class HSDState(NamedTuple):
    x: jnp.ndarray  # (B, n)
    y: jnp.ndarray  # (B, m)
    z: jnp.ndarray  # (B, n)
    tau: jnp.ndarray  # (B,)
    kappa: jnp.ndarray  # (B,)
    status: jnp.ndarray  # (B,) int32
    iterations: jnp.ndarray  # (B,) int32 — iterations spent while active
    k: jnp.ndarray  # () int32 — global loop counter
    rp0: jnp.ndarray  # (B,) initial-residual norms for relative indicators
    rd0: jnp.ndarray
    rg0: jnp.ndarray
    mu0: jnp.ndarray
    # best-iterate tracking (f32 insurance: keep the best point, not the last)
    best_x: jnp.ndarray
    best_y: jnp.ndarray
    best_z: jnp.ndarray
    best_tau: jnp.ndarray
    best_kappa: jnp.ndarray
    best_score: jnp.ndarray  # (B,) max(ρ_p, ρ_d, ρ_A) at the best iterate
    best_k: jnp.ndarray  # (B,) int32 loop index of the best iterate


class _Indicators(NamedTuple):
    rho_p: jnp.ndarray
    rho_d: jnp.ndarray
    rho_g: jnp.ndarray
    rho_mu: jnp.ndarray
    rho_A: jnp.ndarray
    by: jnp.ndarray


def _norm(v):
    return jnp.linalg.norm(v, axis=-1)


def _residuals(ctx, b, c, x, y, z, tau, kappa, k):
    n_plus_1 = x.shape[-1] + 1
    rp = b * tau[..., None] - k.mv(ctx, x)
    rd = c * tau[..., None] - k.rmv(ctx, y) - z
    rg = jnp.sum(c * x, axis=-1) - jnp.sum(b * y, axis=-1) + kappa
    mu = (jnp.sum(x * z, axis=-1) + tau * kappa) / n_plus_1
    return rp, rd, rg, mu


def _indicators(rp, rd, rg, mu, tau, kappa, by, rp0, rd0, rg0, mu0) -> _Indicators:
    one = jnp.ones_like(rp0)
    rho_p = _norm(rp) / jnp.maximum(one, rp0)
    rho_d = _norm(rd) / jnp.maximum(one, rd0)
    rho_g = jnp.abs(rg) / jnp.maximum(one, rg0)
    rho_mu = mu / mu0
    cx_minus_by = rg - kappa  # cᵀx − bᵀy
    # gap test normalized by max(τ, |bᵀy|), i.e. (de-embedded)
    # |cᵀx/τ − bᵀy/τ| ≤ tol·max(1, |obj|) — the SAME quantity the
    # contract audits (objective error over max(1,|f|), BASELINE.md
    # "Correctness").  The previous τ+|bᵀy| denominator was up to ~1
    # objective-unit looser for |obj| ≲ 1 lanes, which forced the bench
    # to run 5x past contract (tol 2e-7) to pass a 1e-6 audit
    # (VERDICT r4 weak item 3).
    tiny = jnp.asarray(jnp.finfo(rp.dtype).tiny, rp.dtype)
    rho_A = jnp.abs(cx_minus_by) / jnp.maximum(jnp.maximum(tau, jnp.abs(by)), tiny)
    return _Indicators(rho_p, rho_d, rho_g, rho_mu, rho_A, by)


def _classify(ind: _Indicators, tau, kappa, status, tol):
    """Per-lane termination test → new status vector."""
    optimal = (ind.rho_p <= tol) & (ind.rho_d <= tol) & (ind.rho_A <= tol)
    inf1 = (
        (ind.rho_p <= tol)
        & (ind.rho_d <= tol)
        & (ind.rho_g <= tol)
        & (tau <= tol * jnp.maximum(1.0, kappa))
    )
    inf2 = (ind.rho_mu <= tol) & (tau <= tol * jnp.minimum(1.0, kappa))
    infeasible = inf1 | inf2
    inf_status = jnp.where(
        ind.by > tol, jnp.int32(int(Status.INFEASIBLE)), jnp.int32(int(Status.UNBOUNDED))
    )
    running = status == _RUNNING
    return jnp.where(
        running & optimal,
        jnp.int32(int(Status.OPTIMAL)),
        jnp.where(running & infeasible, inf_status, status),
    )


def _max_step(x, dx, z, dz, tau, dtau, kappa, dkappa):
    """Largest α keeping (x, z, τ, κ) ≥ 0 along the direction (ratio test)."""
    big = jnp.asarray(jnp.finfo(x.dtype).max, x.dtype)

    def ratios(v, dv):
        return jnp.where(dv < 0, v / jnp.where(dv < 0, -dv, 1.0), big)

    a = jnp.minimum(jnp.min(ratios(x, dx), axis=-1), jnp.min(ratios(z, dz), axis=-1))
    a = jnp.minimum(a, jnp.where(dtau < 0, tau / jnp.where(dtau < 0, -dtau, 1.0), big))
    a = jnp.minimum(a, jnp.where(dkappa < 0, kappa / jnp.where(dkappa < 0, -dkappa, 1.0), big))
    return a


def _make_step_fn(ctx, b, c, opts: SolverOptions, kset: KernelSet, dtype):
    """Build the per-iteration Newton step closure (batched over lanes).

    Solve schedule per iteration (one factorization, 2 + 1 RHS):
    stage 1 jointly solves the τ-column system (p, q) and the predictor
    system; stage 2 solves the corrector.  Multi-RHS solves share the
    factorization read, which matters once the Pallas kernels make the
    solve memory-bound.
    """
    reg_eps = opts.resolved_reg_eps(dtype)
    refine = opts.resolved_refine_steps(dtype)
    kkt_refine = opts.kkt_refine

    def step(x, y, z, tau, kappa, rp, rd, rg, mu):
        # "D" = X Z⁻¹, capped at 1e30: the late-IPM spread of x/z was
        # measured at 5e47 on the CPU f64 oracle, and entries at 1e30 are
        # already "infinite" for the Newton system (the corresponding
        # z ≈ 0 bound is inactive).  The cap keeps every D entry finite
        # in any float format the factor runs in; it is not inert — entries
        # above 1e30 are capped, so post-cap trajectories can differ
        # slightly from uncapped ones.
        dinv = jnp.minimum(x / z, jnp.asarray(1e30, dtype))

        def refine_vs(fac, rs, vs):
            for _ in range(refine):
                es = tuple(r - kset.matvec_M(fac, v) for r, v in zip(rs, vs))
                cs = kset.solve(fac, es)
                vs = tuple(v + cv for v, cv in zip(vs, cs))
            return vs

        def sym_parts(r1, v):
            """Recover u = D(Aᵀv − r1) for a solved v."""
            return dinv * (kset.rmv(ctx, v) - r1)

        # ---- stage 1: τ-column (p, q) + predictor RHS built BEFORE the
        # factorization so both ride the fused factor+solve launch ----
        t_pq = b + kset.mv(ctx, dinv * c)
        # predictor RHS (γ=0, η=1, no aff products):
        #   rhs_d − rhs_xs/x = rd − (−xz)/x = rd + z
        r1_pred = rd + z
        t_pred = rp + kset.mv(ctx, dinv * r1_pred)
        if opts.mehrotra:
            fac, vs = kset.factor_and_solve(ctx, dinv, reg_eps, (t_pq, t_pred))
            q, v_pred = refine_vs(fac, (t_pq, t_pred), vs)
        else:
            gamma0 = jnp.full_like(tau, opts.gamma)
            eta0 = 1.0 - gamma0
            rxs0 = (gamma0 * mu)[..., None] - x * z
            r1_c = eta0[..., None] * rd - rxs0 / x
            t_c = eta0[..., None] * rp + kset.mv(ctx, dinv * r1_c)
            fac, vs = kset.factor_and_solve(ctx, dinv, reg_eps, (t_pq, t_c))
            q, v_c = refine_vs(fac, (t_pq, t_c), vs)

        def msolve(rs):
            return refine_vs(fac, rs, kset.solve(fac, rs))

        p = sym_parts(c, q)
        # denominator of the dτ formula: κ/τ + (bᵀq − cᵀp)
        denom = kappa / tau + jnp.sum(b * q, axis=-1) - jnp.sum(c * p, axis=-1)

        def assemble(v, r1, rhs_g, rhs_xs, rhs_tk):
            """Given the normal-equations solution v for a Newton RHS,
            recover the full direction (dx, dy, dz, dτ, dκ)."""
            u = sym_parts(r1, v)
            dtau = (
                rhs_g
                + rhs_tk / tau
                - (jnp.sum(b * v, axis=-1) - jnp.sum(c * u, axis=-1))
            ) / denom
            dx = u + p * dtau[..., None]
            dy = v + q * dtau[..., None]
            dz = (rhs_xs - z * dx) / x
            dkappa = (rhs_tk - kappa * dtau) / tau
            return dx, dy, dz, dtau, dkappa

        def solve_newton(rhs_p, rhs_d, rhs_g, rhs_xs, rhs_tk):
            r1 = rhs_d - rhs_xs / x
            (v,) = msolve((rhs_p + kset.mv(ctx, dinv * r1),))
            return assemble(v, r1, rhs_g, rhs_xs, rhs_tk)

        def kkt_correct(d, rhs_p, rhs_d, rhs_g, rhs_xs, rhs_tk, sweeps=None):
            """Iterative refinement on the full 5-block Newton system."""
            for _ in range(kkt_refine if sweeps is None else sweeps):
                dx, dy, dz, dtau, dkappa = d
                e_p = rhs_p - (kset.mv(ctx, dx) - b * dtau[..., None])
                e_d = rhs_d - (kset.rmv(ctx, dy) + dz - c * dtau[..., None])
                e_g = rhs_g - (
                    jnp.sum(b * dy, axis=-1) - jnp.sum(c * dx, axis=-1) - dkappa
                )
                e_xs = rhs_xs - (z * dx + x * dz)
                e_tk = rhs_tk - (kappa * dtau + tau * dkappa)
                corr = solve_newton(e_p, e_d, e_g, e_xs, e_tk)
                d = tuple(a + b_ for a, b_ in zip(d, corr))
            return d

        if opts.mehrotra:
            # predictor direction from the joint solve
            rxs_a = -x * z
            rtk_a = -tau * kappa
            da = assemble(v_pred, r1_pred, rg, rxs_a, rtk_a)
            # asymmetric refinement: the predictor is only taken to
            # gauge μ_aff (→ the centering weight γ) and to form the
            # corrector's second-order products — the step actually
            # TAKEN is the corrector — so it tolerates fewer sweeps
            # than the corrector (opts.kkt_refine_pred, None = same)
            da = kkt_correct(da, rp, rd, rg, rxs_a, rtk_a,
                             sweeps=opts.resolved_kkt_refine_pred())
            dxa, dya, dza, dta, dka = da
            a_aff = jnp.minimum(1.0, _max_step(x, dxa, z, dza, tau, dta, kappa, dka))
            aan = a_aff[..., None]
            mu_aff = (
                jnp.sum((x + aan * dxa) * (z + aan * dza), axis=-1)
                + (tau + a_aff * dta) * (kappa + a_aff * dka)
            ) / (x.shape[-1] + 1)
            gamma = jnp.clip((mu_aff / mu) ** 3, 0.0, 1.0)
            # ---- stage 2: corrector ----
            eta = 1.0 - gamma
            rhs_p = eta[..., None] * rp
            rhs_d = eta[..., None] * rd
            rhs_g = eta * rg
            rhs_xs = (gamma * mu)[..., None] - x * z - dxa * dza
            rhs_tk = gamma * mu - tau * kappa - dta * dka
            d = solve_newton(rhs_p, rhs_d, rhs_g, rhs_xs, rhs_tk)
            d = kkt_correct(d, rhs_p, rhs_d, rhs_g, rhs_xs, rhs_tk)
            dx, dy, dz, dtau, dkappa = d

            # Gondzio multiple centrality correctors: push outlier
            # complementarity products toward [βmin, βmax]·γμ with extra
            # solves through the SAME factorization; per-lane accept only
            # when the step length improves.  Iteration-count reducer —
            # the right trade when per-iteration fixed costs dominate.
            for _ in range(opts.gondzio_correctors):
                alpha_c = jnp.minimum(
                    1.0, opts.alpha0 * _max_step(x, dx, z, dz, tau, dtau, kappa, dkappa)
                )
                a_hat = jnp.minimum(1.0, 1.5 * alpha_c + 0.1)
                ah = a_hat[..., None]
                v_t = (x + ah * dx) * (z + ah * dz)
                vtk = (tau + a_hat * dtau) * (kappa + a_hat * dkappa)
                mu_g = gamma * mu
                lo = (0.1 * mu_g)[..., None]
                hi = (10.0 * mu_g)[..., None]
                # correction only for products outside the box
                t_xs = jnp.clip(v_t, lo, hi) - v_t
                t_tk = jnp.clip(vtk, 0.1 * mu_g, 10.0 * mu_g) - vtk
                zero = jnp.zeros_like(rg)
                dc = solve_newton(
                    jnp.zeros_like(rp), jnp.zeros_like(rd), zero, t_xs, t_tk
                )
                cand = tuple(a + b_ for a, b_ in zip(d, dc))
                alpha_new = jnp.minimum(
                    1.0,
                    opts.alpha0 * _max_step(x, cand[0], z, cand[2], tau, cand[3], kappa, cand[4]),
                )
                accept = alpha_new > alpha_c + 1e-4
                an_ = accept[..., None]
                d = tuple(
                    jnp.where(an_ if dv.ndim == 2 else accept, cv, dv)
                    for dv, cv in zip(d, cand)
                )
                dx, dy, dz, dtau, dkappa = d
        else:
            rhs_g0 = eta0 * rg
            rtk0 = gamma0 * mu - tau * kappa
            d = assemble(v_c, r1_c, rhs_g0, rxs0, rtk0)
            d = kkt_correct(d, eta0[..., None] * rp, eta0[..., None] * rd, rhs_g0, rxs0, rtk0)
            dx, dy, dz, dtau, dkappa = d

        alpha = jnp.minimum(
            1.0, opts.alpha0 * _max_step(x, dx, z, dz, tau, dtau, kappa, dkappa)
        )
        an = alpha[..., None]
        return (
            x + an * dx,
            y + an * dy,
            z + an * dz,
            tau + alpha * dtau,
            kappa + alpha * dkappa,
        )

    return step


def _run_phase(
    ctx,
    b,
    c,
    state: HSDState,
    opts: SolverOptions,
    kset: KernelSet,
    dtype,
    tol: float,
    maxiter: int,
    reduce_any: Callable,
) -> HSDState:
    """Run the masked IPM loop until all lanes finish or ``k == maxiter``."""
    step = _make_step_fn(ctx, b, c, opts, kset, dtype)
    patience = opts.stall_patience

    def cond(s: HSDState):
        return (s.k < maxiter) & reduce_any(s.status == _RUNNING)

    def body(s: HSDState) -> HSDState:
        rp, rd, rg, mu = _residuals(ctx, b, c, s.x, s.y, s.z, s.tau, s.kappa, kset)
        by = jnp.sum(b * s.y, axis=-1)
        ind = _indicators(rp, rd, rg, mu, s.tau, s.kappa, by, s.rp0, s.rd0, s.rg0, s.mu0)
        status = _classify(ind, s.tau, s.kappa, s.status, tol)
        running = status == _RUNNING

        # best-iterate bookkeeping (finite scores only)
        score = jnp.maximum(jnp.maximum(ind.rho_p, ind.rho_d), ind.rho_A)
        was_running = (s.status == _RUNNING) & jnp.isfinite(score)
        improved = was_running & (score < s.best_score)
        imn = improved[..., None]
        best_x = jnp.where(imn, s.x, s.best_x)
        best_y = jnp.where(imn, s.y, s.best_y)
        best_z = jnp.where(imn, s.z, s.best_z)
        best_tau = jnp.where(improved, s.tau, s.best_tau)
        best_kappa = jnp.where(improved, s.kappa, s.best_kappa)
        best_score = jnp.where(improved, score, s.best_score)
        # the stall clock only resets on MATERIAL progress (opts.stall_rtol
        # relative drop); with the default 0.0 this equals `improved`
        if opts.stall_rtol:
            material = was_running & (score < s.best_score * (1.0 - opts.stall_rtol))
        else:
            material = improved
        best_k = jnp.where(material, s.k, s.best_k)

        # stall cutoff: no best-score progress for `patience` iterations →
        # stop spending FLOPs on this lane (its best iterate is kept)
        stalled = running & (s.k - best_k >= patience)
        status = jnp.where(stalled, jnp.int32(int(Status.STALLED)), status)
        active = status == _RUNNING

        if opts.log_every:
            from pycllp_jax.utils.logging import iteration_record

            nact = jnp.sum(active)
            mx = lambda v: jnp.max(jnp.where(active, v, 0.0))
            lax.cond(
                s.k % opts.log_every == 0,
                lambda: jax.debug.callback(
                    iteration_record,
                    str(jnp.dtype(s.x.dtype)),
                    s.k,
                    nact,
                    mx(ind.rho_p),
                    mx(ind.rho_d),
                    mx(ind.rho_g),
                    jnp.sum(jnp.where(active, mu, 0.0)) / jnp.maximum(nact, 1),
                ),
                lambda: None,
            )

        xn, yn, zn, taun, kappan = step(s.x, s.y, s.z, s.tau, s.kappa, rp, rd, rg, mu)

        # numerical guard: a lane whose step went non-finite keeps its old
        # iterate and is flagged NUMERICAL (the f32 breakdown path).
        finite = (
            jnp.all(jnp.isfinite(xn), axis=-1)
            & jnp.all(jnp.isfinite(yn), axis=-1)
            & jnp.all(jnp.isfinite(zn), axis=-1)
            & jnp.isfinite(taun)
            & jnp.isfinite(kappan)
            & (taun > 0)
            & (kappan >= 0)
        )
        status = jnp.where(active & ~finite, jnp.int32(int(Status.NUMERICAL)), status)
        take = active & finite

        tn = take[..., None]
        return HSDState(
            x=jnp.where(tn, xn, s.x),
            y=jnp.where(tn, yn, s.y),
            z=jnp.where(tn, zn, s.z),
            tau=jnp.where(take, taun, s.tau),
            kappa=jnp.where(take, kappan, s.kappa),
            status=status,
            iterations=jnp.where(take, s.iterations + 1, s.iterations),
            k=s.k + 1,
            rp0=s.rp0,
            rd0=s.rd0,
            rg0=s.rg0,
            mu0=s.mu0,
            best_x=best_x,
            best_y=best_y,
            best_z=best_z,
            best_tau=best_tau,
            best_kappa=best_kappa,
            best_score=best_score,
            best_k=best_k,
        )

    return lax.while_loop(cond, body, state)


def _run_narrow_phase(
    ctx, b, c, state: HSDState, opts: SolverOptions, kset: KernelSet,
    dtype, tol: float, maxiter: int, reduce_any: Callable,
) -> HSDState:
    """Narrow IPM phase with the ``kkt_warmup`` refine schedule.

    KKT-level refinement is an end-quality knob (crossover acceptance is
    named by the LAST few f32 directions), so the first ``kkt_warmup``
    iterations run with ``kkt_refine=0`` — 2·kkt_refine fewer solves per
    iteration — and the loop continues refined from there.  The split is
    two sequential while_loops over the same state (``_run_phase`` caps
    are absolute in ``k``); a warmup at/below the workload's minimum lane
    iteration count leaves every lane's terminal iterate unchanged.
    Resumed states (k ≥ warmup) skip the warmup loop at runtime.
    """
    w = opts.kkt_warmup
    if opts.kkt_refine and w:
        state = _run_phase(
            ctx, b, c, state, opts.replace(kkt_refine=0), kset, dtype, tol,
            min(w, maxiter) if isinstance(maxiter, int) else w, reduce_any,
        )
    return _run_phase(ctx, b, c, state, opts, kset, dtype, tol, maxiter, reduce_any)


def _finalize(ctx, b, c, s: HSDState, kset: KernelSet, tol):
    """Fold the current iterate into `best`, classify on the best iterate."""
    rp, rd, rg, mu = _residuals(ctx, b, c, s.x, s.y, s.z, s.tau, s.kappa, kset)
    by = jnp.sum(b * s.y, axis=-1)
    ind = _indicators(rp, rd, rg, mu, s.tau, s.kappa, by, s.rp0, s.rd0, s.rg0, s.mu0)
    score = jnp.maximum(jnp.maximum(ind.rho_p, ind.rho_d), ind.rho_A)
    improved = (s.status == _RUNNING) & jnp.isfinite(score) & (score < s.best_score)
    imn = improved[..., None]
    s = s._replace(
        best_x=jnp.where(imn, s.x, s.best_x),
        best_y=jnp.where(imn, s.y, s.best_y),
        best_z=jnp.where(imn, s.z, s.best_z),
        best_tau=jnp.where(improved, s.tau, s.best_tau),
        best_kappa=jnp.where(improved, s.kappa, s.best_kappa),
        best_score=jnp.where(improved, score, s.best_score),
    )
    # non-terminated lanes answer with their best iterate — including
    # NUMERICAL ones (VERDICT r2 item 4): a lane whose wide step NaN'd
    # keeps its last finite iterate in x, but its tracked best (often a
    # phase-1 point) can be strictly better; the tracker only ever
    # accepts finite scores, so this is safe.
    stalled = s.status == jnp.int32(int(Status.STALLED))
    numerical = s.status == jnp.int32(int(Status.NUMERICAL))
    use_best = (s.status == _RUNNING) | stalled | numerical
    ubn = use_best[..., None]
    x = jnp.where(ubn, s.best_x, s.x)
    y = jnp.where(ubn, s.best_y, s.y)
    z = jnp.where(ubn, s.best_z, s.z)
    tau = jnp.where(use_best, s.best_tau, s.tau)
    kappa = jnp.where(use_best, s.best_kappa, s.kappa)

    rp, rd, rg, mu = _residuals(ctx, b, c, x, y, z, tau, kappa, kset)
    by = jnp.sum(b * y, axis=-1)
    ind = _indicators(rp, rd, rg, mu, tau, kappa, by, s.rp0, s.rd0, s.rg0, s.mu0)
    # STALLED/NUMERICAL lanes are re-opened for this final test: if the
    # best iterate meets tol after all, they are OPTIMAL.
    status_open = jnp.where(stalled | numerical, _RUNNING, s.status)
    status = _classify(ind, tau, kappa, status_open, tol)
    status = jnp.where(
        status == _RUNNING,
        jnp.where(
            stalled,
            jnp.int32(int(Status.STALLED)),
            jnp.where(
                numerical,
                jnp.int32(int(Status.NUMERICAL)),
                jnp.int32(int(Status.ITERATION_LIMIT)),
            ),
        ),
        status,
    )
    return x, y, z, tau, kappa, status, ind


def _fold_to_best(ctx, b, c, s: HSDState, kset: KernelSet, only=None) -> HSDState:
    """Replace each lane's CURRENT iterate with its tracked best where the
    best scores strictly better.

    Used before a finish phase re-opens lanes: at the f32 stall floor the
    last iterate can be far worse than the best one seen (that is the
    whole point of best-iterate tracking), and the wide phase resets the
    best trackers — continuing from the raw last iterate was measured to
    make the finish phase REGRESS accuracy (6.9e-3 vs 2.7e-4 max on the
    64² bench, 2026-08-19).
    """
    def score_of(x, y, z, tau, kappa):
        rp, rd, rg, mu = _residuals(ctx, b, c, x, y, z, tau, kappa, kset)
        by = jnp.sum(b * y, axis=-1)
        ind = _indicators(rp, rd, rg, mu, tau, kappa, by, s.rp0, s.rd0, s.rg0, s.mu0)
        return jnp.maximum(jnp.maximum(ind.rho_p, ind.rho_d), ind.rho_A)

    # re-score BOTH candidates in the current dtype: comparing a freshly
    # recomputed score of x against the narrower-dtype RECORDED score of
    # best_x can pick the worse point (measured: a poisoned-finish lane
    # answering 9.5e-7 when its narrow best was 2.2e-7)
    score = score_of(s.x, s.y, s.z, s.tau, s.kappa)
    score_b = score_of(s.best_x, s.best_y, s.best_z, s.best_tau, s.best_kappa)
    use_best = ~jnp.isfinite(score) | (jnp.isfinite(score_b) & (score_b < score))
    if only is not None:
        use_best = use_best & only  # restrict the fold to these lanes
    ubn = use_best[..., None]
    return s._replace(
        x=jnp.where(ubn, s.best_x, s.x),
        y=jnp.where(ubn, s.best_y, s.y),
        z=jnp.where(ubn, s.best_z, s.z),
        tau=jnp.where(use_best, s.best_tau, s.tau),
        kappa=jnp.where(use_best, s.best_kappa, s.kappa),
    )


def _crossover_state(
    fctx, b, c, state: HSDState, fkset: KernelSet, opts: SolverOptions, tol,
    reopen: bool = True,
) -> HSDState:
    """Apply the vertex crossover (solvers/crossover.py) to a wide state.

    Every lane not already proven INFEASIBLE/UNBOUNDED gets a candidate;
    a lane is accepted when the candidate passes BOTH the sign/residual
    verification and the ρ-indicator optimality test at full ``tol`` —
    accepted lanes become OPTIMAL with the vertex as their iterate
    (τ = 1, κ = 0: the de-embedded exact solution).  With ``reopen``,
    rejected lanes become RUNNING so a wide IPM continuation picks them
    up from their (folded-to-best) interior point; a FINAL (rescue)
    crossover passes ``reopen=False`` so reject statuses — in
    particular STALLED, which downstream restart logic keys on — are
    left untouched.

    ``fctx``/``fkset`` here are the CROSSOVER kernel set and its context
    (``opts.crossover_kset``); its mv/rmv are wide-precision either way,
    so the residual/ρ verification below is genuine f64 regardless of
    how the factor runs.
    """
    from pycllp_jax.solvers.crossover import crossover_candidate

    tiny = jnp.asarray(jnp.finfo(state.x.dtype).tiny, state.x.dtype)
    tau_safe = jnp.maximum(state.tau, tiny)
    xv, yv, zv, ok, rp, rd = crossover_candidate(
        fctx,
        b,
        c,
        state.x / tau_safe[..., None],
        state.z / tau_safe[..., None],
        fkset,
        refine=opts.crossover_refine,
        feas_tol=opts.crossover_feas_tol,
        repair=opts.crossover_repair,
    )
    tau1 = jnp.ones_like(state.tau)
    kap0 = jnp.zeros_like(state.kappa)
    # ρ test from the residuals the verification already computed (rd is
    # the z-clamp residue — see crossover_candidate's return contract);
    # the gap/μ quantities are cheap dots, no further matvecs needed.
    rg = jnp.sum(c * xv, axis=-1) - jnp.sum(b * yv, axis=-1) + kap0
    mu = (jnp.sum(xv * zv, axis=-1) + tau1 * kap0) / (xv.shape[-1] + 1)
    by = jnp.sum(b * yv, axis=-1)
    ind = _indicators(
        rp, rd, rg, mu, tau1, kap0, by, state.rp0, state.rd0, state.rg0, state.mu0
    )
    opt = (ind.rho_p <= tol) & (ind.rho_d <= tol) & (ind.rho_A <= tol)
    eligible = (state.status != jnp.int32(int(Status.INFEASIBLE))) & (
        state.status != jnp.int32(int(Status.UNBOUNDED))
    )
    accept = eligible & ok & opt
    an = accept[..., None]
    return state._replace(
        x=jnp.where(an, xv, state.x),
        y=jnp.where(an, yv, state.y),
        z=jnp.where(an, zv, state.z),
        tau=jnp.where(accept, tau1, state.tau),
        kappa=jnp.where(accept, kap0, state.kappa),
        status=jnp.where(
            accept,
            jnp.int32(int(Status.OPTIMAL)),
            jnp.where(eligible & reopen, _RUNNING, state.status),
        ),
    )


def _wide_cross_opts(opts: SolverOptions) -> SolverOptions:
    """Crossover settings for a basis solve in the float64 finish set.

    The float64 crossovers verify at a FLOORED feasibility tolerance: a
    correct basis solved in float64 carries residual ~1e-8-class for the
    ill-conditioned lanes that reach them (exactly the ones whose
    mixed-IR verification diverges), and holding them to 1e-9 leaves
    them with an IPM answer instead.  An accepted 1e-8-residual vertex
    perturbs the audited objective by ~|y·rp| ≈ 3e-7 — still 3x under
    the 1e-6 contract — and the ρ ≤ tol test still applies on top.
    refine=1, not the mixed engine's 2: after a DIRECT float64 factor
    one true-residual sweep already sits orders under the floored
    verification bound.
    """
    return opts.replace(
        crossover_feas_tol=max(opts.crossover_feas_tol, 1e-8),
        crossover_refine=min(opts.crossover_refine, 1),
    )


def _restart_merge(state: HSDState, fresh: HSDState, retry) -> HSDState:
    """Merge a fresh start into ``state`` for the ``retry`` lanes.

    Fresh-restart fallback for lanes the wide phase left unfinished:
    phase 1's f32 floor can leave a lane so far off the central path
    that the wide continuation stalls recentring within its patience —
    measured on a 32²×256 workload: 9/256 lanes STALLED at ~3e-3
    objective error through EVERY finish kernel set (including the
    XLA-f64 oracle), while a cold f64 solve of the same instances
    converges in ≤10 iterations.  Retry lanes take the fresh iterates
    and normalizers but KEEP their old best trackers (best-iterate
    insurance: a failed restart can never answer worse than the old
    best); the loop clock restarts at 0.
    """
    rn = retry[..., None]
    return HSDState(
        x=jnp.where(rn, fresh.x, state.x),
        y=jnp.where(rn, fresh.y, state.y),
        z=jnp.where(rn, fresh.z, state.z),
        tau=jnp.where(retry, fresh.tau, state.tau),
        kappa=jnp.where(retry, fresh.kappa, state.kappa),
        status=jnp.where(retry, _RUNNING, state.status),
        iterations=state.iterations,
        k=jnp.int32(0),
        rp0=jnp.where(retry, fresh.rp0, state.rp0),
        rd0=jnp.where(retry, fresh.rd0, state.rd0),
        rg0=jnp.where(retry, fresh.rg0, state.rg0),
        mu0=jnp.where(retry, fresh.mu0, state.mu0),
        best_x=state.best_x,
        best_y=state.best_y,
        best_z=state.best_z,
        best_tau=state.best_tau,
        best_kappa=state.best_kappa,
        best_score=state.best_score,
        best_k=jnp.zeros_like(state.best_k),
    )


# stall_patience for restart phases: a restarted lane keeps its OLD best
# trackers as insurance, so the stall clock's baseline is the old
# best_score — which a cold start cannot beat until it has ~converged.
# With a finite patience the clock kills exactly the lanes that need
# more than `patience` iterations to do so (measured: 2/256 lanes
# stall-killed at k=8 that converge at k=9-10).  Restart phases are
# already budget-capped, so the cutoff buys nothing there: disable it.
_NO_STALL = 1 << 30


def _retry_mask(status):
    return (
        (status == _RUNNING)
        | (status == jnp.int32(int(Status.STALLED)))
        | (status == jnp.int32(int(Status.NUMERICAL)))
    )


def _mehrotra_start(ctx, b, c, kset: KernelSet, reg_eps):
    """Mehrotra's least-squares starting point, HSD-adapted.

    x̂ = Aᵀ(AAᵀ)⁻¹b (min-norm primal), ŷ = (AAᵀ)⁻¹Ac, ẑ = c − Aᵀŷ,
    then the positivity shifts from Mehrotra (1992): one extra
    factorization (D = I) per solve, typically 2–4 fewer IPM iterations.
    """
    ones_d = jnp.ones_like(c)
    fac0, (vb, vc) = kset.factor_and_solve(
        ctx, ones_d, reg_eps, (b, kset.mv(ctx, c))
    )
    x_hat = kset.rmv(ctx, vb)
    y_hat = vc
    z_hat = c - kset.rmv(ctx, y_hat)
    dx = jnp.maximum(-1.5 * jnp.min(x_hat, axis=-1), 0.0)[..., None]
    dz = jnp.maximum(-1.5 * jnp.min(z_hat, axis=-1), 0.0)[..., None]
    xs = x_hat + dx
    zs = z_hat + dz
    dot = jnp.sum(xs * zs, axis=-1)
    # guard degenerate all-zero cases with a unit fallback
    sum_z = jnp.maximum(jnp.sum(zs, axis=-1), 1e-8)
    sum_x = jnp.maximum(jnp.sum(xs, axis=-1), 1e-8)
    x0 = xs + (0.5 * dot / sum_z)[..., None]
    z0 = zs + (0.5 * dot / sum_x)[..., None]
    # keep strictly interior even for pathological data
    x0 = jnp.maximum(x0, 1e-4)
    z0 = jnp.maximum(z0, 1e-4)
    return x0, y_hat, z0


def _cast_state(s: HSDState, dtype) -> HSDState:
    def cast(v):
        return v.astype(dtype) if jnp.issubdtype(v.dtype, jnp.floating) else v

    return HSDState(*[cast(v) for v in s])


def _fresh_state(
    ctx, b_s, c_s, opts: SolverOptions, kset: KernelSet, dtype, warm=None
) -> HSDState:
    """Initial HSD state (blind, Mehrotra least-squares, or warm start).

    ``warm`` is an optional (x, y, z) triple in SCALED equality
    coordinates — typically the previous solve's solution on a nearby
    problem.  A solution sits ON the boundary (complementary zeros), so
    it is interiorized: blended ``warm_lambda`` of the way toward the
    well-centered blind start and floored strictly positive; κ is set to
    the point's own average complementarity so τκ does not drown the
    warm point's small μ.
    """
    B, m = b_s.shape
    n = c_s.shape[-1]
    if warm is not None:
        lam = jnp.asarray(opts.warm_lambda, dtype)
        xw, yw, zw = (jnp.asarray(v, dtype) for v in warm)
        x0 = jnp.maximum((1.0 - lam) * xw + lam, 1e-4)
        z0 = jnp.maximum((1.0 - lam) * zw + lam, 1e-4)
        y0 = (1.0 - lam) * yw
        tau0 = jnp.ones((B,), dtype)
        kappa0 = jnp.sum(x0 * z0, axis=-1) / n
        # indicator normalizers come from the BLIND start, not the warm
        # point: a warm start's residuals are tiny, and normalizing by
        # them would make the termination test absolute (strictly harder
        # than a cold solve's relative test).  A warm solve therefore
        # faces the same criterion as a cold init_point='ones' solve;
        # cold init_point='mehrotra' normalizes by ITS start's residuals
        # instead, so those two criteria differ by the ratio of the
        # starts' residual norms.
        ones_x = jnp.ones((B, n), dtype)
        rp_b, rd_b, rg_b, mu_b = _residuals(
            ctx, b_s, c_s, ones_x, jnp.zeros((B, m), dtype), ones_x,
            jnp.ones((B,), dtype), jnp.ones((B,), dtype), kset,
        )
        big = jnp.asarray(jnp.finfo(dtype).max, dtype)
        return HSDState(
            x=x0, y=y0, z=z0, tau=tau0, kappa=kappa0,
            status=jnp.full((B,), _RUNNING, jnp.int32),
            iterations=jnp.zeros((B,), jnp.int32),
            k=jnp.int32(0),
            rp0=_norm(rp_b), rd0=_norm(rd_b), rg0=jnp.abs(rg_b), mu0=mu_b,
            best_x=x0, best_y=y0, best_z=z0, best_tau=tau0, best_kappa=kappa0,
            best_score=jnp.full((B,), big, dtype),
            best_k=jnp.zeros((B,), jnp.int32),
        )
    if opts.init_point == "mehrotra":
        x0, y0, z0 = _mehrotra_start(ctx, b_s, c_s, kset, opts.resolved_reg_eps(dtype))
    else:
        x0 = jnp.ones((B, n), dtype)
        y0 = jnp.zeros((B, m), dtype)
        z0 = jnp.ones((B, n), dtype)
    tau0 = jnp.ones((B,), dtype)
    kappa0 = jnp.ones((B,), dtype)
    rp, rd, rg, mu = _residuals(ctx, b_s, c_s, x0, y0, z0, tau0, kappa0, kset)
    big = jnp.asarray(jnp.finfo(dtype).max, dtype)
    return HSDState(
        x=x0,
        y=y0,
        z=z0,
        tau=tau0,
        kappa=kappa0,
        status=jnp.full((B,), _RUNNING, jnp.int32),
        iterations=jnp.zeros((B,), jnp.int32),
        k=jnp.int32(0),
        rp0=_norm(rp),
        rd0=_norm(rd),
        rg0=jnp.abs(rg),
        mu0=mu,
        best_x=x0,
        best_y=y0,
        best_z=z0,
        best_tau=tau0,
        best_kappa=kappa0,
        best_score=jnp.full((B,), big, dtype),
        best_k=jnp.zeros((B,), jnp.int32),
    )


def _package(ctx, b_s, c_s, state: HSDState, kset: KernelSet, opts: SolverOptions, scaling, c_orig):
    """Finalize + unscale a terminal state into the public output dict.

    ``c_orig`` is the UNSCALED objective vector batch (original data) used
    for the reported objective value.
    """
    x, y, z, tau, kappa, status, ind = _finalize(ctx, b_s, c_s, state, kset, opts.tol)
    out_dtype = x.dtype
    tau_safe = jnp.maximum(tau, jnp.asarray(jnp.finfo(out_dtype).tiny, out_dtype))
    inv_tau = (1.0 / tau_safe)[..., None]
    x_hat = x * inv_tau
    y_hat = y * inv_tau
    z_hat = z * inv_tau
    if scaling is not None:
        sc = type(scaling)(*[v.astype(out_dtype) for v in scaling])
        x_hat, y_hat, z_hat = unscale_solution(x_hat, y_hat, z_hat, sc)
    objective = jnp.sum(c_orig.astype(out_dtype) * x_hat, axis=-1)
    return {
        "x": x_hat,
        "y": y_hat,
        "z": z_hat,
        "tau": tau,
        "kappa": kappa,
        "objective": objective,
        "status": status,
        "iterations": state.iterations,
        "rho_p": ind.rho_p,
        "rho_d": ind.rho_d,
        "rho_gap": ind.rho_g,
    }


def _package_bucketed(
    ctx, b_s, c_s, state: HSDState, kset: KernelSet, opts: SolverOptions,
    scaling, c_orig, bucket: int
):
    """:func:`_package` with the finalize/classify pass confined to a
    gathered bucket of the NON-TERMINAL lanes.

    After the crossover finish ~99% of lanes are already OPTIMAL with
    their exact vertex as the iterate; the full-width ``_finalize``
    would still pay two wide residual passes (4 wide matvecs) plus
    norms over every lane just to re-derive what is already known.
    Here terminal lanes (OPTIMAL / INFEASIBLE / UNBOUNDED) pass through
    untouched and only the gathered remainder runs ``_finalize``
    (best-iterate fold + last-chance classification).  Non-terminal
    lanes beyond ``bucket`` keep their iterate; still-RUNNING ones are
    flagged ITERATION_LIMIT — attributable to capacity, as in the drain
    tiers.  The ρ diagnostics are not computed — callers requesting
    ``rho_*`` keys route through the full :func:`_package`.
    """
    terminal = (
        (state.status == jnp.int32(int(Status.OPTIMAL)))
        | (state.status == jnp.int32(int(Status.INFEASIBLE)))
        | (state.status == jnp.int32(int(Status.UNBOUNDED)))
    )
    nt = ~terminal
    # overflow guard (ADVICE r4): non-terminal lanes beyond `bucket` skip
    # the gathered _finalize below, so an overflow tail would answer with
    # its LAST iterate even when its tracked best is strictly better.
    # This cond-gated fold runs a full-width best-iterate fold over the
    # non-terminal lanes ONLY when they overflow the bucket — never on
    # the typical high-acceptance run (runtime-skipped), so the fast path
    # stays two-residual-passes cheaper.  Beyond-bucket STALLED/NUMERICAL
    # lanes still skip _finalize's last-chance reclassification; that is
    # the remaining (status-only) divergence from the full _package.
    state = lax.cond(
        jnp.sum(nt) > bucket,
        lambda s: _fold_to_best(ctx, b_s, c_s, s, kset, only=nt),
        lambda s: s,
        state,
    )
    idx = jnp.argsort(~nt)[:bucket]
    take = lambda v: v[idx] if getattr(v, "ndim", 0) else v  # noqa: E731
    sub = HSDState(*[take(v) for v in state])
    x2, y2, z2, tau2, kappa2, status2, _ = _finalize(
        ctx, b_s[idx], c_s[idx], sub, kset, opts.tol
    )
    resumed = nt[idx]

    def put(full, vals):
        mask = resumed.reshape(resumed.shape + (1,) * (vals.ndim - 1))
        return full.at[idx].set(jnp.where(mask, vals, full[idx]))

    x = put(state.x, x2)
    y = put(state.y, y2)
    z = put(state.z, z2)
    tau = put(state.tau, tau2)
    kappa = put(state.kappa, kappa2)
    status = put(state.status, status2)
    status = jnp.where(status == _RUNNING, jnp.int32(int(Status.ITERATION_LIMIT)), status)

    out_dtype = x.dtype
    tau_safe = jnp.maximum(tau, jnp.asarray(jnp.finfo(out_dtype).tiny, out_dtype))
    inv_tau = (1.0 / tau_safe)[..., None]
    x_hat = x * inv_tau
    y_hat = y * inv_tau
    z_hat = z * inv_tau
    if scaling is not None:
        sc = type(scaling)(*[v.astype(out_dtype) for v in scaling])
        x_hat, y_hat, z_hat = unscale_solution(x_hat, y_hat, z_hat, sc)
    objective = jnp.sum(c_orig.astype(out_dtype) * x_hat, axis=-1)
    return {
        "x": x_hat,
        "y": y_hat,
        "z": z_hat,
        "tau": tau,
        "kappa": kappa,
        "objective": objective,
        "status": status,
        "iterations": state.iterations,
    }


@partial(jax.jit, static_argnames=("opts", "kset", "reduce_any"))
def hsd_solve_batched(
    A,
    b,
    c,
    opts: SolverOptions = SolverOptions(),
    kset: KernelSet | None = None,
    reduce_any: Callable = jnp.any,
    warm=None,
):
    """Solve a batch of equality-form LPs ``min cᵀx, Ax = b, x ≥ 0``.

    Parameters
    ----------
    A : (m, n) shared or (B, m, n) per-instance constraint matrices.
    b : (B, m); c : (B, n).
    kset : the hot-path kernel set; ``None`` picks the backend's own
        (:func:`pycllp_jax.ops.gpu.select_kernels`).
    reduce_any : mask reduction for the loop predicate; the sharded path
        passes a collective (e.g. a psum of the local mask).
    warm : optional (x, y, z) starting point in UNSCALED equality
        coordinates, batched — typically the previous solve's solution on
        a nearby problem (the sequential re-solve pattern).  Scaled and
        interiorized internally (``SolverOptions.warm_lambda``); on
        correlated scenario sequences this typically halves the
        iteration count.  Overrides ``opts.init_point``.

    Returns a dict of arrays: x, y, z, tau, kappa, objective, status,
    iterations, rho_p, rho_d, rho_gap — all with leading batch axis.

    NOTE: traced under ``jax.default_matmul_precision("highest")`` — a
    GPU otherwise runs f32 matmuls in TF32 (about three decimal digits),
    which destroys the positive-definiteness of ADAᵀ and NaNs the
    Cholesky within a few IPM iterations.
    """
    _require_x64(opts)  # trace-time: silent f64→f32 truncation is an error
    with jax.default_matmul_precision("highest"):
        return _hsd_solve_batched_impl(
            A, b, c, opts, resolve_kernels(kset), reduce_any, warm
        )


def _hsd_solve_batched_impl(A, b, c, opts, kset, reduce_any, warm=None):
    dtype = jnp.dtype(opts.dtype) if opts.dtype else jnp.result_type(A, b, c)
    finish = opts.finish_dtype is not None and jnp.dtype(opts.finish_dtype) != dtype
    # With a finish phase configured, scaling and the phase-2 arrays are
    # built in the WIDE dtype from the original inputs; phase 1 sees the
    # rounded copies.  (Upcasting already-rounded phase-1 arrays would
    # make the polish phase faithfully solve the rounded problem and
    # freeze in an O(ε_narrow) objective error.)
    wide = jnp.dtype(opts.finish_dtype) if finish else dtype
    A_w = jnp.asarray(A, wide)
    b_w = jnp.asarray(b, wide)
    c_w = jnp.asarray(c, wide)

    if opts.scale:
        scaling = ruiz_equilibrate(A_w)
        A_sw, b_sw, c_sw = scale_problem(A_w, b_w, c_w, scaling)
    else:
        scaling = None
        A_sw, b_sw, c_sw = A_w, b_w, c_w
    A_s = A_sw.astype(dtype)
    b_s = b_sw.astype(dtype)
    c_s = c_sw.astype(dtype)

    ctx = kset.prepare(A_s)
    if warm is not None:
        # map the user's unscaled warm point into scaled coordinates
        # (inverse of unscale_solution: x̃ = x/s, ỹ = y/r, z̃ = z·s)
        xw, yw, zw = (jnp.asarray(v, dtype) for v in warm)
        if scaling is not None:
            xw = xw / scaling.col.astype(dtype)
            yw = yw / scaling.row.astype(dtype)
            zw = zw * scaling.col.astype(dtype)
        warm = (xw, yw, zw)
    state = _fresh_state(ctx, b_s, c_s, opts, kset, dtype, warm=warm)

    phase1_tol = max(opts.tol, opts.switch_tol) if finish else opts.tol
    state = _run_narrow_phase(
        ctx, b_s, c_s, state, opts, kset, dtype, phase1_tol, opts.maxiter, reduce_any
    )

    if finish:
        # continue the SAME interior state in the wider dtype: the bulk of
        # iterations ran on the fast dtype; the last few polish to full
        # tol — against the wide-dtype problem data, NOT an upcast of the
        # rounded phase-1 copies (see note at the top of this function).
        # A kernel set with a float32-only fast path substitutes its
        # float64 sibling here — see KernelSet.finish_kernels.
        fdtype = jnp.dtype(opts.finish_dtype)
        fkset = kset.finish_kernels()
        ckset = kset.crossover_kernels(opts.crossover_kset)
        A_f, b_f, c_f = A_sw, b_sw, c_sw
        state = _fold_to_best(ctx, b_s, c_s, state, kset)
        ctx = fkset.prepare(A_f)
        cctx = ctx if ckset is fkset else ckset.prepare(A_f)
        state = _cast_state(state, fdtype)
        state = state._replace(
            best_score=jnp.full_like(state.best_score, jnp.finfo(fdtype).max),
            best_k=jnp.full_like(state.best_k, state.k),
        )
        if opts.finish_mode == "crossover":
            # one wide basis solve finishes accepted lanes as OPTIMAL;
            # rejects are re-opened RUNNING for the IPM continuation below
            state = _crossover_state(cctx, b_f, c_f, state, ckset, opts, opts.tol)
        else:
            reopen = state.status != jnp.int32(int(Status.NUMERICAL))
            state = state._replace(status=jnp.where(reopen, _RUNNING, state.status))
        wopts = opts.replace(
            stall_patience=opts.finish_patience,
            stall_rtol=0.0,
            kkt_refine=opts.resolved_finish_kkt_refine(),
            kkt_refine_pred=None,  # the asymmetric predictor schedule is
            # a NARROW knob — wide directions refine symmetrically
            gondzio_correctors=opts.finish_gondzio,
        )
        state = _run_phase(
            ctx,
            b_f,
            c_f,
            state,
            wopts,
            fkset,
            fdtype,
            opts.finish_tol(),
            opts.maxiter + opts.finish_maxiter,
            reduce_any,
        )
        if opts.finish_mode == "crossover":
            # second attempt after the IPM sharpened the rejects — and a
            # rescue for lanes whose IPM stalled just above tol (vertex
            # acceptance tests the candidate, not the IPM's progress) —
            # in the float64 finish set, as the scan path's drain tiers
            # do: an IPM-OPTIMAL lane meets tol on the ρ indicators, not
            # on the objective, and its exact vertex replaces it.
            # reopen=False: reject statuses stay STALLED/NUMERICAL so
            # the restart fallback below still sees them.
            state = _fold_to_best(ctx, b_f, c_f, state, fkset)
            state = _crossover_state(
                ctx, b_f, c_f, state, fkset, _wide_cross_opts(opts), opts.tol,
                reopen=False,
            )
        if opts.finish_restart:
            # fresh-restart fallback for wide-stalled lanes (see
            # _restart_merge): whole-batch masked — finished lanes stay
            # frozen, STALLED/NUMERICAL ones rerun from a cold Mehrotra
            # start; still-RUNNING (budget-capped) lanes continue warm
            # with the restart round's extra budget (k resets to 0).
            retry = (state.status == jnp.int32(int(Status.STALLED))) | (
                state.status == jnp.int32(int(Status.NUMERICAL))
            )
            fresh = _fresh_state(
                ctx, b_f, c_f, opts.replace(init_point="mehrotra"), fkset, fdtype
            )
            state = _restart_merge(state, fresh, retry)
            state = _run_phase(
                ctx, b_f, c_f, state,
                wopts.replace(stall_patience=_NO_STALL), fkset, fdtype,
                opts.finish_tol(), opts.finish_maxiter + 10, reduce_any,
            )
        return _package(ctx, b_f, c_f, state, fkset, opts, scaling, c_w)

    return _package(ctx, b_s, c_s, state, kset, opts, scaling, c_w)


def hsd_solve(A, b, c, opts: SolverOptions = SolverOptions(), kset: KernelSet | None = None):
    """Unbatched convenience wrapper: solve one ``min cᵀx, Ax=b, x≥0``."""
    out = hsd_solve_batched(A, b[None], c[None], opts, kset)
    return {k: v[0] for k, v in out.items()}


def _sanitize_carry(x, y, z, ok, cap=1e6):
    """Per-lane warm-carry sanitizer: non-finite / not-ok lanes fall back
    to the blind start, finite ones are clipped (τ→0 lanes blow up)."""
    fin = (
        ok
        & jnp.all(jnp.isfinite(x), -1)
        & jnp.all(jnp.isfinite(y), -1)
        & jnp.all(jnp.isfinite(z), -1)
    )
    fn = fin[..., None]
    return (
        jnp.where(fn, jnp.clip(x, 0.0, cap), 1.0),
        jnp.where(fn, jnp.clip(y, -cap, cap), 0.0),
        jnp.where(fn, jnp.clip(z, 0.0, cap), 1.0),
    )


@partial(jax.jit, static_argnames=("opts", "kset", "keys", "warm_chain"))
def _hsd_scan_core(A, b3, c3, opts, kset, keys, warm_chain=False):
    if not warm_chain:
        def f(_, bc):
            out = hsd_solve_batched(A, bc[0], bc[1], opts, kset)
            return None, tuple(out[k] for k in keys)
        _, res = lax.scan(f, None, (b3, c3))
        return res

    # warm chain: chunk k+1's lane j starts from chunk k's lane-j solution
    # (the pywr init-once / re-solve pattern: the chunk axis is the time /
    # correlation axis, lanes are scenarios).  Chunk 0 runs from the blind
    # start (the warm path overrides opts.init_point).
    def f(carry, bc):
        out = hsd_solve_batched(A, bc[0], bc[1], opts, kset, warm=carry)
        ok = (out["status"] == jnp.int32(int(Status.OPTIMAL))) | (
            out["status"] == jnp.int32(int(Status.STALLED))
        ) | (out["status"] == jnp.int32(int(Status.ITERATION_LIMIT)))
        carry = _sanitize_carry(out["x"], out["y"], out["z"], ok)
        return carry, tuple(out[k] for k in keys)

    dtype = jnp.dtype(opts.dtype) if opts.dtype else jnp.result_type(A, b3, c3)
    B, m = b3.shape[1], b3.shape[2]
    n = c3.shape[2]
    carry0 = (
        jnp.ones((B, n), dtype),
        jnp.zeros((B, m), dtype),
        jnp.ones((B, n), dtype),
    )
    _, res = lax.scan(f, carry0, (b3, c3))
    return res


def _compact_resume(
    ctx, b_sf, c_sf, sflat, opts, kset, dtype, tol, maxiter, bucket, restart=False
):
    """Compact the still-RUNNING lanes on device and resume them warm.

    Stable argsort of the finished mask → gather the full interior state
    of up to ``bucket`` unfinished lanes into one dense batch, run the
    masked loop with the remaining budget, scatter the state back.  Lanes
    beyond ``bucket`` (overflow) keep their capped state.

    ``restart=True``: additionally gather STALLED/NUMERICAL lanes and
    rerun those from a COLD Mehrotra start (the wide-phase fresh-restart
    fallback — see _restart_merge); old best trackers are preserved so a
    failed restart cannot regress.  Still-RUNNING overflow lanes in the
    same bucket resume WARM — a cold f64 solve needs ~10 iterations
    where a warm continuation needs ~2-4, so restarting lanes that were
    merely queued behind the bucket limit wastes most of the budget.
    """
    unfinished = _retry_mask(sflat.status) if restart else (sflat.status == _RUNNING)
    idx = jnp.argsort(~unfinished)[:bucket]
    take = lambda v: v[idx] if getattr(v, "ndim", 0) else v  # noqa: E731
    state2 = HSDState(*[take(v) for v in sflat])
    resumed = unfinished[idx]
    if restart:
        fresh = _fresh_state(
            ctx, b_sf[idx], c_sf[idx], opts.replace(init_point="mehrotra"), kset, dtype
        )
        stuck = (sflat.status == jnp.int32(int(Status.STALLED))) | (
            sflat.status == jnp.int32(int(Status.NUMERICAL))
        )
        # _restart_merge re-opens the stuck lanes and zeroes every lane's
        # stall clock; RUNNING overflow lanes keep their warm state.
        state2 = _restart_merge(state2, fresh, stuck[idx])
        opts = opts.replace(stall_patience=_NO_STALL)  # see _NO_STALL note
    else:
        # restart the stall clock at the resume point: gathered lanes
        # carry a best_k from their own (earlier) clock, and the shared
        # scalar k may have jumped far past it — without the reset a
        # resumed lane can be declared STALLED before taking a single
        # step.
        state2 = state2._replace(best_k=jnp.full_like(state2.best_k, state2.k))
    state2 = _run_phase(
        ctx, b_sf[idx], c_sf[idx], state2, opts, kset, dtype, tol, maxiter, jnp.any
    )
    merged = {}
    for name, v in sflat._asdict().items():
        if not getattr(v, "ndim", 0):  # scalar loop counter
            merged[name] = jnp.maximum(v, getattr(state2, name))
            continue
        v2 = getattr(state2, name)
        mask = resumed.reshape(resumed.shape + (1,) * (v2.ndim - 1))
        merged[name] = v.at[idx].set(jnp.where(mask, v2, v[idx]))
    return HSDState(**merged)


def _narrow_opts_view(opts: SolverOptions, phase1_tol: float) -> SolverOptions:
    """Canonicalize finish-phase knobs out of the narrow program's static
    config (cache discipline, VERDICT r3 item 3: crossover/finish knob
    changes must not recompile the narrow stages).  ``finish_dtype`` is
    kept — it decides the dtype the scaling is computed in, and the wide
    stages must see the SAME scaled space (see the phase-data note in
    ``_hsd_solve_batched_impl``); the phase-1 tolerance is pre-folded
    into ``tol``.
    """
    return opts.replace(
        tol=phase1_tol,
        switch_tol=1e-3,
        finish_maxiter=20,
        finish_patience=8,
        finish_restart=True,
        finish_mode="ipm",
        finish_kkt_refine=None,
        finish_gondzio=0,
        crossover_refine=2,
        crossover_feas_tol=1e-9,
        crossover_kset="mixed1",
        crossover_repair=2,
    )


def _finish_opts_view(opts: SolverOptions) -> SolverOptions:
    """The twin of :func:`_narrow_opts_view`: canonicalize narrow-only
    knobs out of the finish program's static config, so narrow stall/KKT
    tuning never recompiles the wide stages.  ``kkt_refine`` (a narrow
    acceptance knob) is pre-resolved into ``finish_kkt_refine``."""
    return opts.replace(
        maxiter=40,
        stall_patience=12,
        stall_rtol=0.0,
        kkt_refine=0,
        finish_kkt_refine=opts.resolved_finish_kkt_refine(),
        # narrow-phase Gondzio correctors are a narrow acceptance knob
        # (like kkt_refine): the wide phases read finish_gondzio, so
        # canonicalize the narrow value out of the finish cache key
        gondzio_correctors=0,
        kkt_refine_pred=None,
        kkt_warmup=0,
        init_point="mehrotra",
        warm_start=False,
        warm_lambda=0.05,
        switch_tol=1e-3,
    )


def _scan_scaled_arrays(A, b3, c3, opts):
    """Shared preamble of the scan programs: wide + narrow scaled data.

    Deterministic from (A, b3, c3, opts), so the separately-jitted
    narrow and finish programs can each recompute it instead of shipping
    five big arrays between programs — recomputing the O(m·n) Ruiz
    scaling and the O(N·(m+n)) elementwise scale application costs ~ms,
    while keeping the inter-program interface to just the HSDState.
    """
    dtype = jnp.dtype(opts.dtype) if opts.dtype else jnp.result_type(A, b3, c3)
    finish = opts.finish_dtype is not None and jnp.dtype(opts.finish_dtype) != dtype
    wide = jnp.dtype(opts.finish_dtype) if finish else dtype
    K, chunk, m = b3.shape
    n = c3.shape[-1]
    N = K * chunk
    A_w = jnp.asarray(A, wide)
    c_flat_w = c3.reshape(N, n).astype(wide)
    b_flat_w = b3.reshape(N, m).astype(wide)
    if opts.scale:
        scaling = ruiz_equilibrate(A_w)
        A_sw, b_sfw, c_sfw = scale_problem(A_w, b_flat_w, c_flat_w, scaling)
    else:
        scaling = None
        A_sw, b_sfw, c_sfw = A_w, b_flat_w, c_flat_w
    return dtype, wide, scaling, A_sw, b_sfw, c_sfw, c_flat_w


@partial(jax.jit, static_argnames=("opts", "kset", "keys", "cap", "bucket", "warm_chain"))
def _hsd_scan_narrow_core(A, b3, c3, opts, kset, keys, cap, bucket, warm_chain=False):
    """Stages 1+2: capped narrow chunks (scan) + compacted warm resume.

    A chunk's masked while_loop runs to its SLOWEST lane, so chunk cost
    is the per-chunk max iteration count while useful work is the mean
    (observed 64×64 bench workload: mean ~11, chunk max ~21).  Stage 1
    therefore caps every chunk at ``cap`` iterations; the still-running
    lanes (~8% at cap 12) are compacted ON DEVICE — a stable argsort of
    the finished mask, gather of the full interior state — into one
    ``bucket``-wide batch that stage 2 resumes WARM (same iterates, best
    trackers, and stall clocks, loop counter continuing at ``cap``) with
    the full ``opts.maxiter`` budget.  Results scatter back over the
    stage-1 rows.

    With ``keys`` set (narrow-only config) the packaged outputs are
    returned directly — one device program, one dispatch, one pull.
    With ``keys=None`` the flat narrow HSDState is returned (device-
    resident) for the separately-jitted finish program: split, the two
    programs compile and cache independently, and a finish-knob change
    no longer recompiles the narrow stages.
    """
    with jax.default_matmul_precision("highest"):
        dtype, wide, scaling, A_sw, b_sfw, c_sfw, c_flat_w = _scan_scaled_arrays(
            A, b3, c3, opts
        )
        K, chunk, m = b3.shape
        n = c3.shape[-1]
        N = K * chunk
        A_s = A_sw.astype(dtype)
        b_sf = b_sfw.astype(dtype)
        c_sf = c_sfw.astype(dtype)
        ctx = kset.prepare(A_s)
        phase1_tol = opts.tol  # pre-folded by _narrow_opts_view / caller

        # ---- stage 1: scanned, capped narrow chunks ----
        if warm_chain:
            # chunk k+1 lane j warm-starts from chunk k lane j's (scaled)
            # interior point — the pywr re-solve pattern; mid-flight
            # (capped) points are still useful warm starts and are
            # interiorized by _fresh_state either way.
            def f(carry, bc):
                b_s, c_s = bc
                state = _fresh_state(ctx, b_s, c_s, opts, kset, dtype, warm=carry)
                state = _run_narrow_phase(
                    ctx, b_s, c_s, state, opts, kset, dtype, phase1_tol, cap, jnp.any
                )
                tau_safe = jnp.maximum(
                    state.tau, jnp.asarray(jnp.finfo(dtype).tiny, dtype)
                )
                carry = _sanitize_carry(
                    state.x / tau_safe[..., None],
                    state.y / tau_safe[..., None],
                    state.z / tau_safe[..., None],
                    state.status != jnp.int32(int(Status.NUMERICAL)),
                )
                return carry, state

            carry0 = (
                jnp.ones((chunk, n), dtype),
                jnp.zeros((chunk, m), dtype),
                jnp.ones((chunk, n), dtype),
            )
            _, states = lax.scan(
                f, carry0, (b_sf.reshape(K, chunk, m), c_sf.reshape(K, chunk, n))
            )
        else:
            def f(_, bc):
                b_s, c_s = bc
                state = _fresh_state(ctx, b_s, c_s, opts, kset, dtype)
                state = _run_narrow_phase(
                    ctx, b_s, c_s, state, opts, kset, dtype, phase1_tol, cap, jnp.any
                )
                return None, state

            _, states = lax.scan(
                f, None, (b_sf.reshape(K, chunk, m), c_sf.reshape(K, chunk, n))
            )
        # flatten per-lane state fields over (K, chunk) → (N,); the loop
        # counter k is per-chunk — any still-RUNNING lane's chunk ran to
        # exactly `cap` (an early-exiting chunk has no running lanes), so
        # stage 2 resumes every gathered lane at k = cap.
        sflat = HSDState(
            **{
                f_: (jnp.int32(cap) if f_ == "k" else v.reshape(N, *v.shape[2:]))
                for f_, v in states._asdict().items()
            }
        )

        # ---- stage 2: compact the narrow tail, resume with full budget ----
        sflat = _compact_resume(
            ctx, b_sf, c_sf, sflat, opts, kset, dtype, phase1_tol, opts.maxiter, bucket
        )

        if keys is None:
            return sflat
        outs = _package(
            ctx, b_sf, c_sf, sflat, kset, opts, scaling, c_flat_w.astype(dtype)
        )
        return tuple(outs[k] for k in keys)


@partial(
    jax.jit,
    static_argnames=("opts", "kset", "keys", "finish_cap", "finish_bucket", "rounds"),
)
def _hsd_scan_finish_core(
    A, b3, c3, sflat, opts, kset, keys, finish_cap, finish_bucket, rounds=4
):
    """Stages 3+4: the wide finish, as its OWN cached program.

    Takes the (device-resident) narrow HSDState from
    :func:`_hsd_scan_narrow_core` and polishes every lane to the full
    ``opts.tol`` contract in the wide dtype (the wide IPM aims at
    ``opts.finish_tol()``).  Stage 3 runs the vertex
    crossover (or a capped wide IPM) per scanned chunk; stage 4 drains
    the rejects through BOUNDED ``lax.while_loop`` rounds of gathered
    float64 work — each round is skipped at runtime when no lane is
    RUNNING, so a high-acceptance batch pays ~nothing here (VERDICT r3:
    the fixed-width stage-4 tail burned ~2 s on a ~dozen-lane tail), and
    a reject volume larger than ``finish_bucket`` is drained by repeats
    instead of silently overflowing to ITERATION_LIMIT (ADVICE r3).
    """
    with jax.default_matmul_precision("highest"):
        dtype, wide, scaling, A_sw, b_sfw, c_sfw, c_flat_w = _scan_scaled_arrays(
            A, b3, c3, opts
        )
        K, chunk, m = b3.shape
        n = c3.shape[-1]
        N = K * chunk
        A_s = A_sw.astype(dtype)
        b_sf = b_sfw.astype(dtype)
        c_sf = c_sfw.astype(dtype)
        ctx = kset.prepare(A_s)

        # ---- stage 3: wide finish over ALL lanes, scanned per chunk ----
        fkset = kset.finish_kernels()
        fctx = fkset.prepare(A_sw)
        ckset = kset.crossover_kernels(opts.crossover_kset)
        cctx = fctx if ckset is fkset else ckset.prepare(A_sw)
        sflat = _fold_to_best(ctx, b_sf, c_sf, sflat, kset)
        sflat = _cast_state(sflat, wide)
        sflat = sflat._replace(
            k=jnp.int32(0),
            best_score=jnp.full_like(sflat.best_score, jnp.finfo(wide).max),
            best_k=jnp.zeros_like(sflat.best_k),
        )
        wopts = opts.replace(
            stall_patience=opts.finish_patience,
            stall_rtol=0.0,
            kkt_refine=opts.resolved_finish_kkt_refine(),
            kkt_refine_pred=None,  # the asymmetric predictor schedule is
            # a NARROW knob — wide directions refine symmetrically
            gondzio_correctors=opts.finish_gondzio,
        )
        ftol = opts.finish_tol()  # where the wide IPM stops a lane

        # PYCLLP_FINISH_TRUNCATE=<stage>: return after the named stage
        # (diagnostic builds only — splits the finish program's cost
        # empirically, since no sync point can exist inside one jit).
        # Read at TRACE time and NOT part of the jit cache key: toggling
        # it between calls in one process silently returns the
        # previously compiled program — use a fresh process per setting.
        _trunc = os.environ.get("PYCLLP_FINISH_TRUNCATE", "")

        def _truncated(s):
            return _package_bucketed(
                fctx, b_sfw, c_sfw, s, fkset, opts, scaling, c_flat_w, finish_bucket
            )

        if _trunc == "pre":
            return tuple(_truncated(sflat)[k] for k in keys)

        if opts.finish_mode == "crossover":
            # ONE basis solve per lane: accepted lanes are OPTIMAL
            # outright; rejects re-open RUNNING and fall through to the
            # drain tiers.  Straight-line code — no wide while_loop over
            # ALL lanes — and with the default crossover_kset="mixed1"
            # the factors run in float32 (f64 residual refinement + f64
            # verification).  REPAIR here is 0: full-width repair pays
            # ~2 more candidate passes over every lane for the minority
            # that reject — tier 0 below applies ``opts.crossover_repair``
            # on the GATHERED rejects instead (same math, a fraction of
            # the width).
            per_lane = {
                f_: v.reshape(K, chunk, *v.shape[1:])
                for f_, v in sflat._asdict().items()
                if f_ != "k"
            }
            s3_opts = opts.replace(crossover_repair=0)

            def g(_, xs):
                st_fields, b_s, c_s = xs
                st = HSDState(k=jnp.int32(0), **st_fields)
                st = _crossover_state(cctx, b_s, c_s, st, ckset, s3_opts, opts.tol)
                return None, {f_: v for f_, v in st._asdict().items() if f_ != "k"}

            base_k = 0
        else:
            reopen = sflat.status != jnp.int32(int(Status.NUMERICAL))
            sflat = sflat._replace(
                status=jnp.where(reopen, _RUNNING, sflat.status)
            )
            per_lane = {
                f_: v.reshape(K, chunk, *v.shape[1:])
                for f_, v in sflat._asdict().items()
                if f_ != "k"
            }

            def g(_, xs):
                st_fields, b_s, c_s = xs
                st = HSDState(k=jnp.int32(0), **st_fields)
                st = _run_phase(
                    fctx, b_s, c_s, st, wopts, fkset, wide, ftol, finish_cap, jnp.any
                )
                return None, {f_: v for f_, v in st._asdict().items() if f_ != "k"}

            base_k = finish_cap

        _, fdict = lax.scan(
            g,
            None,
            (per_lane, b_sfw.reshape(K, chunk, m), c_sfw.reshape(K, chunk, n)),
        )
        sflat = HSDState(
            k=jnp.int32(base_k),
            **{f_: v.reshape(N, *v.shape[2:]) for f_, v in fdict.items()},
        )
        if _trunc == "stage3":
            return tuple(_truncated(sflat)[k] for k in keys)

        if opts.finish_mode == "crossover":
            # ---- stage 4 (crossover): bounded draining rounds. ----
            # Stage 3's mixed-engine rejects split into two anatomies:
            # (a) RIGHT basis, ill-conditioned — the f32-factor IR
            # missed the 1e-9 verification; a float64 basis solve accepts
            # these instantly; (b) wrong basis beyond sign repair —
            # these need genuinely wide IPM steps.  Tier 1 repeats
            # [gather ``finish_bucket`` rejects → float64 crossover →
            # short wide IPM (``finish_cap``) → re-cross → scatter] as a
            # ``lax.while_loop`` over rounds: each repeat drains up to a
            # bucket of lanes, the loop SKIPS entirely when nothing is
            # RUNNING (a fixed-width round pays its full bucket width
            # even for a ~dozen-lane tail), and a reject volume beyond
            # one bucket is drained by repeats instead of silently
            # keeping capped narrow answers (ITERATION_LIMIT lanes).  Tier 2 does the same
            # with the DEEP treatment (IPM to ``finish_maxiter``, cold
            # restart of stuck lanes, rescue crossover) at bucket/8
            # width — vertex acceptance tests the CANDIDATE's residuals,
            # not the IPM's progress, so a lane stalled just above tol
            # still answers with the exact vertex.
            def scatter(s, st2, idx, resumed):
                merged = {}
                for name, v in s._asdict().items():
                    if not getattr(v, "ndim", 0):
                        merged[name] = jnp.maximum(v, getattr(st2, name))
                        continue
                    v2 = getattr(st2, name)
                    mask = resumed.reshape(resumed.shape + (1,) * (v2.ndim - 1))
                    merged[name] = v.at[idx].set(jnp.where(mask, v2, v[idx]))
                return HSDState(**merged)

            def drain(s0, width, n_rounds, body):
                """Bounded rounds of [gather → body → scatter] over the
                RUNNING lanes, each lane treated AT MOST ONCE: a lane
                that exhausts a full tier treatment and is still
                RUNNING is masked out of later rounds (without the mask
                a couple of stubborn lanes re-trigger the full-bucket
                float64 round up to ``n_rounds`` times).  Rounds therefore only
                repeat to drain reject VOLUME beyond one bucket; the
                loop is skipped outright when nothing is RUNNING.
                """
                def untreated(s, treated):
                    return (s.status == _RUNNING) & ~treated

                def round_body(carry):
                    s, treated, r = carry
                    unfinished = untreated(s, treated)
                    idx = jnp.argsort(~unfinished)[:width]
                    take = lambda v: v[idx] if getattr(v, "ndim", 0) else v  # noqa: E731
                    st2 = HSDState(*[take(v) for v in s])
                    resumed = unfinished[idx]
                    st2 = body(b_sfw[idx], c_sfw[idx], st2)
                    treated = treated.at[idx].set(treated[idx] | resumed)
                    return scatter(s, st2, idx, resumed), treated, r + 1

                def round_cond(carry):
                    s, treated, r = carry
                    return (r < n_rounds) & jnp.any(untreated(s, treated))

                s, _, _ = lax.while_loop(
                    round_cond,
                    round_body,
                    (s0, jnp.zeros(s0.status.shape, jnp.bool_), jnp.int32(0)),
                )
                return s

            # tier 0: basis-repair rounds on the gathered rejects, mixed
            # engine — the typical reject is a basis off by 1-2 indices,
            # fixed by sign-guided re-selection with NO wide IPM; at 8x
            # the float64-tier bucket this swallows the typical
            # post-stage-3 reject volume in one round of f32-factor
            # solves.
            def tier0(b2, c2, st2):
                return _crossover_state(cctx, b2, c2, st2, ckset, opts, opts.tol)

            if opts.crossover_repair:  # without repair a re-cross of the
                # unchanged state would re-fail identically — skip the tier
                # width: decoupled from the float64 bucket — the mixed
                # repair rounds are f32-factor cheap, and one 16K round
                # swallows the typical post-stage-3 reject volume where
                # 8×1024 would pay a second gather+round
                sflat = drain(sflat, min(max(16384, 8 * finish_bucket), N), rounds, tier0)
            if _trunc == "tier0":
                return tuple(_truncated(sflat)[k] for k in keys)

            topts = _wide_cross_opts(opts)

            # tier 1: short wide IPM → float64 cross.  With the
            # Jacobi-scaled mixed engine upstream, the precision-limited
            # rejects are absorbed by tier 0, so what reaches this tier
            # is wrong-basis work whose point needs a few genuine
            # float64 IPM steps to re-center before the basis is
            # identifiable; the repair rounds live in the post-IPM
            # cross.
            def tier1(b2, c2, st2):
                st2 = st2._replace(best_k=jnp.full_like(st2.best_k, st2.k))
                st2 = _run_phase(
                    fctx, b2, c2, st2, wopts, fkset, wide, ftol,
                    st2.k + finish_cap, jnp.any,
                )
                st2 = _fold_to_best(fctx, b2, c2, st2, fkset)
                return _crossover_state(fctx, b2, c2, st2, fkset, topts, opts.tol)

            sflat = drain(sflat, finish_bucket, rounds, tier1)
            if _trunc == "tier1":
                return tuple(_truncated(sflat)[k] for k in keys)

            # tier 2: narrow, deep — IPM to budget, restart, rescue.
            # reopen=False in the rescue keeps rejects STALLED, so the
            # drain loop's RUNNING test only re-fires for lanes that
            # never fit a bucket — each lane gets the deep treatment
            # exactly once.
            def tier2(b2, c2, st2):
                st2 = st2._replace(best_k=jnp.full_like(st2.best_k, st2.k))
                st2 = _run_phase(
                    fctx, b2, c2, st2, wopts, fkset, wide, ftol,
                    st2.k + opts.finish_maxiter, jnp.any,
                )
                if opts.finish_restart:
                    stuck = (st2.status == jnp.int32(int(Status.STALLED))) | (
                        st2.status == jnp.int32(int(Status.NUMERICAL))
                    )
                    fresh = _fresh_state(
                        fctx, b2, c2, opts.replace(init_point="mehrotra"), fkset, wide
                    )
                    st2 = _restart_merge(st2, fresh, stuck)
                    st2 = _run_phase(
                        fctx, b2, c2, st2,
                        wopts.replace(stall_patience=_NO_STALL), fkset, wide,
                        ftol, opts.finish_maxiter + 10, jnp.any,
                    )
                st2 = _fold_to_best(fctx, b2, c2, st2, fkset)
                return _crossover_state(
                    fctx, b2, c2, st2, fkset, topts, opts.tol, reopen=False
                )

            # width 256, decoupled from the float64 bucket: tier 2's
            # two deep while_loops pay their width EVERY masked
            # iteration, and the population that reaches it is tiny —
            # narrow-but-more-rounds is the right trade (the rounds loop
            # is skipped once nothing is RUNNING).
            sflat = drain(sflat, 256, rounds, tier2)
        else:
            # ---- stage 4 (ipm): compact the wide finish tail, resume
            # (TWO rounds: a tail larger than the bucket overflows round
            # 1 — those lanes stay RUNNING and round 2 gathers them;
            # measured 2,913 overflow lanes answering at 1e-4 with a
            # single round, 2026-08-19).  Each round is cond-gated: when
            # no lane needs it, the gathered Mehrotra fresh-start and
            # argsort/gather work is skipped at runtime. ----
            # the shared scalar loop-clock k advances across rounds, so
            # each round's budget must extend past the previous round's
            # endpoint.  Round 2 doubles as the fresh-restart fallback:
            # it regathers STALLED/NUMERICAL lanes and reruns them from
            # a cold Mehrotra start (see _restart_merge /
            # _compact_resume(restart=True)).  ``finish_bucket`` sizes
            # these rounds independently of the narrow stage-2 bucket.
            sflat = lax.cond(
                jnp.any(sflat.status == _RUNNING),
                lambda s: _compact_resume(
                    fctx, b_sfw, c_sfw, s, wopts, fkset, wide, ftol,
                    base_k + opts.finish_maxiter, finish_bucket,
                ),
                lambda s: s,
                sflat,
            )
            sflat = lax.cond(
                jnp.any(_retry_mask(sflat.status)),
                lambda s: _compact_resume(
                    fctx, b_sfw, c_sfw, s, wopts, fkset, wide, ftol,
                    base_k + 2 * opts.finish_maxiter, finish_bucket,
                    restart=opts.finish_restart,
                ),
                lambda s: s,
                sflat,
            )
        if any(k in ("rho_p", "rho_d", "rho_gap") for k in keys):
            outs = _package(fctx, b_sfw, c_sfw, sflat, fkset, opts, scaling, c_flat_w)
        else:
            # ρ diagnostics not requested → finalize/classify only the
            # gathered non-terminal remainder (see _package_bucketed)
            outs = _package_bucketed(
                fctx, b_sfw, c_sfw, sflat, fkset, opts, scaling, c_flat_w,
                finish_bucket,
            )
        return tuple(outs[k] for k in keys)


def hsd_solve_scan(
    A,
    b,
    c,
    opts: SolverOptions = SolverOptions(),
    kset: KernelSet | None = None,
    *,
    chunk: int = 16384,
    keys: tuple = ("x", "y", "z", "objective", "status", "iterations"),
    compact_cap: int | None = None,
    compact_bucket: int = 8192,
    finish_cap: int = 6,
    finish_bucket: int | None = None,
    warm_chain: bool = False,
):
    """Chunked batched solve as one/two device programs (``lax.scan`` over chunks).

    The throughput shape for large scenario sweeps: scenario data is
    staged onto the device once, the scan runs every chunk's masked
    ``while_loop`` back-to-back on device, and the host is involved
    exactly twice (one dispatch, one result pull) — or three times with
    a finish phase, whose stages run as a SECOND cached program over the
    device-resident narrow state (split, the programs compile and cache
    independently and a finish-knob change no longer recompiles the
    narrow stages).  Each chunk also exits its while_loop at its OWN
    slowest lane rather than the global maximum, which is why this
    beats a single fused mega-batch as well.

    ``b``/``c`` are (N, m)/(N, n) with shared 2-D ``A`` (per-chunk A is
    not supported here — use :func:`hsd_solve_batched` per chunk).  N is
    padded up to a chunk multiple (repeating the last row) and trimmed
    on return.  Returns the ``keys`` fields only (flat (N, ...) device
    arrays); fewer keys = smaller scan carries and result pulls.

    ``compact_cap``: enable the fused two-phase sweep — cap every chunk
    at this iteration count, then compact the still-running lanes on
    device into one ``compact_bucket``-wide batch that resumes warm with
    the full budget (see :func:`_hsd_scan_narrow_core`).  On the 64×64
    bench workload ``compact_cap=12`` cuts total device iterations ~35%
    (chunk cost = slowest lane; p50 is 11 but chunk max is ~21).  Lanes
    beyond ``compact_bucket`` (remnant overflow) keep their capped
    phase-1 answer (status ITERATION_LIMIT).

    With ``opts.finish_dtype`` set, the compact sweep appends a wide
    polish of EVERY lane to the full ``opts.tol`` (``finish_cap``-capped
    scanned chunks + compacted tail resumes) — the configuration that
    meets the 1e-6 contract at batched-f32 throughput.  With
    ``opts.finish_mode="crossover"`` the per-chunk wide IPM scan is
    replaced by ONE wide basis solve per lane (vertex crossover,
    :mod:`pycllp_jax.solvers.crossover`); only the rejected lanes run
    the wide IPM, sized by ``finish_bucket`` (default =
    ``compact_bucket``; crossover rejects are few, and a masked wide
    while_loop's cost scales with its width, so a smaller bucket pays).

    ``warm_chain``: chunk k+1's lane j warm-starts from chunk k's lane-j
    solution (sanitized per lane), for correlated scenario streams where
    the chunk axis is the time/correlation axis — the upstream pywr
    init-once/re-solve pattern at scale.  Chunk 0 runs from the blind
    start (overrides ``opts.init_point`` on the warm path).
    """
    if getattr(A, "ndim", 2) != 2:
        raise ValueError("hsd_solve_scan requires shared 2-D A")
    _require_x64(opts)
    kset = resolve_kernels(kset)
    b = jnp.asarray(b)
    c = jnp.asarray(c)
    N = b.shape[0]
    chunk = min(chunk, N)
    pad = (-N) % chunk
    if pad:
        b = jnp.concatenate([b, jnp.broadcast_to(b[-1:], (pad, b.shape[1]))], 0)
        c = jnp.concatenate([c, jnp.broadcast_to(c[-1:], (pad, c.shape[1]))], 0)
    K = b.shape[0] // chunk
    b3 = b.reshape(K, chunk, -1)
    c3 = c.reshape(K, chunk, -1)
    if compact_cap is not None:
        dtype = jnp.dtype(opts.dtype) if opts.dtype else jnp.result_type(A, b, c)
        finish = opts.finish_dtype is not None and jnp.dtype(opts.finish_dtype) != dtype
        if not finish:
            res = _hsd_scan_narrow_core(
                A, b3, c3, opts, kset, tuple(keys),
                int(compact_cap), min(int(compact_bucket), K * chunk),
                bool(warm_chain),
            )
            return {k: v[:N] for k, v in zip(keys, res)}
        phase1_tol = max(opts.tol, opts.switch_tol)
        sync = os.environ.get("PYCLLP_SCAN_SYNC")  # stage-split timing
        t0 = time.time() if sync else None
        sflat = _hsd_scan_narrow_core(
            A, b3, c3, _narrow_opts_view(opts, phase1_tol), kset, None,
            int(compact_cap), min(int(compact_bucket), K * chunk),
            bool(warm_chain),
        )
        if sync:
            # numpy-side count: a jnp reduction here would be a FRESH
            # tiny program whose compile lands in the timed window
            running = int((np.asarray(sflat.status) == _RUNNING).sum())
            print(
                f"[scan] narrow stage: {time.time() - t0:.3f}s "
                f"(sync incl. status pull; {running} lanes still RUNNING)",
                file=sys.stderr, flush=True,
            )
            t0 = time.time()
        fb = min(int(finish_bucket or compact_bucket), K * chunk)
        res = _hsd_scan_finish_core(
            A, b3, c3, sflat, _finish_opts_view(opts), kset, tuple(keys),
            int(finish_cap), fb,
            # enough drain rounds to empty the WHOLE batch through the
            # bucket: the rounds-loop is skipped at runtime once no lane
            # is RUNNING, so a generous static bound costs nothing on
            # the typical (high-acceptance) run but makes a small bucket
            # overflow-proof on hard workloads
            rounds=max(4, -(-(K * chunk) // fb)),
        )
        if sync:
            np.asarray(res[-1])
            print(
                f"[scan] finish stage: {time.time() - t0:.3f}s (sync)",
                file=sys.stderr, flush=True,
            )
        return {k: v[:N] for k, v in zip(keys, res)}
    res = _hsd_scan_core(A, b3, c3, opts, kset, tuple(keys), bool(warm_chain))
    return {
        k: v.reshape(K * chunk, *v.shape[2:])[:N] for k, v in zip(keys, res)
    }
