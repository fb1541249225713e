"""Column-sharded HSD for LPs larger than one chip — batched.

The "model parallel" slot of SURVEY.md §2.3 (no upstream analogue):
variables (columns of A) partition across the mesh; each device holds
``A_loc (m, n/P)`` and the ``x/z/c`` shards, while ``y/b`` and the m×m
normal matrix are replicated.  A leading batch axis carries small
batches of big LPs (shared A, per-instance b/c — the big-LP sibling of
the scenario batch).  Per iteration:

* ``M_b = Σ_p A_p D_{b,p} A_pᵀ`` — local Gram matrices assembled with
  ONE ``psum`` over the model axis (the Schur-complement-style
  reduction of BASELINE.json's north star: the only collective in the
  hot loop, riding ICI);
* batched Cholesky + triangular solves run on the replicated (B, m, m)
  M on every device (m ≪ n: redundant compute is cheaper than sharding
  an m×m factor);
* matvecs ``A@x`` psum; ``Aᵀy`` is purely local; dot products and the
  ratio test reduce with psum/pmin.

Termination quantities are replicated by construction, so the
``while_loop`` predicate (any lane RUNNING) is consistent across
devices with no extra collective.  Per-lane status masking mirrors
:mod:`pycllp_jax.solvers.hsd`.

Accuracy: the batched-path playbook is ported 1:1 into the sharded loop — Ruiz
equilibration of A (host-side, folded into b/c), Mehrotra's
least-squares starting point (one extra d=1 factorization), per-lane
best-iterate tracking with a stall clock, iterative refinement of each
normal-equations solve in f32, and an optional WIDE FINISH phase
(``opts.finish_dtype``): the same sharded loop continues the interior
state in the wide dtype toward ``opts.finish_tol()``.  The wide factor is
the replicated/row-sharded Cholesky in native f64 (the big-LP batch is
small, so a few wide O(m³/P) factorizations per lane are affordable).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from pycllp_jax.solvers.options import SolverOptions, Status
from pycllp_jax.utils.scaling import ruiz_equilibrate, scale_problem

__all__ = ["column_sharded_hsd_solve", "model_mesh"]

_RUNNING = np.int32(int(Status.RUNNING))  # numpy scalar: no device init at import


def model_mesh(n_devices: int | None = None, axis: str = "model") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


class ColState(NamedTuple):
    x: jnp.ndarray  # (B, n_loc)
    y: jnp.ndarray  # (B, m) replicated
    z: jnp.ndarray  # (B, n_loc)
    tau: jnp.ndarray  # (B,)
    kappa: jnp.ndarray  # (B,)
    status: jnp.ndarray  # (B,) int32
    iterations: jnp.ndarray  # (B,) int32
    k: jnp.ndarray  # () int32
    rp0: jnp.ndarray  # (B,) relative-indicator normalizers
    rd0: jnp.ndarray
    rg0: jnp.ndarray
    mu0: jnp.ndarray
    best_x: jnp.ndarray  # best-iterate insurance (f32 floor behaviour)
    best_y: jnp.ndarray
    best_z: jnp.ndarray
    best_tau: jnp.ndarray
    best_kappa: jnp.ndarray
    best_score: jnp.ndarray
    best_k: jnp.ndarray


def column_sharded_hsd_solve(
    A,
    b,
    c,
    opts: SolverOptions = SolverOptions(),
    mesh: Mesh | None = None,
    factor: str = "replicated",
):
    """Solve a (batch of) equality-form LP(s) ``min cᵀx, Ax=b, x≥0``
    with columns sharded over the mesh.  ``n`` must divide by the mesh
    size (the registry ``schur`` solver pads automatically).

    ``b``/``c`` may be ``(m,)``/``(n,)`` (single LP) or ``(B, m)``/
    ``(B, n)``.  Returns dict(x, z, y, objective, status, iterations)
    with x/z column-sharded and the batch axis matching the input.

    ``opts.finish_dtype`` enables the wide finish phase: phase 1 runs in
    ``opts.dtype`` to ``opts.switch_tol``, then the SAME sharded state
    continues in the wide dtype toward ``opts.finish_tol()`` with
    ``opts.finish_maxiter`` extra budget (matching the batched path's
    two-phase contract).

    ``factor`` selects the normal-matrix strategy:

    * ``"replicated"`` (default) — psum-assemble the full (B, m, m) M
      and Cholesky it redundantly on every device.  Right for m ≪ n:
      redundant O(m³) compute is cheaper than distributing it.
    * ``"sharded"`` — M's ROWS partition over the mesh and a
      distributed blocked Cholesky factors it in place
      (:mod:`pycllp_jax.parallel.dchol`): per-device memory O(B·m²/P),
      trailing-update FLOPs sharded P ways, one all-gather per panel.
      The path for big-m LPs whose factor exceeds one chip.  Requires
      ``m`` divisible by the mesh size.
    """
    if mesh is None:
        mesh = model_mesh()
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    m, n = A.shape
    if n % n_dev:
        raise ValueError(f"n={n} not divisible by mesh size {n_dev}")
    if factor not in ("replicated", "sharded"):
        raise ValueError(f"unknown factor strategy {factor!r}")
    if factor == "sharded" and m % n_dev:
        raise ValueError(f"factor='sharded' needs m={m} divisible by {n_dev}")

    dtype = jnp.dtype(opts.dtype) if opts.dtype else jnp.result_type(A, b, c)
    finish = opts.finish_dtype is not None and jnp.dtype(opts.finish_dtype) != dtype
    wide = jnp.dtype(opts.finish_dtype) if finish else dtype
    # scaling + wide-phase data derive from the ORIGINAL inputs in the
    # WIDE dtype; phase 1 sees rounded copies (same phase-data rationale
    # as solvers/hsd._hsd_solve_batched_impl)
    A_w = jnp.asarray(A, wide)
    b_w = jnp.asarray(b, wide)
    c_w = jnp.asarray(c, wide)
    squeeze = b_w.ndim == 1
    if squeeze:
        b_w, c_w = b_w[None], c_w[None]
    if opts.scale:
        scaling = ruiz_equilibrate(A_w)
        A_sw, b_sw, c_sw = scale_problem(A_w, b_w, c_w, scaling)
        col_scale = scaling.col.astype(wide)
        row_scale = scaling.row.astype(wide)
    else:
        A_sw, b_sw, c_sw = A_w, b_w, c_w
        col_scale = jnp.ones((n,), wide)
        row_scale = jnp.ones((m,), wide)
    n_total = n
    phase1_tol = max(opts.tol, opts.switch_tol) if finish else opts.tol

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, axis), P(), P(None, axis), P(axis), P()),
        out_specs={
            "x": P(None, axis),
            "z": P(None, axis),
            "y": P(),
            "objective": P(),
            "status": P(),
            "iterations": P(),
        },
        check_vma=False,
    )
    def solve(A_lw, b_rw, c_lw, col_l, row_r):
        B = b_rw.shape[0]

        def psum(v):
            return lax.psum(v, axis)

        def pmin(v):
            return lax.pmin(v, axis)

        def make_ops(A_l, b_r, c_l):
            """Sharded linear ops + factor/solve closures for one dtype."""
            dt = A_l.dtype
            reg_eps = opts.resolved_reg_eps(dt)
            refine = opts.resolved_refine_steps(dt)

            def mv(x_l):  # A @ x → (B, m) replicated
                return psum(jnp.einsum("bn,mn->bm", x_l, A_l))

            def rmv(y_r):  # Aᵀ y → local (B, n_loc) shard
                return jnp.einsum("bm,mn->bn", y_r, A_l)

            def pdot(u_l, v_l):  # (B,) replicated
                return psum(jnp.sum(u_l * v_l, axis=-1))

            def dnorm(v_l):  # (B,) 2-norm of column-sharded vectors
                return jnp.sqrt(psum(jnp.sum(v_l * v_l, axis=-1)))

            def make_factor(dinv):
                """Factor M = A·diag(dinv)·Aᵀ + δI → (msolve, reg)."""
                if factor == "sharded":
                    from pycllp_jax.parallel.dchol import (
                        rowshard_cholesky,
                        rowshard_cholesky_solve,
                    )

                    my = lax.axis_index(axis)
                    mb = m // n_dev
                    cols = jnp.arange(m)
                    emask = (
                        cols[None, :] == (my * mb + jnp.arange(mb))[:, None]
                    ).astype(dt)
                    Mw = jnp.zeros((B, mb, m), dt)
                    for i in range(n_dev):
                        rows = slice(i * mb, (i + 1) * mb)
                        Gi = psum(jnp.einsum("in,bn,jn->bij", A_l[rows], dinv, A_l))
                        Mw = jnp.where(my == i, Gi, Mw)
                    dloc = jnp.einsum("bam,am->ba", Mw, emask)
                    dmax = lax.pmax(jnp.max(dloc, axis=-1), axis)
                    reg = reg_eps * dmax
                    Mw = Mw + reg[:, None, None] * emask[None]
                    Lw, kks = rowshard_cholesky(Mw, axis, n_dev)

                    def fsolve(r):
                        return rowshard_cholesky_solve(Lw, kks, r, axis, n_dev)

                else:
                    M = psum(jnp.einsum("in,bn,jn->bij", A_l, dinv, A_l))
                    diag_max = jnp.max(jnp.diagonal(M, axis1=-2, axis2=-1), axis=-1)
                    reg = reg_eps * diag_max
                    M = M + reg[:, None, None] * jnp.eye(m, dtype=dt)
                    L = lax.linalg.cholesky(M)

                    def fsolve(r):
                        t = lax.linalg.triangular_solve(
                            L, r[..., None], left_side=True, lower=True
                        )
                        return lax.linalg.triangular_solve(
                            L, t, left_side=True, lower=True, transpose_a=True
                        )[..., 0]

                def matvec_M(v):
                    return mv(dinv * rmv(v)) + reg[:, None] * v

                def msolve(r):
                    v = fsolve(r)
                    for _ in range(refine):  # f32 insurance (dtype-resolved)
                        v = v + fsolve(r - matvec_M(v))
                    return v

                return msolve

            return dict(
                mv=mv, rmv=rmv, pdot=pdot, dnorm=dnorm, make_factor=make_factor,
                reg_eps=reg_eps,
            )

        def residuals(ops, b_r, c_l, s):
            rp = b_r * s.tau[:, None] - ops["mv"](s.x)
            rd = c_l * s.tau[:, None] - ops["rmv"](s.y) - s.z
            rg = ops["pdot"](c_l, s.x) - jnp.sum(b_r * s.y, axis=-1) + s.kappa
            mu = (ops["pdot"](s.x, s.z) + s.tau * s.kappa) / (n_total + 1)
            return rp, rd, rg, mu

        def indicators(ops, b_r, s, rp, rd, rg, mu):
            by = jnp.sum(b_r * s.y, axis=-1)
            rho_p = jnp.linalg.norm(rp, axis=-1) / s.rp0
            rho_d = ops["dnorm"](rd) / s.rd0
            rho_g = jnp.abs(rg) / s.rg0
            rho_A = jnp.abs(rg - s.kappa) / (s.tau + jnp.abs(by))
            return by, rho_p, rho_d, rho_g, rho_A

        def classify(ops, b_r, s, rp, rd, rg, mu, tol):
            by, rho_p, rho_d, rho_g, rho_A = indicators(ops, b_r, s, rp, rd, rg, mu)
            optimal = (rho_p <= tol) & (rho_d <= tol) & (rho_A <= tol)
            inf1 = (
                (rho_p <= tol)
                & (rho_d <= tol)
                & (rho_g <= tol)
                & (s.tau <= tol * jnp.maximum(1.0, s.kappa))
            )
            inf2 = (mu / s.mu0 <= tol) & (s.tau <= tol * jnp.minimum(1.0, s.kappa))
            infs = jnp.where(
                by > tol,
                jnp.int32(int(Status.INFEASIBLE)),
                jnp.int32(int(Status.UNBOUNDED)),
            )
            running = s.status == _RUNNING
            return jnp.where(
                running & optimal,
                jnp.int32(int(Status.OPTIMAL)),
                jnp.where(running & (inf1 | inf2), infs, s.status),
            )

        def score_of(ops, b_r, c_l, s):
            rp, rd, rg, mu = residuals(ops, b_r, c_l, s)
            _, rho_p, rho_d, _, rho_A = indicators(ops, b_r, s, rp, rd, rg, mu)
            return jnp.maximum(jnp.maximum(rho_p, rho_d), rho_A)

        def max_step(dt, x, dx, z, dz, tau, dtau, kappa, dkappa):
            big = jnp.asarray(jnp.finfo(dt).max, dt)

            def ratios(v, dv):
                r = jnp.where(dv < 0, v / jnp.where(dv < 0, -dv, 1.0), big)
                return (
                    jnp.min(r, axis=-1)
                    if r.shape[-1]
                    else jnp.full(r.shape[:-1], big, dt)
                )

            a = pmin(jnp.minimum(ratios(x, dx), ratios(z, dz)))
            a = jnp.minimum(
                a, jnp.where(dtau < 0, tau / jnp.where(dtau < 0, -dtau, 1.0), big)
            )
            a = jnp.minimum(
                a,
                jnp.where(dkappa < 0, kappa / jnp.where(dkappa < 0, -dkappa, 1.0), big),
            )
            return a

        def mehrotra_start(ops, b_r, c_l):
            """Least-squares start (sharded twin of hsd._mehrotra_start)."""
            msolve0 = ops["make_factor"](jnp.ones_like(c_l))
            x_hat = ops["rmv"](msolve0(b_r))
            y_hat = msolve0(ops["mv"](c_l))
            z_hat = c_l - ops["rmv"](y_hat)
            dt = c_l.dtype
            gmin = lambda v: pmin(jnp.min(v, axis=-1))  # noqa: E731
            dx = jnp.maximum(-1.5 * gmin(x_hat), 0.0)[:, None]
            dz = jnp.maximum(-1.5 * gmin(z_hat), 0.0)[:, None]
            xs = x_hat + dx
            zs = z_hat + dz
            dot = ops["pdot"](xs, zs)
            sum_z = jnp.maximum(psum(jnp.sum(zs, axis=-1)), 1e-8)
            sum_x = jnp.maximum(psum(jnp.sum(xs, axis=-1)), 1e-8)
            x0 = jnp.maximum(xs + (0.5 * dot / sum_z)[:, None], jnp.asarray(1e-4, dt))
            z0 = jnp.maximum(zs + (0.5 * dot / sum_x)[:, None], jnp.asarray(1e-4, dt))
            return x0, y_hat, z0

        def fresh_state(ops, b_r, c_l):
            dt = c_l.dtype
            if opts.init_point == "mehrotra":
                x0, y0, z0 = mehrotra_start(ops, b_r, c_l)
            else:
                x0 = jnp.ones_like(c_l)
                y0 = jnp.zeros_like(b_r)
                z0 = jnp.ones_like(c_l)
            ones = jnp.ones((B,), dt)
            big = jnp.asarray(jnp.finfo(dt).max, dt)
            s = ColState(
                x0, y0, z0, ones, ones,
                jnp.full((B,), _RUNNING, jnp.int32),
                jnp.zeros((B,), jnp.int32), jnp.int32(0),
                ones, ones, ones, ones,
                x0, y0, z0, ones, ones,
                jnp.full((B,), big, dt), jnp.zeros((B,), jnp.int32),
            )
            rp, rd, rg, mu = residuals(ops, b_r, c_l, s)
            return s._replace(
                rp0=jnp.maximum(1.0, jnp.linalg.norm(rp, axis=-1)),
                rd0=jnp.maximum(1.0, ops["dnorm"](rd)),
                rg0=jnp.maximum(1.0, jnp.abs(rg)),
                mu0=mu,
            )

        def run_phase(ops, b_r, c_l, s0, tol, maxiter, patience):
            dt = c_l.dtype

            def cond(s):
                return (s.k < maxiter) & jnp.any(s.status == _RUNNING)

            def body(s):
                rp, rd, rg, mu = residuals(ops, b_r, c_l, s)
                status = classify(ops, b_r, s, rp, rd, rg, mu, tol)
                running = status == _RUNNING

                # best-iterate bookkeeping + stall clock (hsd twin)
                score = score_of(ops, b_r, c_l, s)
                was_running = (s.status == _RUNNING) & jnp.isfinite(score)
                improved = was_running & (score < s.best_score)
                imn = improved[:, None]
                best_x = jnp.where(imn, s.x, s.best_x)
                best_y = jnp.where(imn, s.y, s.best_y)
                best_z = jnp.where(imn, s.z, s.best_z)
                best_tau = jnp.where(improved, s.tau, s.best_tau)
                best_kappa = jnp.where(improved, s.kappa, s.best_kappa)
                best_score = jnp.where(improved, score, s.best_score)
                if opts.stall_rtol:
                    material = was_running & (
                        score < s.best_score * (1.0 - opts.stall_rtol)
                    )
                else:
                    material = improved
                best_k = jnp.where(material, s.k, s.best_k)
                stalled = running & (s.k - best_k >= patience)
                status = jnp.where(stalled, jnp.int32(int(Status.STALLED)), status)

                # capped at 1e30 (see the twin note in
                # solvers/hsd._make_step_fn)
                dinv = jnp.minimum(s.x / s.z, jnp.asarray(1e30, dt))  # (B, n_loc)
                msolve = ops["make_factor"](dinv)
                mv, rmv, pdot = ops["mv"], ops["rmv"], ops["pdot"]

                def sym_solve(r1_l, r2_r):
                    v = msolve(r2_r + mv(dinv * r1_l))
                    u = dinv * (rmv(v) - r1_l)
                    return u, v

                p, q = sym_solve(c_l, b_r)
                denom = s.kappa / s.tau + jnp.sum(b_r * q, axis=-1) - pdot(c_l, p)

                def newton(eta, gmu, dxa, dza, dta, dka):
                    rxs = gmu[:, None] - s.x * s.z - dxa * dza
                    rtk = gmu - s.tau * s.kappa - dta * dka
                    r1 = eta[:, None] * rd - rxs / s.x
                    u, v = sym_solve(r1, eta[:, None] * rp)
                    dtau = (
                        eta * rg + rtk / s.tau
                        - (jnp.sum(b_r * v, axis=-1) - pdot(c_l, u))
                    ) / denom
                    dx = u + p * dtau[:, None]
                    dy = v + q * dtau[:, None]
                    dz = (rxs - s.z * dx) / s.x
                    dkappa = (rtk - s.kappa * dtau) / s.tau
                    return dx, dy, dz, dtau, dkappa

                zero_l = jnp.zeros_like(s.x)
                zero = jnp.zeros((B,), dt)
                one = jnp.ones((B,), dt)
                dxa, dya, dza, dta, dka = newton(one, zero, zero_l, zero_l, zero, zero)
                a_aff = jnp.minimum(
                    1.0, max_step(dt, s.x, dxa, s.z, dza, s.tau, dta, s.kappa, dka)
                )
                aan = a_aff[:, None]
                mu_aff = (
                    pdot(s.x + aan * dxa, s.z + aan * dza)
                    + (s.tau + a_aff * dta) * (s.kappa + a_aff * dka)
                ) / (n_total + 1)
                gamma = jnp.clip((mu_aff / mu) ** 3, 0.0, 1.0)
                dx, dy, dz, dtau, dkappa = newton(
                    1.0 - gamma, gamma * mu, dxa, dza, dta, dka
                )
                alpha = jnp.minimum(
                    1.0,
                    opts.alpha0
                    * max_step(dt, s.x, dx, s.z, dz, s.tau, dtau, s.kappa, dkappa),
                )

                an = alpha[:, None]
                xn = s.x + an * dx
                yn = s.y + an * dy
                zn = s.z + an * dz
                taun = s.tau + alpha * dtau
                kappan = s.kappa + alpha * dkappa
                finite = (
                    psum(
                        jnp.sum(~jnp.isfinite(xn), axis=-1)
                        + jnp.sum(~jnp.isfinite(zn), axis=-1)
                    )
                    == 0
                ) & jnp.isfinite(taun) & (taun > 0)
                status = jnp.where(
                    (status == _RUNNING) & ~finite,
                    jnp.int32(int(Status.NUMERICAL)),
                    status,
                )
                take = status == _RUNNING
                tn = take[:, None]
                return s._replace(
                    x=jnp.where(tn, xn, s.x),
                    y=jnp.where(tn, yn, s.y),
                    z=jnp.where(tn, zn, s.z),
                    tau=jnp.where(take, taun, s.tau),
                    kappa=jnp.where(take, kappan, s.kappa),
                    status=status,
                    iterations=jnp.where(take, s.iterations + 1, s.iterations),
                    k=s.k + 1,
                    best_x=best_x,
                    best_y=best_y,
                    best_z=best_z,
                    best_tau=best_tau,
                    best_kappa=best_kappa,
                    best_score=best_score,
                    best_k=best_k,
                )

            return lax.while_loop(cond, body, s0)

        def fold_to_best(ops, b_r, c_l, s):
            score = score_of(ops, b_r, c_l, s)
            sb = ColState(
                s.best_x, s.best_y, s.best_z, s.best_tau, s.best_kappa,
                s.status, s.iterations, s.k, s.rp0, s.rd0, s.rg0, s.mu0,
                s.best_x, s.best_y, s.best_z, s.best_tau, s.best_kappa,
                s.best_score, s.best_k,
            )
            score_b = score_of(ops, b_r, c_l, sb)
            use_best = ~jnp.isfinite(score) | (jnp.isfinite(score_b) & (score_b < score))
            ubn = use_best[:, None]
            return s._replace(
                x=jnp.where(ubn, s.best_x, s.x),
                y=jnp.where(ubn, s.best_y, s.y),
                z=jnp.where(ubn, s.best_z, s.z),
                tau=jnp.where(use_best, s.best_tau, s.tau),
                kappa=jnp.where(use_best, s.best_kappa, s.kappa),
            )

        # ---- phase 1 (narrow) ----
        A_l1 = A_lw.astype(dtype)
        b_r1 = b_rw.astype(dtype)
        c_l1 = c_lw.astype(dtype)
        ops1 = make_ops(A_l1, b_r1, c_l1)
        s = fresh_state(ops1, b_r1, c_l1)
        s = run_phase(ops1, b_r1, c_l1, s, phase1_tol, opts.maxiter, opts.stall_patience)

        if finish:
            # ---- phase 2 (wide): continue the SAME sharded state ----
            s = fold_to_best(ops1, b_r1, c_l1, s)
            cast = lambda v: (  # noqa: E731
                v.astype(wide) if jnp.issubdtype(v.dtype, jnp.floating) else v
            )
            s = ColState(*[cast(v) for v in s])
            ops2 = make_ops(A_lw, b_rw, c_lw)
            reopen = s.status != jnp.int32(int(Status.NUMERICAL))
            s = s._replace(
                status=jnp.where(reopen, _RUNNING, s.status),
                best_score=jnp.full_like(s.best_score, jnp.finfo(wide).max),
                best_k=jnp.full_like(s.best_k, s.k),
            )
            s = run_phase(
                ops2, b_rw, c_lw, s, opts.finish_tol(),
                opts.maxiter + opts.finish_maxiter, opts.finish_patience,
            )
            ops_f, b_rf, c_lf = ops2, b_rw, c_lw
        else:
            ops_f, b_rf, c_lf = ops1, b_r1, c_l1

        # ---- finalize on the best iterate ----
        s = fold_to_best(ops_f, b_rf, c_lf, s)
        rp, rd, rg, mu = residuals(ops_f, b_rf, c_lf, s)
        stalled = s.status == jnp.int32(int(Status.STALLED))
        numerical = s.status == jnp.int32(int(Status.NUMERICAL))
        status_open = jnp.where(stalled | numerical, _RUNNING, s.status)
        status = classify(
            ops_f, b_rf, s._replace(status=status_open), rp, rd, rg, mu, opts.tol
        )
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
        out_dt = s.x.dtype
        tau_safe = jnp.maximum(s.tau, jnp.asarray(jnp.finfo(out_dt).tiny, out_dt))
        # unscale (x̂ = s_col·x̃, ŷ = s_row·ỹ, ẑ = z̃/s_col) and report the
        # objective against the ORIGINAL c
        x_hat = s.x / tau_safe[:, None] * col_l[None, :].astype(out_dt)
        y_hat = s.y / tau_safe[:, None] * row_r[None, :].astype(out_dt)
        z_hat = s.z / tau_safe[:, None] / col_l[None, :].astype(out_dt)
        objective = psum(jnp.sum(c_lw.astype(out_dt) * (s.x / tau_safe[:, None]), -1))
        return {
            "x": x_hat,
            "z": z_hat,
            "y": y_hat,
            "objective": objective,
            "status": status,
            "iterations": s.iterations,
        }

    with jax.default_matmul_precision("highest"):
        out = solve(A_sw, b_sw, c_sw, col_scale, row_scale)
    if squeeze:
        out = {k_: v[0] for k_, v in out.items()}
    return out
