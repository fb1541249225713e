"""Solver options, status codes, and the solution container.

Upstream parity: pycllp passes tolerance/maxiter as solver kwargs and
returns per-instance status/convergence flags (reference mount empty this
build — SURVEY.md §0; capability per BASELINE.json north_star).  Here the
options are a frozen, hashable dataclass passed as a *static* jit argument
(SURVEY.md §5 "config/flag system" disposition).
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Any

import numpy as np

__all__ = ["SolverOptions", "Status", "Solution"]


class Status(enum.IntEnum):
    """Per-instance termination status.

    Matches the classic interior-point status convention (optimal /
    iteration limit / primal infeasible / dual infeasible a.k.a.
    unbounded / numerical breakdown).  ``RUNNING`` is internal.
    """

    RUNNING = -1
    OPTIMAL = 0
    ITERATION_LIMIT = 1
    INFEASIBLE = 2
    UNBOUNDED = 3
    NUMERICAL = 4
    STALLED = 5  # no indicator progress for `stall_patience` iterations;
    # the reported point is the best iterate reached (f32 floor behaviour)


@dataclass(frozen=True)
class SolverOptions:
    """Hashable solver configuration (static under ``jax.jit``).

    Attributes
    ----------
    tol:
        Relative optimality tolerance (primal/dual residual and gap);
        the upstream default optimality tolerance is 1e-6 relative gap.
    maxiter:
        Iteration cap for the IPM loop (static loop bound under jit).
    alpha0:
        Fraction-to-the-boundary step damping (Mehrotra's 0.99995).
    mehrotra:
        Use predictor-corrector (True) or single centering step (False).
    gamma:
        Fixed centering parameter when ``mehrotra=False``.
    reg_eps:
        Relative diagonal (Tikhonov) regularization added to the normal
        matrix before Cholesky, scaled by its max diagonal.
    refine_steps:
        Iterative-refinement sweeps on each normal-equations solve
        (cheap insurance for the f32 path).
    scale:
        Apply Ruiz equilibration to A (and fold into b, c) before
        solving; strongly recommended for f32.
    dtype:
        Compute dtype ("float32"/"float64"/None=follow inputs).
    kkt_refine:
        Iterative-refinement passes on the full 5-block Newton system
        (each pass = one extra normal-equations solve); tightens f32
        directions beyond what `refine_steps` (normal-equations-level
        refinement) can.
    stall_patience:
        Iterations without best-score progress before a lane is frozen
        as STALLED (its best iterate is returned).
    finish_dtype:
        If set (e.g. "float64" with dtype="float32"), continue the same
        interior state in this dtype for a final polish phase — bulk
        iterations run fast/narrow, the last few run wide to full tol.
    finish_maxiter:
        Extra iteration budget for the finish phase.
    switch_tol:
        Phase-1 tolerance when a finish phase is configured.
    """

    tol: float = 1e-6
    maxiter: int = 100
    alpha0: float = 0.99995
    mehrotra: bool = True
    gamma: float = 0.1
    reg_eps: float | None = None  # None → dtype-dependent default
    refine_steps: int | None = None  # None → dtype-dependent default
    scale: bool = True
    dtype: str | None = None
    kkt_refine: int = 0
    kkt_refine_pred: int | None = None  # KKT refinement sweeps for the
    # PREDICTOR direction only (None = kkt_refine).  The predictor is
    # never taken: it gauges μ_aff (→ centering weight γ) and feeds the
    # corrector's second-order products, so it tolerates fewer sweeps
    # than the corrector — the direction that IS taken and whose quality
    # names the crossover basis.  kkt_refine=3 with kkt_refine_pred=1
    # drops 2 of 6 refinement solves per iteration.
    kkt_warmup: int = 0  # narrow iterations run at kkt_refine=0 before
    # the configured kkt_refine engages.  KKT-level refinement is an
    # END-QUALITY knob (it tightens the f32 direction near the indicator
    # floor, which is what names the crossover basis); the first few
    # iterations are far from the floor and gain nothing from it, so a
    # warmup below the observed minimum lane iteration count (bench
    # 64x64: min 7) buys back ~kkt_refine extra solves x warmup
    # iterations of narrow time with an unchanged terminal iterate on
    # every lane.  0 = refine from the first iteration.
    gondzio_correctors: int = 0  # extra centrality-corrector solves per
    # iteration (Gondzio); reduces iteration count for ~1 solve each
    stall_patience: int = 12
    stall_rtol: float = 0.0  # minimum RELATIVE best-score improvement that
    # counts as progress for the stall clock (0 = any improvement).  At the
    # f32 indicator floor, scores jitter by tiny amounts; requiring e.g. a
    # 5% drop stops those jitters from resetting the patience window, so
    # stalled lanes freeze sooner.  Best-iterate tracking itself still
    # accepts ANY improvement — this only affects the stall clock.
    finish_dtype: str | None = None
    finish_maxiter: int = 20
    switch_tol: float = 1e-3
    finish_patience: int = 8  # stall clock for the wide finish phase
    # (stall_rtol is reset to 0 there): the narrow phase's aggressive
    # clock is tuned for the f32 indicator floor; wide solves make real
    # progress every iteration and must not be frozen early.
    finish_restart: bool = True  # fresh-restart fallback: lanes the wide
    # phase leaves STALLED/NUMERICAL/unfinished are rerun once from a
    # cold Mehrotra start in the wide dtype (old best iterate kept as
    # insurance).  Phase 1's f32 floor can leave a lane too far off the
    # central path for the wide continuation to recentre within its
    # stall patience — measured: 9/256 lanes stalled at ~3e-3 objective
    # error through every finish kernel set, while cold f64 solves of
    # the same instances converge in <=10 iterations.
    finish_mode: str = "ipm"  # how the wide finish reaches full tol:
    #   "ipm"        continue the interior iteration in the wide dtype
    #                (3-8 wide factorizations/lane)
    #   "crossover"  ONE wide basis solve per lane — identify the optimal
    #                basis from the narrow point, recover the exact vertex
    #                from the basis normal equations (solvers/crossover.py),
    #                verify per lane; rejected lanes fall back to the wide
    #                IPM continuation.  Cheaper when the narrow phase
    #                identifies most bases (nondegenerate workloads).
    crossover_refine: int = 2  # refinement sweeps on the basis solves
    # (true-residual outer refinement in solvers/crossover.py)
    crossover_feas_tol: float = 1e-9  # per-lane vertex verification bound
    crossover_kset: str = "mixed1"  # kernel set for the crossover basis
    # SOLVES (KernelSet.crossover_kernels; sets without a float32 fast
    # path, such as ReferenceKernels, always use their float64 finish set):
    #   "mixed1" f32 factor + f64 iterative refinement (1 inner sweep;
    #            the crossover's own crossover_refine sweeps sit on top).
    #            Valid HERE even though mixed is a documented negative
    #            result for the IPM finish: the basis system's diagonal
    #            is the 0/1 indicator, so cond(M) = κ(B)² stays moderate
    #            where the late-IPM D = x/z spans ~1/μ² and defeats IR.
    #            An ill-conditioned basis simply fails the (always-f64)
    #            verification and falls back to the wide IPM.
    #   "mixed"  same with 3 inner sweeps.
    #   "wide"   use the float64 finish kernel set itself.
    crossover_repair: int = 2  # batched basis-repair rounds on rejected
    # lanes: flip sign-violated indices (basic xv<0 out, nonbasic zv<0
    # in), re-solve, re-verify — each round one cheap mixed factor+solve
    # (rejects are typically off by 1-2 basis indices).  On the registry
    # batched path the rounds run at full width inside the crossover; on
    # the scan path they run in the GATHERED tier-0 drain.
    finish_kkt_refine: int | None = None  # kkt_refine for the WIDE phases;
    # None inherits ``kkt_refine`` (a config that sets kkt_refine keeps
    # its KKT safety net in the finish too).  The bench sets this to 0
    # explicitly: KKT-level refinement is f32 insurance (it raises the
    # narrow point's crossover acceptance); genuine-f64 directions don't
    # need it, and each pass costs an extra wide solve per iteration
    # plus compile payload.
    finish_gondzio: int = 0  # Gondzio centrality correctors in the wide
    # phase only.  Wide factorizations are the expensive resource; extra
    # corrector SOLVES through the same factorization cut the wide
    # iteration count ~30-40%.
    log_every: int = 0  # emit structured per-iteration metrics every k
    # iterations (0 = off); see pycllp_jax.utils.logging
    init_point: str = "ones"  # "ones" (blind HSD start) or "mehrotra"
    # (least-squares start: one extra factorization, typically saves
    # 2-4 IPM iterations)
    warm_start: bool = False  # registry-level: reuse the previous solve's
    # solution as the starting point for the next solve on the same
    # structure (the upstream init-once / re-solve sweep pattern).  See
    # ``hsd_solve_batched(..., warm=)`` for the underlying mechanism.
    # On the chunked scan path this enables chunk-to-chunk warm chaining
    # instead (``hsd_solve_scan(..., warm_chain=True)``).
    warm_lambda: float = 0.05  # interiorization blend for a warm start:
    # the supplied point is pulled this fraction of the way toward the
    # well-centered blind start (x=z=1 on scaled data), then floored
    # strictly positive — a boundary point (an optimal solution has many
    # zeros) would stall the very first ratio test otherwise.

    def replace(self, **kw) -> "SolverOptions":
        return dataclasses.replace(self, **kw)

    def resolved_reg_eps(self, dtype) -> float:
        if self.reg_eps is not None:
            return self.reg_eps
        return 2e-6 if np.dtype(dtype) == np.float32 else 1e-12

    def finish_tol(self) -> float:
        """ρ bound at which the wide finish's IPM stops a lane.

        ρ ≤ tol bounds the scaled residuals, not the objective error: the
        primal and dual residuals enter the objective as well, and on the
        64×64 bench workload lanes stopped at ρ ≈ 0.65·tol were up to
        1.15·tol off scipy.  The wide IPM therefore runs each lane a
        decade under ``tol``.  A lane whose budget ends first answers its
        best iterate, OPTIMAL if that meets ``tol``; a crossover vertex is
        exact up to its verified residuals and is accepted at ``tol``.
        """
        return 0.1 * self.tol

    def resolved_finish_kkt_refine(self) -> int:
        return self.kkt_refine if self.finish_kkt_refine is None else self.finish_kkt_refine

    def resolved_kkt_refine_pred(self) -> int:
        return self.kkt_refine if self.kkt_refine_pred is None else self.kkt_refine_pred

    def resolved_refine_steps(self, dtype) -> int:
        if self.refine_steps is not None:
            return self.refine_steps
        return 1 if np.dtype(dtype) == np.float32 else 0


@dataclass
class Solution:
    """Batched solve result.

    All arrays carry the instance batch axis first (absent for an
    unbatched solve).  ``x``/``y``/``z`` are in the coordinates of the
    form that was solved; container-level ``solve()`` wrappers map them
    back to the user's form.
    """

    x: Any  # primal (..., n)
    y: Any  # row duals (..., m)
    z: Any  # reduced costs (..., n)
    objective: Any  # (...,)
    status: Any  # (...,) int32 Status codes
    iterations: Any  # (...,)
    # convergence diagnostics at exit
    rho_p: Any = None
    rho_d: Any = None
    rho_gap: Any = None

    @property
    def converged(self):
        return np.asarray(self.status) == int(Status.OPTIMAL)

    def __repr__(self) -> str:
        st = np.atleast_1d(np.asarray(self.status))
        it = np.atleast_1d(np.asarray(self.iterations))
        n_opt = int((st == int(Status.OPTIMAL)).sum())
        return (
            f"Solution(n={st.size}, optimal={n_opt}, "
            f"iters[min/mean/max]={it.min()}/{it.mean():.1f}/{it.max()})"
        )
