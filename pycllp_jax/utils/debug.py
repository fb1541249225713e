"""Numerical debug mode (SURVEY.md §5 sanitizer disposition).

Instances are independent lanes, so there is nothing to race; the
numerical hazard is the factorization going non-PSD / non-finite in f32.
This module provides a checked solve wrapper that localises WHERE a
NUMERICAL lane first broke: it re-runs the solve with per-iteration
finite-ness probes and reports the first offending iteration and the
state statistics at that point.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from pycllp_jax.solvers.hsd import hsd_solve_batched
from pycllp_jax.solvers.options import SolverOptions, Status

__all__ = ["diagnose_numerical_lanes", "checked_solve"]


def checked_solve(A, b, c, opts: SolverOptions = SolverOptions(), kset=None):
    """Solve; if any lane ends NUMERICAL, attach a diagnosis report."""
    out = hsd_solve_batched(A, b, c, opts, kset)
    status = np.asarray(out["status"])
    bad = np.flatnonzero(status == int(Status.NUMERICAL))
    report = diagnose_numerical_lanes(A, b, c, bad, opts) if bad.size else []
    return out, report


def diagnose_numerical_lanes(A, b, c, lanes, opts: SolverOptions, max_lanes: int = 4):
    """Re-solve failing lanes one iteration at a time (f64 shadow run)
    and report where f32 and f64 trajectories diverge.

    Returns a list of dict reports, one per diagnosed lane.
    """
    reports = []
    A = np.asarray(A)
    for lane in list(lanes)[:max_lanes]:
        bi = np.asarray(b)[lane : lane + 1]
        ci = np.asarray(c)[lane : lane + 1]
        Ai = A[lane] if A.ndim == 3 else A
        rep = {"lane": int(lane)}
        # f64 shadow: does the instance solve cleanly in high precision?
        shadow = hsd_solve_batched(
            Ai.astype(np.float64),
            bi.astype(np.float64),
            ci.astype(np.float64),
            opts.replace(dtype="float64", finish_dtype=None),
        )
        rep["f64_status"] = int(np.asarray(shadow["status"])[0])
        rep["f64_iterations"] = int(np.asarray(shadow["iterations"])[0])
        # find the first f32 iteration that breaks by bisecting maxiter
        lo, hi = 1, opts.maxiter
        while lo < hi:
            mid = (lo + hi) // 2
            probe = hsd_solve_batched(
                Ai.astype(np.float32),
                bi.astype(np.float32),
                ci.astype(np.float32),
                opts.replace(dtype="float32", finish_dtype=None, maxiter=mid),
            )
            if int(np.asarray(probe["status"])[0]) == int(Status.NUMERICAL):
                hi = mid
            else:
                lo = mid + 1
        rep["first_bad_f32_iteration"] = int(lo)
        # conditioning proxy at the pre-breakdown iterate
        probe = hsd_solve_batched(
            Ai.astype(np.float32),
            bi.astype(np.float32),
            ci.astype(np.float32),
            opts.replace(dtype="float32", finish_dtype=None, maxiter=max(1, lo - 1)),
        )
        x = np.asarray(probe["x"])[0]
        z = np.asarray(probe["z"])[0]
        with np.errstate(divide="ignore", invalid="ignore"):
            dspread = np.nanmax(x / np.maximum(z, 1e-30)) / max(
                np.nanmin(x / np.maximum(z, 1e-30)), 1e-30
            )
        rep["scaling_spread_before_breakdown"] = float(dspread)
        rep["hint"] = (
            "instance solves in f64 — raise reg_eps, enable kkt_refine, or "
            "use finish_dtype='float64'"
            if rep["f64_status"] == int(Status.OPTIMAL)
            else "instance is numerically hard even in f64 — check problem scaling"
        )
        reports.append(rep)
    return reports
