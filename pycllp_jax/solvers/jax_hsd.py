"""Registry-facing JAX HSD solver.

Upstream parity: the NumPy ``hsd`` solver class and the OpenCL-batched
``clhsd`` class collapse onto the same jitted core here; the
:class:`KernelSet` that feeds the hot path is the backend's own
(:func:`pycllp_jax.ops.gpu.select_kernels`).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from pycllp_jax.solvers.base import BaseSolver, register_solver
from pycllp_jax.solvers.hsd import hsd_solve_batched, hsd_solve_scan
from pycllp_jax.solvers.options import Solution, Status

__all__ = ["JaxHSDSolver"]

_SOLUTION_KEYS = (
    "x", "y", "z", "objective", "status", "iterations",
    "rho_p", "rho_d", "rho_gap",
)

# statuses whose terminal point is a useful warm start for the next solve
_WARMABLE = (int(Status.OPTIMAL), int(Status.STALLED), int(Status.ITERATION_LIMIT))


def _sanitized_warm(out: dict, prev):
    """Per-lane warm cache update that cannot poison later solves.

    INFEASIBLE/UNBOUNDED lanes have τ→0 (x/τ blows up) and NUMERICAL
    lanes carry NaN; caching those verbatim would propagate through
    every subsequent warm solve on that lane.  Such lanes keep the
    previous warm point if one exists, else fall back to the blind
    start (x=z=1, y=0) — always per lane.
    """
    keep = np.isin(out["status"], _WARMABLE)
    keep = keep & np.isfinite(out["x"]).all(-1)
    keep = keep & np.isfinite(out["y"]).all(-1) & np.isfinite(out["z"]).all(-1)
    if prev is None:
        prev = (np.ones_like(out["x"]), np.zeros_like(out["y"]), np.ones_like(out["z"]))
    kn = keep[:, None]
    return (
        np.where(kn, out["x"], prev[0]),
        np.where(kn, out["y"], prev[1]),
        np.where(kn, out["z"], prev[2]),
    )


@register_solver
class JaxHSDSolver(BaseSolver):
    """Batched HSD IPM on the backend's kernel set.

    The whole solve is one jitted ``lax.while_loop``; per-instance
    convergence is a masked status vector (pycllp's per-work-item flags,
    re-platformed — SURVEY.md §2.3).

    Large-batch throughput knobs (shared 2-D A only; see
    :func:`~pycllp_jax.solvers.hsd.hsd_solve_scan`):

    chunk : solve the batch as a ``lax.scan`` of chunk-wide masked
        while_loops in ONE device program.
    compact_cap / compact_bucket : fused cap/compact/warm-resume sweep —
        cap every chunk, finish the slow tail compacted into one bucket.
    """

    name = "hsd"
    aliases = ("jax_hsd", "hsd_pallas", "clhsd", "pallas")

    def __init__(
        self,
        options=None,
        *,
        chunk: int | None = None,
        compact_cap: int | None = None,
        compact_bucket: int = 8192,
        **opt_kwargs,
    ):
        super().__init__(options, **opt_kwargs)
        self.chunk = chunk
        self.compact_cap = compact_cap
        self.compact_bucket = compact_bucket
        self._warm = None  # (x, y, z) equality-coordinate solution of the
        # previous solve, kept when options.warm_start is set

    def _init_impl(self, eq) -> None:
        self._warm = None  # new structure invalidates the warm point

    def _solve_impl(self, A, b, c) -> Solution:
        scan = (self.chunk or self.compact_cap) and getattr(A, "ndim", 2) == 2
        if scan:
            # warm_start on the scan path means chunk-to-chunk warm
            # chaining WITHIN the batch (the chunk axis is the stream's
            # correlation axis); solve-to-solve caching stays off — each
            # scan solve is its own chain.
            out = hsd_solve_scan(
                jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                self.options,
                chunk=self.chunk or b.shape[0], keys=_SOLUTION_KEYS,
                compact_cap=self.compact_cap,
                compact_bucket=self.compact_bucket,
                warm_chain=self.options.warm_start,
            )
        else:
            warm = None
            if self.options.warm_start and self._warm is not None:
                shapes_match = (
                    self._warm[0].shape == (b.shape[0], c.shape[-1])
                    and self._warm[1].shape == b.shape
                )
                warm = self._warm if shapes_match else None
            out = hsd_solve_batched(
                jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                self.options, warm=warm,
            )
        out = {k: np.asarray(out[k]) for k in _SOLUTION_KEYS}
        if self.options.warm_start and not scan:
            self._warm = _sanitized_warm(out, self._warm)
        return Solution(**out)
