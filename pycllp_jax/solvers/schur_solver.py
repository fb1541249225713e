"""Registry-facing column-sharded (big-LP) solver.

The model-parallel capability of SURVEY.md §2.3 promoted to a
first-class registry backend (VERDICT r1 item 4): one LP — or a small
batch of them — whose variable dimension is sharded over the device
mesh, normal matrix psum-assembled per iteration
(:func:`pycllp_jax.parallel.column_sharded_hsd_solve`).

Columns are zero-padded up to mesh divisibility with unit objective
coefficients (a zero column contributes nothing to ADAᵀ and its
variable sits at 0 with reduced cost 1 — invisible to the solution);
the padding is stripped from the returned x/z.
"""

from __future__ import annotations

import numpy as np

from pycllp_jax.parallel.schur import column_sharded_hsd_solve, model_mesh
from pycllp_jax.solvers.base import BaseSolver, register_solver
from pycllp_jax.solvers.options import Solution

__all__ = ["SchurSolver"]


@register_solver
class SchurSolver(BaseSolver):
    """Column-sharded HSD over a ``("model",)`` mesh.

    For LPs whose n (or the per-iteration O(m²·n) Gram work) exceeds one
    chip: each device owns n/P columns, the m×m normal matrix is
    psum-assembled and factored replicated.  Use the scenario-batched
    solver (``hsd``) when the batch, not the LP, is big.
    """

    name = "schur"
    aliases = ("column_sharded", "big_lp")

    def __init__(self, options=None, *, mesh=None, **opt_kwargs):
        super().__init__(options, **opt_kwargs)
        self.mesh = mesh

    def _solve_impl(self, A, b, c) -> Solution:
        if getattr(A, "ndim", 2) != 2:
            raise ValueError(
                "schur solver shards the columns of ONE shared A; "
                "per-instance (3-D) A is not supported"
            )
        mesh = self.mesh if self.mesh is not None else model_mesh()
        n_dev = mesh.devices.size
        m, n = A.shape
        pad = (-n) % n_dev
        if pad:
            A = np.concatenate([A, np.zeros((m, pad), A.dtype)], axis=1)
            c = np.concatenate([c, np.ones((c.shape[0], pad), c.dtype)], axis=1)
        out = column_sharded_hsd_solve(A, b, c, self.options, mesh=mesh)
        x = np.asarray(out["x"])[:, :n]
        z = np.asarray(out["z"])[:, :n]
        return Solution(
            x=x,
            y=np.asarray(out["y"]),
            z=z,
            objective=np.asarray(out["objective"]),
            status=np.asarray(out["status"]),
            iterations=np.asarray(out["iterations"]),
        )
