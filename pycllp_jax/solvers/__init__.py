"""Solver layer: registry + backends (upstream parity: ``pycllp/solvers/``)."""

from pycllp_jax.solvers.options import Solution, SolverOptions, Status
from pycllp_jax.solvers.base import (
    BaseSolver,
    available_solvers,
    get_solver,
    register_solver,
    solver_registry,
)

# importing backend modules registers them
from pycllp_jax.solvers import jax_hsd as _jax_hsd  # noqa: F401
from pycllp_jax.solvers import scipy_solver as _scipy_solver  # noqa: F401
from pycllp_jax.solvers import cpp as _cpp  # noqa: F401
from pycllp_jax.solvers import dense_path as _dense_path  # noqa: F401
from pycllp_jax.solvers import schur_solver as _schur_solver  # noqa: F401

__all__ = [
    "BaseSolver",
    "Solution",
    "SolverOptions",
    "Status",
    "available_solvers",
    "get_solver",
    "register_solver",
    "solver_registry",
]
