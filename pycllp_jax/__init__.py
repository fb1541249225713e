"""pycllp_jax — a batched linear-programming framework for accelerators.

A from-scratch re-design (NOT a port) of the capabilities of
``jetuk/pycllp``: batched interior-point LP solving where thousands of
independent LP instances (scenarios) are solved simultaneously on one
device (an NVIDIA GPU) or a mesh of them.

Capability parity map (upstream paths are named for orientation only; the
reference mount was empty this build — see SURVEY.md §0 — so no line
citations are possible):

=====================  =======================================  =====================
Capability             upstream (pycllp)                         here
=====================  =======================================  =====================
Problem containers     ``pycllp/lp.py`` GeneralLP/StandardLP    :mod:`pycllp_jax.models`
Solver registry        ``pycllp/solvers/__init__.py``           :mod:`pycllp_jax.solvers`
Pure reference HSD     ``pycllp/solvers/hsd.py`` (NumPy)        :mod:`pycllp_jax.solvers.hsd`
Native backend         vendored Vanderbei C + Cython            :mod:`pycllp_jax.solvers.cpp` (C++/ctypes)
Device batch backend   OpenCL work-item-per-LP kernels          :mod:`pycllp_jax.ops` XLA + Pallas Triton
Scenario batching      leading n-problems axis on b/c           batched pytrees + vmap/mask
Multi-device           (absent upstream)                        :mod:`pycllp_jax.parallel`
LP file IO             vendored ``iolp.c`` MPS reader           :mod:`pycllp_jax.io.mps`
=====================  =======================================  =====================
"""

__version__ = "0.1.0"

from pycllp_jax.models import GeneralLP, StandardLP, EqualityLP, SparseMatrixBuilder
from pycllp_jax.solvers import (
    BaseSolver,
    Solution,
    SolverOptions,
    Status,
    available_solvers,
    get_solver,
    register_solver,
    solver_registry,
)

__all__ = [
    "GeneralLP",
    "StandardLP",
    "EqualityLP",
    "SparseMatrixBuilder",
    "BaseSolver",
    "Solution",
    "SolverOptions",
    "Status",
    "available_solvers",
    "get_solver",
    "register_solver",
    "solver_registry",
    "__version__",
]
