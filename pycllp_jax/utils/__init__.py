"""Utilities: scaling, logging, checkpointing, profiling."""

from pycllp_jax.utils.scaling import (
    RuizScaling,
    ruiz_equilibrate,
    scale_problem,
    unscale_solution,
)

__all__ = ["RuizScaling", "ruiz_equilibrate", "scale_problem", "unscale_solution"]
