"""Ruiz equilibration for LP data.

f32 insurance for the batched device path (SURVEY.md §7 hard part 1): iteratively
scale rows and columns of A toward unit max-norm, folding the scaling
into b, c, and the recovered solution.  Pure function of the problem
data; runs once per structure (not per scenario) when A is shared.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

__all__ = ["RuizScaling", "ruiz_equilibrate", "scale_problem", "unscale_solution"]


class RuizScaling(NamedTuple):
    row: jnp.ndarray  # (..., m) row scale factors r
    col: jnp.ndarray  # (..., n) column scale factors s


def ruiz_equilibrate(A, iters: int = 10, eps: float = 1e-12) -> RuizScaling:
    """Compute r, s such that diag(r)·A·diag(s) has ~unit max row/col norms."""
    r = jnp.ones(A.shape[:-1], dtype=A.dtype)
    s = jnp.ones(A.shape[:-2] + A.shape[-1:], dtype=A.dtype)
    for _ in range(iters):
        As = A * r[..., :, None] * s[..., None, :]
        row_norm = jnp.max(jnp.abs(As), axis=-1)
        col_norm = jnp.max(jnp.abs(As), axis=-2)
        # all-zero rows/columns (e.g. padding in heterogeneous batches)
        # keep scale 1 rather than blowing up by 1/sqrt(eps)
        r = r / jnp.where(row_norm > eps, jnp.sqrt(row_norm), 1.0)
        s = s / jnp.where(col_norm > eps, jnp.sqrt(col_norm), 1.0)
    return RuizScaling(row=r, col=s)


def scale_problem(A, b, c, scaling: RuizScaling):
    """Apply equilibration to the equality form min cᵀx, Ax=b, x≥0.

    x̃ = x / s  ⇒  Ã = R A S, b̃ = R b, c̃ = S c  (R=diag(row), S=diag(col)).
    """
    r, s = scaling
    A_s = A * r[..., :, None] * s[..., None, :]
    b_s = b * r
    c_s = c * s
    return A_s, b_s, c_s


def unscale_solution(x, y, z, scaling: RuizScaling):
    """Map the scaled-problem solution back: x = S x̃, y = R ỹ, z = c̃-space → z = z̃/s."""
    r, s = scaling
    return x * s, y * r, z / s
