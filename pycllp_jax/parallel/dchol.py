"""Row-sharded blocked Cholesky over a model mesh (SPMD, shard_map-inner).

The last capability slot of SURVEY.md §7 step 6 ("distributed blocked
Cholesky"; no upstream analogue — reference mount empty, SURVEY.md §0):
the column-sharded big-LP path (:mod:`pycllp_jax.parallel.schur`)
psum-assembles the m×m normal matrix and, by default, factors it
REPLICATED on every device — correct for m ≪ n, but an LP whose m×m
factor exceeds one chip's memory has no path.  This module shards the
factor itself: M's ROWS partition into P contiguous blocks of mb = m/P,
one per mesh device, and a right-looking blocked Cholesky runs as a
static P-step SPMD loop:

    step k:  L_kk = chol(M_kk)            (replicated: every device
                                           factors the (B, mb, mb)
                                           diagonal block — P·mb³ total
                                           redundant FLOPs, negligible)
             P_i  = M_i[:, kcols]·L_kkᵀ⁻¹ (each device, own rows; for
                                           i == k this IS L_kk, for
                                           i < k it is masked to zero)
             panel = all_gather(P_i)      (ONE collective per step,
                                           (B, m, mb) riding ICI)
             M_i  -= P_i · panelᵀ         (trailing update: the O(m³)
                                           work, perfectly sharded)

Per-device memory is O(B·mb·m) for the factor and O(B·m·mb) transient
for the panel — the full (B, m, m) never materialises anywhere.  The
solves stay block-sequential (P small triangular solves chained by
psum-broadcasts of (B, mb) vectors), so forward+backward substitution
is O(B·m²/P) compute per device with 4P tiny collectives.

All functions here are SPMD-inner: call them INSIDE ``shard_map`` with
``axis`` bound to the mesh axis over which M's rows are sharded.
Everything is batched over a leading B axis.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = ["rowshard_cholesky", "rowshard_cholesky_solve"]


def _tsolve(L, B_, *, left: bool, transpose: bool):
    return lax.linalg.triangular_solve(
        L, B_, left_side=left, lower=True, transpose_a=transpose
    )


def rowshard_cholesky(Mw, axis: str, n_blocks: int):
    """Factor a row-sharded SPD matrix: ``M = L·Lᵀ``, rows stay sharded.

    Parameters
    ----------
    Mw : (B, mb, m) — this device's row block of the (B, m, m) matrix.
    axis : mesh axis name the rows are sharded over.
    n_blocks : static mesh size P (= m / mb).

    Returns ``(Lw, Lkks)``: ``Lw`` (B, mb, m) — this device's rows of
    the lower factor; ``Lkks`` (P, B, mb, mb) — the replicated diagonal
    blocks (kept so the solves need no re-broadcast).
    """
    my = lax.axis_index(axis)
    B, mb, m = Mw.shape
    Lw = jnp.zeros_like(Mw)
    kks = []
    for k in range(n_blocks):
        kcols = slice(k * mb, (k + 1) * mb)
        # replicated diagonal block (psum-select from its owner)
        diag = lax.psum(jnp.where(my == k, Mw[:, :, kcols], 0.0), axis)
        Lkk = lax.linalg.cholesky(diag)
        kks.append(Lkk)
        # panel piece for my rows:  P_i = M_i[:, kcols] · L_kk⁻ᵀ
        # (for i == k this equals L_kk itself; i < k rows are done —
        # masked out so their stale columns cannot pollute the gather)
        Pi = _tsolve(Lkk, Mw[:, :, kcols], left=False, transpose=True)
        Pi = jnp.where(my >= k, Pi, 0.0)
        # ONE all-gather: the full (B, m, mb) panel column
        panel = lax.all_gather(Pi, axis, axis=1, tiled=True)
        # trailing update of my rows (no-op for finished rows: Pi == 0)
        Mw = Mw - jnp.einsum("bar,bcr->bac", Pi, panel)
        Lw = Lw.at[:, :, kcols].set(jnp.where(my >= k, Pi, Lw[:, :, kcols]))
    return Lw, jnp.stack(kks)


def rowshard_cholesky_solve(Lw, Lkks, r, axis: str, n_blocks: int):
    """Solve ``L·Lᵀ x = r`` for replicated ``r`` (B, m) → replicated x.

    Block forward then backward substitution, sequential over the P row
    blocks; each step is one (B, mb, mb) triangular solve replicated on
    every device plus one psum-broadcast of a (B, mb) vector.
    """
    my = lax.axis_index(axis)
    B, mb, m = Lw.shape

    # forward:  y_k = L_kk⁻¹ (r_k − Σ_{j<k} L_kj y_j)   (owner computes
    # the partial sum from its own factor rows, psum broadcasts it)
    ys = []
    for k in range(n_blocks):
        kcols = slice(k * mb, (k + 1) * mb)
        acc = r[:, kcols]
        if k:
            ydone = jnp.concatenate(ys, axis=-1)  # (B, k·mb) replicated
            own = jnp.einsum("bam,bm->ba", Lw[:, :, : k * mb], ydone)
            acc = acc - lax.psum(jnp.where(my == k, own, 0.0), axis)
        Lkk = Lkks[k]
        ys.append(_tsolve(Lkk, acc[..., None], left=True, transpose=False)[..., 0])

    # backward:  x_k = L_kk⁻ᵀ (y_k − Σ_{i>k} L_ikᵀ x_i)   (each device
    # past block k contributes its own rows' transpose-product)
    xs = [None] * n_blocks
    x = jnp.zeros((B, m), Lw.dtype)
    for k in range(n_blocks - 1, -1, -1):
        kcols = slice(k * mb, (k + 1) * mb)
        zero = jnp.zeros((), my.dtype)
        xmine = lax.dynamic_slice(x, (zero, my * mb), (B, mb))
        contrib = lax.psum(
            jnp.where(
                my > k, jnp.einsum("bar,ba->br", Lw[:, :, kcols], xmine), 0.0
            ),
            axis,
        )
        xk = _tsolve(Lkks[k], (ys[k] - contrib)[..., None], left=True, transpose=True)[
            ..., 0
        ]
        xs[k] = xk
        x = x.at[:, kcols].set(xk)
    return x
