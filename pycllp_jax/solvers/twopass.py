"""Compacted batch solve: cap, compact, warm-resume.

A batched ``lax.while_loop`` runs every lane of a chunk until the SLOWEST
lane terminates, so chunk cost is governed by the max iteration count
while useful work is the mean.  The upstream OpenCL design has the same
property per work-group (reference mount empty this build — SURVEY.md
§0); pycllp simply ate the divergence.

The ONE mechanism that fixes this is the fused on-device
cap → compact → warm-resume sweep in
:func:`pycllp_jax.solvers.hsd.hsd_solve_scan` (``compact_cap=``): every
chunk is capped, the still-running lanes are compacted on device into a
single bucket batch that resumes WARM (same iterates), and results
scatter back — one dispatch, one pull.  ``hsd_solve_two_pass`` is the
host-orchestrated predecessor kept for API compatibility; for shared
2-D A it now *delegates* to the fused sweep (bit-identical trajectories,
strictly less host traffic).  Only per-instance (3-D) A — which the
scan core does not take — still runs the host-side two-pass ladder:

1. **Pass 1** — solve every chunk with a short iteration cap.
2. **Compact** — pull statuses; lanes that hit the cap are gathered
   into a padded remnant batch.
3. **Pass 2** — the remnant re-solves from scratch with the full
   ``opts.maxiter`` budget; results scatter back.
"""

from __future__ import annotations

import numpy as np

from pycllp_jax.ops.reference import KernelSet
from pycllp_jax.solvers.hsd import hsd_solve_batched, hsd_solve_scan
from pycllp_jax.solvers.options import SolverOptions, Status

__all__ = ["hsd_solve_two_pass"]

_OUT_KEYS = (
    "x", "y", "z", "tau", "kappa", "objective", "status", "iterations",
    "rho_p", "rho_d", "rho_gap",
)


def _bucket(size: int, min_bucket: int, max_bucket: int) -> int:
    """Smallest power-of-two bucket ≥ size (clamped) — stable jit shapes."""
    b = min_bucket
    while b < size and b < max_bucket:
        b *= 2
    return min(b, max_bucket)


def hsd_solve_two_pass(
    A,
    b,
    c,
    opts: SolverOptions = SolverOptions(),
    kset: KernelSet | None = None,
    *,
    chunk: int | None = None,
    pass1_maxiter: int = 16,
    min_bucket: int = 1024,
    reduce_any=None,
    keys: tuple = _OUT_KEYS,
):
    """Solve ``min cᵀx, Ax=b, x≥0`` batched, with remnant compaction.

    Parameters mirror :func:`hsd_solve_batched`; additionally:

    chunk : rows per pass-1 dispatch (default: the whole batch at once).
    pass1_maxiter : iteration cap for pass 1.  Lanes still running at the
        cap continue (shared A: resume warm on device; 3-D A: re-solve
        from scratch) with the full ``opts.maxiter``.
    min_bucket : smallest remnant padding bucket (keeps the number of
        distinct compiled shapes logarithmic in batch size).
    keys : which output fields to materialise on host.

    Returns the same dict of (host) arrays as ``hsd_solve_batched``,
    restricted to ``keys`` (+ ``status``).  For shared 2-D A
    ``iterations`` counts cumulatively across the warm resume (the true
    per-lane total); for 3-D A remnant lanes report the pass-2
    from-scratch count.
    """
    b = np.asarray(b)
    c = np.asarray(c)
    B = b.shape[0]
    chunk = B if chunk is None else min(chunk, B)
    if B % chunk:
        raise ValueError(f"batch {B} must be a multiple of chunk {chunk}")

    if getattr(A, "ndim", 2) == 2:
        # shared structure: the fused on-device sweep IS the mechanism
        # (pass-1 cap → device-side compaction → warm resume with the
        # full budget), so delegate; identical trajectories, no host
        # round-trip between passes.  The resume bucket covers every
        # lane so no remnant overflows (the overflow short-cut is a
        # throughput knob of hsd_solve_scan, not of this API).
        want = tuple(dict.fromkeys(("status",) + tuple(keys)))
        kw = {} if reduce_any is None else {"reduce_any": reduce_any}
        if kw:
            raise ValueError(
                "reduce_any is not supported on the shared-A two-pass path; "
                "use pycllp_jax.parallel.sharded_hsd_solve for collective "
                "termination"
            )
        out = hsd_solve_scan(
            A, b, c, opts, kset,
            chunk=chunk, keys=want,
            compact_cap=min(pass1_maxiter, opts.maxiter),
            compact_bucket=B,
        )
        return {k: np.asarray(v) for k, v in out.items()}

    opts1 = opts.replace(maxiter=pass1_maxiter)
    kw = {} if reduce_any is None else {"reduce_any": reduce_any}

    # pass 1: async chunk dispatches (device handles collected, then the
    # ONLY eager pull is the status vector that drives compaction)
    pass1 = []
    for k in range(B // chunk):
        sl = slice(k * chunk, (k + 1) * chunk)
        pass1.append(hsd_solve_batched(A[sl], b[sl], c[sl], opts1, kset, **kw))
    status = np.concatenate([np.asarray(p["status"]) for p in pass1])

    remnant = np.flatnonzero(status == int(Status.ITERATION_LIMIT))
    subs = []  # (row indices, pass-2 device results)
    if remnant.size and opts.maxiter > pass1_maxiter:
        # pass 2: compact the unfinished lanes into padded bucket batches
        nb = _bucket(remnant.size, min_bucket, chunk)
        for s in range(-(-remnant.size // nb)):
            idx = remnant[s * nb : (s + 1) * nb]
            pad = nb - idx.size
            rows = np.concatenate([idx, np.repeat(idx[-1:], pad)]) if pad else idx
            subs.append(
                (idx, hsd_solve_batched(A[rows], b[rows], c[rows], opts, kset, **kw))
            )

    out = {}
    for key in dict.fromkeys(("status",) + tuple(keys)):
        vals = (
            status.copy()
            if key == "status"
            else np.concatenate([np.asarray(p[key]) for p in pass1])
        )
        for idx, res in subs:
            vals[idx] = np.asarray(res[key])[: idx.size]
        out[key] = vals
    return out
