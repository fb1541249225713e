"""Chunked scenario-sweep driver with checkpoint/resume.

The BASELINE.json config-5 capability: a stochastic-LP sweep (shared A,
per-scenario b/c — the pywr-style init-once/re-solve pattern at scale)
streamed through the batched solver in chunks, each chunk's results
persisted so an interrupted sweep resumes by skipping completed chunks
(SURVEY.md §5 checkpoint/resume disposition: no in-iteration
checkpointing — an IPM solve is cheap to redo; the chunk is the unit).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

import jax

from pycllp_jax.ops.reference import KernelSet
from pycllp_jax.solvers.hsd import hsd_solve_batched, hsd_solve_scan
from pycllp_jax.solvers.options import SolverOptions

__all__ = ["SweepResult", "scenario_sweep"]

_MANIFEST = "manifest.json"


@dataclass
class SweepResult:
    objective: np.ndarray  # (N,)
    status: np.ndarray  # (N,)
    iterations: np.ndarray  # (N,)
    n_chunks: int
    n_resumed: int  # chunks skipped because already on disk


def _chunk_path(out_dir: str, k: int) -> str:
    return os.path.join(out_dir, f"chunk_{k:06d}.npz")


def scenario_sweep(
    A: np.ndarray,
    b: np.ndarray,
    c: np.ndarray,
    opts: SolverOptions = SolverOptions(),
    *,
    chunk: int = 16384,
    out_dir: str | None = None,
    save_x: bool = False,
    mesh=None,
    solve_fn: Callable | None = None,
    progress: Callable[[int, int], None] | None = None,
    kset: KernelSet | None = None,
    window_chunks: int = 8,
    compact_cap: int | None = None,
    compact_bucket: int = 8192,
    finish_cap: int = 6,
    finish_bucket: int | None = None,
    warm_chain: bool = False,
) -> SweepResult:
    """Solve N scenarios (shared A, batched b/c) in chunks.

    With ``out_dir`` set, per-chunk results persist as ``chunk_*.npz``
    and a manifest pins (shapes, chunk, tol) so a restarted sweep with
    the same configuration skips completed chunks; a mismatched
    configuration raises rather than silently mixing results.

    Dispatch shape: on the default path (shared 2-D A, no custom
    ``solve_fn``/``mesh``) up to ``window_chunks`` chunks run as ONE
    device program (:func:`hsd_solve_scan`, optionally with the fused
    cap/compact/warm-resume sweep), so the per-chunk host round-trip
    leaves the steady state.  The
    chunk stays the persist/resume unit; a window containing any
    missing chunk is re-solved whole and only its missing chunks are
    written (an LP re-solve is deterministic and cheap — SURVEY.md §5).

    ``warm_chain``: chunk-to-chunk warm starts within each window for
    correlated scenario streams (see :func:`hsd_solve_scan`); the chain
    restarts at window boundaries (and therefore on resume), which only
    costs a cold first chunk per window.
    """
    N = b.shape[0]
    if c.shape[0] != N:
        raise ValueError("b and c must agree on the scenario count")
    n_chunks = -(-N // chunk)

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        manifest = {
            "N": int(N),
            "chunk": int(chunk),
            "m": int(A.shape[-2]),
            "n": int(A.shape[-1]),
            "tol": opts.tol,
            "dtype": str(np.dtype(opts.dtype) if opts.dtype else b.dtype),
            "save_x": bool(save_x),
        }
        mpath = os.path.join(out_dir, _MANIFEST)
        if os.path.exists(mpath):
            old = json.load(open(mpath))
            if old != manifest:
                raise ValueError(
                    f"sweep dir {out_dir} holds a different configuration:"
                    f" {old} != {manifest}"
                )
        else:
            json.dump(manifest, open(mpath, "w"))

    scan_ok = solve_fn is None and mesh is None and getattr(A, "ndim", 2) == 2
    if solve_fn is None:
        if mesh is not None:
            from pycllp_jax.parallel import sharded_hsd_solve

            def solve_fn(Ab, bb, cb):
                return sharded_hsd_solve(Ab, bb, cb, opts, mesh=mesh, kset=kset)

        else:

            def solve_fn(Ab, bb, cb):
                return hsd_solve_batched(Ab, bb, cb, opts, kset)

    objective = np.zeros(N)
    status = np.zeros(N, np.int32)
    iterations = np.zeros(N, np.int32)
    n_resumed = 0
    keys = ("objective", "status", "iterations") + (("x",) if save_x else ())

    def persist(path, sl, out, lo, hi):
        payload = {k_: np.asarray(out[k_])[sl][: hi - lo] for k_ in keys}
        tmp = path + ".tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, path)  # atomic: a crash never leaves half-chunks

    window = max(1, window_chunks if scan_ok else 1)
    k = 0
    while k < n_chunks:
        kw = min(window, n_chunks - k)
        paths = [
            _chunk_path(out_dir, k + j) if out_dir else None for j in range(kw)
        ]
        missing = [
            j for j, p in enumerate(paths) if p is None or not os.path.exists(p)
        ]
        for j in range(kw):
            if j in missing:
                continue
            lo, hi = (k + j) * chunk, min((k + j + 1) * chunk, N)
            data = np.load(paths[j])
            objective[lo:hi] = data["objective"]
            status[lo:hi] = data["status"]
            iterations[lo:hi] = data["iterations"]
            n_resumed += 1
        if missing:
            lo_w = (k + missing[0]) * chunk
            hi_w = min((k + missing[-1] + 1) * chunk, N)
            bb, cb = b[lo_w:hi_w], c[lo_w:hi_w]
            if scan_ok:
                out = hsd_solve_scan(
                    A, bb, cb, opts, kset, chunk=chunk, keys=keys,
                    compact_cap=compact_cap, compact_bucket=compact_bucket,
                    finish_cap=finish_cap, finish_bucket=finish_bucket,
                    warm_chain=warm_chain,
                )
            else:
                pad = chunk - (hi_w - lo_w)
                if pad > 0:  # keep one compiled shape for the tail chunk
                    bb = np.concatenate([bb, np.repeat(bb[-1:], pad, 0)], 0)
                    cb = np.concatenate([cb, np.repeat(cb[-1:], pad, 0)], 0)
                out = solve_fn(A, bb, cb)
            out = {k_: np.asarray(v) for k_, v in out.items()}  # ONE pull per key
            for j in missing:
                lo, hi = (k + j) * chunk, min((k + j + 1) * chunk, N)
                sl = slice(lo - lo_w, lo - lo_w + chunk)
                objective[lo:hi] = out["objective"][sl][: hi - lo]
                status[lo:hi] = out["status"][sl][: hi - lo]
                iterations[lo:hi] = out["iterations"][sl][: hi - lo]
                if paths[j]:
                    persist(paths[j], sl, out, lo, hi)
        if progress is not None:
            progress(min(k + kw, n_chunks), n_chunks)
        k += kw

    return SweepResult(
        objective=objective,
        status=status,
        iterations=iterations,
        n_chunks=n_chunks,
        n_resumed=n_resumed,
    )
