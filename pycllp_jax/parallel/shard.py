"""Scenario-axis sharding of the batched HSD solve over a device mesh.

No upstream analogue — pycllp is single-device (SURVEY.md §2.3); this is
the capability the device mesh adds: the scenario batch partitions over
a named mesh axis via ``shard_map``, and per-iteration termination is
gated either

* ``collective`` — a cross-device ``pmax`` of the local any-active mask
  inside the jitted ``while_loop`` (all shards step in lockstep; no host
  round-trip — the BASELINE.json "collective convergence gating"), or
* ``local`` — each shard runs its own loop and finishes independently
  (no per-iteration sync; best throughput for independent instances).

Shared-structure A is replicated; per-instance A shards with the batch.
On one device the mesh degrades gracefully to a no-op partitioning.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pycllp_jax.ops.gpu import resolve_kernels
from pycllp_jax.ops.reference import KernelSet
from pycllp_jax.solvers.hsd import hsd_solve_batched
from pycllp_jax.solvers.options import SolverOptions

__all__ = [
    "scenario_mesh",
    "CollectiveAny",
    "sharded_hsd_solve",
    "sharded_hsd_solve_scan",
]


def scenario_mesh(n_devices: int | None = None, axis: str = "scenario") -> Mesh:
    """1-D mesh over the first ``n_devices`` local devices (default all)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


@dataclass(frozen=True)
class CollectiveAny:
    """Hashable mask reduction: any(mask) OR-reduced across a mesh axis.

    Frozen-dataclass (not a lambda) so it is a stable static jit argument
    — a fresh lambda per call would defeat the jit cache.
    """

    axis: str

    def __call__(self, mask):
        local = jnp.any(mask).astype(jnp.int32)
        return jax.lax.pmax(local, self.axis) > 0


def sharded_hsd_solve(
    A,
    b,
    c,
    opts: SolverOptions = SolverOptions(),
    mesh: Mesh | None = None,
    kset: KernelSet | None = None,
    termination: str = "collective",
):
    """Solve equality-form LP batch with the scenario axis sharded.

    ``b``/``c`` are (B, m)/(B, n) with B divisible by the mesh size;
    ``A`` is (m, n) shared (replicated) or (B, m, n) (sharded).
    Returns the same dict as :func:`hsd_solve_batched`, with outputs
    sharded over the scenario axis.
    """
    if mesh is None:
        mesh = scenario_mesh()
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    B = b.shape[0]
    if B % n_dev:
        raise ValueError(f"batch {B} not divisible by mesh size {n_dev}")
    if termination not in ("collective", "local"):
        raise ValueError(f"unknown termination {termination!r}")
    kset = resolve_kernels(kset)

    a_spec = P(axis) if np.ndim(A) == 3 else P()
    reduce_any = CollectiveAny(axis) if termination == "collective" else jnp.any

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(a_spec, P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    def local_solve(A_l, b_l, c_l):
        return hsd_solve_batched(A_l, b_l, c_l, opts, kset, reduce_any)

    return local_solve(A, b, c)


def sharded_hsd_solve_scan(
    A,
    b,
    c,
    opts: SolverOptions = SolverOptions(),
    mesh: Mesh | None = None,
    kset: KernelSet | None = None,
    *,
    chunk: int = 16384,
    keys: tuple = ("objective", "status", "iterations"),
    compact_cap: int | None = None,
    compact_bucket: int = 8192,
    finish_cap: int = 6,
    finish_bucket: int | None = None,
    warm_chain: bool = False,
):
    """Scenario-sharded twin of :func:`pycllp_jax.solvers.hsd.hsd_solve_scan`.

    Each shard runs the FULL fused sweep — capped chunk scan, on-device
    compaction/warm-resume, and (with ``opts.finish_dtype``) the wide
    crossover/drain finish — on its local slice of the scenario stream:
    the compaction story of the single-chip scan path, scaled over the
    mesh.  Termination is shard-LOCAL by design: compaction repacks
    lanes within a shard, so cross-shard lockstep (the ``collective``
    gate of :func:`sharded_hsd_solve`) has nothing to synchronise — each
    shard simply finishes its own slice (the best-throughput mode for
    independent scenarios; SURVEY.md §2.3).

    ``b``/``c`` are (N, m)/(N, n) with shared 2-D ``A`` (replicated).
    N is padded up to a ``chunk × mesh-size`` multiple (repeating the
    last row) and trimmed on return; buckets apply PER SHARD.
    """
    from pycllp_jax.solvers.hsd import (
        _finish_opts_view,
        _hsd_scan_finish_core,
        _hsd_scan_narrow_core,
        _narrow_opts_view,
    )

    if getattr(A, "ndim", 2) != 2:
        raise ValueError("sharded_hsd_solve_scan requires shared 2-D A")
    if mesh is None:
        mesh = scenario_mesh()
    kset = resolve_kernels(kset)
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    b = jnp.asarray(b)
    c = jnp.asarray(c)
    N = b.shape[0]
    chunk = max(1, min(chunk, -(-N // n_dev)))
    quantum = chunk * n_dev
    pad = (-N) % quantum
    if pad:
        b = jnp.concatenate([b, jnp.broadcast_to(b[-1:], (pad, b.shape[1]))], 0)
        c = jnp.concatenate([c, jnp.broadcast_to(c[-1:], (pad, c.shape[1]))], 0)
    K = b.shape[0] // chunk  # divisible by n_dev by construction
    b3 = b.reshape(K, chunk, -1)
    c3 = c.reshape(K, chunk, -1)
    local_n = (K // n_dev) * chunk
    cap = int(compact_cap) if compact_cap is not None else 12
    bucket = min(int(compact_bucket), local_n)
    fbucket = min(int(finish_bucket or compact_bucket), local_n)

    dtype = jnp.dtype(opts.dtype) if opts.dtype else jnp.result_type(A, b, c)
    finish = opts.finish_dtype is not None and jnp.dtype(opts.finish_dtype) != dtype
    phase1_tol = max(opts.tol, opts.switch_tol)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    def run(A_r, b3_l, c3_l):
        if not finish:
            return _hsd_scan_narrow_core(
                A_r, b3_l, c3_l, opts, kset, tuple(keys), cap, bucket,
                bool(warm_chain),
            )
        sflat = _hsd_scan_narrow_core(
            A_r, b3_l, c3_l, _narrow_opts_view(opts, phase1_tol), kset, None,
            cap, bucket, bool(warm_chain),
        )
        return _hsd_scan_finish_core(
            A_r, b3_l, c3_l, sflat, _finish_opts_view(opts), kset, tuple(keys),
            int(finish_cap), fbucket,
            rounds=max(4, -(-local_n // fbucket)),
        )

    res = run(A, b3, c3)
    return {k: v[:N] for k, v in zip(keys, res)}
