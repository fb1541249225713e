"""Multi-host bring-up and global meshes.

No upstream analogue (pycllp is single-process — SURVEY.md §2.3).  In a
multi-process job (for example one process per GPU) each process runs
this same program; ``initialize()`` wires them via ``jax.distributed``
(the coordinator address, process count and id come as explicit args or
through ``JAX_COORDINATOR_ADDRESS``), after which ``jax.devices()``
spans the job and the scenario/model meshes from this package address
every card.  XLA hands the collectives to NCCL: over NVLink between the
cards of one host, every card reaches every other at the same rate, so
the 1-D meshes follow the algorithm alone.
"""

from __future__ import annotations

import os

import numpy as np

import jax
from jax.sharding import Mesh

__all__ = ["initialize", "is_distributed", "global_scenario_mesh", "host_local_batch"]

_initialized = False


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialise multi-process JAX when a coordinator address is given
    (explicitly or in the environment); returns True when distributed.

    Single-process callers get False and everything else in the package
    keeps working on local devices — the upstream-compatible default.
    """
    global _initialized
    if _initialized:
        return jax.process_count() > 1
    explicit = coordinator_address is not None
    env = os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get(
        "COORDINATOR_ADDRESS"
    )
    if explicit or env:
        jax.distributed.initialize(
            coordinator_address=coordinator_address or env,
            num_processes=num_processes,
            process_id=process_id,
        )
        _initialized = True
        return True
    return False


def is_distributed() -> bool:
    return jax.process_count() > 1


def global_scenario_mesh(axis: str = "scenario") -> Mesh:
    """1-D mesh over every device in the (possibly multi-host) job."""
    return Mesh(np.array(jax.devices()), (axis,))


def host_local_batch(total: int) -> tuple[int, int]:
    """Split a global scenario count across processes: returns
    (this host's start, count).  The scenario axis shards by process
    contiguously so host-local data loading needs no shuffle."""
    p, pc = jax.process_index(), jax.process_count()
    per = -(-total // pc)
    lo = min(p * per, total)
    hi = min(lo + per, total)
    return lo, hi - lo
