"""Multi-device scenario sharding (no upstream analogue; SURVEY.md §2.3)."""

from pycllp_jax.parallel.shard import (
    CollectiveAny,
    scenario_mesh,
    sharded_hsd_solve,
    sharded_hsd_solve_scan,
)
from pycllp_jax.parallel.schur import column_sharded_hsd_solve, model_mesh
from pycllp_jax.parallel.distributed import (
    global_scenario_mesh,
    host_local_batch,
    initialize,
    is_distributed,
)

__all__ = [
    "CollectiveAny",
    "column_sharded_hsd_solve",
    "global_scenario_mesh",
    "host_local_batch",
    "initialize",
    "is_distributed",
    "model_mesh",
    "scenario_mesh",
    "sharded_hsd_solve",
    "sharded_hsd_solve_scan",
]
