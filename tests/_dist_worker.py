"""Worker process for the 2-process CPU-cluster distributed test.

Launched by tests/test_distributed.py as
    python tests/_dist_worker.py <coordinator> <num_processes> <rank>
with JAX_PLATFORMS=cpu and 2 virtual devices per process, so the global
mesh spans 2 processes x 2 devices = 4 devices.

Exit codes: 0 = solved and agreed with the single-process solve,
42 = distributed bring-up unsupported in this environment (test skips),
anything else = failure.
"""

from __future__ import annotations

import sys

COORD, NPROC, RANK = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

import jax  # noqa: E402

# pin through jax.config (as tests/conftest.py does) so the cluster
# forms over local CPU devices even on a machine with a GPU
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

try:
    from pycllp_jax.parallel.distributed import initialize

    ok = initialize(coordinator_address=COORD, num_processes=NPROC, process_id=RANK)
except Exception as e:  # pragma: no cover - environment-dependent
    print(f"distributed init failed: {e}", file=sys.stderr)
    sys.exit(42)
if not ok or jax.process_count() != NPROC:
    print(f"process_count={jax.process_count()} != {NPROC}", file=sys.stderr)
    sys.exit(42)

import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from pycllp_jax import SolverOptions  # noqa: E402
from pycllp_jax.io.generate import random_standard_lp  # noqa: E402
from pycllp_jax.parallel.distributed import global_scenario_mesh, host_local_batch  # noqa: E402
from pycllp_jax.parallel.shard import sharded_hsd_solve  # noqa: E402
from pycllp_jax.solvers.hsd import hsd_solve_batched  # noqa: E402

B = 8
lp = random_standard_lp(6, 10, nlp=B, seed=7, dtype=np.float64)
eq = lp.to_equality_form()
A = np.asarray(eq.A)
b = np.asarray(eq.b)
c = np.asarray(eq.c)

mesh = global_scenario_mesh()
assert len(mesh.devices.ravel()) == 4, mesh
sharding = NamedSharding(mesh, P("scenario"))

# each process feeds only ITS contiguous slice of the scenario stream
lo, cnt = host_local_batch(B)
b_g = jax.make_array_from_process_local_data(sharding, b[lo : lo + cnt])
c_g = jax.make_array_from_process_local_data(sharding, c[lo : lo + cnt])

opts = SolverOptions(tol=1e-8, dtype="float64")
out = sharded_hsd_solve(A, b_g, c_g, opts, mesh=mesh, termination="collective")

# single-process oracle: the same batch solved locally, unsharded; each
# process checks the shards it actually holds (no cross-process gather
# needed — agreement of every shard on every process covers the batch)
ref = hsd_solve_batched(A, b, c, opts)
ref_obj = np.asarray(ref["objective"])
errs = []
for shard in out["objective"].addressable_shards:
    sl = shard.index[0]
    got = np.asarray(shard.data)
    want = ref_obj[sl]
    errs.append(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))
err = max(errs)
print(f"rank {RANK}: process_count={jax.process_count()} max rel diff {err:.2e}")
assert err < 1e-8
print(f"rank {RANK}: AGREE")
