"""Multi-device: scenario sharding and the big-LP column-sharded path.

Works on any device count — run on CPU with a virtual mesh:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/03_sharded_and_big.py
"""

import numpy as np

import jax

import pycllp_jax as tp
from pycllp_jax.io.generate import random_equality_lp
from pycllp_jax.parallel import (
    column_sharded_hsd_solve,
    model_mesh,
    scenario_mesh,
    sharded_hsd_solve,
)

print(f"devices: {jax.device_count()}")

# --- scenario sharding: the batch partitions across the mesh -------------
mesh = scenario_mesh()
n_dev = mesh.devices.size
A, _, _ = random_equality_lp(16, 40, seed=0)
rng = np.random.default_rng(1)
B = 64 * n_dev
b = rng.uniform(0.1, 1.0, size=(B, 40)) @ A.T
c = rng.normal(size=(B, 16)) @ A + rng.uniform(0.1, 1.0, size=(B, 40))
out = sharded_hsd_solve(A, b, c, tp.SolverOptions(tol=1e-8), mesh=mesh,
                        termination="collective")
print(f"scenario-sharded: {B} lanes over {n_dev} devices, "
      f"optimal={int((np.asarray(out['status'])==0).sum())}/{B}")

# --- big-LP path: ONE LP, columns sharded (psum-assembled normal matrix) --
A, b1, c1 = random_equality_lp(24, 64, seed=2)
out = column_sharded_hsd_solve(
    A, b1, c1, tp.SolverOptions(tol=1e-9, scale=False), mesh=model_mesh()
)
print(f"column-sharded single LP: status={int(np.asarray(out['status']))}, "
      f"objective={float(np.asarray(out['objective'])):.6f}")
