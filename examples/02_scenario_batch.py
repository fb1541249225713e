"""The core capability: thousands of scenarios, one structure.

One constraint matrix A, a batch of (b, c) scenario data — the
stochastic-LP pattern (pywr-style water-resource scenarios upstream).

Run: python examples/02_scenario_batch.py
"""

import time

import numpy as np

import pycllp_jax as tp
from pycllp_jax.io.generate import random_standard_lp

N_SCENARIOS = 4096

lp = random_standard_lp(64, 64, nlp=N_SCENARIOS, seed=0, dtype=np.float32)
print(f"batch: {lp.nproblems} scenarios of a {lp.nrows}x{lp.ncols} LP")

solver = tp.get_solver("hsd", tol=1e-5, dtype="float32", stall_patience=6)
solver.init(lp)  # convert + trace + compile once

t0 = time.time()
sol = solver.solve()
print(f"solved {N_SCENARIOS} LPs in {time.time()-t0:.2f}s -> {sol}")

# re-solve with perturbed scenario data (no recompilation)
lp.b = lp.b * np.random.default_rng(1).uniform(0.95, 1.05, lp.b.shape).astype(np.float32)
t0 = time.time()
sol2 = solver.solve(lp)
print(f"re-solve in {time.time()-t0:.2f}s; mean objective moved "
      f"{float(np.mean(np.abs(np.asarray(sol2.objective) - np.asarray(sol.objective)))):.4f}")
