"""Scenario sweeps with checkpoint/resume, and MPS file IO.

Run: python examples/04_sweep_and_mps.py
"""

import tempfile

import numpy as np

import pycllp_jax as tp
from pycllp_jax.io.generate import random_equality_lp
from pycllp_jax.io.mps import read_mps, write_mps
from pycllp_jax.utils.sweep import scenario_sweep

# --- MPS round trip ------------------------------------------------------
glp = tp.GeneralLP(A=[[1, 2], [3, 1]], row_lb=[2, 3], c=[1, 1], sense="min")
text = write_mps(glp, name="EXAMPLE")
prob = read_mps(text)
print(f"MPS: parsed {prob.name!r} with rows {prob.row_names}")

# --- chunked sweep with resume ------------------------------------------
A, _, _ = random_equality_lp(8, 20, seed=0)
rng = np.random.default_rng(1)
N = 1000
b = rng.uniform(0.1, 1.0, size=(N, 20)) @ A.T
c = rng.normal(size=(N, 8)) @ A + rng.uniform(0.1, 1.0, size=(N, 20))

with tempfile.TemporaryDirectory() as d:
    res = scenario_sweep(A, b, c, tp.SolverOptions(tol=1e-8), chunk=256, out_dir=d)
    print(f"sweep: {N} scenarios in {res.n_chunks} chunks, "
          f"optimal={int((res.status==0).sum())}")
    # a second run resumes from the persisted chunks
    res2 = scenario_sweep(A, b, c, tp.SolverOptions(tol=1e-8), chunk=256, out_dir=d)
    print(f"resume: skipped {res2.n_resumed}/{res2.n_chunks} chunks")
