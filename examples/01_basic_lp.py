"""Basic usage: model a small LP three ways and solve it.

Run: python examples/01_basic_lp.py
"""

import numpy as np

import pycllp_jax as tp

# --- 1. GeneralLP: bounds, senses, ranges --------------------------------
# min  x + y
# s.t. x + 2y >= 2
#      3x + y >= 3
#      x, y >= 0
glp = tp.GeneralLP(A=[[1, 2], [3, 1]], row_lb=[2, 3], c=[1, 1], sense="min")
solver = tp.get_solver("hsd", tol=1e-9)
solver.init(glp)
sol = solver.solve()
print(f"GeneralLP : x = {np.asarray(sol.x)}, objective = {float(sol.objective):.4f}")

# --- 2. StandardLP (Vanderbei convention): max c'x, Ax <= b, x >= 0 ------
std = tp.StandardLP(A=[[2.0, 1.0], [1.0, 3.0]], b=[10.0, 15.0], c=[3.0, 2.0])
solver.init(std)
sol = solver.solve()
print(f"StandardLP: x = {np.asarray(sol.x)}, objective = {float(sol.objective):.4f}")

# --- 3. Incremental sparse construction ---------------------------------
b = tp.SparseMatrixBuilder(2, 2)
b[0, 0] = 2.0
b[0, 1] = 1.0
b[1, 0] = 1.0
b[1, 1] = 3.0
std2 = tp.StandardLP.from_builder(b, b=[10.0, 15.0], c=[3.0, 2.0])
solver.init(std2)
print(f"Builder   : objective = {float(solver.solve().objective):.4f} (same LP)")

# --- statuses ------------------------------------------------------------
infeasible = tp.StandardLP(A=[[1.0, 1.0]], b=[-1.0], c=[1.0, 1.0])
solver.init(infeasible)
print(f"infeasible LP -> status {tp.Status(int(solver.solve().status)).name}")
