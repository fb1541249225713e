"""Fuzz the GeneralLP → StandardLP conversion against scipy.

Random structured LPs with every bound pattern (finite/infinite lower/
upper, free, fixed-ish), row senses (≤, ≥, =, range), and both
objective senses must round-trip through the conversion + HSD solve to
the same optimal objective scipy finds on the ORIGINAL general form.
"""

import numpy as np
import pytest
from scipy.optimize import linprog

from pycllp_jax import GeneralLP, Status, get_solver


def _random_general_lp(rng):
    m = rng.integers(2, 7)
    n = rng.integers(2, 7)
    A = rng.normal(size=(m, n)) * (rng.random((m, n)) < 0.8)
    # variable bounds: mix of patterns
    lb = np.where(rng.random(n) < 0.7, rng.uniform(-2, 0.5, n), -np.inf)
    ub = np.where(rng.random(n) < 0.5, rng.uniform(1.0, 4.0, n), np.inf)
    ub = np.maximum(ub, lb + 0.5)
    # rows: pick a feasible interior point within bounds to anchor
    x0 = np.where(
        np.isfinite(lb) & np.isfinite(ub),
        (lb + ub) / 2,
        np.where(np.isfinite(lb), lb + 1.0, np.where(np.isfinite(ub), ub - 1.0, 0.3)),
    )
    r = A @ x0
    kind = rng.integers(0, 4, size=m)  # 0: <=, 1: >=, 2: ==, 3: range
    row_lb = np.full(m, -np.inf)
    row_ub = np.full(m, np.inf)
    slack = rng.uniform(0.5, 2.0, size=m)
    row_ub[kind == 0] = (r + slack)[kind == 0]
    row_lb[kind == 1] = (r - slack)[kind == 1]
    row_lb[kind == 2] = row_ub[kind == 2] = r[kind == 2]
    row_lb[kind == 3] = (r - slack)[kind == 3]
    row_ub[kind == 3] = (r + slack)[kind == 3]
    c = rng.normal(size=n)
    sense = "min" if rng.random() < 0.5 else "max"
    return GeneralLP(A=A, row_lb=row_lb, row_ub=row_ub, c=c, lb=lb, ub=ub, sense=sense)


def _scipy_solve_general(glp):
    glp._freeze()
    s = 1.0 if glp.sense == "min" else -1.0
    A_ub, b_ub, A_eq, b_eq = [], [], [], []
    for i in range(glp.A.shape[0]):
        lo, hi = glp.row_lb[i], glp.row_ub[i]
        if np.isfinite(lo) and np.isfinite(hi) and lo == hi:
            A_eq.append(glp.A[i])
            b_eq.append(hi)
            continue
        if np.isfinite(hi):
            A_ub.append(glp.A[i])
            b_ub.append(hi)
        if np.isfinite(lo):
            A_ub.append(-glp.A[i])
            b_ub.append(-lo)
    res = linprog(
        s * glp.c,
        A_ub=np.array(A_ub) if A_ub else None,
        b_ub=np.array(b_ub) if b_ub else None,
        A_eq=np.array(A_eq) if A_eq else None,
        b_eq=np.array(b_eq) if b_eq else None,
        bounds=list(zip(glp.lb, [u if np.isfinite(u) else None for u in glp.ub])),
        method="highs",
    )
    return res, s


@pytest.mark.parametrize("seed", range(20))
def test_random_general_lp_matches_scipy(seed):
    rng = np.random.default_rng(1000 + seed)
    glp = _random_general_lp(rng)
    res, s = _scipy_solve_general(glp)
    solver = get_solver("hsd", tol=1e-9, maxiter=200)
    solver.init(glp)
    sol = solver.solve()
    if res.status == 0:
        assert int(np.asarray(sol.status)) == int(Status.OPTIMAL), (
            f"scipy optimal but hsd gave {Status(int(np.asarray(sol.status))).name}"
        )
        obj_general = s * res.fun + glp.f
        np.testing.assert_allclose(
            float(sol.objective), obj_general, rtol=1e-6, atol=1e-6
        )
        x = np.asarray(sol.x)
        assert np.all(x >= glp.lb - 1e-6)
        assert np.all(x <= glp.ub + 1e-6)
        r = glp.A @ x
        assert np.all(r <= glp.row_ub + 1e-5)
        assert np.all(r >= glp.row_lb - 1e-5)
    elif res.status == 3:  # unbounded
        assert int(np.asarray(sol.status)) in (
            int(Status.UNBOUNDED),
            int(Status.INFEASIBLE),  # HiGHS/IPM can disagree on the label
            int(Status.ITERATION_LIMIT),
        )
    elif res.status == 2:  # infeasible (shouldn't happen: anchored feasible)
        assert int(np.asarray(sol.status)) != int(Status.OPTIMAL)
