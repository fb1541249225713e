"""Netlib fixture suite (BASELINE.md config 4).

Real netlib data cannot exist in this environment (permanent
disposition in pycllp_jax/io/netlib.py); these tests pin the synthetic
stand-ins' optima through the FULL GeneralLP -> StandardLP -> registry
solver chain and prove the heterogeneous padding scheme is benign
(padded-lane optima equal unpadded ones) -- VERDICT r2 items 7 and
weak-7.
"""

import numpy as np
import pytest

from pycllp_jax import SolverOptions, Status, get_solver
from pycllp_jax.io.netlib import (
    FIXTURE_OBJECTIVES,
    fixture_names,
    load_fixture,
    pad_and_mask,
)


@pytest.mark.parametrize("name", fixture_names())
def test_fixture_optimum_through_full_chain(name):
    prob = load_fixture(name)
    std, fmap = prob.lp.to_standard_form()
    solver = get_solver("hsd", tol=1e-9)
    solver.init(std)
    sol = solver.solve()
    assert int(np.asarray(sol.status)) == int(Status.OPTIMAL)
    obj = fmap.recover_objective(float(np.asarray(sol.objective)))
    ref = FIXTURE_OBJECTIVES[name]
    assert abs(obj - ref) / max(1.0, abs(ref)) < 1e-6, (name, obj, ref)


def test_padding_is_benign():
    """Solving the padded batch must reproduce each problem's own
    optimum: pad rows are slack-only, pad columns never enter."""
    from pycllp_jax.solvers.hsd import hsd_solve_batched

    stds = [load_fixture(nm).lp.to_standard_form()[0] for nm in fixture_names()]
    A, b, c, row_mask, col_mask = pad_and_mask(stds, np.float64)
    # equality-augment the padded batch (slack per row)
    B, m, n = A.shape
    eye = np.broadcast_to(np.eye(m), (B, m, m))
    A_eq = np.concatenate([A, eye], axis=2)
    c_eq = np.concatenate([-c, np.zeros((B, m))], axis=1)
    out = hsd_solve_batched(A_eq, b, c_eq, SolverOptions(tol=1e-9))
    assert np.all(np.asarray(out["status"]) == int(Status.OPTIMAL))
    for k, nm in enumerate(fixture_names()):
        padded_obj = -float(out["objective"][k])  # equality obj is negated
        ref = FIXTURE_OBJECTIVES[nm]  # max-form optimum of the unpadded LP
        assert abs(padded_obj - ref) / max(1.0, abs(ref)) < 1e-6, (nm, padded_obj, ref)
        # pad columns never active
        x = np.asarray(out["x"][k][:n])
        pad_x = x[~col_mask[k]]
        if pad_x.size:
            assert np.abs(pad_x).max() < 1e-7
