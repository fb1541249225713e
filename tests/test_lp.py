"""Model-layer tests: sparse builder, CSC round-trip, form conversions.

Mirrors the upstream ``tests/test_lp.py`` coverage shape (SURVEY.md §4):
GeneralLP → StandardLP conversion, sparse construction, batch shapes.
"""

import numpy as np
import pytest

from pycllp_jax import GeneralLP, SparseMatrixBuilder, StandardLP
from pycllp_jax.models.sparse import csc_to_dense, dense_to_csc


class TestSparseBuilder:
    def test_set_get(self):
        b = SparseMatrixBuilder()
        b[0, 0] = 1.0
        b[2, 3] = -4.5
        b.set_value(1, 1, 2.0)
        assert b[0, 0] == 1.0
        assert b[2, 3] == -4.5
        assert b[0, 3] == 0.0
        assert b.shape == (3, 4)
        assert b.nnz == 3

    def test_overwrite_semantics(self):
        b = SparseMatrixBuilder()
        b[0, 0] = 1.0
        b[0, 0] = 5.0
        assert b[0, 0] == 5.0
        assert b.nnz == 1
        b.add_value(0, 0, 1.0)
        assert b[0, 0] == 6.0

    def test_csc_roundtrip(self):
        rng = np.random.default_rng(0)
        dense = rng.normal(size=(5, 7)) * (rng.random((5, 7)) < 0.4)
        a, ia, ka = dense_to_csc(dense)
        assert len(ka) == 8
        assert len(a) == np.count_nonzero(dense)
        back = csc_to_dense(a, ia, ka, 5)
        np.testing.assert_allclose(back, dense)

    def test_csc_column_pointers(self):
        b = SparseMatrixBuilder(3, 3)
        b[0, 0] = 1.0
        b[2, 0] = 2.0
        b[1, 2] = 3.0
        a, ia, ka = b.tocsc()
        np.testing.assert_array_equal(ka, [0, 2, 2, 3])
        np.testing.assert_array_equal(ia, [0, 2, 1])
        np.testing.assert_allclose(a, [1.0, 2.0, 3.0])

    def test_bounds_checking(self):
        b = SparseMatrixBuilder(2, 2)
        with pytest.raises(IndexError):
            b[2, 0] = 1.0
        with pytest.raises(IndexError):
            b[0, -1] = 1.0


class TestStandardLP:
    def test_shapes(self):
        lp = StandardLP(A=np.ones((3, 4)), b=np.ones(3), c=np.ones(4))
        assert lp.nrows == 3
        assert lp.ncols == 4
        assert lp.nproblems == 1
        assert not lp.batched

    def test_batched_shapes(self):
        lp = StandardLP(A=np.ones((3, 4)), b=np.ones((10, 3)), c=np.ones((10, 4)))
        assert lp.nproblems == 10
        assert lp.batched

    def test_csc_roundtrip(self):
        rng = np.random.default_rng(1)
        A = rng.normal(size=(3, 4))
        lp = StandardLP(A=A, b=rng.normal(size=3), c=rng.normal(size=4))
        a, ia, ka = lp.tocsc()
        lp2 = StandardLP.from_csc(a, ia, ka, lp.b, lp.c, nrows=3)
        np.testing.assert_allclose(np.asarray(lp2.A), A)

    def test_equality_form(self):
        rng = np.random.default_rng(2)
        A = rng.normal(size=(3, 4))
        b = rng.normal(size=3)
        c = rng.normal(size=4)
        eq = StandardLP(A=A, b=b, c=c, f=1.5).to_equality_form()
        assert eq.A.shape == (3, 7)
        np.testing.assert_allclose(np.asarray(eq.A)[:, 4:], np.eye(3))
        np.testing.assert_allclose(np.asarray(eq.c)[:4], -c)
        np.testing.assert_allclose(np.asarray(eq.c)[4:], 0.0)
        # objective mapping: max c'x == −(min −c'x) + f
        x_eq = np.abs(rng.normal(size=7))
        np.testing.assert_allclose(
            eq.standard_objective(x_eq), c @ x_eq[:4] + 1.5
        )

    def test_pytree(self):
        import jax

        lp = StandardLP(A=np.ones((2, 3)), b=np.ones(2), c=np.ones(3))
        leaves = jax.tree_util.tree_leaves(lp)
        assert len(leaves) == 4  # A, b, c, f


class TestGeneralToStandard:
    def _check_against_scipy(self, glp: GeneralLP, seed=0):
        """Solve the general form directly with scipy, and the converted
        standard form with scipy, and compare objectives + recovered x."""
        from scipy.optimize import linprog

        glp._freeze()
        sense = 1.0 if glp.sense == "min" else -1.0
        # scipy solves min; encode rows as ub/lb pairs
        A_ub, b_ub = [], []
        A_eq, b_eq = [], []
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
            sense * glp.c,
            A_ub=np.array(A_ub) if A_ub else None,
            b_ub=np.array(b_ub) if b_ub else None,
            A_eq=np.array(A_eq) if A_eq else None,
            b_eq=np.array(b_eq) if b_eq else None,
            bounds=list(zip(glp.lb, [u if np.isfinite(u) else None for u in glp.ub])),
            method="highs",
        )
        assert res.status == 0, res.message
        obj_general = sense * res.fun + glp.f

        std, fmap = glp.to_standard_form()
        # standard form is max c'x + f, Ax<=b, x>=0 → scipy min −c'x
        res2 = linprog(
            -np.asarray(std.c),
            A_ub=np.asarray(std.A),
            b_ub=np.asarray(std.b),
            bounds=[(0, None)] * std.ncols,
            method="highs",
        )
        assert res2.status == 0, res2.message
        obj_std = -res2.fun + np.asarray(std.f)
        np.testing.assert_allclose(
            fmap.recover_objective(obj_std), obj_general, rtol=1e-7, atol=1e-8
        )
        x = fmap.recover_x(res2.x)
        np.testing.assert_allclose(glp.c @ x + glp.f, obj_general, rtol=1e-7, atol=1e-8)
        # recovered x satisfies original bounds and rows
        assert np.all(x >= glp.lb - 1e-8)
        assert np.all(x <= glp.ub + 1e-8)
        r = glp.A @ x
        assert np.all(r <= glp.row_ub + 1e-7)
        assert np.all(r >= glp.row_lb - 1e-7)

    def test_simple_min(self):
        # min x+y s.t. x+2y >= 2, 3x+y >= 3, x,y >= 0
        glp = GeneralLP(
            A=[[1, 2], [3, 1]],
            row_lb=[2, 3],
            c=[1, 1],
            sense="min",
        )
        self._check_against_scipy(glp)

    def test_max_with_upper_bounds(self):
        glp = GeneralLP(
            A=[[1, 1, 1], [2, 1, 0]],
            row_ub=[10, 8],
            c=[3, 2, 1],
            ub=[4, 4, 4],
            sense="max",
        )
        self._check_against_scipy(glp)

    def test_equality_rows_and_shifted_bounds(self):
        glp = GeneralLP(
            A=[[1, 1], [1, -1]],
            row_lb=[4, 1],
            row_ub=[4, np.inf],
            c=[1, 2],
            lb=[0.5, -1.0],
            ub=[np.inf, 5.0],
            f=2.0,
            sense="min",
        )
        self._check_against_scipy(glp)

    def test_free_variable_split(self):
        # min x − y s.t. x + y = 3, x − y ≤ 1; y free
        glp = GeneralLP(
            A=[[1, 1], [1, -1]],
            row_lb=[3, -np.inf],
            row_ub=[3, 1],
            c=[1, -1],
            lb=[0, -np.inf],
            ub=[np.inf, np.inf],
            sense="min",
        )
        self._check_against_scipy(glp)

    def test_reflected_variable(self):
        # variable with (-inf, u] bound only
        glp = GeneralLP(
            A=[[1, 1]],
            row_lb=[-np.inf],
            row_ub=[5],
            c=[-1, -1],
            lb=[0, -np.inf],
            ub=[np.inf, 2.0],
            sense="min",
        )
        self._check_against_scipy(glp)

    def test_incremental_build(self):
        glp = GeneralLP(c=[1, 1], row_lb=[2, 3], sense="min")
        glp.set_value(0, 0, 1.0)
        glp.set_value(0, 1, 2.0)
        glp.set_value(1, 0, 3.0)
        glp.set_value(1, 1, 1.0)
        self._check_against_scipy(glp)
