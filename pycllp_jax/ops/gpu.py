"""Pallas Triton kernel for the IPM hot path on NVIDIA GPUs.

The device analogue of pycllp's OpenCL work-item-per-LP kernels, laid
out batch-first: one Triton program owns one LP.

* Formation stays in XLA.  With a shared 2-D ``A`` the batch of normal
  matrices is ONE GEMM: ``M[b, (i,j)] = Σ_n d[b,n]·W[(i,j), n]`` with
  ``W[(i,j), n] = A[i,n]·A[j,n]`` precomputed per structure, which
  lands batch-first ``(B, m·m)`` straight out of cuBLAS.
* The Cholesky factorization stays in XLA (``lax.linalg.cholesky``,
  cuSOLVER's batched factor): a register-resident Triton factor was
  measured no faster end to end (PERF.md).
* The triangular solves are a Triton kernel.  XLA emits two batched
  triangular solves per right-hand side; here one program per LP
  applies ``(LLᵀ)⁻¹`` to all stacked right-hand sides in one launch,
  reading L one row at a time.  L is padded to the next power of two
  (Triton block shapes) with an identity block, which leaves the
  solutions unchanged.

Routing is by dtype and size: float64 and ``m > MAX_M`` go to the XLA
reference solves, float32 up to ``MAX_M`` to the Triton kernel.  The
kernel runs only on a GPU backend; interpret mode (the CPU tests) must
be asked for with ``TritonKernels(interpret=True)``.
"""

from __future__ import annotations

import functools
import typing

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from pycllp_jax.ops.reference import REFERENCE_KERNELS, PreparedA, ReferenceKernels

__all__ = ["TritonKernels", "TRITON_KERNELS", "select_kernels", "resolve_kernels"]

# Largest padded order the solve kernel takes: the orders compiled and
# timed against XLA on the card (PERF.md).  Larger ones go to XLA.
MAX_M = 64


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


# ---------------------------------------------------------------------------
# kernel body (one LP per program)
# ---------------------------------------------------------------------------


def _solve_kernel(l_ref, r_ref, v_ref, *, mp: int):
    """Solve ``L Lᵀ v = r`` for the ``kp`` stacked right-hand sides.

    Both substitutions read L one contiguous row at a time from the
    program's own block (L1-resident after the first touch): forward is
    row-oriented (v[k] = (r[k] − L[k,:k]·v[:k]) / L[k,k]), backward
    column-oriented in Lᵀ (v[:k] −= L[k,:k]·v[k]).  Each step costs
    O(kp·mp) work instead of a pass over the whole factor.
    """
    idx = jnp.arange(mp)
    v = r_ref[...]  # (kp, mp)

    def pick(v, k):
        return jnp.sum(jnp.where(idx[None, :] == k, v, 0.0), axis=1)  # (kp,)

    def fwd(k, v):
        row = l_ref[k, :]
        lkk = jnp.sum(jnp.where(idx == k, row, 0.0))
        acc = jnp.sum(jnp.where(idx[None, :] < k, v * row[None, :], 0.0), axis=1)
        vk = (pick(v, k) - acc) / lkk
        return jnp.where(idx[None, :] == k, vk[:, None], v)

    def bwd(i, v):
        k = mp - 1 - i
        row = l_ref[k, :]
        lkk = jnp.sum(jnp.where(idx == k, row, 0.0))
        vk = pick(v, k) / lkk
        v = v - vk[:, None] * jnp.where(idx < k, row, 0.0)[None, :]
        return jnp.where(idx[None, :] == k, vk[:, None], v)

    v = lax.fori_loop(0, mp, fwd, v)
    v_ref[...] = lax.fori_loop(0, mp, bwd, v)


# ---------------------------------------------------------------------------
# pallas_call wrappers
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("interpret",))
def solve_padded(L, R, *, interpret: bool = False):
    """L (B, mp, mp), R (B, kp, mp) with mp, kp powers of two → V."""
    B, kp, mp = R.shape
    rhs = pl.BlockSpec((None, kp, mp), lambda i: (i, 0, 0))
    return pl.pallas_call(
        functools.partial(_solve_kernel, mp=mp),
        grid=(B,),
        in_specs=[pl.BlockSpec((None, mp, mp), lambda i: (i, 0, 0)), rhs],
        out_specs=rhs,
        out_shape=jax.ShapeDtypeStruct(R.shape, R.dtype),
        name="pycllp_chol_solve",
        interpret=interpret,
        backend="triton",
        # one warp per LP (measured fastest at m <= 64; PERF.md)
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
    )(L, R)


def pad_matrix(M, mp: int):
    """Embed (B, m, m) into (B, mp, mp) with an identity trailing block
    (a Cholesky factor padded so stays the factor of the padded matrix)."""
    m = M.shape[-1]
    if mp == m:
        return M
    Mp = jnp.pad(M, ((0, 0), (0, mp - m), (0, mp - m)))
    tail = (jnp.arange(mp) >= m).astype(M.dtype)
    return Mp + jnp.diag(tail)


def stack_rhs(rs, mp: int):
    """Tuple of k (B, m) right-hand sides → zero-padded (B, kp, mp)."""
    k = len(rs)
    R = jnp.stack(rs, axis=1)
    return jnp.pad(R, ((0, 0), (0, _pow2(k) - k), (0, mp - R.shape[-1])))


# ---------------------------------------------------------------------------
# KernelSet implementation
# ---------------------------------------------------------------------------


class PreparedW(typing.NamedTuple):
    """Shared 2-D A context + the (m², n) self-outer-product W."""

    A: typing.Any
    Asq: typing.Any
    W: typing.Any


class TritonFactor(typing.NamedTuple):
    """Factor for the kernel solve: L is (B, mp, mp), padded to a power of 2."""

    ctx: typing.Any
    L: typing.Any
    d: typing.Any
    reg: typing.Any


class TritonKernels(ReferenceKernels):
    """Triton stacked solves; XLA formation, Cholesky and matvecs.

    float64, unbatched and ``m > MAX_M`` factors route to the XLA
    reference solves.  The float64 finish phase uses the reference set.
    """

    def __init__(self, interpret: bool = False):
        self.interpret = interpret
        self.name = "triton_interpret" if interpret else "triton"

    def _check_backend(self):
        if not self.interpret and jax.default_backend() != "gpu":
            raise RuntimeError(
                f"{self.name} kernels need a GPU backend, found "
                f"{jax.default_backend()!r}; use REFERENCE_KERNELS or "
                "TritonKernels(interpret=True)"
            )

    def prepare(self, A):
        if A.ndim != 2:
            return PreparedA(A=A, Asq=A * A)
        m, n = A.shape
        W = (A[:, None, :] * A[None, :, :]).reshape(m * m, n)
        return PreparedW(A=A, Asq=A * A, W=W)

    def normal_matrix(self, ctx, d):
        if isinstance(ctx, PreparedW) and d.ndim == 2:
            m = ctx.A.shape[0]
            return (d @ ctx.W.T.astype(d.dtype)).reshape(d.shape[0], m, m)
        return super().normal_matrix(ctx, d)

    def factor_matrix(self, ctx, M, d, reg):
        fac = super().factor_matrix(ctx, M, d, reg)
        m = M.shape[-1]
        if M.dtype != jnp.float32 or M.ndim != 3 or _pow2(m) > MAX_M:
            return fac
        return TritonFactor(ctx=ctx, L=pad_matrix(fac.L, _pow2(m)), d=d, reg=reg)

    def solve(self, fac, rs):
        if not isinstance(fac, TritonFactor):
            return super().solve(fac, rs)
        self._check_backend()
        R = stack_rhs(tuple(r.astype(fac.L.dtype) for r in rs), fac.L.shape[-1])
        V = solve_padded(fac.L, R, interpret=self.interpret)
        m = rs[0].shape[-1]
        return tuple(V[:, i, :m] for i in range(len(rs)))

    def finish_kernels(self):
        return REFERENCE_KERNELS

    def crossover_kernels(self, which):
        if which in ("mixed", "mixed1"):
            from pycllp_jax.ops.mixed import MixedPrecisionKernels

            return MixedPrecisionKernels.on(self, ir_steps=3 if which == "mixed" else 1)
        if which == "wide":
            return self.finish_kernels()
        raise ValueError(f"unknown crossover kernel set {which!r}")

    def __eq__(self, other):
        return type(other) is type(self) and other.interpret == self.interpret

    def __hash__(self):
        return hash((type(self), self.interpret))


TRITON_KERNELS = TritonKernels()


def select_kernels(backend: str | None = None):
    """The hot-path kernel set for a backend: Triton on a GPU, XLA else."""
    backend = backend or jax.default_backend()
    return TRITON_KERNELS if backend == "gpu" else REFERENCE_KERNELS


def resolve_kernels(kset=None):
    """``kset`` as given, or :func:`select_kernels` for ``None`` — the
    one place the solver entry points choose their default set."""
    return select_kernels() if kset is None else kset
