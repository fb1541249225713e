"""Numerical hot-path kernels (L1): reference XLA ops + Pallas Triton kernels."""

from pycllp_jax.ops.reference import (
    REFERENCE_KERNELS,
    KernelSet,
    NormalFactor,
    PreparedA,
    ReferenceKernels,
)

__all__ = [
    "REFERENCE_KERNELS",
    "KernelSet",
    "NormalFactor",
    "PreparedA",
    "ReferenceKernels",
]
