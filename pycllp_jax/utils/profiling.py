"""Profiling helpers: FLOP model + achieved-vs-peak accounting.

SURVEY.md §5: the benchmark harness must compute achieved-vs-peak for
the batched-Cholesky north star, so the per-iteration FLOP model lives
here, beside a thin ``jax.profiler`` wrapper.
"""

from __future__ import annotations

import contextlib
import os
import pathlib

import jax

__all__ = [
    "PEAKS", "device_peaks", "enable_compile_cache",
    "ipm_iteration_flops", "solve_flops", "achieved_tflops", "trace",
]

# Published dense peaks per device, keyed by ``jax.devices()[0].device_kind``.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, without
# sparsity, at the full 700 W power limit.  f32 is the CUDA-core rate
# (the solver runs f32 products at "highest" precision, not TF32).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_tflops": 67.0,
        "tf32_tflops": 495.0,
        "bf16_tflops": 989.0,
        "f64_tflops": 34.0,
        "f64_tensor_tflops": 67.0,
        "hbm_gbps": 3350.0,
    },
}


def device_peaks(device_kind: str) -> dict:
    """Peak rates of ``device_kind``; a device not in :data:`PEAKS` is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak rates recorded for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


def enable_compile_cache(root) -> str:
    """Point JAX's persistent compile cache at a fixed directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins and nothing is set in
    code (JAX reads the variable itself); otherwise the cache lives in
    ``<root>/.jax_cache``.  Returns the directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(pathlib.Path(root).resolve() / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def ipm_iteration_flops(m: int, n: int, n_rhs: int = 3) -> int:
    """FLOPs for one HSD iteration of one instance (dense, shared A).

    normal-eq formation 2·m²·n (as W@d: 2·m²·n), Cholesky m³/3,
    ``n_rhs`` forward+backward solves 2·n_rhs·m², ~8 A-matvecs 2·m·n
    each (residuals, sym_solve assemblies), vector ops O(n).
    """
    return int(
        2 * m * m * n  # M = W @ d
        + m**3 // 3  # Cholesky
        + 2 * n_rhs * 2 * m * m  # triangular solves
        + 8 * 2 * m * n  # matvecs
        + 20 * n  # elementwise
    )


def solve_flops(m: int, n: int, iterations, n_rhs: int = 3):
    """Total FLOPs for a batch: sum of per-instance iteration counts."""
    import numpy as np

    return int(np.sum(np.asarray(iterations)) * ipm_iteration_flops(m, n, n_rhs))


def achieved_tflops(total_flops: int, seconds: float) -> float:
    return total_flops / seconds / 1e12


@contextlib.contextmanager
def trace(log_dir: str):
    """``jax.profiler.trace`` wrapper (view with XProf/Perfetto)."""
    with jax.profiler.trace(log_dir):
        yield
