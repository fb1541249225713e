"""Problem-definition layer (upstream parity: ``pycllp/lp.py``)."""

from pycllp_jax.models.sparse import SparseMatrixBuilder
from pycllp_jax.models.lp import (
    BaseLP,
    EqualityLP,
    GeneralLP,
    StandardFormMap,
    StandardLP,
)

__all__ = [
    "BaseLP",
    "EqualityLP",
    "GeneralLP",
    "SparseMatrixBuilder",
    "StandardFormMap",
    "StandardLP",
]
