"""Former name of :mod:`pycllp_jax`, kept so that existing imports and
``python -m`` calls keep working.

Every submodule resolves to the very module object of ``pycllp_jax``: one
solver registry, one jit cache.
"""

import importlib
import pkgutil
import sys

import pycllp_jax

for _info in pkgutil.walk_packages(pycllp_jax.__path__, "pycllp_jax."):
    if not _info.name.endswith(".__main__"):
        _alias = __name__ + _info.name[len("pycllp_jax"):]
        sys.modules[_alias] = importlib.import_module(_info.name)
sys.modules[__name__] = pycllp_jax
