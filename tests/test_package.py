"""The package under its former name resolves to the very same modules."""

import importlib
import os
import pathlib
import pkgutil
import subprocess
import sys

import pytest

import pycllp_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
ALIASES = sorted(
    m.name for m in pkgutil.iter_modules([str(ROOT)])
    if m.ispkg and m.name.startswith("pycllp_") and m.name != "pycllp_jax"
)


def test_one_alias_package():
    assert len(ALIASES) == 1, ALIASES


@pytest.mark.parametrize("sub", ["solvers.hsd", "ops.gpu", "parallel.shard", "io.netlib"])
def test_alias_submodule_is_the_same_object(sub):
    assert importlib.import_module(ALIASES[0]) is pycllp_jax
    alias_mod = importlib.import_module(f"{ALIASES[0]}.{sub}")
    assert alias_mod is importlib.import_module(f"pycllp_jax.{sub}")


def test_alias_runs_the_cli():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-m", ALIASES[0], "info"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert "solvers:" in res.stdout and "hsd" in res.stdout
