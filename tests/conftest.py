"""Test configuration: CPU backend with a virtual 8-device mesh + f64.

Mirrors the SURVEY.md §4 plan: the oracle chain runs in f64 on CPU;
multi-device sharding tests use ``xla_force_host_platform_device_count``
so collective-gated termination is exercised without several GPUs.
The platform is pinned to the CPU through ``jax.config`` so the suite
never opens a GPU, even on a machine that has one; tests that need the
card carry the ``gpu`` marker and run through ``chip_smoke.py``.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = _flags + " --xla_force_host_platform_device_count=8"

import jax

import pytest  # noqa: E402

# Fast/slow test tiers.  The full suite jit-compiles ~10 minutes of
# device programs; `pytest -m "not slow"` keeps a <~2-minute contract
# tier for gating individual commits (the full suite still runs per
# round).  Entries are (file, substring-of-test-name); a file with an
# empty name set marks the whole module.
_SLOW = {
    "test_schur.py": (),
    "test_warmstart.py": (),
    "test_twopass.py": (),
    "test_sweep.py": (),
    "test_distributed.py": (),
    "test_utils.py": ("test_diagnosis_shape",),
    "test_hsd.py": (
        "test_cross_backend_agreement",
        "TestGondzioCorrectors",
        "TestMehrotraStart",
        "test_float32_finish_float64",
        "test_general_with_bounds_and_sense",
    ),
    "test_shard.py": (
        "test_matches_unsharded",
        "test_batched_A_shards",
        "test_mixed_statuses_across_shards",
    ),
}


def pytest_configure(config):
    # `-m gpu` (chip_smoke.py's GPU test phase) keeps the process on its
    # card; every other selection runs on the local CPU devices.
    if config.getoption("markexpr", "") == "gpu":
        return
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    assert jax.default_backend() == "cpu", "tests must run on local CPU devices"
    assert jax.device_count() == 8, "expected 8 virtual CPU devices for sharding tests"


def pytest_collection_modifyitems(config, items):
    for item in items:
        fname = item.location[0].rsplit("/", 1)[-1]
        pats = _SLOW.get(fname)
        if pats is None:
            continue
        if not pats or any(p in item.nodeid for p in pats):
            item.add_marker(pytest.mark.slow)
