#!/usr/bin/env python3
"""Chip smoke test: the batched HSD solve end to end on an NVIDIA GPU.

Run from the repository root of a machine with a GPU:

    python3 chip_smoke.py           # one card: kernels, main path, user API
    python3 chip_smoke.py --four    # the multi-card paths on four cards

One process opens the card(s); every phase raises on failure and the
script exits non-zero.  It refuses to run without a GPU.  The last line
of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent

# kernel-phase tolerances, with their reasons
FORM_TOL = 1e-5  # f32 formation at "highest" vs f64; TF32 would land near 1e-3
BACKWARD_TOL = 1e-5  # per-lane backward error of factor + solve, ~m·ε_f32
CONTRACT_TOL = 1e-6  # the solver's objective contract, audited against scipy
# lanes of the 65,536-LP workload (seed 3) that an H100 run once left
# nearest the contract or above it; every audit of that workload adds them
EDGE_LANES = (12439, 22128, 24701, 34493, 42413, 46605)


def say(*a):
    print(*a, flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)
    say(f"  ok: {what}")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def _kernel_case(label, A, d, kset, B, reg_eps=2e-6):
    """Formation and factor+solve of ``kset`` against f64 XLA on one shape."""
    import jax
    import jax.numpy as jnp

    from pycllp_jax.ops.reference import REFERENCE_KERNELS

    m = A.shape[-2]
    rng = np.random.default_rng(1)
    rs = tuple(jnp.asarray(rng.standard_normal((B, m)), jnp.float32) for _ in range(3))
    A32, d32 = jnp.asarray(A, jnp.float32), jnp.asarray(d, jnp.float32)
    A64, d64 = A32.astype(jnp.float64), d32.astype(jnp.float64)

    t0 = time.time()
    with jax.default_matmul_precision("highest"):
        ctx = kset.prepare(A32)
        M32 = kset.normal_matrix(ctx, d32)
        fac = kset.factor(ctx, d32, reg_eps)
        vs = kset.solve(fac, rs)
    jax.block_until_ready(vs)
    say(f"[{label}] first call (compile + run): {time.time() - t0:.1f}s; "
        f"factor type {type(fac).__name__}, L {tuple(fac.L.shape)}")

    ctx64 = REFERENCE_KERNELS.prepare(A64)
    M64 = REFERENCE_KERNELS.normal_matrix(ctx64, d64)
    scale = jnp.max(jnp.abs(M64), axis=(-2, -1))
    form_err = float(jnp.max(jnp.max(jnp.abs(M32 - M64), axis=(-2, -1)) / scale))
    say(f"[{label}] formation max rel err vs f64: {form_err:.3e} (tol {FORM_TOL:.0e})")
    check(form_err <= FORM_TOL, f"{label}: f32 formation within {FORM_TOL:.0e} of f64")

    reg = fac.reg.astype(jnp.float64)
    Mreg = M64 + reg[:, None, None] * jnp.eye(m, dtype=jnp.float64)
    Mnorm = jnp.max(jnp.sum(jnp.abs(Mreg), axis=-1), axis=-1)
    fac64 = REFERENCE_KERNELS.factor_matrix(ctx64, M64, d64, reg)
    worst = 0.0
    for r, v in zip(rs, vs):
        v64, r64 = v.astype(jnp.float64), r.astype(jnp.float64)
        res = jnp.einsum("bij,bj->bi", Mreg, v64) - r64
        bwd = jnp.max(jnp.abs(res), -1) / (
            Mnorm * jnp.max(jnp.abs(v64), -1) + jnp.max(jnp.abs(r64), -1))
        worst = max(worst, float(jnp.max(bwd)))
        (vref,) = REFERENCE_KERNELS.solve(fac64, (r64,))
        fwd = float(jnp.max(jnp.abs(v64 - vref)) / jnp.max(jnp.abs(vref)))
    say(f"[{label}] factor+solve per-lane backward error max {worst:.3e} "
        f"(tol {BACKWARD_TOL:.0e}); forward diff vs f64 XLA {fwd:.3e} (information)")
    check(worst <= BACKWARD_TOL, f"{label}: backward error within {BACKWARD_TOL:.0e}")

    # a lane whose normal matrix is not PSD must come out NaN, alone
    d_bad = d32.at[1].set(-d32[1])
    with jax.default_matmul_precision("highest"):
        fac_b = kset.factor(ctx, d_bad, 0.0)
        (vb,) = kset.solve(fac_b, rs[:1])
    vb = np.asarray(vb)
    check(np.isnan(vb[1]).any() and np.isfinite(np.delete(vb, 1, 0)).all(),
          f"{label}: non-PSD lane is NaN, the other lanes finite")
    return fac, rs


def _memory_analysis(label, kset, fac, rs):
    """Compile the kernel call alone and print its memory analysis."""
    import functools

    import jax

    from pycllp_jax.ops import gpu

    if not isinstance(fac, gpu.TritonFactor):
        say(f"[{label}] solve routed to XLA: no kernel memory analysis")
        return
    R = gpu.stack_rhs(rs, fac.L.shape[-1])
    fn = functools.partial(gpu.solve_padded, interpret=kset.interpret)
    compiled = jax.jit(fn).lower(fac.L, R).compile()
    say(f"[{label}] solve kernel memory_analysis: {compiled.memory_analysis()}")


def kernel_phase(kset, lanes=(16384, 4096, 4096)):
    from pycllp_jax.io.generate import random_standard_lp
    from pycllp_jax.io.netlib import load_fixture

    say(f"== kernel phase: {kset.name} against f64 XLA ==")
    rng = np.random.default_rng(0)
    cases = []
    for label, m, n_std, B in (("throughput 64x128", 64, 64, lanes[0]),
                               ("batch32 32x64", 32, 32, lanes[1])):
        A = np.asarray(random_standard_lp(m, n_std, nlp=1, seed=3).to_equality_form().A)
        cases.append((label, A, B))
    # netlib bucket (56 rows: adlittle) as per-instance 3-D A, padded to 64
    std = load_fixture("adlittle").lp.to_standard_form()[0]
    A1 = np.concatenate([np.asarray(std.A), np.eye(std.A.shape[0])], axis=1)
    B3 = lanes[2]
    A3 = A1[None] * (1.0 + 0.01 * rng.standard_normal((B3,) + A1.shape))
    cases.append((f"netlib 3-D {A1.shape[0]}x{A1.shape[1]}", A3, B3))
    for label, A, B in cases:
        n = A.shape[-1]
        # d spread over [1e-3, 1e3], like a mid-IPM iterate
        d = 10.0 ** rng.uniform(-3, 3, (B, n))
        t0 = time.time()
        fac, rs = _kernel_case(label, A, d, kset, B)
        _memory_analysis(label, kset, fac, rs)
        say(f"[{label}] phase seconds: {time.time() - t0:.1f}")


# ---------------------------------------------------------------------------
# main path phase
# ---------------------------------------------------------------------------


def main_path_phase(kset, card, total=65536):
    import jax

    import bench
    from pycllp_jax import Status
    from pycllp_jax.io.generate import random_standard_lp
    from pycllp_jax.solvers.hsd import hsd_solve_scan

    m, n_std = 64, 64
    say(f"== main path: {total} LPs of {m}x{n_std} through hsd_solve_scan ({kset.name}) ==")
    lp = random_standard_lp(m, n_std, nlp=total, seed=3, dtype=np.float32)
    eq = lp.to_equality_form()
    A = jax.device_put(np.asarray(eq.A, np.float32))
    b = jax.device_put(np.asarray(eq.b, np.float32))
    c = jax.device_put(np.asarray(eq.c, np.float32))
    opts = bench.bench_options()

    def solve():
        out = hsd_solve_scan(
            A, b, c, opts, kset, chunk=bench.CHUNK,
            keys=("objective", "status", "iterations"),
            compact_cap=bench.CAP or None, compact_bucket=bench.BUCKET,
            finish_cap=bench.FINISH_CAP, finish_bucket=bench.FINISH_BUCKET,
        )
        return {k: np.asarray(v) for k, v in out.items()}

    t0 = time.time()
    solve()
    say(f"main path warm-up (compile + run): {time.time() - t0:.1f}s")
    t0 = time.time()
    out = solve()
    dt = time.time() - t0
    say(f"main path timed repeat: {dt:.3f}s = {total / dt:.0f} LP/s on {card} "
        "(information, not a claim)")
    st = out["status"]
    uniq, counts = np.unique(st, return_counts=True)
    say(f"statuses: {dict(zip(uniq.tolist(), counts.tolist()))}; iterations "
        f"p50/p99 {np.percentile(out['iterations'], 50):.0f}/"
        f"{np.percentile(out['iterations'], 99):.0f}")
    check(bool((st == int(Status.OPTIMAL)).all()), f"all {total} lanes OPTIMAL at tol {opts.tol}")
    edge = [i for i in EDGE_LANES if i < total]
    audit = bench.accuracy_check(lp, out["objective"], n_std, total, status=st, extra=edge)
    check(audit <= CONTRACT_TOL, f"scipy audit max rel err {audit:.2e} <= {CONTRACT_TOL:.0e}")


def user_api_phase(B=10000):
    from scipy.optimize import linprog

    import pycllp_jax as tp
    from pycllp_jax.io.generate import random_standard_lp

    say("== user API: README example through get_solver('hsd') ==")
    m, n = 20, 30
    gen = random_standard_lp(m, n, nlp=2 * B, seed=5)
    A = np.asarray(gen.A)
    b_all, c_all = np.asarray(gen.b), np.asarray(gen.c)
    lp = tp.StandardLP(A=A, b=b_all[:B], c=c_all[:B])
    solver = tp.get_solver("hsd", tol=1e-6, dtype="float32", finish_dtype="float64")
    t0 = time.time()
    solver.init(lp)
    sol = solver.solve()
    say(f"first solve (compile + run): {time.time() - t0:.1f}s, {sol}")
    lp.b = b_all[B:]
    t0 = time.time()
    sol2 = solver.solve(lp)
    say(f"second solve with new b: {time.time() - t0:.1f}s, {sol2}")
    o1, o2 = np.asarray(sol.objective), np.asarray(sol2.objective)
    check(o1.shape == o2.shape == (B,), f"objective shapes ({B},)")
    check(bool(np.all(np.isfinite(o1)) and np.all(np.isfinite(o2))), "finite objectives")
    check(float(np.mean(o1 != o2)) > 0.99, "new b changes the objectives")
    for st in (sol.status, sol2.status):
        uniq, counts = np.unique(np.asarray(st), return_counts=True)
        say(f"statuses: {dict(zip(uniq.tolist(), counts.tolist()))}")
    worst = 0.0
    for i in np.linspace(0, B - 1, 16, dtype=int):
        for obj, bb in ((o1, b_all[i]), (o2, b_all[B + i])):
            res = linprog(-c_all[i], A_ub=A, b_ub=bb, bounds=[(0, None)] * n, method="highs")
            if res.status == 0:
                worst = max(worst, abs(obj[i] - (-res.fun)) / max(1.0, abs(res.fun)))
    check(worst <= CONTRACT_TOL, f"sampled objectives match scipy (max rel {worst:.2e})")


def gpu_tests_phase():
    """The repository's GPU-marked tests, in this process, on this card."""
    import pytest

    class Tally:
        passed = failed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.skipped:
                self.skipped += 1
            elif report.failed:
                self.failed += 1
            elif report.when == "call":
                self.passed += 1

    say("== GPU-marked tests (pytest -m gpu) ==")
    tally = Tally()
    rc = pytest.main(
        [str(ROOT / "tests" / "test_gpu.py"), "-m", "gpu", "-n", "0", "-q",
         "-p", "no:cacheprovider", "--rootdir", str(ROOT)],
        plugins=[tally],
    )
    say(f"gpu tests: {tally.passed} passed, {tally.failed} failed, {tally.skipped} skipped")
    check(rc == 0 and tally.passed > 0 and not tally.failed and not tally.skipped,
          "every GPU-marked test ran and passed")


# ---------------------------------------------------------------------------
# four-card phase
# ---------------------------------------------------------------------------


def four_phase(kset, per=16384, schur=(256, 2048, 8)):
    import bench
    from pycllp_jax import SolverOptions
    from pycllp_jax.io.generate import random_equality_lp, random_standard_lp
    from pycllp_jax.parallel import (
        column_sharded_hsd_solve, model_mesh, scenario_mesh, sharded_hsd_solve,
    )

    m, n_std = 64, 64
    total = 4 * per
    say(f"== four cards: sharded_hsd_solve, 4 x {per} LPs of {m}x{n_std} ==")
    lp = random_standard_lp(m, n_std, nlp=total, seed=3, dtype=np.float32)
    eq = lp.to_equality_form()
    A, b, c = (np.asarray(v, np.float32) for v in (eq.A, eq.b, eq.c))
    opts = bench.bench_options()
    keys = ("objective", "status")
    edge = [i for i in EDGE_LANES if i < total]

    def pull(out):
        return {k: np.asarray(out[k]) for k in keys}

    def statuses(st):
        return dict(zip(*[a.tolist() for a in np.unique(st, return_counts=True)]))

    # the same work on one card: the whole batch in one solve
    t0 = time.time()
    ref = pull(sharded_hsd_solve(A, b, c, opts, mesh=scenario_mesh(1), kset=kset))
    say(f"[1 card] {time.time() - t0:.1f}s incl. compile; statuses {statuses(ref['status'])}")
    for term in ("collective", "local"):
        t0 = time.time()
        out = pull(sharded_hsd_solve(A, b, c, opts, mesh=scenario_mesh(4), kset=kset,
                                     termination=term))
        say(f"[4 cards, {term}] {time.time() - t0:.1f}s incl. compile; statuses "
            f"{statuses(out['status'])}")
        check(bool((out["status"] == ref["status"]).all()), f"{term}: statuses equal the 1-card run")
        rel = np.abs(out["objective"] - ref["objective"]) / np.maximum(1.0, np.abs(ref["objective"]))
        say(f"[4 cards, {term}] lanes differing from the 1-card run: {int((rel > 0).sum())}")
        check(float(rel.max()) <= CONTRACT_TOL, f"{term}: objectives within 1e-6 of 1-card ({rel.max():.2e})")
        audit = bench.accuracy_check(lp, out["objective"], n_std, total,
                                     status=out["status"], extra=edge)
        check(audit <= CONTRACT_TOL, f"{term}: scipy audit max rel err {audit:.2e} <= {CONTRACT_TOL:.0e}")

    ms, ns, B = schur
    say(f"== four cards: column_sharded_hsd_solve(factor='sharded'), {B} LPs of {ms}x{ns} ==")
    from scipy.optimize import linprog

    rng = np.random.default_rng(0)
    A2, b0, c0 = random_equality_lp(ms, ns, seed=9)
    b2 = np.stack([b0 * (1 + 0.05 * rng.random(ms)) for _ in range(B)]).astype(np.float32)
    c2 = np.stack([c0 + 0.02 * rng.random(ns) for _ in range(B)]).astype(np.float32)
    A2 = A2.astype(np.float32)
    sopts = SolverOptions(
        tol=1e-6, dtype="float32", maxiter=60, init_point="mehrotra",
        stall_patience=6, finish_dtype="float64", switch_tol=1e-4, finish_maxiter=40,
    )
    outs = {}
    for nd, fac in ((1, "replicated"), (4, "sharded")):
        t0 = time.time()
        o = column_sharded_hsd_solve(A2, b2, c2, sopts, mesh=model_mesh(nd), factor=fac)
        outs[nd] = {k: np.asarray(o[k]) for k in ("objective", "status")}
        say(f"[{nd} card(s), factor={fac}] {time.time() - t0:.1f}s incl. compile; "
            f"statuses {outs[nd]['status'].tolist()}")
    check(bool((outs[4]["status"] == outs[1]["status"]).all()), "schur: statuses equal the 1-card run")
    rel = np.abs(outs[4]["objective"] - outs[1]["objective"]) / np.maximum(1.0, np.abs(outs[1]["objective"]))
    check(float(rel.max()) <= CONTRACT_TOL, f"schur: objectives within 1e-6 of 1-card ({rel.max():.2e})")
    res = linprog(c2[0].astype(np.float64), A_eq=A2.astype(np.float64),
                  b_eq=b2[0].astype(np.float64), bounds=[(0, None)] * ns, method="highs")
    rel0 = abs(outs[4]["objective"][0] - res.fun) / max(1.0, abs(res.fun))
    check(res.status == 0 and rel0 <= CONTRACT_TOL, f"schur lane 0 vs scipy: {rel0:.2e}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the multi-card paths, on four cards")
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})", file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke: need {need} GPUs, JAX sees {len(devices)}", file=sys.stderr)
        return 2

    sys.path.insert(0, str(ROOT))
    import bench

    bench.setup_jax()
    cache_dir = jax.config.jax_compilation_cache_dir
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    say(f"nvidia-smi: {card}")
    say(f"jax {jax.__version__}; devices {devices}; compile cache {cache_dir}")
    card = card.splitlines()[0]

    kset = bench.get_kset()
    t_all = time.time()
    if args.four:
        four_phase(kset)
    else:
        t0 = time.time()
        kernel_phase(kset)
        say(f"kernel phase: {time.time() - t0:.1f}s")
        t0 = time.time()
        main_path_phase(kset, card)
        say(f"main path phase: {time.time() - t0:.1f}s")
        t0 = time.time()
        user_api_phase()
        say(f"user API phase: {time.time() - t0:.1f}s")
        t0 = time.time()
        gpu_tests_phase()
        say(f"GPU tests phase: {time.time() - t0:.1f}s")
    say(f"total: {time.time() - t_all:.1f}s")
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": need}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
