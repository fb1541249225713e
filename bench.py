"""Benchmark harness (BASELINE.md eval configs).

Default mode measures config 3 — 65,536 dense 64x64 LPs, f32, one chip —
and prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "LP/s", "vs_baseline": N/1e5}
Diagnostics go to stderr.

Env knobs:
  BENCH_MODE     throughput (default) | batch32 | netlib | weak | sweep |
                 correctness | schur | all
  BENCH_KSET     triton | reference   (kernel set for the hot path;
                                       default: the backend's own choice,
                                       pycllp_jax.ops.gpu.select_kernels)
  BENCH_TOTAL / BENCH_CHUNK / BENCH_M / BENCH_N / BENCH_REPEATS
  BENCH_CAP / BENCH_BUCKET   fused compact-resume sweep (CAP=0 disables)

The compile cache lives in ``$JAX_COMPILATION_CACHE_DIR`` when that is
set, else in ``.jax_cache/`` beside this file.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import time
import traceback

import numpy as np

import jax

from pycllp_jax import SolverOptions, Status  # noqa: E402
from pycllp_jax.io.generate import random_standard_lp  # noqa: E402
from pycllp_jax.solvers.hsd import hsd_solve_batched, hsd_solve_scan  # noqa: E402
from pycllp_jax.utils.profiling import enable_compile_cache  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent

BASELINE_LPS_PER_SEC = 1.0e5  # BASELINE.json north-star
CONTRACT_TOL = 1e-6  # max objective rel-err vs scipy of the finish config

MODE = os.environ.get("BENCH_MODE", "throughput")
M = int(os.environ.get("BENCH_M", 64))
N = int(os.environ.get("BENCH_N", 64))
TOTAL = int(os.environ.get("BENCH_TOTAL", 65536))
CHUNK = int(os.environ.get("BENCH_CHUNK", 16384))
REPEATS = int(os.environ.get("BENCH_REPEATS", 3))
# fused cap/compact/warm-resume sweep (0 disables): chunk cost is its
# slowest lane, so cap every chunk at CAP iterations and finish the
# ~6% tail compacted into one BUCKET-wide warm-resumed batch
CAP = int(os.environ.get("BENCH_CAP", 12))
BUCKET = int(os.environ.get("BENCH_BUCKET", 5120))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def setup_jax():
    """Process-wide JAX settings of every bench entry point."""
    enable_compile_cache(ROOT)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    # the contract-meeting headline runs an f64 finish phase — x64 must
    # be on for the wide stages to be genuinely wide.  The narrow stages
    # are explicitly f32 via opts.dtype.
    jax.config.update("jax_enable_x64", True)


def get_kset():
    from pycllp_jax.ops.gpu import TRITON_KERNELS, select_kernels
    from pycllp_jax.ops.reference import REFERENCE_KERNELS

    name = os.environ.get("BENCH_KSET")
    if name is None:
        return select_kernels()
    return {"triton": TRITON_KERNELS, "reference": REFERENCE_KERNELS}[name]


FINISH = os.environ.get("BENCH_FINISH", "1") != "0"
FINISH_CAP = int(os.environ.get("BENCH_FINISH_CAP", 3))
FINISH_GONDZIO = int(os.environ.get("BENCH_FINISH_GONDZIO", 0))
FINISH_MAXITER = int(os.environ.get("BENCH_FINISH_MAXITER", 20))
# crossover finish is the contract default: one wide basis solve per
# lane instead of a wide IPM phase, with the rejects drained through
# the fallback bucket.
FINISH_MODE = os.environ.get("BENCH_FINISH_MODE", "crossover")
# stage-4 drain bucket: the drain rounds make a small bucket
# overflow-PROOF — a reject volume beyond one bucket just takes more
# skipped-when-empty rounds — and a float64 tier's cost scales with the
# bucket width, so small is fast.
FINISH_BUCKET = int(os.environ.get("BENCH_FINISH_BUCKET", 1024)) or None
# crossover engine knobs: basis solves on the mixed set (f32 factor +
# f64 refinement) with batched basis-repair rounds
CROSSOVER_KSET = os.environ.get("BENCH_CROSSOVER_KSET", "mixed1")
REPAIR = int(os.environ.get("BENCH_REPAIR", 2))
# refine=2: the basis-solve IR is the verification limiter; past 2
# sweeps the acceptance curve flattens (the remainder is the
# high-cond(B)^2 tail owned by the floored float64 tiers).
CROSSOVER_REFINE = int(os.environ.get("BENCH_CROSSOVER_REFINE", 2))
CROSSOVER_FEAS = float(
    os.environ.get("BENCH_CROSSOVER_FEAS", os.environ.get("BENCH_FEAS", 1e-9))
)
# KKT-level refinement of each narrow Newton direction: one extra solve
# per pass through the SAME factorization.  For the crossover finish
# this is the acceptance knob: more passes, more lanes accept their
# first basis guess, which sizes the wide fallback bucket.
KKT = int(os.environ.get("BENCH_KKT", 3))
# narrow iterations at kkt_refine=0 before refinement engages (0: the
# unrefined early directions bend the whole f32 trajectory, so a
# warmup costs crossover acceptance).
KKT_WARMUP = int(os.environ.get("BENCH_KKT_WARMUP", 0))
# predictor-direction KKT sweeps (<0 = follow BENCH_KKT): the predictor
# only gauges mu_aff and feeds the corrector's second-order products,
# so it tolerates fewer sweeps than the corrector that is taken.
KKT_PRED = int(os.environ.get("BENCH_KKT_PRED", 0))
TOL = float(os.environ.get("BENCH_TOL", 0)) or None


def bench_options() -> SolverOptions:
    # headline config: f32 bulk at the 1e-5 indicator floor (early stall
    # cutoff, Mehrotra least-squares start), then a float64 finish
    # phase polishing EVERY lane to the 1e-6 contract (BASELINE.md
    # "Correctness" row).  BENCH_FINISH=0 gives the round-1 narrow-only
    # best-effort config (~1e-4 objective accuracy) for comparison.
    fin = (
        dict(
            finish_dtype="float64",
            switch_tol=float(os.environ.get("BENCH_SWITCH_TOL", 1e-5)),
            finish_maxiter=FINISH_MAXITER,
            finish_gondzio=FINISH_GONDZIO,
            finish_mode=FINISH_MODE,
            crossover_kset=CROSSOVER_KSET,
            crossover_repair=REPAIR,
            crossover_refine=CROSSOVER_REFINE,
            crossover_feas_tol=CROSSOVER_FEAS,
            # explicit: narrow kkt_refine is the crossover-acceptance
            # knob; the wide phases' genuine-f64 directions don't need it
            finish_kkt_refine=int(os.environ.get("BENCH_FINISH_KKT", 0)),
        )
        if FINISH
        else {}
    )
    # tol 1e-6 — the contract tolerance: rho_A normalizes by max(τ, |bᵀy|),
    # i.e. the de-embedded |gap| over max(1, |obj|), the quantity the
    # audit checks.  The residuals add to the objective error, so lanes
    # the wide IPM finishes stop at opts.finish_tol(), a decade under.
    return SolverOptions(
        tol=TOL or (1e-6 if FINISH else 1e-5),
        maxiter=int(os.environ.get("BENCH_MAXITER", 40)),
        dtype="float32",
        stall_patience=int(os.environ.get("BENCH_PATIENCE", 3)),
        stall_rtol=float(os.environ.get("BENCH_STALL_RTOL", 0.05)),
        refine_steps=0,
        kkt_refine=KKT,
        kkt_refine_pred=(None if KKT_PRED < 0 else KKT_PRED),
        kkt_warmup=KKT_WARMUP,
        # narrow-phase Gondzio correctors: a crossover-acceptance knob
        # like kkt_refine (better-centred narrow points name their basis)
        gondzio_correctors=int(os.environ.get("BENCH_GONDZIO", 0)),
        init_point="mehrotra",
        **fin,
    )


def emit(metric, value, unit, vs_baseline):
    print(
        json.dumps(
            {
                "metric": metric,
                "value": round(float(value), 1),
                "unit": unit,
                "vs_baseline": round(float(vs_baseline), 4),
            }
        )
    )


def accuracy_check(lp, objective, n, total, status=None, n_sample=64, extra=()):
    """Scipy audit: ``n_sample`` evenly spaced lanes, the ``extra``
    lanes, PLUS every non-OPTIMAL lane, so stragglers carry no
    unmeasured error.  Returns the max relative objective error over the
    lanes scipy solves; an audit that cannot run raises.  The sample is a
    smoke signal: the solver verifies each crossover vertex on device,
    and its wide IPM runs each lane toward ``opts.finish_tol()``."""
    from scipy.optimize import linprog

    idx = set(np.linspace(0, total - 1, n_sample, dtype=int).tolist()) | set(extra)
    n_straggler = 0
    if status is not None:
        stragglers = np.flatnonzero(np.asarray(status) != int(Status.OPTIMAL))
        n_straggler = len(stragglers)
        idx |= set(stragglers.tolist())
    rels = []
    for i in sorted(idx):
        res = linprog(
            -np.asarray(lp.c)[i].astype(np.float64),
            A_ub=np.asarray(lp.A, np.float64),
            b_ub=np.asarray(lp.b)[i].astype(np.float64),
            bounds=[(0, None)] * n,
            method="highs",
        )
        if res.status == 0:
            std_obj = -float(objective[i])  # equality obj is negated
            rels.append(abs(std_obj - (-res.fun)) / max(1.0, abs(res.fun)))
    if not rels:
        raise RuntimeError("scipy audit: no audited lane has an optimum")
    log(
        f"objective rel-err vs scipy ({len(rels)} lanes incl. "
        f"{n_straggler} non-OPTIMAL): max {max(rels):.2e} mean {np.mean(rels):.2e}"
    )
    return max(rels)


def require_contract(rel: float, what: str):
    """Raise when an audited objective error exceeds the contract."""
    if not rel <= CONTRACT_TOL:
        raise RuntimeError(f"{what}: objective rel-err {rel:.2e} vs scipy > {CONTRACT_TOL:.0e}")


def run_throughput(m=M, n=N, total=TOTAL, chunk=CHUNK, emit_json=True):
    log(f"devices: {jax.devices()}")
    kset = get_kset()
    log(f"kernel set: {kset.name}")
    lp = random_standard_lp(m, n, nlp=total, seed=3, dtype=np.float32)
    eq = lp.to_equality_form()
    # scenario data staged on device ONCE (real deployments keep the
    # scenario stream resident), so the timed window holds no uploads
    A = jax.device_put(np.asarray(eq.A, np.float32))
    b_all = jax.device_put(np.asarray(eq.b, np.float32))
    c_all = jax.device_put(np.asarray(eq.c, np.float32))
    opts = bench_options()
    keys = ("objective", "status", "iterations")

    def solve_all():
        # ONE device program: lax.scan over chunks (single dispatch);
        # the result pull below is the only trustworthy sync
        out = hsd_solve_scan(
            A, b_all, c_all, opts, kset, chunk=chunk, keys=keys,
            compact_cap=CAP or None, compact_bucket=BUCKET,
            finish_cap=FINISH_CAP, finish_bucket=FINISH_BUCKET,
        )
        return out["objective"], out["status"], out["iterations"]

    t0 = time.time()
    out = solve_all()
    np.asarray(out[0])
    log(f"warmup (incl compile): {time.time() - t0:.1f}s")

    best = float("inf")
    for r in range(REPEATS):
        t0 = time.time()
        objective, status, iterations = solve_all()
        objective = np.asarray(objective)
        dt = time.time() - t0
        best = min(best, dt)
        log(f"repeat {r}: {dt:.3f}s -> {total / dt:.0f} LP/s")

    status = np.asarray(status)
    iterations = np.asarray(iterations)
    uniq, counts = np.unique(status, return_counts=True)
    log(f"statuses: {dict(zip(uniq.tolist(), counts.tolist()))}")
    pct = np.percentile(iterations, [50, 90, 99])
    log(
        f"iterations min/mean/max: {iterations.min()}/{iterations.mean():.1f}/"
        f"{iterations.max()}  p50/p90/p99: {pct[0]:.0f}/{pct[1]:.0f}/{pct[2]:.0f}"
    )
    audit = accuracy_check(lp, objective, n, total, status=status)
    if FINISH:  # the narrow-only config makes no contract
        require_contract(audit, f"throughput {m}x{n}")

    # achieved-vs-peak (SURVEY.md §5): FLOP model over actual iteration counts
    from pycllp_jax.utils.profiling import achieved_tflops, device_peaks, solve_flops

    kind = jax.devices()[0].device_kind
    m_eq, n_eq = m, n + m  # equality form after slack augmentation
    tf = achieved_tflops(solve_flops(m_eq, n_eq, iterations), best)
    log(
        f"achieved {tf:.2f} TFLOP/s (useful-FLOP model) = "
        f"{100 * tf / device_peaks(kind)['f32_tflops']:.1f}% of {kind} f32 peak"
    )

    lps = total / best
    if emit_json:
        emit("LPs solved/sec/chip (batched 64x64 dense)", lps, "LP/s", lps / BASELINE_LPS_PER_SEC)
    return lps


def run_batch32():
    lps = run_throughput(m=32, n=32, total=4096, chunk=1024, emit_json=False)
    emit("LPs solved/sec/chip (batched 32x32 dense)", lps, "LP/s", lps / BASELINE_LPS_PER_SEC)


def run_netlib():
    """Config 4: heterogeneous netlib batch, BUCKETED by padded size
    (VERDICT r1 item 10: round-1 padded every problem to the global max).

    Buckets holding one distinct structure take the shared-A fast path
    (2-D A, Pallas W-trick kernels); genuinely mixed buckets pad within
    the bucket and run the per-instance (3-D A) path.  Per-replica b is
    perturbed scenario-style so the batch isn't 512 copies of one solve.
    """
    from pycllp_jax.io.netlib import bucket_problems, fixture_names, load_fixture, pad_and_mask

    names = fixture_names()
    probs = [load_fixture(nm) for nm in names]
    stds = [p.lp.to_standard_form()[0] for p in probs]
    reps = int(os.environ.get("BENCH_NETLIB_REPS", 512))
    rng = np.random.default_rng(7)
    opts = bench_options()
    kset = get_kset()
    buckets = bucket_problems(stds)
    log(f"netlib buckets: { {k: [names[i] for i in v] for k, v in buckets.items()} }")

    staged = []
    for key, idxs in sorted(buckets.items()):
        if len(idxs) == 1:
            # one structure → shared-A fast path
            eq = stds[idxs[0]].to_equality_form()
            A = jax.device_put(np.asarray(eq.A, np.float32))
            scale = (1.0 + 0.1 * rng.random((reps, 1))).astype(np.float32)
            b = jax.device_put(np.asarray(eq.b, np.float32).reshape(1, -1) * scale)
            c = jax.device_put(
                np.broadcast_to(
                    np.asarray(eq.c, np.float32).reshape(1, -1), (reps, eq.c.shape[-1])
                ).copy()
            )
            staged.append((names[idxs[0]], A, b, c))
        else:
            Ab, bb, cb, _, _ = pad_and_mask([stds[i] for i in idxs], np.float32)
            mm = Ab.shape[1]
            eye = np.broadcast_to(np.eye(mm, dtype=np.float32), (Ab.shape[0], mm, mm))
            A_eq = np.concatenate([Ab, eye], axis=2)
            c_eq = np.concatenate([-cb, np.zeros((Ab.shape[0], mm), np.float32)], axis=1)
            A_eq = np.repeat(A_eq, reps, 0)
            scale = (1.0 + 0.1 * rng.random((A_eq.shape[0], 1))).astype(np.float32)
            b_r = np.repeat(bb, reps, 0) * scale
            c_r = np.repeat(c_eq, reps, 0)
            staged.append(
                ("+".join(names[i] for i in idxs),
                 jax.device_put(A_eq), jax.device_put(b_r), jax.device_put(c_r))
            )

    def solve_all():
        outs = [hsd_solve_batched(A, b, c, opts, kset) for _, A, b, c in staged]
        return [np.asarray(o["objective"]) for o in outs]

    t0 = time.time()
    solve_all()
    log(f"warmup: {time.time()-t0:.1f}s")
    t0 = time.time()
    solve_all()
    dt = time.time() - t0
    total = sum(b.shape[0] for _, _, b, _ in staged)
    log(f"netlib bucketed batch ({total} over {len(staged)} buckets): {dt:.3f}s")
    emit("netlib bucketed heterogeneous LPs/s", total / dt, "LP/s", (total / dt) / BASELINE_LPS_PER_SEC)


def run_weak():
    """Weak scaling: iterations/s with the scenario batch sharded over
    1..n_devices (per-device batch held constant), at bench-realistic
    shapes (64×64, BENCH_PER_DEV ≥ 4096 lanes/device — VERDICT r3 weak
    item 5), for BOTH termination modes: ``collective`` (in-loop pmax
    gate, every shard steps in lockstep) and ``local`` (independent
    shard loops, no per-iteration sync).  Emits the collective-mode
    efficiency as the JSON line; the full curve goes to stderr (and
    docs/PERFORMANCE.md).
    """
    from pycllp_jax.parallel import scenario_mesh, sharded_hsd_solve

    n_dev_total = jax.device_count()
    per_dev = int(os.environ.get("BENCH_PER_DEV", 4096))
    # fixed work for a scaling measurement: narrow IPM only (the finish
    # phase's gather/drain stages are batch-global, not per-iteration),
    # uncapped by tolerance or the stall clock
    opts = bench_options().replace(
        maxiter=20, stall_patience=100, tol=1e-12, kkt_refine=0,
        finish_dtype=None,
    )
    lp = random_standard_lp(M, N, nlp=per_dev * n_dev_total, seed=3, dtype=np.float32)
    eq = lp.to_equality_form()
    A = np.asarray(eq.A, np.float32)
    sizes = [s for s in (1, 2, 4, 8, 16) if s <= n_dev_total]
    results = {}
    for term in ("collective", "local"):
        for nd in sizes:
            mesh = scenario_mesh(nd)
            B = per_dev * nd
            b = np.asarray(eq.b[:B], np.float32)
            c = np.asarray(eq.c[:B], np.float32)
            out = sharded_hsd_solve(A, b, c, opts, mesh=mesh, termination=term)
            np.asarray(out["objective"])  # warm
            t0 = time.time()
            out = sharded_hsd_solve(A, b, c, opts, mesh=mesh, termination=term)
            iters = np.asarray(out["iterations"])
            dt = time.time() - t0
            it_per_s = iters.sum() / dt
            results[(term, nd)] = it_per_s
            log(
                f"weak scaling [{term}] {nd} dev: {B} lanes, {iters.sum()} "
                f"lane-iters in {dt:.3f}s -> {it_per_s:.0f} it/s"
            )
    for term in ("collective", "local"):
        base = results[(term, sizes[0])]
        curve = [
            f"{nd}dev {100 * results[(term, nd)] / (base * nd / sizes[0]):.1f}%"
            for nd in sizes
        ]
        log(f"weak-scaling efficiency [{term}]: {' '.join(curve)}")
    eff = results[("collective", sizes[-1])] / (
        results[("collective", sizes[0])] * sizes[-1] / sizes[0]
    )
    emit("weak-scaling efficiency (iterations/s)", 100 * eff, "%", eff / 0.90)


def run_sweep():
    from pycllp_jax.utils.sweep import scenario_sweep

    total = int(os.environ.get("BENCH_TOTAL", 131072))
    lp = random_standard_lp(M, N, nlp=total, seed=3, dtype=np.float32)
    eq = lp.to_equality_form()
    # scenario stream staged on device once (as in run_throughput)
    A = jax.device_put(np.asarray(eq.A, np.float32))
    b = jax.device_put(np.asarray(eq.b, np.float32))
    c = jax.device_put(np.asarray(eq.c, np.float32))
    # window/bucket sized to REUSE the headline config's compiled
    # programs verbatim (same (K, chunk) shapes and static opts): a
    # window of 4 chunks at the headline bucket makes the sweep pay
    # ZERO new compiles after a throughput run (the r3 sweep config
    # "timed out compiling" — VERDICT r3 item 3/5)
    kw = dict(chunk=CHUNK, kset=get_kset(), compact_cap=CAP or None,
              compact_bucket=BUCKET, window_chunks=4,
              finish_cap=FINISH_CAP, finish_bucket=FINISH_BUCKET)
    res = scenario_sweep(A, b, c, bench_options(), **kw)  # warm incl compile
    t0 = time.time()
    res = scenario_sweep(A, b, c, bench_options(), **kw)
    dt = time.time() - t0
    ok = (res.status == int(Status.OPTIMAL)) | (res.status == int(Status.STALLED))
    log(f"sweep {total} scenarios in {dt:.2f}s, ok={ok.mean()*100:.1f}%")
    emit("scenario sweep LPs/s", total / dt, "LP/s", (total / dt) / BASELINE_LPS_PER_SEC)


def run_schur():
    """Big-LP path: batch of m=256, n=2048 LPs, columns sharded over the
    local mesh (1 chip here; the 8-device sharding is CPU-mesh tested)."""
    from pycllp_jax.io.generate import random_equality_lp
    from pycllp_jax.parallel import column_sharded_hsd_solve, model_mesh

    m = int(os.environ.get("BENCH_SCHUR_M", 256))
    n = int(os.environ.get("BENCH_SCHUR_N", 2048))
    B = int(os.environ.get("BENCH_SCHUR_B", 8))
    mesh = model_mesh()
    rng = np.random.default_rng(0)
    A, b0, c0 = random_equality_lp(m, n, seed=9)
    b = np.stack([b0 * (1 + 0.05 * rng.random(m)) for _ in range(B)]).astype(np.float32)
    c = np.stack([c0 + 0.02 * rng.random(n) for _ in range(B)]).astype(np.float32)
    A = A.astype(np.float32)
    # the round-4 accuracy playbook, on (VERDICT r3 item 6 / r4 item 5:
    # the m=256 row previously ran a plain f32 loop to its 60-iteration
    # cap): Mehrotra start + stall clock + WIDE finish to the contract
    opts = SolverOptions(
        tol=1e-6, dtype="float32", maxiter=60, init_point="mehrotra",
        stall_patience=6, finish_dtype="float64", switch_tol=1e-4,
        finish_maxiter=40,
    )
    out = column_sharded_hsd_solve(A, b, c, opts, mesh=mesh)
    np.asarray(out["objective"])  # warm incl compile
    t0 = time.time()
    out = column_sharded_hsd_solve(A, b, c, opts, mesh=mesh)
    iters = np.asarray(out["iterations"])
    dt = time.time() - t0
    st = np.asarray(out["status"])
    uniq, counts = np.unique(st, return_counts=True)
    # lane-0 audit (equality form: scipy solves the same min c'x)
    from scipy.optimize import linprog

    res = linprog(
        c[0].astype(np.float64), A_eq=np.asarray(A, np.float64),
        b_eq=b[0].astype(np.float64), bounds=[(0, None)] * n, method="highs",
    )
    if res.status != 0:
        raise RuntimeError(f"schur lane-0 audit: scipy status {res.status}")
    rel = abs(float(out["objective"][0]) - res.fun) / max(1.0, abs(res.fun))
    log(f"schur lane-0 rel-err vs scipy: {rel:.2e}")
    require_contract(rel, "schur lane 0")
    log(f"schur {B}x({m}x{n}) on {mesh.devices.size} dev: {dt:.3f}s, "
        f"statuses={dict(zip(uniq.tolist(), counts.tolist()))}, iters={iters.tolist()}")
    emit(f"big-LP ({m}x{n}) solves/s", B / dt, "LP/s", (B / dt) / BASELINE_LPS_PER_SEC)


def _median_seconds(fn, *args, reps=20):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def run_kernels():
    """The Triton kernel set against XLA's plain version on this device.

    Per kernel at the throughput widths (one 16,384-lane chunk of 64x128
    LPs, d spread over [1e-3, 1e3]): median seconds of each call.  End to
    end: the throughput config through ``hsd_solve_scan`` with each set,
    in turns (reference, triton, triton, reference) after a warm-up of
    each.  Logs to stderr only: a comparison of kernel sets, not a
    metric of the system.
    """
    ksets = kernel_times()
    _end_to_end_ab(ksets)


def kernel_times():
    """Median device seconds of each hot-path kernel of both sets at the
    throughput widths; returns the sets compared."""
    import jax.numpy as jnp

    from pycllp_jax.ops.gpu import TRITON_KERNELS
    from pycllp_jax.ops.reference import REFERENCE_KERNELS

    ksets = {"reference": REFERENCE_KERNELS, "triton": TRITON_KERNELS}
    rng = np.random.default_rng(0)
    A = jnp.asarray(random_standard_lp(M, N, nlp=1, seed=3).to_equality_form().A, jnp.float32)
    d = jnp.asarray(10.0 ** rng.uniform(-3, 3, (CHUNK, A.shape[1])), jnp.float32)
    rs = tuple(jnp.asarray(rng.standard_normal((CHUNK, M)), jnp.float32) for _ in range(3))
    with jax.default_matmul_precision("highest"):
        for name, k in ksets.items():
            ctx = k.prepare(A)
            form = jax.jit(k.normal_matrix)
            Mx = form(ctx, d)
            reg = jnp.full((CHUNK,), 1e-3, jnp.float32)
            fac_fn = jax.jit(k.factor_matrix)
            fac = fac_fn(ctx, Mx, d, reg)
            t_form = _median_seconds(form, ctx, d)
            t_fac = _median_seconds(fac_fn, ctx, Mx, d, reg)
            t_s1 = _median_seconds(jax.jit(k.solve), fac, rs[:1])
            t_s3 = _median_seconds(jax.jit(k.solve), fac, rs)
            log(f"kernels [{name}] {CHUNK} lanes {M}x{A.shape[1]}: formation "
                f"{t_form * 1e3:.3f} ms, factor {t_fac * 1e3:.3f} ms, solve k=1 "
                f"{t_s1 * 1e3:.3f} ms, solve k=3 {t_s3 * 1e3:.3f} ms")
    return ksets


def _end_to_end_ab(ksets):
    lp = random_standard_lp(M, N, nlp=TOTAL, seed=3, dtype=np.float32)
    eq = lp.to_equality_form()
    Ad = jax.device_put(np.asarray(eq.A, np.float32))
    b_all = jax.device_put(np.asarray(eq.b, np.float32))
    c_all = jax.device_put(np.asarray(eq.c, np.float32))
    opts = bench_options()

    def solve(kset):
        out = hsd_solve_scan(
            Ad, b_all, c_all, opts, kset, chunk=CHUNK, keys=("objective", "status"),
            compact_cap=CAP or None, compact_bucket=BUCKET,
            finish_cap=FINISH_CAP, finish_bucket=FINISH_BUCKET,
        )
        return np.asarray(out["status"])

    for name, k in ksets.items():
        t0 = time.time()
        st = solve(k)
        log(f"end-to-end [{name}] warm-up {time.time() - t0:.1f}s, "
            f"{int((st == int(Status.OPTIMAL)).sum())}/{TOTAL} OPTIMAL")
    times = {name: [] for name in ksets}
    for name in ("reference", "triton", "triton", "reference"):
        t0 = time.perf_counter()
        solve(ksets[name])
        times[name].append(time.perf_counter() - t0)
        log(f"end-to-end [{name}] {times[name][-1]:.4f}s")
    log(f"end-to-end mean seconds: reference {np.mean(times['reference']):.4f}, "
        f"triton {np.mean(times['triton']):.4f}")


def run_correctness():
    """Config 1: afiro-scale correctness vs scipy at the 1e-6 contract."""
    from scipy.optimize import linprog

    lp = random_standard_lp(30, 50, nlp=64, seed=1)
    eq = lp.to_equality_form()
    opts = SolverOptions(tol=1e-7, dtype="float32", finish_dtype="float64")
    out = hsd_solve_batched(
        np.asarray(eq.A), np.asarray(eq.b), np.asarray(eq.c), opts
    )
    rels = []
    for i in range(64):
        res = linprog(
            -np.asarray(lp.c)[i], A_ub=np.asarray(lp.A), b_ub=np.asarray(lp.b)[i],
            bounds=[(0, None)] * 50, method="highs",
        )
        rels.append(abs(-float(out["objective"][i]) + res.fun) / max(1, abs(res.fun)))
    log(f"correctness: max rel {max(rels):.2e}")
    require_contract(max(rels), "correctness")
    emit("max objective rel-err vs scipy (mixed precision)", max(rels), "rel", max(rels) / 1e-6)


def run_all():
    """All BASELINE.md eval configs in one process; each emits its own
    JSON line.  A failed mode is reported and the rest still run; the
    process then exits non-zero."""
    failed = []
    for name, fn in (
        ("correctness", run_correctness),  # config 1
        ("batch32", run_batch32),  # config 2
        ("throughput", run_throughput),  # config 3
        ("netlib", run_netlib),  # config 4
        ("sweep", run_sweep),  # config 5 (single-host stand-in)
        ("weak", run_weak),  # weak-scaling target
        ("schur", run_schur),  # big-LP / model-parallel path
    ):
        log(f"===== BENCH_MODE={name} =====")
        try:
            fn()
        except Exception:  # keep recording the rest, fail at the end
            log(f"mode {name} FAILED:\n{traceback.format_exc()}")
            emit(f"{name} (FAILED)", float("nan"), "-", 0.0)
            failed.append(name)
    if failed:
        raise SystemExit(f"bench modes failed: {', '.join(failed)}")


def main():
    setup_jax()
    modes = {
        "throughput": run_throughput,
        "batch32": run_batch32,
        "netlib": run_netlib,
        "weak": run_weak,
        "sweep": run_sweep,
        "correctness": run_correctness,
        "schur": run_schur,
        "kernels": run_kernels,
        "all": run_all,
    }
    modes[MODE]()


if __name__ == "__main__":
    main()
