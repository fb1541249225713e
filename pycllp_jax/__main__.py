"""Command-line interface: solve MPS files, inspect the environment.

Usage:
    python -m pycllp_jax solve problem.mps [--solver hsd] [--tol 1e-6]
    python -m pycllp_jax info
"""

from __future__ import annotations

import argparse
import json
import sys


def cmd_info(args) -> int:
    import jax

    import pycllp_jax as tp

    print(f"pycllp_jax {tp.__version__}")
    print(f"jax {jax.__version__}, backend {jax.default_backend()}")
    print(f"devices: {jax.devices()}")
    print(f"solvers: {tp.available_solvers()}")
    return 0


def cmd_solve(args) -> int:
    import numpy as np

    import pycllp_jax as tp
    from pycllp_jax.io.mps import read_mps

    prob = read_mps(args.file)
    m, n = prob.shape
    print(f"{prob.name or args.file}: {m} rows, {n} cols", file=sys.stderr)
    solver = tp.get_solver(
        args.solver,
        tol=args.tol,
        maxiter=args.maxiter,
        dtype=args.dtype,
        finish_dtype=args.finish_dtype,
    )
    solver.init(prob.lp)
    sol = solver.solve()
    status = tp.Status(int(np.asarray(sol.status)))
    out = {
        "status": status.name,
        "objective": float(np.asarray(sol.objective)),
        "iterations": int(np.asarray(sol.iterations)),
    }
    if args.print_solution:
        out["x"] = {
            name: float(v)
            for name, v in zip(prob.col_names, np.asarray(sol.x))
        }
    print(json.dumps(out, indent=2))
    return 0 if status == tp.Status.OPTIMAL else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pycllp_jax")
    p.add_argument(
        "--platform",
        default=None,
        help="force a jax platform (e.g. 'cpu' — small one-off solves "
        "avoid the device compile latency)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("info", help="environment and registry report")
    pi.set_defaults(fn=cmd_info)

    ps = sub.add_parser("solve", help="solve an MPS file")
    ps.add_argument("file")
    ps.add_argument("--solver", default="hsd")
    ps.add_argument("--tol", type=float, default=1e-6)
    ps.add_argument("--maxiter", type=int, default=100)
    ps.add_argument("--dtype", default=None)
    ps.add_argument("--finish-dtype", dest="finish_dtype", default=None)
    ps.add_argument("--print-solution", action="store_true")
    ps.set_defaults(fn=cmd_solve)

    args = p.parse_args(argv)
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if getattr(args, "dtype", None) != "float32":
        # without x64, jax silently downcasts the f64 problem data and a
        # tight tolerance can never be met
        jax.config.update("jax_enable_x64", True)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
