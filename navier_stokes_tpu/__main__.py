"""Command-line driver: `python -m navier_stokes_tpu <command>`.

The reference's CLI surface is a bare `./proj` with everything hardcoded
(``/root/reference/src/main.cpp:4-21``).  Here every hardcoded constant is a
flag or a config file (SURVEY §5 config table).

Commands:
  run     unsteady Navier-Stokes (the reference's main.cpp run by default)
  stokes  steady Stokes (the reference's dead initial-guess path, first-class)
  info    parse a mesh and print its stats
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_common(p):
    p.add_argument("--mesh", default="/root/reference/mesh/correct_mesh_yt.msh")
    p.add_argument("--config", help="JSON/TOML SolverConfig file")
    p.add_argument("--nu", type=float)
    p.add_argument("--rho", type=float)
    p.add_argument("--p-out", dest="p_out", type=float)
    p.add_argument(
        "--preconditioner",
        choices=["identity", "block_diagonal", "block_triangular", "cahouet_chabard"],
    )
    p.add_argument(
        "--distributed", action="store_true",
        help="join the JAX multi-host runtime (coordinator from "
        "JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID); "
        "the reference's MPI_InitFinalize (main.cpp:7)",
    )
    p.add_argument("--matvec", choices=["flat", "windowed"])
    p.add_argument("--time-scheme", dest="time_scheme", choices=["bdf1", "bdf2"])
    p.add_argument(
        "--initial-guess", dest="initial_guess", choices=["zero", "stokes"],
        help="'stokes' = the reference's designed initial-guess path (cpp:636-644)",
    )
    p.add_argument("--dtype", choices=["auto", "float32", "float64"])
    p.add_argument("--devices", type=int, help="shard over N devices (SPMD)")
    p.add_argument("--output-dir", help="write XDMF/HDF5 output here")
    p.add_argument("--log-json", help="dump the structured run log to this file")


def _build_config(args):
    from .config import SolverConfig

    cfg = SolverConfig.from_file(args.config) if args.config else SolverConfig()
    for field, attr in (("nu", "nu"), ("rho", "rho"), ("p_out", "p_out"), ("dtype", "dtype")):
        v = getattr(args, attr, None)
        if v is not None:
            setattr(cfg, field, v)
    if getattr(args, "preconditioner", None):
        cfg.krylov.preconditioner = args.preconditioner
    if getattr(args, "matvec", None):
        cfg.krylov.matvec = args.matvec
    if getattr(args, "T", None) is not None:
        cfg.T = args.T
    if getattr(args, "dt", None) is not None:
        cfg.dt = args.dt
    if getattr(args, "time_scheme", None):
        cfg.time_scheme = args.time_scheme
    if getattr(args, "initial_guess", None):
        cfg.initial_guess = args.initial_guess
    return cfg


def cmd_run(args):
    from .models.navier_stokes import NavierStokesSolver
    from .utils.logging import RunLog

    cfg = _build_config(args)
    verbose = True
    if getattr(args, "distributed", False):
        from .parallel.bootstrap import initialize_distributed, is_coordinator

        initialize_distributed()
        verbose = is_coordinator()  # rank-0 pcout (hpp:648,698)
    log = RunLog(verbose=verbose)
    solver = NavierStokesSolver(args.mesh, cfg, log=log, n_devices=args.devices)
    solver.setup()
    if args.output_dir:
        from .io.xdmf import XdmfWriter

        writer = XdmfWriter(
            solver.dofs, output_dir=args.output_dir,
            partitioning=solver.cell_owner,  # real SPMD ownership (cpp:702-705)
        )
        solver.output_hooks.append(lambda s, t, sol: writer.write(s, t, sol))
    solver.solve()
    if args.output_dir:
        writer.write_series()
    if args.log_json:
        log.dump_json(args.log_json)
    return 0


def cmd_stokes(args):
    from .models.stokes import StokesSolver
    from .utils.logging import RunLog

    cfg = _build_config(args)
    if not args.config:
        # the reference Stokes path's tag set (mesh-square, cpp:472,511)
        cfg.inlet_tags, cfg.neumann_tags, cfg.wall_tags = (0,), (1,), (2, 3)
        if not args.preconditioner:
            cfg.krylov.preconditioner = "block_triangular"  # cpp:546
    log = RunLog()
    solver = StokesSolver(args.mesh, cfg, log=log)
    solver.solve()
    if args.output_dir:
        from .io.xdmf import XdmfWriter

        writer = XdmfWriter(solver.dofs, output_dir=args.output_dir)
        writer.write(0, 0.0, solver.solution)
    if args.log_json:
        log.dump_json(args.log_json)
    return 0


def cmd_info(args):
    from .fem.dofs import make_dofs
    from .mesh.msh_io import read_msh

    mesh = read_msh(args.mesh)
    dofs = make_dofs(mesh)
    print(mesh.summary())
    print(json.dumps({"n_u": dofs.n_u, "n_p": dofs.n_p, "n_total": dofs.n_total}))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="navier_stokes_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="unsteady Navier-Stokes (reference main.cpp run)")
    _add_common(p_run)
    p_run.add_argument("--T", type=float, help="final time (default 1.0, main.cpp:12)")
    p_run.add_argument("--dt", type=float, help="time step (default 0.05, main.cpp:13)")
    p_run.set_defaults(fn=cmd_run)

    p_st = sub.add_parser("stokes", help="steady Stokes (reference dead path, cpp:380-559)")
    _add_common(p_st)
    p_st.set_defaults(fn=cmd_stokes)

    p_info = sub.add_parser("info", help="mesh statistics")
    p_info.add_argument("--mesh", required=True)
    p_info.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
