"""Combinatorial flag-interaction sweep: every {matvec} x {preconditioner}
x {time_scheme} x {initial_guess} combination must produce a finite solve.

Caught in round 2: preconditioner='cahouet_chabard' with matvec='flat'
raised 'unknown preconditioner' at solve time (now degrades to
block_triangular).  Run on CPU; does not touch the GPU.

Usage: python scripts/sweep_flag_matrix.py [2d|spmd|3d|all]
  spmd mode needs XLA_FLAGS=--xla_force_host_platform_device_count=2
"""

import itertools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from navier_stokes_tpu.config import SolverConfig
from navier_stokes_tpu.mesh.generate import box, unit_square
from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
from navier_stokes_tpu.utils.logging import RunLog

PRECONDS = ("identity", "block_diagonal", "block_triangular", "cahouet_chabard")


def run(mode: str) -> list[str]:
    fails = []
    if mode == "3d":
        mesh = box(4, 4, 4)
        wall_tags = (2, 3, 4, 5)
        combos = itertools.product(
            ("flat", "windowed"), PRECONDS, ("bdf1", "bdf2"), ("zero",)
        )
    else:
        mesh = unit_square(5)
        wall_tags = (2, 3)
        matvecs = ("windowed",) if mode == "spmd" else ("flat", "windowed")
        combos = itertools.product(
            matvecs, PRECONDS, ("bdf1", "bdf2"), ("zero", "stokes")
        )
    n_dev = 2 if mode == "spmd" else None

    for matvec, precond, scheme, guess in combos:
        tag = f"{mode}/{matvec}/{precond}/{scheme}/{guess}"
        try:
            cfg = SolverConfig(
                inlet_tags=(0,), neumann_tags=(1,), wall_tags=wall_tags,
                p_out=0.0, dt=0.05, T=0.1,
            )
            cfg.time_scheme = scheme
            cfg.initial_guess = guess
            cfg.krylov.matvec = matvec
            cfg.krylov.cells_per_block = 16
            cfg.krylov.preconditioner = precond
            cfg.krylov.max_iters = 500
            cfg.newton.max_iters = 6
            s = NavierStokesSolver(
                mesh, cfg, log=RunLog(verbose=False), n_devices=n_dev
            )
            s.setup()
            s.solve()
            ok = bool(np.isfinite(np.asarray(s.solution)).all())
            print(("PASS " if ok else "NONFINITE ") + tag, flush=True)
            if not ok:
                fails.append(tag)
        except Exception as e:  # noqa: BLE001 — sweep must survive any combo
            print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
            fails.append(tag)
    return fails


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "2d"
    modes = ("2d", "spmd", "3d") if mode == "all" else (mode,)
    fails = []
    for m in modes:
        fails += run(m)
    print("failures:", fails)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
