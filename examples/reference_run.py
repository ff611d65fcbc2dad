"""The reference's as-shipped run, end to end (main.cpp:4-21 equivalent).

P2/P1 Taylor-Hood on mesh/correct_mesh_yt.msh, nu=1e-3, rho=1, p_out=10,
implicit Euler T=1.0 dt=0.05 (20 steps), Newton tol 1e-2 abs, tangent GMRES
tol 1e-2 rel with identity preconditioner — including the as-shipped quirks
(frozen sin(0)=0 inlet, u^T grad-u residual, omitted continuity residual).

Writes ParaView output (output-NNNN.{h5,xdmf}) and the Newton residual
trajectory (THE parity signal, SURVEY §5) as JSON.

Usage: python examples/reference_run.py [outdir] [--matvec windowed|flat]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import navier_stokes_tpu as ns
from navier_stokes_tpu.io.xdmf import XdmfWriter


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "reference_run_out"
    matvec = "windowed"
    if "--matvec" in sys.argv:
        matvec = sys.argv[sys.argv.index("--matvec") + 1]

    cfg = ns.SolverConfig()  # exactly the as-shipped configuration
    cfg.krylov.matvec = matvec
    cfg.krylov.max_iters = 3000
    cfg.newton.max_iters = 25  # divergent steps cap (the as-shipped flow blows up around t=0.3; see newton_trajectory.json)

    mesh = "/root/reference/mesh/correct_mesh_yt.msh"
    if not os.path.exists(mesh):  # generated channel of the same extent:
        # map the generator's tags (0 inlet, 1 outlet, 2-3 walls)
        mesh = ns.rectangle(60, 30, 0, 7, 0, 4)
        cfg.inlet_tags, cfg.neumann_tags, cfg.wall_tags = (0,), (1,), (2, 3)
    log = ns.RunLog()
    solver = ns.NavierStokesSolver(mesh, cfg, log=log)
    solver.setup()
    writer = XdmfWriter(solver.dofs, output_dir=outdir)
    solver.output_hooks.append(lambda s, t, sol: writer.write(s, t, sol))

    t0 = time.time()
    solver.solve()
    wall = time.time() - t0
    writer.write_series()

    traj = log.residual_trajectory()
    with open(os.path.join(outdir, "newton_trajectory.json"), "w") as f:
        json.dump(
            {
                "config": "reference as-shipped (main.cpp)",
                "matvec": matvec,
                "wall_seconds": wall,
                "trajectory": traj,
                "gmres": [r for r in log.records if r.get("event") == "gmres"],
            },
            f,
            indent=1,
        )
    print(f"\nDone in {wall:.1f}s; output + trajectory in {outdir}/")


if __name__ == "__main__":
    from navier_stokes_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
