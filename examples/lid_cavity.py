"""Lid-driven cavity validation (Ghia, Ghia & Shin 1982 centerline profiles).

Enclosed flow on [0,1]^2, moving lid u=(1,0) on the top boundary, no-slip
elsewhere — a second physics family beyond the DFG channel benchmarks, and
the standard all-Dirichlet case: there is NO Neumann boundary, so the
pressure carries the constant nullspace (the framework's FGMRES solves the
consistent singular system; the Cahouet-Chabard Kp sweep takes its
pure-Neumann diagonal shift path in fem/windowed_assembly.py).

Steady state is reached by BDF2 time marching with the device-resident
scanned loop. Reported: u(y) along the vertical centerline x=0.5 and
v(x) along the horizontal centerline y=0.5 against the Ghia et al. (1982)
Table I/II values (129x129 stream-function-vorticity reference), plus the
standard u_min/v_min/v_max functionals.

Usage:  python examples/lid_cavity.py [n=64] [Re=100] [T=12] [dt=0.05]
Env:    CAVITY_PRECOND (default cahouet_chabard), CAVITY_CHUNK (default 10).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import navier_stokes_tpu as ns
from navier_stokes_tpu.mesh.generate import rectangle

# Ghia, Ghia & Shin (1982), Re=100, 129x129 grid.
# Table I: u through the geometric center (x=0.5); Table II: v at y=0.5.
GHIA_RE100_U = [  # (y, u)
    (1.0000, 1.00000), (0.9766, 0.84123), (0.9688, 0.78871),
    (0.9609, 0.73722), (0.9531, 0.68717), (0.8516, 0.23151),
    (0.7344, 0.00332), (0.6172, -0.13641), (0.5000, -0.20581),
    (0.4531, -0.21090), (0.2813, -0.15662), (0.1719, -0.10150),
    (0.1016, -0.06434), (0.0703, -0.04775), (0.0625, -0.04192),
    (0.0547, -0.03717), (0.0000, 0.00000),
]
GHIA_RE100_V = [  # (x, v)
    (1.0000, 0.00000), (0.9688, -0.05906), (0.9609, -0.07391),
    (0.9531, -0.08864), (0.9453, -0.10313), (0.9063, -0.16914),
    (0.8594, -0.22445), (0.8047, -0.24533), (0.5000, 0.05454),
    (0.2344, 0.17527), (0.2266, 0.17507), (0.1563, 0.16077),
    (0.0938, 0.12317), (0.0781, 0.10890), (0.0703, 0.10091),
    (0.0625, 0.09233), (0.0000, 0.00000),
]


def lid(x, t=0.0):
    """Unit lid velocity; applied only on the top-boundary DoFs (tag 3)."""
    v = np.zeros_like(x)
    v[:, 0] = 1.0
    return v


def centerline(coords, vel, axis):
    """Sample the P2 nodal field on the x=0.5 (axis=0) or y=0.5 (axis=1)
    line; structured even-n meshes put nodes exactly on it."""
    on = np.isclose(coords[:, axis], 0.5, atol=1e-9)
    order = np.argsort(coords[on, 1 - axis])
    return coords[on][order, 1 - axis], vel[on][order]


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    re = float(sys.argv[2]) if len(sys.argv) > 2 else 100.0
    T = float(sys.argv[3]) if len(sys.argv) > 3 else 12.0
    dt = float(sys.argv[4]) if len(sys.argv) > 4 else 0.05

    mesh = rectangle(n, n, name=f"cavity_{n}")
    cfg = ns.SolverConfig(
        T=T, dt=dt, nu=1.0 / re, rho=1.0, p_out=0.0,
        inlet_tags=(3,), wall_tags=(0, 1, 2), neumann_tags=(),
    )
    cfg.convection_form = "standard"
    cfg.include_continuity_residual = True
    cfg.jacobian_mass_rho = True
    cfg.time_scheme = "bdf2"
    cfg.krylov.matvec = "windowed"
    cfg.krylov.preconditioner = os.environ.get("CAVITY_PRECOND", "cahouet_chabard")
    cfg.krylov.rel_tol = 1e-4
    cfg.krylov.max_iters = 300
    cfg.newton.tol = 1e-6
    cfg.newton.min_iters = 1
    cfg.newton.max_iters = 6

    log = ns.RunLog(verbose=False)
    solver = ns.NavierStokesSolver(mesh, cfg, log=log, inlet=lid)
    solver.setup()
    t0 = time.time()
    out = solver.solve_scanned(
        chunk=int(os.environ.get("CAVITY_CHUNK", "10")), newton_iters=2,
        progress=lambda step, t, f, res=None, iters=None: print(
            f"step {step:5d}  t={t:6.2f}  |r|={float(np.asarray(res)[-1]):.2e}"
            f"  gmres/step={float(np.mean(iters)):.0f}"
            f"  wall={time.time()-t0:6.1f}s", flush=True),
    )
    wall = time.time() - t0

    vc = solver.velocity_coords(real_only=True)
    vv = np.asarray(solver.velocity(real_only=True))
    y_u, u_c = centerline(vc, vv[:, 0], axis=0)  # u(y) at x=0.5
    x_v, v_c = centerline(vc, vv[:, 1], axis=1)  # v(x) at y=0.5

    ref_u = np.array(GHIA_RE100_U) if re == 100 else None
    report = {
        "n": n, "re": re, "T": T, "dt": dt, "n_dofs": solver.dofs.n_total,
        "wall_s": round(wall, 1),
        "u_min_centerline": float(u_c.min()),
        "v_min_centerline": float(v_c.min()),
        "v_max_centerline": float(v_c.max()),
        "final_residual": float(np.asarray(out["residual"])[-1]),
    }
    if re == 100:
        iu = np.interp(ref_u[:, 0], y_u, u_c)
        ref_v = np.array(GHIA_RE100_V)
        iv = np.interp(ref_v[:, 0], x_v, v_c)
        report["max_err_u_vs_ghia"] = float(np.abs(iu - ref_u[:, 1]).max())
        report["max_err_v_vs_ghia"] = float(np.abs(iv - ref_v[:, 1]).max())
        # Ghia Table I extrema at Re=100: u_min=-0.21090, v_min=-0.24533,
        # v_max=0.17527 (their 129x129 grid)
        report["u_min_ghia"] = -0.21090
        report["v_min_ghia"] = -0.24533
        report["v_max_ghia"] = 0.17527

    outdir = sys.argv[5] if len(sys.argv) > 5 else "cavity_out"
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"cavity_re{re:g}_n{n}.json"), "w") as f:
        json.dump({
            "report": report,
            "centerline_u": {"y": y_u.tolist(), "u": u_c.tolist()},
            "centerline_v": {"x": x_v.tolist(), "v": v_c.tolist()},
        }, f, indent=1)
    print(json.dumps(report, indent=1), flush=True)


if __name__ == "__main__":
    from navier_stokes_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
