"""Newton-step timing at flagship scale: windowed assembly + windowed operator.

env: REFINE (default 2), PRECOND (identity|block_diagonal|block_triangular),
INNER (inner CG cap), NEWTON_REPS
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from navier_stokes_tpu.config import SolverConfig
    from navier_stokes_tpu.fem.windowed_assembly import assemble_windowed
    from navier_stokes_tpu.mesh.mesh import refine_uniform
    from navier_stokes_tpu.mesh.msh_io import read_msh
    from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
    from navier_stokes_tpu.utils.logging import RunLog

    refine = int(os.environ.get("REFINE", "2"))
    precond = os.environ.get("PRECOND", "identity")
    inner = int(os.environ.get("INNER", "2000"))

    mesh = refine_uniform(read_msh("/root/reference/mesh/correct_mesh_yt.msh"), refine)
    cfg = SolverConfig()
    cfg.dtype = "float32"
    cfg.krylov.matvec = "windowed"
    cfg.krylov.preconditioner = precond
    cfg.krylov.inner_max_iters = inner
    s = NavierStokesSolver(mesh, cfg, log=RunLog(verbose=False)).setup()
    lay = s._win_layout
    n = s.dofs.n_total
    print(f"n={n} nb={lay.nb} pad={lay.pad_factor:.2f} precond={precond} inner<={inner}", flush=True)

    u = s.solution + 0.01
    u_old = s.solution_old

    # assembly alone
    kw = dict(dt=cfg.dt, nu=cfg.nu, rho=cfg.rho,
              convection_form=cfg.convection_form,
              include_continuity_residual=cfg.include_continuity_residual)

    @jax.jit
    def asm(wa, la, a, b):
        A_t, r, d = assemble_windowed(wa, la, a, b, **kw)
        return A_t.ravel()[::8192].sum(), jnp.linalg.norm(r), d.ravel()[::4096].sum()

    jax.block_until_ready(asm(s._wassembly, lay, u, u_old))
    t0 = time.perf_counter()
    for _ in range(20):
        out = asm(s._wassembly, lay, u, u_old)
    jax.block_until_ready(out)
    ta = (time.perf_counter() - t0) / 20 * 1e3
    print(f"windowed assembly: {ta:.2f} ms  ({n/ta/1e3:.1f} MDoF/s)", flush=True)

    # full newton step
    bc_vals = jnp.asarray(s.dirichlet.values(cfg.dt), dtype=u.dtype)
    out = s._newton_iteration(u.copy(), u_old, bc_vals)
    jax.block_until_ready(out)
    reps = int(os.environ.get("NEWTON_REPS", "3"))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = s._newton_iteration(u.copy(), u_old, bc_vals)
        jax.block_until_ready(out)
    tn = (time.perf_counter() - t0) / reps * 1e3
    print(f"newton step: {tn:.1f} ms  gmres_iters={int(out[2])}", flush=True)


if __name__ == "__main__":
    main()
