"""Probe outer-FGMRES iteration counts for Schur-preconditioner variants.

The question (VERDICT r1 item 2): with dt=0.05 the tangent A00 is
mass-dominated, so the true Schur complement is ~ dt * pressure Laplacian —
the reference's Mp/nu surrogate (built for steady Stokes) is spectrally wrong.
Candidates measured here by OUTER ITERATION COUNT only (apply cost is
prototyped with full matvecs; cheap block kernels come later if counts
justify them):

  identity    : reference as-shipped (cpp:570)
  mp          : lower-triangular sweep, S^-1 ~ lumped(Mp/nu)^-1
  cc          : S^-1 ~ nu*lumped(Mp)^-1 + (1/dt)*ApproxInv(Ap) via k-step
                Jacobi-CG, Ap = B diag(A00)^-1 B^T (SIMPLE-style)

env: REFINE (default 1), K_AP (default 8), K_A00 (default 4)
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
    from navier_stokes_tpu.la.cg import cg
    from navier_stokes_tpu.la.gmres import fgmres
    from navier_stokes_tpu.la.preconditioners import jacobi
    from navier_stokes_tpu.mesh.mesh import refine_uniform
    from navier_stokes_tpu.mesh.msh_io import read_msh
    from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
    from navier_stokes_tpu.ops.windowed import windowed_matvec
    from navier_stokes_tpu.utils.logging import RunLog

    refine = int(os.environ.get("REFINE", "1"))
    k_ap = int(os.environ.get("K_AP", "8"))
    k_a00 = int(os.environ.get("K_A00", "4"))

    mesh = refine_uniform(read_msh("/root/reference/mesh/correct_mesh_yt.msh"), refine)
    cfg = SolverConfig()
    cfg.dtype = "float32"
    cfg.krylov.matvec = "windowed"
    s = NavierStokesSolver(mesh, cfg, log=RunLog(verbose=False)).setup()
    lay, wa = s._win_layout, s._wassembly
    n, n_u = s.dofs.n_total, s.dofs.n_u
    bc_rows = s._bc_rows
    print(f"n={n}", flush=True)

    # typical second-time-step state: one roughly-solved step as background
    u = s.solution
    u_old = jnp.zeros_like(u)

    @jax.jit
    def build(wa, lay, u, u_old):
        return assemble_windowed(
            wa, lay, u, u_old, dt=cfg.dt, nu=cfg.nu, rho=cfg.rho,
            convection_form=cfg.convection_form,
            include_continuity_residual=cfg.include_continuity_residual,
        )

    A_t, residual, diag0 = build(wa, lay, u, u_old)
    bc_diag = diag0[bc_rows]
    residual = residual.at[bc_rows].set(0.0)
    res_norm = float(jnp.linalg.norm(residual))
    atol = cfg.krylov.rel_tol * res_norm
    print(f"||r|| = {res_norm:.3e}, atol = {atol:.3e}", flush=True)

    def mv(v):
        y = windowed_matvec(lay, A_t, v)
        return y.at[bc_rows].set(bc_diag * v[bc_rows])

    def apply_full(xu, zero_bc):
        x = jnp.zeros(n, dtype=xu.dtype).at[:n_u].set(xu)
        if zero_bc:
            x = x.at[bc_rows].set(0.0)
        return windowed_matvec(lay, A_t, x)

    def A00_mv(v):
        y = apply_full(v, zero_bc=True)[:n_u]
        return y.at[bc_rows].set(bc_diag * v[bc_rows])

    diag_u = diag0[:n_u].at[bc_rows].set(bc_diag)
    inv_du = jnp.where(diag_u != 0, 1.0 / jnp.where(diag_u != 0, diag_u, 1.0), 1.0)
    pA = jacobi(diag_u)
    inv_mp = wa.inv_mp  # lumped (psi_i psi_j / nu) inverse

    def Bt_p(p):  # velocity rows of A [0; p]
        x = jnp.zeros(n, dtype=p.dtype).at[n_u:].set(p)
        x = x.at[bc_rows].set(0.0)  # BC columns eliminated
        return windowed_matvec(lay, A_t, x)[:n_u]

    def B_u(v):  # pressure rows of A [v; 0]
        x = jnp.zeros(n, dtype=v.dtype).at[:n_u].set(v)
        x = x.at[bc_rows].set(0.0)
        return windowed_matvec(lay, A_t, x)[n_u:]

    def Ap_mv(p):  # SIMPLE Schur: B diag(A00)^-1 B^T  (SPD)
        return B_u(inv_du * Bt_p(p))

    diag_ap = None  # filled below (probe)

    def precond_mp(v):
        vu, vp = v[:n_u], v[n_u:]
        du = cg(A00_mv, vu, atol=0.0, maxiter=k_a00, precond=pA).x
        dp = inv_mp * (vp - B_u(du))
        return jnp.concatenate([du, dp])

    def precond_cc(v):
        vu, vp = v[:n_u], v[n_u:]
        du = cg(A00_mv, vu, atol=0.0, maxiter=k_a00, precond=pA).x
        rp = vp - B_u(du)
        # Cahouet-Chabard: S^-1 ~ nu*Mp_l^-1 + Ap^-1 (Ap absorbs the 1/dt
        # scale through diag(A00) ~ M/dt)
        dp_ap = cg(Ap_mv, rp, atol=0.0, maxiter=k_ap, precond=jacobi(diag_ap)).x
        # inv_mp = (Mp/nu)^-1 lumped = nu * Mp_l^-1, exactly CC's mass term;
        # Ap = B diag(A00)^-1 B^T ~ dt * Lap_p absorbs the 1/dt scale
        dp = inv_mp * rp + dp_ap
        return jnp.concatenate([du, dp])

    # estimate diag(Ap) by probing with +-1 random vectors (Hutchinson, host)
    key = jax.random.PRNGKey(0)
    est = jnp.zeros(n - n_u)
    for i in range(8):
        z = jax.random.rademacher(jax.random.fold_in(key, i), (n - n_u,), dtype=jnp.float32)
        est = est + z * Ap_mv(z)
    diag_ap = jnp.maximum(est / 8.0, 1e-8)

    for name, M in [("identity", None), ("mp", precond_mp), ("cc", precond_cc)]:
        t0 = time.perf_counter()
        sol = jax.block_until_ready(
            jax.jit(lambda r: fgmres(mv, r, atol=atol, restart=60, maxiter=2000,
                                     precond=M))(residual)
        )
        dt_ms = (time.perf_counter() - t0) * 1e3
        print(
            f"{name:10s}: iters={int(sol.iters):5d} converged={bool(sol.converged)} "
            f"res={float(sol.residual):.3e} wall={dt_ms:.0f} ms (incl compile)",
            flush=True,
        )


if __name__ == "__main__":
    main()
