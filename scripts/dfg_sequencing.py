"""DFG 2D-2 mesh-sequencing continuation: refine-1 limit cycle -> refine-2.

A from-scratch refine=2 run spends hours of device time re-developing the
vortex street (the weakly-pinned channel tangents need ~100-180 FGMRES
iterations per step at 1.78M DoF).  The limit cycle is UNIQUE, so standard
mesh sequencing applies: take the developed refine-1 state (t ~ 6, saved by
examples/dfg_cylinder.py with DFG_CKPT_EVERY), prolong it onto the refine-2
mesh, and run only a few shedding periods (period = D/(St*U) ~ 0.33 s) for
the fine-mesh statistics.

Prolongation is EXACT up to the circle snap: load_dfg_mesh(2) is one red
refinement of load_dfg_mesh(1) (children of coarse cell p are fine cells
{p, p+nc, p+2nc, p+3nc} — mesh._refine_once concatenates quadrant groups),
and P2 on the children reproduces P2 on the parent.  Fine nodes snapped onto
the circle sit O(h^2) outside their parent; their barycentric coordinates
are clamped (projection onto the parent element's polynomial).

Usage:
  python scripts/dfg_sequencing.py <coarse_ckpt.h5> <outdir> [T_end] [dt]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import navier_stokes_tpu as ns
from navier_stokes_tpu.models.functionals import BoundaryForce, strouhal_number

from dfg_common import D, H, load_dfg_mesh  # noqa: E402


def make_cfg(refine, T, dt, nu):
    """The dfg_cylinder.py refine>=2 production configuration (kept in sync
    with examples/dfg_cylinder.py — corrected formulation, BDF2, CC knobs)."""
    cfg = ns.SolverConfig(T=T, dt=dt, nu=nu, rho=1.0, p_out=0.0)
    cfg.convection_form = "standard"
    cfg.include_continuity_residual = True
    cfg.jacobian_mass_rho = True
    cfg.time_scheme = "bdf2"
    cfg.newton.tol = 1e-4
    cfg.newton.min_iters = 1
    cfg.newton.max_iters = 8
    cfg.krylov.rel_tol = float(os.environ.get("DFG_RELTOL", "1e-3"))
    cfg.krylov.max_iters = int(os.environ.get("DFG_GMRES_CAP", "150"))
    cfg.krylov.matvec = "windowed"
    cfg.krylov.preconditioner = "cahouet_chabard"
    cfg.krylov.cc_iters_a00 = int(os.environ.get("DFG_CC_A00", "8"))
    cfg.krylov.cc_iters_ap = int(os.environ.get("DFG_CC_AP", "2"))
    cfg.krylov.a00_solver = os.environ.get("DFG_A00_SOLVER", "gmres")
    cfg.krylov.cc_coarse_agg = int(os.environ.get("DFG_CC_COARSE", "0"))
    return cfg


def prolong(coarse, fine, u_c):
    """Planar coarse state -> planar fine state (P2 velocity + P1 pressure).

    coarse/fine: NavierStokesSolver objects (set up, single device).
    u_c: planar [n_total_coarse] numpy state on the coarse solver's dofs.
    """
    dc, df = coarse.dofs, fine.dofs
    mc, mf = coarse.mesh, fine.mesh
    nc = mc.n_cells
    assert mf.n_cells == 4 * nc, "fine mesh must be ONE red refinement"

    # coarse per-cell geometry for barycentric coordinates
    cells_c = np.asarray(mc.cells, np.int64)
    v0 = mc.coords[cells_c[:, 0]]  # [nc, 2]
    J = np.stack(
        [mc.coords[cells_c[:, 1]] - v0, mc.coords[cells_c[:, 2]] - v0], axis=2
    )  # [nc, 2, 2] columns are edge vectors
    Jinv = np.linalg.inv(J)

    ux = u_c[: dc.n_vs]
    uy = u_c[dc.n_vs : 2 * dc.n_vs]
    p_c = u_c[dc.n_u :]
    cvd_c = np.asarray(dc.cell_vdofs, np.int64)  # [nc, 6]
    cpd_c = np.asarray(dc.cell_pdofs, np.int64)  # [nc, 3]

    out = np.zeros(df.n_total)

    def eval_space(coords_f, cell_dofs_f, tab, coarse_cell_dofs, vals_list):
        """For every fine dof (via its first containing fine cell), evaluate
        the coarse FE functions at its location.  Returns [n_dofs_f, n_funcs].
        coords_f: [n_f, 2]; cell_dofs_f: [4nc, k]; tab: basis evaluator
        points -> [k_c, npts]; vals_list: list of [n_dofs_c] coefficient
        vectors on the coarse space."""
        n_f = coords_f.shape[0]
        # first fine cell containing each fine dof
        k = cell_dofs_f.shape[1]
        first_cell = np.full(n_f, -1, np.int64)
        # reversed so the FIRST occurrence wins (identical values anyway)
        flat = cell_dofs_f.ravel()
        cells_rep = np.repeat(np.arange(cell_dofs_f.shape[0]), k)
        first_cell[flat[::-1]] = cells_rep[::-1]
        have = first_cell >= 0
        parent = first_cell[have] % nc
        x = coords_f[have]
        xi = np.einsum("cij,cj->ci", Jinv[parent], x - v0[parent])
        # clamp: circle-snapped nodes sit O(h^2) outside the parent
        xi = np.clip(xi, 0.0, 1.0)
        s = xi.sum(axis=1)
        over = s > 1.0
        xi[over] /= s[over, None]
        N = tab(xi)  # [k_c, m]
        outs = []
        for vals in vals_list:
            coef = vals[coarse_cell_dofs[parent]]  # [m, k_c]
            res = np.zeros(n_f)
            res[have] = np.einsum("km,mk->m", N, coef)
            outs.append(res)
        return outs

    def tab_v(pts):
        return np.asarray(df.element.velocity.tabulate(pts)[0], np.float64)

    def tab_p(pts):
        return np.asarray(df.element.pressure.tabulate(pts)[0], np.float64)

    uxf, uyf = eval_space(
        np.asarray(df.v_coords, np.float64),
        np.asarray(df.cell_vdofs, np.int64),
        tab_v, cvd_c, [ux, uy],
    )
    (pf,) = eval_space(
        np.asarray(df.p_coords, np.float64),
        np.asarray(df.cell_pdofs, np.int64),
        tab_p, cpd_c, [p_c],
    )
    if df.v_mask is not None:
        uxf[~df.v_mask] = 0.0
        uyf[~df.v_mask] = 0.0
    if df.p_mask is not None:
        pf[~df.p_mask] = 0.0
    out[: df.n_vs] = uxf
    out[df.n_vs : 2 * df.n_vs] = uyf
    out[df.n_u :] = pf
    return out


def main():
    ckpt = sys.argv[1]
    outdir = sys.argv[2]
    T_end = float(sys.argv[3]) if len(sys.argv) > 3 else 7.6
    dt = float(sys.argv[4]) if len(sys.argv) > 4 else 0.004
    os.makedirs(outdir, exist_ok=True)
    re = 100.0
    u_mean = 1.0
    nu = u_mean * D / re

    def inflow(x, t=0.0):
        v = np.zeros_like(x)
        y = x[:, 1] + 0.2
        v[:, 0] = 1.5 * u_mean * 4.0 * y * (H - y) / H**2
        return v

    # coarse side: restore the developed refine-1 state.  The archived
    # refine-1 checkpoints were written before the round-5 layout defaults
    # changed (cells_per_block 512->448, chunk_cells 128->256); the restore
    # path validates the layout bit-for-bit, so pin the coarse solver to the
    # checkpoint-era knobs (it only restores + prolongs — never solves).
    mesh_c = load_dfg_mesh(1)
    cfg_c = make_cfg(1, 8.0, 0.0025, nu)
    cfg_c.krylov.cells_per_block = 512
    cfg_c.krylov.chunk_cells = 128
    sc = ns.NavierStokesSolver(mesh_c, cfg_c, log=ns.RunLog(verbose=False), inlet=inflow)
    sc.setup()
    sc.restore_checkpoint(ckpt)
    t0 = sc.time
    print(f"coarse state restored: t={t0:.3f} step={sc._step}", flush=True)
    u_c = np.asarray(sc._planar(sc.solution), np.float64)

    # fine side
    mesh_f = load_dfg_mesh(2)
    cfg_f = make_cfg(2, T_end, dt, nu)
    sf = ns.NavierStokesSolver(mesh_f, cfg_f, log=ns.RunLog(verbose=False), inlet=inflow)
    sf.setup()
    t_pro = time.time()
    u_f = prolong(sc, sf, u_c)
    print(f"prolonged {sc.dofs.n_total} -> {sf.dofs.n_total} dofs "
          f"in {time.time()-t_pro:.0f}s, |u_f| = {np.linalg.norm(u_f):.4e}",
          flush=True)
    del sc

    import jax.numpy as jnp

    sf.solution = jnp.asarray(u_f, sf._dtype)
    sf.solution_old = sf.solution.copy()
    sf.solution_old2 = None  # first fine step bootstraps with BDF1
    sf.time = t0
    sf._step = 0

    force = BoundaryForce(sf.dofs, tags=(13,), nu=nu, rho=1.0)
    scale = 2.0 / (1.0 * u_mean**2 * D)
    series = []
    t_start = time.time()

    def progress(step, t, f_chunk, res=None, iters=None, reaction=None):
        k0 = len(series)
        rx = np.asarray(reaction) if reaction is not None else None
        for i, f in enumerate(np.asarray(f_chunk)):
            row = {
                "step": k0 + i + 1, "t": t0 + (k0 + i + 1) * dt,
                "cd": float(f[0] * scale), "cl": float(f[1] * scale),
            }
            if rx is not None:
                row["cd_r"] = float(rx[i][0] * scale)
                row["cl_r"] = float(rx[i][1] * scale)
            series.append(row)
        s = series[-1]
        print(
            f"step {step:5d}  t={s['t']:7.3f}  Cd={s.get('cd_r', s['cd']):+.4f} "
            f"Cl={s.get('cl_r', s['cl']):+.4f}  |r|={float(np.asarray(res)[-1]):.2e} "
            f"gmres/step={float(np.mean(iters)):.0f}  wall={time.time()-t_start:7.1f}s",
            flush=True,
        )
        _dump(outdir, re, dt, t0, series, time.time() - t_start, True)
        sf.save_checkpoint(os.path.join(outdir, "ckpt.h5"))

    sf.solve_scanned(
        functional=force._force, reaction_tags=(13,),
        chunk=int(os.environ.get("DFG_CHUNK", "2")),
        newton_iters=int(os.environ.get("DFG_SWEEPS", "2")),
        progress=progress, resume=True,
    )
    _dump(outdir, re, dt, t0, series, time.time() - t_start, False)


def _dump(outdir, re, dt, t0, series, wall, partial):
    # settle window: the first ~0.25 s after prolongation re-adjusts the
    # solution to the fine mesh; stats start after it
    settle = float(os.environ.get("DFG_SETTLE", "0.35"))
    tail = [s for s in series if s["t"] >= t0 + settle]
    key_cd = "cd_r" if (tail and "cd_r" in tail[0]) else "cd"
    key_cl = "cl_r" if (tail and "cl_r" in tail[0]) else "cl"
    cd_v = [s[key_cd] for s in tail]
    cl_v = [s[key_cl] for s in tail]
    out = {
        "description": "DFG 2D-2 refine=2 via mesh sequencing from the "
        "developed refine-1 state (scripts/dfg_sequencing.py)",
        "force_eval": "reaction" if key_cd == "cd_r" else "traction",
        "re": re, "dt": dt, "scheme": "bdf2", "t_start": t0,
        "settle_window_s": settle,
        "wall_seconds": wall, "partial": partial,
        "stats_window": [tail[0]["t"] if tail else None,
                         tail[-1]["t"] if tail else None],
        "cd_max": max(cd_v) if cd_v else None,
        "cd_mean": float(np.mean(cd_v)) if cd_v else None,
        "cl_max": max(cl_v) if cl_v else None,
        "cl_min": min(cl_v) if cl_v else None,
        "strouhal": strouhal_number(cl_v, dt, D, 1.0) if len(cl_v) > 50 else None,
        "series": series,
    }
    with open(os.path.join(outdir, "cd_cl_refine2_seq.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
