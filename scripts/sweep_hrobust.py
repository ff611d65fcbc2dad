"""h-robustness sweep: outer FGMRES iterations + Newton-step time vs the
velocity-coarse / inner-sweep knobs, at bench problem sizes.

Goal (VERDICT r2 #1): flat outer iteration counts 543k -> 1.78M -> 5M DoF.
Builds the solver ONCE per mesh, then rebuilds only the windowed-assembly
coarse spaces + kernels per variant (the expensive renumbering/layout is
shared).

One process per card:
    python -u scripts/sweep_hrobust.py
Env: SWEEP_MESH (cyl|poli), SWEEP_REFINE, SWEEP_VARIANTS (semicolon list of
aggv,a00,ap triples, e.g. "0,2,8;256,2,8;256,3,8").
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

MESH = os.environ.get("SWEEP_MESH", "cyl")
REFINE = int(os.environ.get("SWEEP_REFINE", "2"))
VARIANTS = os.environ.get(
    "SWEEP_VARIANTS", "0,2,8;256,2,8;256,3,8;512,2,8;256,2,6"
)


def main():
    from navier_stokes_tpu.config import SolverConfig
    from navier_stokes_tpu.fem.windowed_assembly import build_windowed_assembly
    from navier_stokes_tpu.mesh.mesh import refine_uniform
    from navier_stokes_tpu.mesh.msh_io import read_msh
    from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
    from navier_stokes_tpu.utils.logging import RunLog

    if MESH == "dfg":
        # the PRODUCTION problem: geometrically retagged DFG channel
        # (outlet=10 pins Kp through the short right edge — the weakly-pinned
        # configuration the kp_deflate machinery targets), curved-cylinder
        # snapping under refinement
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
        from dfg_common import load_dfg_mesh

        mesh = load_dfg_mesh(REFINE)
    else:
        path = {
            "cyl": "/root/reference/mesh/correct_mesh_yt.msh",
            "poli": "/root/reference/mesh/mesh_poli.msh",
        }[MESH]
        mesh = refine_uniform(read_msh(path), REFINE)

    cfg = SolverConfig()
    cfg.krylov.matvec = "windowed"
    cfg.krylov.preconditioner = "cahouet_chabard"
    cfg.krylov.max_iters = 300
    if os.environ.get("SWEEP_DT"):  # probe other regimes (e.g. DFG dt=0.0025)
        cfg.dt = float(os.environ["SWEEP_DT"])
    if os.environ.get("SWEEP_PRODUCTION", "0") == "1":
        # the DFG production formulation (examples/dfg_cylinder.py)
        cfg.convection_form = "standard"
        cfg.include_continuity_residual = True
        cfg.jacobian_mass_rho = True
        cfg.time_scheme = "bdf2"
    if os.environ.get("SWEEP_A00_SOLVER"):
        cfg.krylov.a00_solver = os.environ["SWEEP_A00_SOLVER"]
    if os.environ.get("SWEEP_CYCLE_A00"):
        cfg.krylov.cc_cycle_a00 = os.environ["SWEEP_CYCLE_A00"]
    if os.environ.get("SWEEP_CYCLE_AP"):
        cfg.krylov.cc_cycle_ap = os.environ["SWEEP_CYCLE_AP"]
    if os.environ.get("SWEEP_RESTART"):
        cfg.krylov.restart = int(os.environ["SWEEP_RESTART"])
    if os.environ.get("SWEEP_RELTOL"):
        cfg.krylov.rel_tol = float(os.environ["SWEEP_RELTOL"])
    s = NavierStokesSolver(mesh, cfg, log=RunLog(verbose=False))
    s.setup()
    n = s.dofs.n_total
    print(f"mesh={MESH} refine={REFINE} n_total={n}", flush=True)

    rng = np.random.default_rng(0)
    uo = s.solution_old
    bv = jnp.asarray(s.dirichlet.values(cfg.dt), dtype=s._dtype)

    def mk_state(eps):
        """Tangent linearization state for the timed Newton step.

        'smooth': an h-INDEPENDENT physical-scale field (the honest
        h-robustness probe: a random per-dof state has gradients ~1/h, so
        its tangent gets intrinsically harder under refinement and masks
        the preconditioner's own h-scaling).  'random': legacy bench state.
        """
        amp = float(os.environ.get("SWEEP_AMP", "0.3"))
        if os.environ.get("SWEEP_STATE", "smooth") == "random":
            return jnp.asarray(0.05 * rng.standard_normal(n), dtype=s._dtype)
        vc, pc = s.dofs.v_coords, s.dofs.p_coords
        kx, ky = 2.0 * np.pi, 2.0 * np.pi
        ux = amp * np.sin(kx * vc[:, 0] + eps) * np.cos(ky * vc[:, 1])
        uy = -amp * np.cos(kx * vc[:, 0] + eps) * np.sin(ky * vc[:, 1])
        p = (amp / 3.0) * np.cos(kx * pc[:, 0] + eps)
        comps = [ux, uy] if s.dofs.dim == 2 else [ux, uy, np.zeros(len(vc))]
        return jnp.asarray(np.concatenate(comps + [p]), dtype=s._dtype)

    for spec in VARIANTS.split(";"):
        f = spec.split(",")  # aggv,a00,ap[,aggp[,cond_cap]]
        aggv, a00, ap = int(f[0]), int(f[1]), int(f[2])
        cfg.krylov.cc_coarse_agg_v = aggv
        cfg.krylov.cc_iters_a00 = a00
        cfg.krylov.cc_iters_ap = ap
        if len(f) > 3:
            cfg.krylov.cc_coarse_agg = int(f[3])
        if len(f) > 4:
            cfg.krylov.cc_coarse_cond_cap = float(f[4])
        t0 = time.perf_counter()
        s._wassembly = build_windowed_assembly(
            s.ctx, s._win_layout, s.dofs,
            dt=s._dt_tangent, nu=cfg.nu, rho=cfg.rho, p_out=cfg.p_out,
            jacobian_mass_rho=cfg.jacobian_mass_rho,
            pin_pdofs=s.dofs.boundary_scalar_pdofs(cfg.neumann_tags),
            coarse_agg=cfg.krylov.cc_coarse_agg,
            coarse_agg_v=cfg.krylov.cc_coarse_agg_v,
            pin_vdofs=s.dofs.boundary_scalar_vdofs(
                tuple(cfg.inlet_tags) + tuple(cfg.wall_tags)
            ),
            coarse_cond_cap=cfg.krylov.cc_coarse_cond_cap,
            kp_deflate=int(os.environ.get("SWEEP_DEFLATE", "0")),
        )
        s._build_kernels()
        t_build = time.perf_counter() - t0

        def step(state):
            return s._newton_iteration(state, uo, bv, cfg.dt, True)

        def sync(out):
            return [float(np.asarray(o.ravel()[0])) for o in jax.tree.leaves(out)]

        sync(step(mk_state(0.03)))
        ts, its, convs, rels = [], [], [], []
        for j in range(3):
            st = mk_state(0.01 * j)
            t0 = time.perf_counter()
            out = step(st)
            sync(out)
            ts.append(time.perf_counter() - t0)
            its.append(int(out[2]))
            convs.append(bool(out[3]))
            # final tangent-solve RELATIVE residual (kres / newton res norm)
            rels.append(float(out[4]) / max(float(out[1]), 1e-300))
        print(
            f"  aggv={aggv:4d} a00={a00} ap={ap} aggp={cfg.krylov.cc_coarse_agg}"
            f" cap={cfg.krylov.cc_coarse_cond_cap:g}"
            f" a00_solver={cfg.krylov.a00_solver}"
            f" cyc=({cfg.krylov.cc_cycle_a00},{cfg.krylov.cc_cycle_ap})"
            f": iters={its} conv={convs} "
            f"rel={['%.1e' % r for r in rels]} "
            f"newton_ms={sorted(ts)[1]*1e3:.1f} (build {t_build:.1f}s)",
            flush=True,
        )


if __name__ == "__main__":
    main()
