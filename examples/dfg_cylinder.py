"""DFG flow-past-a-cylinder benchmark (2D-2, Re=100) with Cd/Cl/Strouhal.

BASELINE.json config #3/#4: the shipped DFG channel mesh (mesh_poli.msh,
2.2 x 0.41 channel offset to [-0.2, 2.0] x [-0.2, 0.21], cylinder r=0.05 at
the origin), parabolic inflow with mean velocity 1 -> Re = u_mean*D/nu = 100.
Published DFG 2D-2 bands (Schaefer-Turek): Cd_max in [3.22, 3.24],
Cl_max ~ 1.0, St in [0.295, 0.305].

The shipped mesh carries no physical groups (all boundary tag 0 — the
reference's hardcoded ids 10-13 could never have matched it), so boundaries
are retagged geometrically to the reference's id convention.  Runs with the
CORRECTED formulation flags (standard convection + continuity residual) and
BDF2 time stepping: the quirk-faithful implicit-Euler variant is for
trajectory parity, not physics (BDF1's dissipation damps the Cl amplitude).

The flow is started impulsively and needs ~3-5 s to break symmetry and
develop the vortex street; statistics are taken over the trailing
STATS_FRACTION of the series.

Usage: python examples/dfg_cylinder.py [outdir] [T] [dt] [re]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import navier_stokes_tpu as ns
from navier_stokes_tpu.models.functionals import BoundaryForce, strouhal_number

from dfg_common import D, H, load_dfg_mesh  # noqa: F401 (shared DFG geometry)

STATS_FRACTION = 0.35  # trailing window for developed-regime statistics


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "dfg_out"
    T = float(sys.argv[2]) if len(sys.argv) > 2 else 8.0
    dt = float(sys.argv[3]) if len(sys.argv) > 3 else 0.0025
    re = float(sys.argv[4]) if len(sys.argv) > 4 else 100.0
    os.makedirs(outdir, exist_ok=True)
    u_mean = 1.0
    u_m = 1.5 * u_mean
    nu = u_mean * D / re

    # smooth inlet ramp over [0, DFG_RAMP] seconds (0 = legacy impulsive
    # start).  The impulsive start's boundary-layer shock makes the first
    # ~100 tangent solves saturate any iteration cap at refine>=2 (measured:
    # 360 GMRES iterations/step, 16 s/step at 1.78M DoF); the developed
    # limit cycle is independent of the startup protocol, so ramping is
    # statistics-neutral and cuts hours off the fine-mesh runs.
    ramp_T = float(os.environ.get("DFG_RAMP", "0"))

    def inflow(x, t=0.0):
        v = np.zeros_like(x)
        y = x[:, 1] + 0.2  # channel occupies y in [-0.2, 0.21]
        prof = 4.0 * y * (H - y) / H**2
        ramp = 1.0 if not ramp_T else min(1.0, t / ramp_T)
        prof = ramp * prof
        v[:, 0] = u_m * prof
        # symmetry-breaking kick: cross-flow at the expected SHEDDING
        # frequency (St 0.3 -> f = St*U/D = 3 Hz) for t in [0, 2].  From an
        # impulsive symmetric start the Karman instability otherwise grows
        # from solver noise only (tens of seconds of physical time); the
        # resonant kick pumps the unstable mode directly and the limit
        # cycle is independent of the seed.
        if t < 2.0:
            v[:, 1] = 0.15 * u_m * np.sin(2.0 * np.pi * 3.0 * t) * prof
        return v

    refine = int(os.environ.get("DFG_REFINE", "1"))
    mesh = load_dfg_mesh(refine)
    cfg = ns.SolverConfig(T=T, dt=dt, nu=nu, rho=1.0, p_out=0.0)
    cfg.convection_form = "standard"
    cfg.include_continuity_residual = True
    cfg.jacobian_mass_rho = True
    cfg.time_scheme = "bdf2"
    # tol 1e-4 with min_iters=1: an absolute tol alone makes Newton exit at
    # iteration 0 once the flow is near-steady, freezing the solution
    # exactly and quenching the Karman instability below that amplitude;
    # the forced per-step sweep keeps small dynamics alive without chasing
    # tolerances below the attainable residual floor
    cfg.newton.tol = 1e-4
    cfg.newton.min_iters = 1
    cfg.newton.max_iters = 8
    # the tangent solve's RELATIVE tolerance sets a numerical damping rate
    # sigma_num ~ -rel_tol/dt on the near-neutral (slowest-Krylov) Karman
    # direction: at 1e-2/0.0025 that is -4/s, which kills the +0.5/s
    # physical instability (measured: resonant 3 Hz kicks decayed at
    # exactly -4/s).  1e-4 brings sigma_num to -0.04/s.  refine=2 runs at
    # 1e-3: the weakly-pinned channel's near-null pressure mode makes
    # rel<~1e-3 unreachable there at any restart/sweep setting (see
    # KrylovConfig.cc_coarse_agg), and sigma_num -0.4/s still lets the
    # kicked +0.5/s instability reach its limit cycle
    cfg.krylov.rel_tol = float(
        os.environ.get("DFG_RELTOL", "1e-4" if refine <= 1 else "1e-3")
    )
    cfg.krylov.max_iters = int(os.environ.get("DFG_GMRES_CAP", "150"))
    cfg.krylov.matvec = "windowed"
    cfg.krylov.preconditioner = "cahouet_chabard"
    # the pressure-Laplacian inner sweeps must track the mesh: Kp's condition
    # number grows as h^-2, so the refine=0 sweet spot (4) stalls the outer
    # FGMRES against its cap at refine>=1
    # refine>=2: the A00 sweep is the outer-iteration lever at this regime's
    # convective CFL (~2.5): a00=8 cut the 1.78M probe tangent 68 -> 22
    # outer iterations; SHORT Kp sweeps win there (the longer sweep's better
    # Kp^-1 approximation resolves the weakly-pinned near-null mode whose
    # amplified response poisons the f32 outer basis — ap=24: 228 outer
    # iters, ap=2: 68; scripts/sweep_hrobust.py)
    cfg.krylov.cc_iters_a00 = int(
        os.environ.get("DFG_CC_A00", {0: "2", 1: "4"}.get(refine, "8"))
    )
    cfg.krylov.cc_iters_ap = int(
        os.environ.get("DFG_CC_AP", {0: "4", 1: "10"}.get(refine, "2"))
    )
    # refine>=1 at developed flow: convection ~ mass in A00 (u*dt/h ~ 1), so
    # the fixed CG micro-sweep emits divergent directions and the outer
    # FGMRES saturates its cap -> under-converged Newton updates -> blowup
    # at t~0.7 (observed).  The Jacobi-FGMRES inner sweep is convection-robust
    # at the same matvec cost (see KrylovConfig.a00_solver).
    cfg.krylov.a00_solver = os.environ.get(
        "DFG_A00_SOLVER", "cg" if refine == 0 else "gmres"
    )
    # two-level coarse correction on the Kp sweeps (KrylovConfig.
    # cc_coarse_agg): at refine<=1 it makes the inner-sweep quality
    # h-independent (measured at refine=0: 5.2x fewer outer FGMRES
    # iterations vs plain Jacobi at equal cc_iters_ap).  At refine>=2 the
    # weakly-pinned Kp's coarse matrix develops a near-null mode whose
    # amplified correction STALLS the f32 outer solve outright (see the
    # KrylovConfig.cc_coarse_agg note + scripts/sweep_hrobust.py) — plain
    # Jacobi-CG with a longer sweep is the validated configuration there.
    cfg.krylov.cc_coarse_agg = int(
        os.environ.get("DFG_CC_COARSE", "128" if refine <= 1 else "0")
    )

    log = ns.RunLog(verbose=False)
    solver = ns.NavierStokesSolver(mesh, cfg, log=log, inlet=inflow)
    solver.setup()
    force = BoundaryForce(solver.dofs, tags=(13,), nu=cfg.nu, rho=cfg.rho)
    scale = 2.0 / (cfg.rho * u_mean**2 * D)

    # checkpoint/resume: multi-hour production runs must be restartable.  DFG_CKPT_EVERY chunks between saves (0 disables);
    # DFG_RESUME=1 restores outdir/ckpt.h5 + the matching series prefix.
    ckpt_every = int(os.environ.get("DFG_CKPT_EVERY", "20"))
    ckpt_path = os.path.join(outdir, "ckpt.h5")
    series = []
    resume = os.environ.get("DFG_RESUME", "0") == "1" and os.path.exists(ckpt_path)
    if resume:
        solver.restore_checkpoint(ckpt_path)
        sp = os.path.join(outdir, "cd_cl_series.json")
        if os.path.exists(sp):
            with open(sp) as f:
                series = json.load(f)["series"][: solver._step]
        assert len(series) == solver._step, (
            f"series length {len(series)} != checkpoint step {solver._step}"
        )
        print(f"resuming from t={solver.time:.4f} (step {solver._step})", flush=True)
    t_start = time.time()

    def progress(step, t, f_chunk, res=None, iters=None, reaction=None):
        k0 = len(series)
        rx = np.asarray(reaction) if reaction is not None else None
        for i, f in enumerate(np.asarray(f_chunk)):
            row = {
                "step": k0 + i + 1, "t": (k0 + i + 1) * dt,
                "cd": float(f[0] * scale), "cl": float(f[1] * scale),
            }
            if rx is not None:
                # superconvergent boundary-reaction evaluation of the same
                # force (models/functionals.BoundaryReaction, in-scan): the
                # HEADLINE Cd/Cl — the traction quadrature above is kept for
                # the convergence comparison
                row["cd_r"] = float(rx[i][0] * scale)
                row["cl_r"] = float(rx[i][1] * scale)
            series.append(row)
        s = series[-1]
        # post-Newton residual + GMRES work per step: a frozen/stalled run
        # (GMRES returning ~0 corrections) is visible here, not just in the
        # suspiciously-constant force series
        diag = ""
        if res is not None:
            diag = f"  |r|={float(np.asarray(res)[-1]):.2e}  gmres/step={float(np.mean(iters)):.0f}"
        print(
            f"step {step:5d}  t={t:7.3f}  Cd={s['cd']:+.4f}  Cl={s['cl']:+.4f}"
            f"{diag}  wall={time.time()-t_start:7.1f}s",
            flush=True,
        )
        _dump(outdir, re, dt, series, time.time() - t_start, partial=True)
        progress.n_chunks = getattr(progress, "n_chunks", 0) + 1
        if ckpt_every and progress.n_chunks % ckpt_every == 0:
            solver.save_checkpoint(ckpt_path + ".tmp")
            os.replace(ckpt_path + ".tmp", ckpt_path)  # atomic swap

    # device-resident scanned time loop: ONE host round trip per chunk —
    # per-step host<->device traffic (BC upload, functional/residual
    # download) otherwise dominates wall time on high-latency links
    solver.solve_scanned(
        functional=force._force, reaction_tags=(13,),
        chunk=int(os.environ.get("DFG_CHUNK", "10")),
        newton_iters=int(os.environ.get("DFG_SWEEPS", "2")), progress=progress,
        resume=resume,
    )
    wall = time.time() - t_start
    _dump(outdir, re, dt, series, wall, partial=False)
    tail = series[int(len(series) * (1 - STATS_FRACTION)):]
    key_cd = "cd_r" if (tail and "cd_r" in tail[0]) else "cd"
    key_cl = "cl_r" if (tail and "cl_r" in tail[0]) else "cl"
    cd_v = [s[key_cd] for s in tail]
    cl_v = [s[key_cl] for s in tail]
    st = strouhal_number(cl_v, dt, D, u_mean)
    print(
        f"\nRe={re:g} cylinder: {len(series)} steps in {wall:.1f}s; developed "
        f"window ({key_cd}): Cd_max={max(cd_v):.4f} Cd_mean={np.mean(cd_v):.4f} "
        f"Cl_max={max(cl_v):+.4f} Cl_min={min(cl_v):+.4f} St={st:.4f}"
    )


def _dump(outdir, re, dt, series, wall, partial):
    tail = series[int(len(series) * (1 - STATS_FRACTION)):]
    # headline stats from the superconvergent reaction evaluation when
    # present; the traction-quadrature stats are archived alongside
    key_cd = "cd_r" if (tail and "cd_r" in tail[0]) else "cd"
    key_cl = "cl_r" if (tail and "cl_r" in tail[0]) else "cl"
    cl_v = [s[key_cl] for s in tail]
    cd_v = [s[key_cd] for s in tail]
    cl_t = [s["cl"] for s in tail]
    cd_t = [s["cd"] for s in tail]
    out = {
        "force_eval": "reaction" if key_cd == "cd_r" else "traction",
        "cd_max_traction": max(cd_t) if cd_t else None,
        "cl_max_traction": max(cl_t) if cl_t else None,
        "re": re,
        "dt": dt,
        "scheme": "bdf2",
        "wall_seconds": wall,
        "partial": partial,
        "stats_window": [tail[0]["t"] if tail else 0.0, tail[-1]["t"] if tail else 0.0],
        "cd_max": max(cd_v) if cd_v else None,
        "cd_mean": float(np.mean(cd_v)) if cd_v else None,
        "cl_max": max(cl_v) if cl_v else None,
        "cl_min": min(cl_v) if cl_v else None,
        "strouhal": strouhal_number(cl_v, dt, D, 1.0) if cl_v else None,
        "series": series,
    }
    with open(os.path.join(outdir, "cd_cl_series.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    from navier_stokes_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
