"""Stage profile of the Cahouet-Chabard-preconditioned Newton iteration.

Times, at the bench configuration (cylinder mesh refined PROF_REFINE times,
as-shipped physics): the outer windowed matvec, the full CC preconditioner
apply, its sub-stages (A00 sweep / B coupling / Kp CG / coarse correction),
and the assemble+solve Newton step — to attribute the per-outer-iteration
cost (bench: newton_ms / iters >> matvec_ms).

One process per card:
    python -u scripts/profile_precond.py
Env: PROF_REFINE (default 2), PROF_REPS (default 20).

Reading guide: the per-APPLY cost is not the optimization target — the
per-NEWTON-STEP cost is.  Lengthening the A00 sweep (cc_iters_a00 2 -> 4)
makes each apply dearer but cuts the OUTER iteration count 21 -> 14-16, so
compare applies only at equal outer counts (scripts/sweep_r5.py times whole
forced Newton steps for exactly this reason).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

REFINE = int(os.environ.get("PROF_REFINE", "2"))
REPS = int(os.environ.get("PROF_REPS", "20"))


def main():
    from navier_stokes_tpu.config import SolverConfig
    from navier_stokes_tpu.fem.windowed_assembly import assemble_windowed
    from navier_stokes_tpu.mesh.mesh import refine_uniform
    from navier_stokes_tpu.mesh.msh_io import read_msh
    from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
    from navier_stokes_tpu.ops.windowed import (
        slice_block, windowed_matvec, windowed_matvec_block)
    from navier_stokes_tpu.utils.logging import RunLog

    mesh = refine_uniform(read_msh("/root/reference/mesh/correct_mesh_yt.msh"), REFINE)
    cfg = SolverConfig()
    cfg.krylov.matvec = "windowed"
    cfg.krylov.preconditioner = "cahouet_chabard"
    if os.environ.get("PROF_CC_COARSE"):
        cfg.krylov.cc_coarse_agg = int(os.environ["PROF_CC_COARSE"])
    s = NavierStokesSolver(mesh, cfg, log=RunLog(verbose=False))
    s.setup()
    n = s.dofs.n_total
    lay, wa = s._win_layout, s._wassembly
    print(f"n_total={n} n_ps={s.dofs.n_ps} coarse_agg={cfg.krylov.cc_coarse_agg}",
          flush=True)

    rng = np.random.default_rng(0)
    u = jnp.asarray(0.05 * rng.standard_normal(n), dtype=s._dtype)
    uo = s.solution_old
    bc_rows = s._bc_rows

    @jax.jit
    def build(wa_a, lay_a, uu, uoo):
        A_t, r, diag0 = assemble_windowed(
            wa_a, lay_a, uu, uoo, dt=cfg.dt, nu=cfg.nu, rho=cfg.rho,
            convection_form=cfg.convection_form,
            include_continuity_residual=cfg.include_continuity_residual)
        return A_t, r, diag0

    A_t, r0, diag0 = build(wa, lay, u, uo)
    bc_diag = diag0.at[bc_rows].get(mode="fill", fill_value=1.0)

    from navier_stokes_tpu.la.cg import cg
    from navier_stokes_tpu.la.preconditioners import coarse_correction, jacobi
    n_u = lay.dim * lay.n_vs
    pA = jacobi(diag0[:n_u].at[bc_rows].set(bc_diag, mode="drop"))
    if wa.coarse_inv_v is not None:  # mirror production: + velocity coarse
        _jac_u = pA
        _coarse_v = coarse_correction(
            wa.agg_v, wa.coarse_inv_v, wa.coarse_agg_size_v, ncomp=lay.dim
        )
        pA = lambda r: _jac_u(r) + _coarse_v(r)

    # every stage takes its big buffers as jit ARGUMENTS, never as baked
    # closure constants (same rule as newton_iteration)
    def st_outer(lay_a, A, _wa, v):
        return windowed_matvec(lay_a, A, v)

    def mk_precond(lay_a, A, wa_a):
        return s._make_windowed_preconditioner(
            lay_a, A, wa_a, bc_diag, diag0, bc_rows)

    def st_precond(lay_a, A, wa_a, v):
        return mk_precond(lay_a, A, wa_a)(v)

    # block storage dtype mirrors production (KrylovConfig.precond_block_dtype)
    bdt = (
        jnp.bfloat16
        if cfg.krylov.precond_block_dtype == "bfloat16" and s._dtype == jnp.float32
        else s._dtype
    )

    def st_a00_sweep(lay_a, A, _wa, v):
        A00 = slice_block(lay_a, A, "v", "v").astype(bdt)

        def mv(w):
            w = w.at[bc_rows].set(0.0, mode="drop")
            y = windowed_matvec_block(lay_a, A00, w, in_spaces="v",
                                      out_spaces="v")
            wb = w.at[bc_rows].get(mode="fill", fill_value=0.0)
            return y.at[bc_rows].set(bc_diag * wb, mode="drop")

        return cg(mv, v[:n_u], atol=0.0, maxiter=cfg.krylov.cc_iters_a00,
                  precond=pA).x

    def st_a00_mv(lay_a, A, _wa, v):
        A00 = slice_block(lay_a, A, "v", "v").astype(bdt)
        return windowed_matvec_block(lay_a, A00, v[:n_u], in_spaces="v",
                                     out_spaces="v")

    def st_b_mv(lay_a, A, _wa, v):
        B = slice_block(lay_a, A, "v", "p").astype(bdt)
        return windowed_matvec_block(lay_a, B, v[:n_u], in_spaces="v",
                                     out_spaces="p")

    def st_kp_mv(lay_a, _A, wa_a, v):
        return windowed_matvec_block(lay_a, wa_a.Kp_t.astype(bdt), v[n_u:],
                                     in_spaces="p", out_spaces="p")

    def _mk_pkp(wa_a):
        # the SHARED production coarse apply (la/preconditioners.
        # coarse_correction) — one implementation for the solver and this
        # profiler, so the stage attribution cannot desynchronize (ADVICE r2)
        pj_a = jacobi(wa_a.diag_kp)
        if wa_a.coarse_inv is None:
            return pj_a, pj_a
        coarse_a = coarse_correction(
            wa_a.agg_p, wa_a.coarse_inv, wa_a.coarse_agg_size
        )
        return coarse_a, lambda rp: pj_a(rp) + coarse_a(rp)

    def st_kp_cg(lay_a, _A, wa_a, v):
        _, pkp = _mk_pkp(wa_a)

        def mv(p):
            return windowed_matvec_block(lay_a, wa_a.Kp_t.astype(bdt), p,
                                         in_spaces="p", out_spaces="p")

        return cg(mv, v[n_u:], atol=0.0, maxiter=cfg.krylov.cc_iters_ap,
                  precond=pkp).x

    def st_coarse(_lay, _A, wa_a, v):
        coarse_a, _ = _mk_pkp(wa_a)
        return coarse_a(v[n_u:])

    stages = {
        "outer_matvec(p2)": st_outer,
        "precond_full": st_precond,
        "a00_sweep(cg%d)" % cfg.krylov.cc_iters_a00: st_a00_sweep,
        "A00_mv(bf16)": st_a00_mv,
        "B_mv": st_b_mv,
        "Kp_mv": st_kp_mv,
        "kp_cg(%d)" % cfg.krylov.cc_iters_ap: st_kp_cg,
        "coarse_only": st_coarse,
    }

    import functools

    x0 = jnp.asarray(rng.standard_normal(n), dtype=s._dtype)
    for name, fn in stages.items():
        # marginal cost of one chained-scan iteration (same methodology as
        # bench.py):  t = (T(length=REPS+1) - T(length=1)) / REPS.  The
        # output->input chain defeats loop-invariant hoisting; the
        # length-1/length-REPS+1 difference cancels the fixed launch cost.
        @functools.partial(jax.jit, static_argnames=("length",))
        def loop(lay_a, A, wa_a, v0, length, f=fn):
            def body(v, _):
                sc = jnp.sum(f(lay_a, A, wa_a, v) ** 2)
                return v * (1.0 + 1e-9 * jnp.tanh(sc)), sc

            vf, ss = jax.lax.scan(body, v0, None, length=length)
            return vf[0], ss.sum()

        def run(length, x):
            return float(np.asarray(loop(lay, A_t, wa, x, length)[1]))

        run(1, x0)  # compile
        run(REPS + 1, x0)  # compile
        t0 = time.perf_counter()
        run(1, x0 * 1.000001)
        t_short = time.perf_counter() - t0
        t0 = time.perf_counter()
        run(REPS + 1, x0 * 1.000002)
        dt_ms = max(time.perf_counter() - t0 - t_short, 1e-9) / REPS * 1e3
        print(f"  {name:20s} {dt_ms:8.3f} ms", flush=True)


if __name__ == "__main__":
    main()
