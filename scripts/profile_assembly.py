"""Micro-profile of the windowed assembly + matvec composition on the device.

Times each stage of assemble_windowed separately (gathers, convection
einsums, A_const add, residual scatter) plus the standalone matvec, to
locate the gap to the memory-bandwidth roofline.  One process per card:

    python scripts/profile_assembly.py

Env: PROF_REFINE (default 2 -> 543k DoF), PROF_REPS (default 10).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

REFINE = int(os.environ.get("PROF_REFINE", "2"))
REPS = int(os.environ.get("PROF_REPS", "10"))


def timed(fn, *args, reps=REPS, label=""):
    """fn is wrapped so only SCALAR checksums leave the jitted program."""

    @jax.jit
    def wrapped(*a):
        out = fn(*a)
        return sum(jnp.sum(o) for o in jax.tree.leaves(out))

    jax.block_until_ready(wrapped(*args))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = wrapped(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps * 1e3
    print(f"{label:34s} {dt:8.2f} ms", flush=True)
    return dt


def main():
    from navier_stokes_tpu.config import SolverConfig
    from navier_stokes_tpu.fem.windowed_assembly import assemble_windowed
    from navier_stokes_tpu.mesh.mesh import refine_uniform
    from navier_stokes_tpu.mesh.msh_io import read_msh
    from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
    from navier_stokes_tpu.ops.windowed import (
        windowed_gather, windowed_matvec, windowed_scatter)
    from navier_stokes_tpu.utils.logging import RunLog

    mesh = refine_uniform(read_msh("/root/reference/mesh/correct_mesh_yt.msh"), REFINE)
    cfg = SolverConfig()
    cfg.krylov.matvec = "windowed"
    s = NavierStokesSolver(mesh, cfg, log=RunLog(verbose=False))
    s.setup()
    lay, wa = s._win_layout, s._wassembly
    n = s.dofs.n_total
    print(f"n_dofs={n}  ncd={lay.ncd}  nb={lay.nb}  Bmax={lay.Bmax}  "
          f"hv={lay.hv}", flush=True)
    rng = np.random.default_rng(0)
    u = jnp.asarray(0.05 * rng.standard_normal(n), jnp.float32)
    uo = jnp.asarray(0.05 * rng.standard_normal(n), jnp.float32)

    kw = dict(dt=cfg.dt, nu=cfg.nu, rho=cfg.rho,
              convection_form=cfg.convection_form,
              include_continuity_residual=cfg.include_continuity_residual)

    # full assembly
    full = jax.jit(lambda wa_a, lay_a, a, b: assemble_windowed(wa_a, lay_a, a, b, **kw))
    timed(full, wa, lay, u, uo, label="assemble_windowed (A_t, r, diag)")

    # stages
    g1 = jax.jit(lambda lay_a, a: windowed_gather(lay_a, a))
    timed(g1, lay, u, label="windowed_gather (1x)")

    def conv_only(wa_a, lay_a, a, b):
        A_t, _, _ = assemble_windowed(wa_a, lay_a, a, b, **kw)
        return A_t
    timed(jax.jit(conv_only), wa, lay, u, uo, label="assembly -> A_t only")

    def resid_only(wa_a, lay_a, a, b):
        _, r, _ = assemble_windowed(wa_a, lay_a, a, b, **kw)
        return r
    timed(jax.jit(resid_only), wa, lay, u, uo, label="assembly -> residual only")

    sc = jax.jit(lambda lay_a, R: windowed_scatter(lay_a, R))
    R = jnp.zeros((lay.nli, lay.ncd), jnp.float32) + 0.1
    timed(sc, lay, R, label="windowed_scatter (1x)")

    A_t, _, _ = jax.block_until_ready(full(wa, lay, u, uo))
    mv = jax.jit(windowed_matvec)
    timed(mv, lay, A_t, u, label="windowed_matvec")

    # HBM roofline reference: A_t is the dominant stream
    a_mb = A_t.size * A_t.dtype.itemsize / 1e6
    print(f"A_t = {a_mb:.0f} MB -> roofline ~{a_mb/800:.2f} ms at 800 GB/s")


if __name__ == "__main__":
    main()
