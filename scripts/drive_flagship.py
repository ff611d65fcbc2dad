"""End-to-end drive: as-shipped flagship run + NEW code paths (cahouet_chabard
preconditioner, Stokes initial guess) on the target backend.

env: VERIFY_BACKEND=gpu|cpu (cpu forces f64 oracle)
"""
import os
import sys

backend = os.environ.get("VERIFY_BACKEND", "gpu")

import jax

if backend == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import navier_stokes_tpu as ns
from navier_stokes_tpu.io.xdmf import XdmfWriter

# ---- drive 1: canonical as-shipped run, windowed + cahouet_chabard ------
cfg = ns.SolverConfig()
cfg.T = 0.15
cfg.krylov.matvec = "windowed"
cfg.krylov.preconditioner = "cahouet_chabard"
s = ns.NavierStokesSolver("/root/reference/mesh/correct_mesh_yt.msh", cfg)
s.setup()
out_dir = f"/tmp/nsout_{backend}"
os.makedirs(out_dir, exist_ok=True)
w = XdmfWriter(s.dofs, output_dir=out_dir)
s.output_hooks.append(lambda st, t, sol: w.write(st, t, sol))
s.solve()
traj = [
    (r["iter"], r["residual"])
    for r in s.log.records
    if r.get("event") == "newton"
]
print("TRAJ1", traj, flush=True)

# ---- drive 2: Stokes initial guess path (designed reference path) -------
cfg2 = ns.SolverConfig()
cfg2.T = 0.10
cfg2.krylov.matvec = "windowed"
cfg2.krylov.preconditioner = "cahouet_chabard"
cfg2.initial_guess = "stokes"
s2 = ns.NavierStokesSolver("/root/reference/mesh/correct_mesh_yt.msh", cfg2)
s2.setup()
s2.solve()
traj2 = [
    (r["iter"], r["residual"])
    for r in s2.log.records
    if r.get("event") == "newton"
]
stokes_recs = [
    r for r in s2.log.records if r.get("event") == "gmres" and r.get("system") == "stokes"
]
print("TRAJ2", traj2, flush=True)
print("STOKES_GMRES", [(r["iters"]) for r in stokes_recs], flush=True)

import numpy as np

v = s.velocity(real_only=True)
p = s.pressure(real_only=True)
print(
    "FIELDS finite=",
    bool(np.all(np.isfinite(v)) and np.all(np.isfinite(p))),
    "p_mean=", float(np.mean(p)),
    "v_max=", float(np.max(np.abs(v))),
    flush=True,
)
print("FILES", sorted(os.listdir(out_dir))[:6], flush=True)
print("VERIFY_DONE", flush=True)
