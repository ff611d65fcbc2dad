"""3D (tet) outer-solve h-robustness sweep — VERDICT r4 #2.

The 2D coarse-space machinery (cc_coarse_agg_v=256, Kp pinning probe) was
tuned on triangles; the 3D backward-step solves ran at 40 outer FGMRES
iterations (1.59M DoF step-3 refine=2) vs 13-21 in 2D.  This sweeps the
coarse aggregate sizes, inner sweep lengths, and cycle compositions on the
step-3 mesh, timing whole forced Newton steps like bench.py's 3d leg.

    python -u scripts/sweep_3d.py
Env: SWEEP3D_MESH (mesh-step-3.msh), SWEEP3D_REFINE (2), SWEEP_COMBOS (json).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

COMBOS = [
    ("default(a4,ap8,aggv256)", {}),
    ("aggv512", {"cc_coarse_agg_v": 512}),
    ("aggv128", {"cc_coarse_agg_v": 128}),
    ("ap12", {"cc_iters_ap": 12}),
    ("a6", {"cc_iters_a00": 6}),
    ("agg128-forced", {"cc_coarse_agg": 128}),
]
if os.environ.get("SWEEP_COMBOS"):
    COMBOS = [(json.dumps(o), o) for o in json.loads(os.environ["SWEEP_COMBOS"])]


def main():
    import dataclasses as _dc

    from navier_stokes_tpu.config import SolverConfig
    from navier_stokes_tpu.mesh.mesh import refine_uniform
    from navier_stokes_tpu.mesh.msh_io import read_msh
    from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
    from navier_stokes_tpu.utils.logging import RunLog

    name = os.environ.get("SWEEP3D_MESH", "mesh-step-3.msh")
    base = read_msh(f"/root/reference/mesh/{name}")
    tags = list(base.tags)
    mesh = refine_uniform(base, int(os.environ.get("SWEEP3D_REFINE", "2")))
    rng = np.random.default_rng(0)
    for label, over in COMBOS:
        cfg = SolverConfig()
        cfg.dtype = "float32"
        cfg.krylov.matvec = "windowed"
        cfg.krylov.preconditioner = "cahouet_chabard"
        cfg.krylov.max_iters = 300
        cfg.krylov.tangent_store_dtype = "bfloat16"
        cfg.inlet_tags = (tags[0],)
        cfg.neumann_tags = tuple(tags[1:2])
        cfg.wall_tags = tuple(tags[2:])
        for k, v in over.items():
            setattr(cfg.krylov, k, v)
        try:
            s = NavierStokesSolver(mesh, cfg, log=RunLog(verbose=False))
            s.setup()
        except Exception as e:
            print(f"{label:26s} SETUP FAILED: {type(e).__name__}: {str(e)[:160]}",
                  flush=True)
            continue
        n = s.dofs.n_total
        uo = s.solution_old
        bv = jnp.asarray(s.dirichlet.values(cfg.dt), dtype=uo.dtype)

        def u_rand():
            return jnp.asarray(0.05 * rng.standard_normal(n), dtype=uo.dtype)

        try:
            out = s._newton_iteration(u_rand(), uo, bv, cfg.dt, True)
            jax.block_until_ready(out[0])  # compile
            ts, its = [], []
            for _ in range(3):
                u = u_rand()
                t0 = time.perf_counter()
                out = s._newton_iteration(u, uo, bv, cfg.dt, True)
                float(np.asarray(out[0][0]))
                ts.append(time.perf_counter() - t0)
                its.append(int(out[2]))
            lay = s._win_layout
            print(
                f"{label:26s} newton {np.median(ts)*1e3:7.1f} ms  iters={its}  "
                f"conv={bool(out[3])}  n={n} nb={lay.nb} Wv={lay.Wv} "
                f"hv={lay.hv}",
                flush=True,
            )
        except Exception as e:
            print(f"{label:26s} RUN FAILED: {type(e).__name__}: {str(e)[:200]}",
                  flush=True)
        del s


if __name__ == "__main__":
    main()
