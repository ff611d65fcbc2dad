"""Newton-step knob sweep at the bench headline size (543k DoF).

Probes the windowed layout's cell-padding granularity (``chunk_cells``),
the FGMRES restart window, the Cahouet-Chabard sweep lengths and their
combination, timing whole forced Newton steps exactly like bench.py's
newton leg and printing the outer iteration counts.

    python -u scripts/sweep_r5.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

REFINE = int(os.environ.get("SWEEP_REFINE", "2"))

COMBOS = [
    ("default(r60,Bc128)", {}),
    ("Bc256", {"chunk_cells": 256}),
    ("Bc512", {"chunk_cells": 512}),
    ("r30", {"restart": 30}),
    ("Bc256,r30", {"chunk_cells": 256, "restart": 30}),
    ("Bc512,r30", {"chunk_cells": 512, "restart": 30}),
]
if os.environ.get("SWEEP_COMBOS"):
    import json

    COMBOS = [(json.dumps(o), o) for o in json.loads(os.environ["SWEEP_COMBOS"])]


def main():
    from navier_stokes_tpu.config import SolverConfig
    from navier_stokes_tpu.mesh.mesh import refine_uniform
    from navier_stokes_tpu.mesh.msh_io import read_msh
    from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
    from navier_stokes_tpu.utils.logging import RunLog

    mesh = refine_uniform(
        read_msh("/root/reference/mesh/correct_mesh_yt.msh"), REFINE
    )
    rng = np.random.default_rng(0)
    for label, over in COMBOS:
        cfg = SolverConfig()
        cfg.dtype = "float32"
        cfg.krylov.matvec = "windowed"
        cfg.krylov.preconditioner = "cahouet_chabard"
        cfg.krylov.max_iters = 300
        for k, v in over.items():
            setattr(cfg.krylov, k, v)
        try:
            s = NavierStokesSolver(mesh, cfg, log=RunLog(verbose=False))
            s.setup()
        except Exception as e:
            print(f"{label:24s} SETUP FAILED: {type(e).__name__}: {str(e)[:160]}",
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
            for _ in range(4):
                u = u_rand()
                t0 = time.perf_counter()
                out = s._newton_iteration(u, uo, bv, cfg.dt, True)
                float(np.asarray(out[0][0]))
                ts.append(time.perf_counter() - t0)
                its.append(int(out[2]))
            lay = s._win_layout
            print(
                f"{label:24s} newton {np.median(ts)*1e3:6.1f} ms  iters={its}  "
                f"conv={bool(out[3])}  nb={lay.nb} Wv={lay.Wv} Wp={lay.Wp} "
                f"Bmax={lay.Bmax}",
                flush=True,
            )
        except Exception as e:
            print(f"{label:24s} RUN FAILED: {type(e).__name__}: {str(e)[:160]}",
                  flush=True)
        del s


if __name__ == "__main__":
    main()
