"""Host-side probe of the windowed-layout quality vs cell ordering (3D).

The RCM-driven blocked numbering of step-5 refine=2 (3.75M DoF tets) yields
halo-5 windows.  This probe builds the layout for both orderings (RCM vs
Morton SFC on centroids) on the 3D step meshes and the 2D bench mesh and
reports halo blocks (hv/hp), window lengths (Wv/Wp), and pad factor — no
accelerator needed (layout construction is pure host numpy).

    python -u scripts/probe_3d_ordering.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def probe(name, mesh, refine, order, cpb=512, Bc=256):
    from navier_stokes_tpu.fem.dofs import make_dofs, renumber_blocked
    from navier_stokes_tpu.mesh.mesh import refine_uniform
    from navier_stokes_tpu.ops.windowed import build_windowed_layout

    t0 = time.perf_counter()
    m = refine_uniform(mesh, refine)
    dofs = make_dofs(m, 2, 1)
    try:
        dofs_r, bi = renumber_blocked(dofs, cells_per_block=cpb, order=order)
        lay = build_windowed_layout(
            dofs_r.cell_vdofs, dofs_r.cell_pdofs, dofs_r.n_vs, dofs_r.n_ps,
            m.dim, block_info=bi, Bc=Bc,
        )
        print(
            f"{name:22s} {order:4s} nc={m.n_cells:8d} n={lay.dim*lay.n_vs+lay.n_ps:9d} "
            f"nb={lay.nb:5d} OWv={lay.OWv:5d} hv={lay.hv} hp={lay.hp} "
            f"Wv={lay.Wv:6d} Wp={lay.Wp:6d} "
            f"Bmax={lay.Bmax:5d} pad={lay.pad_factor:.2f} "
            f"[{time.perf_counter()-t0:.0f}s]",
            flush=True,
        )
    except Exception as e:
        print(f"{name:22s} {order:4s} nc={m.n_cells:8d} FAILED: "
              f"{type(e).__name__}: {str(e)[:120]} [{time.perf_counter()-t0:.0f}s]",
              flush=True)


def main():
    from navier_stokes_tpu.mesh.msh_io import read_msh

    tasks = os.environ.get(
        "PROBE_TASKS",
        "yt2,step3r2,step5r2",
    ).split(",")
    for t in tasks:
        if t == "yt2":
            m = read_msh("/root/reference/mesh/correct_mesh_yt.msh")
            for o in ("rcm", "sfc"):
                probe("yt refine=2 (2D)", m, 2, o)
        elif t == "step3r2":
            m = read_msh("/root/reference/mesh/mesh-step-3.msh")
            for o in ("rcm", "sfc"):
                probe("step-3 refine=2 (3D)", m, 2, o)
        elif t == "step5r2":
            m = read_msh("/root/reference/mesh/mesh-step-5.msh")
            for o in ("rcm", "sfc"):
                probe("step-5 refine=2 (3D)", m, 2, o)


if __name__ == "__main__":
    main()
