"""Independent steady Navier-Stokes oracle (numpy/scipy, direct sparse LU).

A from-scratch Taylor-Hood P2/P1 solver sharing NOTHING with the framework's
assembly/solver stack except the gmsh reader: its own dof numbering, its own
basis tabulation, its own quadrature table, scipy sparse assembly, exact
Newton with SuperLU, and three independent force evaluations.  Purpose:
ground-truth cross-check of benchmark functionals (DFG 2D-1: published
Cd 5.5795, Cl 0.01062, dP 0.11752) against which the JAX framework's
discretization is validated.  ~100k unknowns solve in minutes on one core.

Weak form (gradient form, do-nothing outflow):
    nu (grad u, grad v) + ((u.grad)u, v) - (p, div v) + (q, div u) = 0
Forces on the cylinder reported three ways:
  - surface traction, gradient-form stress    sigma = -pI + mu grad u
  - surface traction, symmetric-form stress   sigma = -pI + 2 mu eps(u)
  - volume/reaction functional (superconvergent: residual tested with the
    characteristic function of the cylinder-boundary velocity dofs)

Usage: python scripts/oracle_steady_ns.py [refine=0] [Um=0.3]
"""

import sys

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

sys.path.insert(0, "/root/repo")

H = 0.41
D = 0.1
NU = 0.001


# ----------------------------------------------------------------- basis
# reference triangle (0,0)-(1,0)-(0,1); P2 dofs: 3 vertices + 3 edge
# midpoints with LOCAL edges (0,1),(1,2),(2,0)
def p2_tab(pts):
    x, y = pts[:, 0], pts[:, 1]
    l0, l1, l2 = 1 - x - y, x, y
    N = np.stack(
        [
            l0 * (2 * l0 - 1), l1 * (2 * l1 - 1), l2 * (2 * l2 - 1),
            4 * l0 * l1, 4 * l1 * l2, 4 * l2 * l0,
        ],
        axis=1,
    )  # [nq, 6]
    d0 = np.stack([-(4 * l0 - 1), -(4 * l0 - 1)], 1)
    d1 = np.stack([4 * l1 - 1, np.zeros_like(x)], 1)
    d2 = np.stack([np.zeros_like(x), 4 * l2 - 1], 1)
    d01 = np.stack([4 * (l0 - l1), -4 * l1], 1)
    d12 = np.stack([4 * l2, 4 * l1], 1)
    d20 = np.stack([-4 * l2, 4 * (l0 - l2)], 1)
    G = np.stack([d0, d1, d2, d01, d12, d20], axis=1)  # [nq, 6, 2]
    return N, G


def p1_tab(pts):
    x, y = pts[:, 0], pts[:, 1]
    N = np.stack([1 - x - y, x, y], axis=1)
    G = np.broadcast_to(
        np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]]), (len(pts), 3, 2)
    ).copy()
    return N, G


# degree-5 7-point Gauss rule on the reference triangle
QP = np.array(
    [
        [1 / 3, 1 / 3],
        [0.0597158717, 0.4701420641], [0.4701420641, 0.0597158717],
        [0.4701420641, 0.4701420641],
        [0.7974269853, 0.1012865073], [0.1012865073, 0.7974269853],
        [0.1012865073, 0.1012865073],
    ]
)
QW = 0.5 * np.array(
    [0.225, 0.1323941527, 0.1323941527, 0.1323941527,
     0.1259391805, 0.1259391805, 0.1259391805]
)

# 3-point Gauss on [0,1] (degree 5) for line integrals
LQ = 0.5 * (1 + np.array([-np.sqrt(3 / 5), 0.0, np.sqrt(3 / 5)]))
LW = np.array([5 / 18, 8 / 18, 5 / 18])


def build_mesh(refine):
    sys.path.insert(0, "/root/repo/examples")
    from dfg_steady_re20 import load_dfg_mesh

    return load_dfg_mesh(refine)


def edge_dofs(cells, n_nodes):
    """Global edge numbering for P2: local edges (0,1),(1,2),(2,0)."""
    e = np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]], cells[:, [2, 0]]])
    e = np.sort(e, axis=1)
    key = e[:, 0].astype(np.int64) * n_nodes + e[:, 1]
    uniq, inv = np.unique(key, return_inverse=True)
    cell_edges = inv.reshape(3, -1).T  # [nc, 3]
    ev = np.stack([uniq // n_nodes, uniq % n_nodes], axis=1)
    return cell_edges, ev  # edge -> (v0, v1)


def main():
    refine = int(sys.argv[1]) if len(sys.argv) > 1 else 0
    um = float(sys.argv[2]) if len(sys.argv) > 2 else 0.3
    mesh = build_mesh(refine)
    c, cells = mesh.coords, mesh.cells.astype(np.int64)
    nn, nc = len(c), len(cells)
    cell_edges, ev = edge_dofs(cells, nn)
    ne = len(ev)
    nvs = nn + ne  # P2 scalar dofs
    # velocity dof coords (vertices then edge midpoints)
    vcoords = np.vstack([c, 0.5 * (c[ev[:, 0]] + c[ev[:, 1]])])
    # per-cell scalar P2 dofs
    cd = np.hstack([cells, nn + cell_edges])  # [nc, 6]

    # geometry
    v0, v1, v2 = c[cells[:, 0]], c[cells[:, 1]], c[cells[:, 2]]
    J = np.stack([v1 - v0, v2 - v0], axis=2)  # [nc, 2, 2] columns = edges
    detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    assert (detJ > 0).all()
    invJ = (
        np.stack(
            [
                np.stack([J[:, 1, 1], -J[:, 0, 1]], 1),
                np.stack([-J[:, 1, 0], J[:, 0, 0]], 1),
            ],
            axis=1,
        )
        / detJ[:, None, None]
    )  # [nc, 2, 2] = J^-1
    N2, G2r = p2_tab(QP)
    N1, G1r = p1_tab(QP)
    # physical gradients: G[c, q, b, d] = G2r[q, b, k] invJ[c, k, d]
    G2 = np.einsum("qbk,ckd->cqbd", G2r, invJ)
    G1 = np.einsum("qbk,ckd->cqbd", G1r, invJ)
    w = QW[None, :] * detJ[:, None]  # [nc, nq]

    # ---------------------------------------------------------- indexing
    # unknowns: [ux (nvs) | uy (nvs) | p (nn)]
    n_u = 2 * nvs
    ntot = n_u + nn

    # Dirichlet dofs: inlet 11 (parabolic), walls 12 + cylinder 13 (zero)
    def boundary_scalar_dofs(tags):
        fs = mesh.boundary_facets[np.isin(mesh.boundary_tags, tags)]
        vids = np.unique(fs)
        e = np.sort(fs, axis=1)
        key = e[:, 0].astype(np.int64) * nn + e[:, 1]
        ekey = ev[:, 0] * nn + ev[:, 1]
        eids = np.nonzero(np.isin(ekey, key))[0]
        return np.concatenate([vids, nn + eids])

    inlet = boundary_scalar_dofs([11])
    walls = boundary_scalar_dofs([12, 13])
    cyl = boundary_scalar_dofs([13])
    fixed = np.unique(np.concatenate([inlet, walls]))
    gvals = np.zeros(ntot)
    yy = vcoords[inlet, 1] + 0.2
    gvals[inlet] = um * 4 * yy * (H - yy) / H**2
    fixed_full = np.concatenate([fixed, nvs + fixed])  # both components
    free = np.setdiff1d(np.arange(ntot), fixed_full)

    # ------------------------------------------------- constant operators
    rows_v = np.broadcast_to(cd[:, None, :, None], (nc, 7, 6, 6))
    cols_v = np.broadcast_to(cd[:, None, None, :], (nc, 7, 6, 6))

    def asm(vals, rows, cols, shape):
        return sp.csr_matrix(
            (vals.ravel(), (rows.ravel(), cols.ravel())), shape=shape
        )

    # viscous: nu * sum_q w G:G
    Kv = np.einsum("cq,cqad,cqbd->cab", w, G2, G2) * NU
    K = asm(
        np.broadcast_to(Kv[:, None], (nc, 1, 6, 6)),
        rows_v[:, :1], cols_v[:, :1], (nvs, nvs),
    )
    # B_d[p, u_d] = -(q, d_d u): per component integral N1_a * G2[b, d]
    Bx = -np.einsum("cq,qa,cqb->cab", w, N1, G2[..., 0])
    By = -np.einsum("cq,qa,cqb->cab", w, N1, G2[..., 1])
    rows_p = np.broadcast_to(cells[:, :, None], (nc, 3, 6))
    cols_p = np.broadcast_to(cd[:, None, :], (nc, 3, 6))
    BxM = asm(Bx, rows_p, cols_p, (nn, nvs))
    ByM = asm(By, rows_p, cols_p, (nn, nvs))

    def conv_ops(U):
        """N(u)v (convection residual vector contribution) and its two
        Jacobian blocks at state U (full planar vector)."""
        ux = U[cd]  # [nc, 6] x-velocity coefficients
        uy = U[nvs + cd]
        uq = np.stack([ux @ N2.T, uy @ N2.T], axis=2)  # [nc, q, 2]
        gx = np.einsum("cb,cqbd->cqd", ux, G2)  # grad ux
        gy = np.einsum("cb,cqbd->cqd", uy, G2)
        # residual: ((u.grad)u, v)
        conv_x = np.einsum("cqd,cqd->cq", uq, gx)
        conv_y = np.einsum("cqd,cqd->cq", uq, gy)
        rx = np.einsum("cq,cq,qb->cb", w, conv_x, N2)
        ry = np.einsum("cq,cq,qb->cb", w, conv_y, N2)
        # Jacobian: ((du.grad)u, v) + ((u.grad)du, v)
        # block (x,x): N_j * dux/dx * N_i + (u.grad N_j) N_i
        ugN = np.einsum("cqd,cqbd->cqb", uq, G2)  # (u.grad) N_b
        Jxx = np.einsum("cq,qa,cqb->cab", w, N2, ugN) + np.einsum(
            "cq,qa,qb,cq->cab", w, N2, N2, gx[..., 0]
        )
        Jxy = np.einsum("cq,qa,qb,cq->cab", w, N2, N2, gx[..., 1])
        Jyx = np.einsum("cq,qa,qb,cq->cab", w, N2, N2, gy[..., 0])
        Jyy = np.einsum("cq,qa,cqb->cab", w, N2, ugN) + np.einsum(
            "cq,qa,qb,cq->cab", w, N2, N2, gy[..., 1]
        )
        return (rx, ry), (Jxx, Jxy, Jyx, Jyy)

    def residual_and_jac(U):
        (rx, ry), (Jxx, Jxy, Jyx, Jyy) = conv_ops(U)
        Rx = np.zeros(nvs)
        np.add.at(Rx, cd.ravel(), rx.ravel())
        Ry = np.zeros(nvs)
        np.add.at(Ry, cd.ravel(), ry.ravel())
        R = np.zeros(ntot)
        R[:nvs] = K @ U[:nvs] + Rx + BxM.T @ U[n_u:]
        R[nvs:n_u] = K @ U[nvs:n_u] + Ry + ByM.T @ U[n_u:]
        R[n_u:] = BxM @ U[:nvs] + ByM @ U[nvs:n_u]
        r1 = rows_v[:, 0]
        c1 = cols_v[:, 0]
        Jc = sp.bmat(
            [
                [K + asm(Jxx, r1, c1, (nvs, nvs)), asm(Jxy, r1, c1, (nvs, nvs)), BxM.T],
                [asm(Jyx, r1, c1, (nvs, nvs)), K + asm(Jyy, r1, c1, (nvs, nvs)), ByM.T],
                [BxM, ByM, None],
            ],
            format="csr",
        )
        return R, Jc

    # ------------------------------------------------------------- Newton
    U = np.zeros(ntot)
    U[fixed] = gvals[fixed]  # x-component inlet profile; y stays 0
    for it in range(12):
        R, Jc = residual_and_jac(U)
        Rf = R[free]
        nr = np.linalg.norm(Rf)
        print(f"newton {it}: |R| = {nr:.3e}", flush=True)
        if nr < 1e-11:
            break
        A = Jc[free][:, free]
        dU = spla.spsolve(A.tocsc(), -Rf)
        U[free] += dU

    # ------------------------------------------------------------- forces
    mu = NU  # rho = 1
    # cylinder facets, owning exterior cell for each
    cyl_f = mesh.boundary_facets[mesh.boundary_tags == 13]
    # locate owning cell: cell containing both facet vertices
    from collections import defaultdict

    v2c = defaultdict(list)
    for ci, cell in enumerate(cells):
        for v in cell[:3]:
            v2c[v].append(ci)
    Fg = np.zeros(2)
    Fs = np.zeros(2)
    for f in cyl_f:
        cands = set(v2c[f[0]]) & set(v2c[f[1]])
        assert len(cands) == 1, "cylinder facet must bound exactly one cell"
        ci = cands.pop()
        loc = cells[ci]
        a, b = c[f[0]], c[f[1]]
        t = b - a
        ln = np.linalg.norm(t)
        nrm = np.array([t[1], -t[0]]) / ln
        # orient out of the fluid = toward cylinder center (origin)
        mid = 0.5 * (a + b)
        if np.dot(nrm, -mid) < 0:
            nrm = -nrm
        # map line quad points to reference coords of cell ci:
        # xi = J^-1 (x - v0)  ->  row-vector form (x - v0) @ invJ.T
        pts = a[None, :] + LQ[:, None] * t[None, :]
        ref = (pts - c[loc[0]]) @ invJ[ci].T
        N2f, G2f = p2_tab(ref)
        Gphys = np.einsum("qbk,kd->qbd", G2f, invJ[ci])
        ux = U[cd[ci]]
        uy = U[nvs + cd[ci]]
        gu = np.stack(
            [np.einsum("b,qbd->qd", ux, Gphys), np.einsum("b,qbd->qd", uy, Gphys)],
            axis=1,
        )  # [q, comp, d]
        N1f, _ = p1_tab(ref)
        pq = N1f @ U[n_u + cells[ci]]
        for q in range(len(LQ)):
            sg = -pq[q] * np.eye(2) + mu * gu[q]
            ss = -pq[q] * np.eye(2) + mu * (gu[q] + gu[q].T)
            Fg += -(sg @ nrm) * LW[q] * ln
            Fs += -(ss @ nrm) * LW[q] * ln

    # reaction (volume) functional: residual WITHOUT BC elimination, summed
    # over cylinder velocity dofs; force BY fluid ON body = -reaction
    R, _ = residual_and_jac(U)
    Fr = -np.array([R[cyl].sum(), R[nvs + cyl].sum()])

    u_mean = 2 / 3 * um
    scale = 2.0 / (u_mean**2 * D)
    p = U[n_u:]
    ia = int(np.argmin(np.linalg.norm(c - [-0.05, 0], axis=1)))
    ib = int(np.argmin(np.linalg.norm(c - [0.05, 0], axis=1)))
    print(f"\noracle steady NS (refine={refine}, Um={um}, {ntot} unknowns):")
    print(f"  max |u| = {np.abs(U[:n_u]).max():.4f}")
    print(f"  Cd/Cl (gradient stress)  = {Fg[0]*scale:.5f} / {Fg[1]*scale:+.5f}")
    print(f"  Cd/Cl (symmetric stress) = {Fs[0]*scale:.5f} / {Fs[1]*scale:+.5f}")
    print(f"  Cd/Cl (reaction)         = {Fr[0]*scale:.5f} / {Fr[1]*scale:+.5f}")
    print(f"  dP = {p[ia]-p[ib]:+.5f}")
    print("  published 2D-1: Cd 5.5795  Cl +0.01062  dP +0.11752")
    # machine-readable full-precision line (scripts/parity_cdcl.py consumes
    # this for the <=1e-6 Cd/Cl parity artifact, BASELINE north star)
    import json as _json

    print("ORACLE_JSON " + _json.dumps({
        "refine": refine, "um": um, "n_unknowns": int(ntot),
        "cd_reaction": float(Fr[0] * scale), "cl_reaction": float(Fr[1] * scale),
        "cd_gradient": float(Fg[0] * scale), "cl_gradient": float(Fg[1] * scale),
        "cd_symmetric": float(Fs[0] * scale), "cl_symmetric": float(Fs[1] * scale),
        "dp": float(p[ia] - p[ib]),
        "newton_final_residual": float(nr),
    }))
    out = sys.argv[3] if len(sys.argv) > 3 else None
    if out:
        np.savez(
            out, U=U, vcoords=vcoords, pcoords=c, nvs=nvs, nn=nn,
            refine=refine, um=um,
        )
        print("  solution dumped to", out)


if __name__ == "__main__":
    main()
