"""Lagrange simplex reference elements (P1, P2, P3) in 2D/3D, tabulated on host.

JAX replacement for deal.II ``FE_SimplexP`` / ``FESystem`` / ``FEValues``
as used by the reference (``/root/reference/src/NavierStokesSolver.cpp:33-56``).
Instead of per-cell ``FEValues::reinit`` recomputation, shape values and
reference gradients are tabulated ONCE at the quadrature points as small dense
numpy arrays; physical gradients come from one batched contraction with the
per-cell inverse Jacobians (see fem/geometry.py).  That keeps every per-cell
quantity a static-shape tensor, which is what XLA needs to batch the
assembly contractions.

Node ordering (defines local DoF order and must match mesh edge extraction):
  vertices [0..dim], then edges in EDGES[dim] order (P2 adds one midpoint node
  per edge), then P3 adds two nodes per edge plus face/interior bubbles.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

__all__ = ["EDGES", "ScalarElement", "p_element", "TaylorHood", "taylor_hood"]

# Edge vertex pairs per dimension; shared with mesh edge extraction.
EDGES = {
    2: ((0, 1), (1, 2), (2, 0)),
    3: ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)),
}

# Faces of the reference simplex (dim-1 sub-simplices), as vertex tuples.
# 2D: the 3 edges; 3D: the 4 triangular faces.
FACES = {
    2: ((0, 1), (1, 2), (2, 0)),
    3: ((0, 2, 1), (0, 1, 3), (0, 3, 2), (1, 2, 3)),
}


def _bary(points: np.ndarray) -> np.ndarray:
    """Barycentric coordinates [n_pts, dim+1] of reference cartesian points."""
    pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
    lam0 = 1.0 - pts.sum(axis=1, keepdims=True)
    return np.concatenate([lam0, pts], axis=1)


def _grad_bary(dim: int) -> np.ndarray:
    """Constant gradients of barycentric coords, [dim+1, dim]."""
    g = np.zeros((dim + 1, dim))
    g[0, :] = -1.0
    g[1:, :] = np.eye(dim)
    return g


@dataclass(frozen=True)
class ScalarElement:
    """Scalar Lagrange P_k element on a simplex."""

    dim: int
    degree: int
    # support points of the nodal basis, reference cartesian, [n_basis, dim]
    support_points: np.ndarray

    @property
    def n_basis(self) -> int:
        return self.support_points.shape[0]

    def tabulate(self, points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Return (values [n_basis, n_pts], grads [n_basis, n_pts, dim])."""
        lam = _bary(points)  # [np, d+1]
        glam = _grad_bary(self.dim)  # [d+1, dim]
        n_pts = lam.shape[0]
        k = self.degree
        vals = []
        grads = []
        d1 = self.dim + 1
        if k == 1:
            for i in range(d1):
                vals.append(lam[:, i])
                grads.append(np.broadcast_to(glam[i], (n_pts, self.dim)).copy())
        elif k == 2:
            for i in range(d1):  # vertex functions λi(2λi−1)
                vals.append(lam[:, i] * (2 * lam[:, i] - 1))
                grads.append((4 * lam[:, i] - 1)[:, None] * glam[i])
            for a, b in EDGES[self.dim]:  # edge functions 4 λa λb
                vals.append(4 * lam[:, a] * lam[:, b])
                grads.append(4 * (lam[:, b][:, None] * glam[a] + lam[:, a][:, None] * glam[b]))
        elif k == 3:
            # vertices: 0.5 λ(3λ-1)(3λ-2)
            for i in range(d1):
                li = lam[:, i]
                vals.append(0.5 * li * (3 * li - 1) * (3 * li - 2))
                dcoef = 0.5 * ((3 * li - 1) * (3 * li - 2) + 3 * li * (3 * li - 2) + 3 * li * (3 * li - 1))
                grads.append(dcoef[:, None] * glam[i])
            # 2 nodes per edge: 9/2 λa λb (3λa − 1) at point 2/3 a + 1/3 b, and sym.
            for a, b in EDGES[self.dim]:
                for u, v in ((a, b), (b, a)):
                    lu, lv = lam[:, u], lam[:, v]
                    vals.append(4.5 * lu * lv * (3 * lu - 1))
                    g = 4.5 * (
                        (lv * (3 * lu - 1) + 3 * lu * lv)[:, None] * glam[u]
                        + (lu * (3 * lu - 1))[:, None] * glam[v]
                    )
                    grads.append(g)
            # face bubbles: 27 λa λb λc per (triangle) face
            for face in FACES[self.dim] if self.dim == 3 else ((0, 1, 2),):
                a, b, c = face
                la, lb, lc = lam[:, a], lam[:, b], lam[:, c]
                vals.append(27 * la * lb * lc)
                grads.append(
                    27
                    * (
                        (lb * lc)[:, None] * glam[a]
                        + (la * lc)[:, None] * glam[b]
                        + (la * lb)[:, None] * glam[c]
                    )
                )
            # P3 on the tet is complete here: (3+1)(3+2)(3+3)/6 = 20 dofs =
            # 4 vertices + 2x6 edge nodes + 4 face bubbles, NO interior
            # bubble (the first interior node appears at P4)
        else:
            raise NotImplementedError(f"P{k} not implemented")
        return np.stack(vals), np.stack(grads)


def _support_points(dim: int, degree: int) -> np.ndarray:
    verts = np.vstack([np.zeros(dim), np.eye(dim)])  # [dim+1, dim]
    pts = [verts[i] for i in range(dim + 1)]
    if degree >= 2:
        for a, b in EDGES[dim]:
            if degree == 2:
                pts.append(0.5 * (verts[a] + verts[b]))
            elif degree == 3:
                pts.append((2 * verts[a] + verts[b]) / 3.0)
                pts.append((verts[a] + 2 * verts[b]) / 3.0)
    if degree == 3:
        faces = FACES[dim] if dim == 3 else ((0, 1, 2),)
        for f in faces:
            pts.append(sum(verts[i] for i in f) / 3.0)
    return np.array(pts, dtype=np.float64)


@functools.lru_cache(maxsize=None)
def p_element(dim: int, degree: int) -> ScalarElement:
    return ScalarElement(dim, degree, _support_points(dim, degree))


@dataclass(frozen=True)
class TaylorHood:
    """Mixed velocity/pressure (P_kv)^dim x P_kp element.

    Local DoF layout (contiguous component blocks, so global block slices of
    the 2x2 saddle-point system are plain slices of the cell matrix):
      [ u_x(n_v) | u_y(n_v) | (u_z(n_v)) | p(n_p) ]
    Equivalent capability to the reference's
    ``FESystem(FE_SimplexP(2), dim, FE_SimplexP(1), 1)``
    (``/root/reference/src/NavierStokesSolver.cpp:35-38``) but with a
    planar component layout (one contiguous block per component) instead
    of deal.II's node-major order.
    """

    dim: int
    velocity: ScalarElement
    pressure: ScalarElement

    @property
    def n_v(self) -> int:
        return self.velocity.n_basis

    @property
    def n_p(self) -> int:
        return self.pressure.n_basis

    @property
    def dofs_per_cell(self) -> int:
        return self.dim * self.n_v + self.n_p


@functools.lru_cache(maxsize=None)
def taylor_hood(dim: int, degree_velocity: int = 2, degree_pressure: int = 1) -> TaylorHood:
    return TaylorHood(dim, p_element(dim, degree_velocity), p_element(dim, degree_pressure))
