"""Gauss quadrature rules on simplices (triangles, tetrahedra) and their faces.

JAX replacement for deal.II ``QGaussSimplex<dim>`` as used by the
reference solver (``/root/reference/src/NavierStokesSolver.cpp:47,52``:
``QGaussSimplex<dim>(fe->degree + 1)`` for cells and
``QGaussSimplex<dim-1>(fe->degree + 1)`` for faces).

All rules are generated/tabulated once on the host as numpy arrays; they enter
device code only as small constant operands of the batched assembly
contractions.  Weights sum to the reference-simplex measure
(1/2 for the unit triangle, 1/6 for the unit tet, 1 for the unit segment), so
``sum_q w_q * |det J|`` integrates 1 over a physical cell.

Rules:
  * hand-tabulated symmetric rules for low degree (fewest points), and
  * conical-product (Stroud / Gauss-Jacobi) rules for any degree, used as the
    general fallback.
Every rule is covered by monomial-exactness unit tests (tests/test_quadrature.py).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

__all__ = ["QuadratureRule", "gauss_simplex", "gauss_segment", "conical_product"]


@dataclass(frozen=True)
class QuadratureRule:
    """Points (in reference-simplex cartesian coordinates) and weights."""

    points: np.ndarray  # [n_q, dim] float64
    weights: np.ndarray  # [n_q] float64, sums to measure of reference simplex
    degree: int  # polynomial degree integrated exactly

    @property
    def dim(self) -> int:
        return self.points.shape[1]

    @property
    def n_points(self) -> int:
        return self.points.shape[0]


def _rule(points, weights, degree) -> QuadratureRule:
    pts = np.asarray(points, dtype=np.float64).reshape(len(weights), -1)
    w = np.asarray(weights, dtype=np.float64)
    return QuadratureRule(pts, w, degree)


# ---------------------------------------------------------------------------
# 1D (unit segment [0, 1]) — used for 2D boundary-face integrals.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def gauss_segment(degree: int) -> QuadratureRule:
    """Gauss-Legendre on [0,1], exact to the given polynomial degree."""
    n = max(1, (degree + 2) // 2)
    x, w = np.polynomial.legendre.leggauss(n)
    pts = (x[:, None] + 1.0) * 0.5
    return QuadratureRule(pts, w * 0.5, 2 * n - 1)


# ---------------------------------------------------------------------------
# Symmetric tabulated simplex rules (barycentric orbits).
# ---------------------------------------------------------------------------


def _tri_orbits(*orbits) -> tuple[np.ndarray, np.ndarray]:
    """Expand (weight, barycentric coords) orbits into cartesian points.

    Each orbit is (w, bary) where bary is a tuple of 3 barycentric coordinates;
    all distinct permutations are generated, each receiving weight w.  Weights
    are fractions of the triangle area; scaled by 1/2 at the end.
    """
    pts, wts = [], []
    for w, bary in orbits:
        seen = set()
        import itertools

        for perm in itertools.permutations(bary):
            if perm in seen:
                continue
            seen.add(perm)
            # cartesian: x = bary[1], y = bary[2] with vertices (0,0),(1,0),(0,1)
            pts.append(perm[1:])
            wts.append(w)
    return np.array(pts, dtype=np.float64), np.array(wts, dtype=np.float64) * 0.5


def _tet_orbits(*orbits) -> tuple[np.ndarray, np.ndarray]:
    pts, wts = [], []
    import itertools

    for w, bary in orbits:
        seen = set()
        for perm in itertools.permutations(bary):
            if perm in seen:
                continue
            seen.add(perm)
            pts.append(perm[1:])
            wts.append(w)
    return np.array(pts, dtype=np.float64), np.array(wts, dtype=np.float64) / 6.0


_TRI_RULES: dict[int, tuple] = {
    1: _tri_orbits((1.0, (1 / 3, 1 / 3, 1 / 3))),
    2: _tri_orbits((1 / 3, (2 / 3, 1 / 6, 1 / 6))),
    3: _tri_orbits(
        (-27 / 48, (1 / 3, 1 / 3, 1 / 3)),
        (25 / 48, (0.6, 0.2, 0.2)),
    ),
    4: _tri_orbits(
        (0.223381589678011, (1 - 2 * 0.445948490915965, 0.445948490915965, 0.445948490915965)),
        (0.109951743655322, (1 - 2 * 0.091576213509771, 0.091576213509771, 0.091576213509771)),
    ),
    5: _tri_orbits(
        (0.225, (1 / 3, 1 / 3, 1 / 3)),
        (0.132394152788506, (1 - 2 * 0.470142064105115, 0.470142064105115, 0.470142064105115)),
        (0.125939180544827, (1 - 2 * 0.101286507323456, 0.101286507323456, 0.101286507323456)),
    ),
}

_TET_RULES: dict[int, tuple] = {
    1: _tet_orbits((1.0, (0.25, 0.25, 0.25, 0.25))),
    2: _tet_orbits(
        (0.25, (0.585410196624969, 0.138196601125011, 0.138196601125011, 0.138196601125011))
    ),
    3: _tet_orbits(
        (-0.8, (0.25, 0.25, 0.25, 0.25)),
        (0.45, (0.5, 1 / 6, 1 / 6, 1 / 6)),
    ),
}


# ---------------------------------------------------------------------------
# Conical-product (Stroud) rules: exact to arbitrary degree via Gauss-Jacobi.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def conical_product(dim: int, n1d: int) -> QuadratureRule:
    """Stroud conical-product rule with n1d points per direction.

    Degree of exactness 2*n1d - 1.  Triangle: n1d^2 points, tet: n1d^3.
    Built from Gauss-Jacobi rules so the simplex collapse (Duffy transform)
    stays exact.  This mirrors how deal.II constructs QGaussSimplex for
    arbitrary order.
    """
    from scipy.special import roots_jacobi

    def jac01(n, alpha):
        # Gauss-Jacobi on [0,1] with weight (1-x)^alpha
        x, w = roots_jacobi(n, alpha, 0.0)
        x = (x + 1.0) * 0.5
        w = w * 0.5 ** (alpha + 1.0)
        return x, w

    if dim == 2:
        xa, wa = jac01(n1d, 1.0)  # weight (1-x)
        xb, wb = jac01(n1d, 0.0)
        pts, wts = [], []
        for i in range(n1d):
            for j in range(n1d):
                x = xa[i]
                y = xb[j] * (1.0 - xa[i])
                pts.append((x, y))
                wts.append(wa[i] * wb[j])
        return _rule(pts, wts, 2 * n1d - 1)
    elif dim == 3:
        xa, wa = jac01(n1d, 2.0)  # weight (1-x)^2
        xb, wb = jac01(n1d, 1.0)  # weight (1-y)
        xc, wc = jac01(n1d, 0.0)
        pts, wts = [], []
        for i in range(n1d):
            for j in range(n1d):
                for k in range(n1d):
                    x = xa[i]
                    y = xb[j] * (1 - xa[i])
                    z = xc[k] * (1 - xa[i]) * (1 - xb[j])
                    pts.append((x, y, z))
                    wts.append(wa[i] * wb[j] * wc[k])
        return _rule(pts, wts, 2 * n1d - 1)
    elif dim == 1:
        return gauss_segment(2 * n1d - 1)
    raise ValueError(f"unsupported dim {dim}")


@functools.lru_cache(maxsize=None)
def gauss_simplex(dim: int, degree: int) -> QuadratureRule:
    """Quadrature on the unit simplex exact for polynomials of `degree`.

    Prefers compact tabulated symmetric rules; falls back to conical product.
    """
    if dim == 1:
        return gauss_segment(degree)
    table = _TRI_RULES if dim == 2 else _TET_RULES if dim == 3 else None
    if table is None:
        raise ValueError(f"unsupported dim {dim}")
    if degree in table:
        pts, wts = table[degree]
        return QuadratureRule(pts, wts, degree)
    n1d = (degree + 2) // 2
    return conical_product(dim, n1d)
