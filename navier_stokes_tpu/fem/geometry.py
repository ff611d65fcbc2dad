"""Batched affine cell/face geometry for simplex meshes.

JAX replacement for deal.II ``MappingFE``/``FEValues::reinit`` geometry
updates (``update_JxW_values | update_quadrature_points | update_gradients``,
``/root/reference/src/NavierStokesSolver.cpp:188-195``).  deal.II recomputes
Jacobians per cell inside the assembly loop; here all cells are processed at
once on the host (numpy) into flat arrays that the jitted assembly
contractions consume:

  J      [nc, dim, dim]   d x / d xi        (columns are edge vectors)
  detJ   [nc]             (> 0 after Mesh orientation fix)
  invJT  [nc, dim, dim]   J^{-T}; physical gradient = invJT @ ref gradient
  qpts   [nc, nq, dim]    physical quadrature points (forcing evaluation)

Boundary-face geometry (for Neumann terms, cpp:314-336) is precomputed per
boundary facet: outward unit normals, face JxW, face quadrature points in the
owning cell's REFERENCE coordinates (so cell basis tabulation applies).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..mesh.mesh import Mesh
from .quadrature import QuadratureRule, gauss_simplex
from .reference_element import FACES

__all__ = ["CellGeometry", "FacetGeometry", "cell_geometry", "facet_geometry"]


@dataclass
class CellGeometry:
    J: np.ndarray  # [nc, dim, dim]
    detJ: np.ndarray  # [nc]
    invJT: np.ndarray  # [nc, dim, dim]
    qpts: np.ndarray  # [nc, nq, dim] physical quadrature points
    jxw: np.ndarray  # [nc, nq]


def cell_geometry(mesh: Mesh, quad: QuadratureRule) -> CellGeometry:
    v = mesh.coords[mesh.cells]  # [nc, dim+1, dim]
    dim = mesh.dim
    J = np.swapaxes(v[:, 1:, :] - v[:, :1, :], 1, 2)  # [nc, dim, dim]
    detJ = np.linalg.det(J)
    invJ = np.linalg.inv(J)
    invJT = np.swapaxes(invJ, 1, 2)
    qpts = v[:, 0, None, :] + np.einsum("cab,qb->cqa", J, quad.points)
    jxw = np.abs(detJ)[:, None] * quad.weights[None, :]
    return CellGeometry(J=J, detJ=detJ, invJT=invJT, qpts=qpts, jxw=jxw)


@dataclass
class FacetGeometry:
    """Geometry of a set of boundary facets (one tag group or all)."""

    cell: np.ndarray  # [nf] owning cell index
    normal: np.ndarray  # [nf, dim] outward unit normal
    jxw: np.ndarray  # [nf, nqf] face JxW
    ref_qpts: np.ndarray  # [nf, nqf, dim] face quad points in cell ref coords
    qpts: np.ndarray  # [nf, nqf, dim] physical face quad points
    quad: QuadratureRule


def facet_geometry(mesh: Mesh, facet_ids: np.ndarray, degree: int) -> FacetGeometry:
    """Precompute geometry for the given boundary facets.

    Face quadrature mirrors the reference's ``QGaussSimplex<dim-1>(degree)``
    (cpp:52).  Reference-cell embedding: the face's vertices (in FACES order of
    the owning cell) span a sub-simplex of the reference cell; face quadrature
    points are mapped through its barycentric embedding.
    """
    dim = mesh.dim
    fquad = gauss_simplex(dim - 1, degree)
    owner, local_face = mesh.facet_cell_map
    cell = owner[facet_ids]
    lf = local_face[facet_ids]

    # reference-cell vertex coordinates
    ref_verts = np.vstack([np.zeros(dim), np.eye(dim)])  # [dim+1, dim]
    faces = np.array(FACES[dim])  # [nf_c, dim]

    # barycentric coords of face quad points on the reference FACE simplex
    lam0 = 1.0 - fquad.points.sum(axis=1, keepdims=True)
    bary_f = np.concatenate([lam0, fquad.points], axis=1)  # [nqf, dim]

    # per local face: embed into cell reference coords
    # ref_qpt = sum_k bary_f[q,k] * ref_verts[faces[lf, k]]
    face_vert_ref = ref_verts[faces]  # [nf_c, dim, dim]
    ref_qpts = np.einsum("qk,fkd->fqd", bary_f, face_vert_ref[lf])

    # physical facet vertices (use the CELL's face vertex order, consistent
    # with FACES orientation)
    cell_verts = mesh.cells[cell]  # [nf, dim+1]
    fverts = np.take_along_axis(cell_verts, faces[lf].astype(np.int64), axis=1)  # [nf, dim]
    pv = mesh.coords[fverts]  # [nf, dim, dim]

    if dim == 2:
        t = pv[:, 1, :] - pv[:, 0, :]  # [nf, 2]
        length = np.linalg.norm(t, axis=1)
        normal = np.stack([t[:, 1], -t[:, 0]], axis=1) / length[:, None]
        jxw = length[:, None] * fquad.weights[None, :]  # weights sum to 1
        qpts = pv[:, None, 0, :] + fquad.points[None, :, :1] * t[:, None, :]
    else:
        e1 = pv[:, 1, :] - pv[:, 0, :]
        e2 = pv[:, 2, :] - pv[:, 0, :]
        cr = np.cross(e1, e2)
        area2 = np.linalg.norm(cr, axis=1)  # = 2 * area
        normal = cr / area2[:, None]
        jxw = area2[:, None] * fquad.weights[None, :]  # weights sum to 1/2
        qpts = (
            pv[:, None, 0, :]
            + fquad.points[None, :, 0:1] * e1[:, None, :]
            + fquad.points[None, :, 1:2] * e2[:, None, :]
        )

    # orient outward: normal must point away from the opposite cell vertex
    centroid = mesh.coords[mesh.cells[cell]].mean(axis=1)  # [nf, dim]
    face_mid = pv.mean(axis=1)
    sign = np.sign(np.einsum("fd,fd->f", normal, face_mid - centroid))
    sign[sign == 0] = 1.0
    normal = normal * sign[:, None]

    return FacetGeometry(
        cell=cell.astype(np.int32),
        normal=normal,
        jxw=jxw,
        ref_qpts=ref_qpts,
        qpts=qpts,
        quad=fquad,
    )
