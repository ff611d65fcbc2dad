"""Host-side unstructured simplex mesh: SoA numpy arrays, static topology.

JAX replacement for deal.II ``Triangulation`` /
``parallel::fullydistributed::Triangulation`` as used by the reference
(``/root/reference/src/NavierStokesSolver.cpp:6-25``).  deal.II's dynamic
cell-iterator mesh becomes a frozen struct-of-arrays: every topological
relation the device kernels need (cell->vertex, cell->edge, boundary facet ->
(cell, local face)) is precomputed here as an int32 array so device code sees
only static shapes.

Conventions
-----------
* cells: [n_cells, dim+1] vertex indices, positively oriented (det J > 0).
* edges: unique vertex pairs (lo < hi), cell_edges follows
  reference_element.EDGES order.
* boundary facets carry the gmsh physical tag (the reference's boundary_id:
  e.g. 10=outlet, 11=inlet, 12/13=walls for the cylinder mesh, cf.
  ``NavierStokesSolver.cpp:320,357,367``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np

from ..fem.reference_element import EDGES, FACES

__all__ = ["Mesh", "extract_cells", "extract_edges", "refine_uniform", "retag_boundary"]


def extract_edges(cells: np.ndarray, dim: int) -> tuple[np.ndarray, np.ndarray]:
    """Unique mesh edges and the per-cell edge map.

    Returns (edges [n_edges, 2] with lo<hi, cell_edges [n_cells, n_cell_edges]).
    Vectorized numpy (sort + unique) — this is the host-side analogue of
    deal.II DoF distribution on lines (``NavierStokesSolver.cpp:64-65``).
    """
    pairs = np.array(EDGES[dim], dtype=np.int64)  # [ne_c, 2]
    cell_pairs = cells[:, pairs]  # [n_cells, ne_c, 2]
    flat = np.sort(cell_pairs.reshape(-1, 2), axis=1)
    edges, inv = np.unique(flat, axis=0, return_inverse=True)
    cell_edges = inv.reshape(cells.shape[0], pairs.shape[0])
    return edges.astype(np.int32), cell_edges.astype(np.int32)


def _orient_cells(coords: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """Flip cells with negative Jacobian so det J > 0 everywhere."""
    dim = coords.shape[1]
    v = coords[cells]  # [nc, dim+1, dim]
    J = np.swapaxes(v[:, 1:, :] - v[:, :1, :], 1, 2)  # [nc, dim, dim]
    det = np.linalg.det(J)
    flipped = cells.copy()
    neg = det < 0
    # swapping the last two vertices flips orientation in 2D and 3D
    flipped[neg, -1], flipped[neg, -2] = cells[neg, -2], cells[neg, -1]
    return flipped


@dataclass
class Mesh:
    coords: np.ndarray  # [n_nodes, dim] float64
    cells: np.ndarray  # [n_cells, dim+1] int32
    boundary_facets: np.ndarray  # [n_bf, dim] int32 (vertex ids)
    boundary_tags: np.ndarray  # [n_bf] int32 (gmsh physical tag / boundary_id)
    name: str = "mesh"
    # cell-level physical tags (unused by the solver, kept for parity/IO)
    cell_tags: np.ndarray | None = field(default=None, repr=False)

    def __post_init__(self):
        self.coords = np.ascontiguousarray(self.coords, dtype=np.float64)
        self.cells = _orient_cells(self.coords, np.ascontiguousarray(self.cells, dtype=np.int32))
        self.boundary_facets = np.ascontiguousarray(self.boundary_facets, dtype=np.int32).reshape(
            -1, self.dim
        )
        self.boundary_tags = np.ascontiguousarray(self.boundary_tags, dtype=np.int32)

    @property
    def dim(self) -> int:
        return self.coords.shape[1]

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @cached_property
    def _edge_data(self) -> tuple[np.ndarray, np.ndarray]:
        from . import meshkit

        if meshkit.available():
            return meshkit.extract_edges_native(self.cells, self.dim)
        return extract_edges(self.cells, self.dim)

    @property
    def edges(self) -> np.ndarray:
        return self._edge_data[0]

    @property
    def cell_edges(self) -> np.ndarray:
        return self._edge_data[1]

    @property
    def n_edges(self) -> int:
        return self.edges.shape[0]

    @cached_property
    def _face_data(self) -> tuple[np.ndarray, np.ndarray]:
        """Unique interior+boundary triangle faces of a tet mesh.

        Returns (faces [n_faces, 3] vertex triples sorted ascending,
        cell_faces [nc, 4] global face id per local face in
        reference_element.FACES[3] order).  The P3 tet dof map places one
        face-bubble dof per global face (the bubble 27 λa λb λc is symmetric
        under vertex permutation, so no orientation data is needed).
        """
        assert self.dim == 3, "face map is 3D-only (2D faces are the cells)"
        local = np.array(FACES[3], dtype=np.int64)  # [4, 3]
        tri = np.sort(self.cells[:, local].reshape(-1, 3), axis=1)
        faces, inv = np.unique(tri, axis=0, return_inverse=True)
        return faces.astype(np.int32), inv.reshape(self.n_cells, 4).astype(np.int32)

    @property
    def faces(self) -> np.ndarray:
        return self._face_data[0]

    @property
    def cell_faces(self) -> np.ndarray:
        return self._face_data[1]

    @property
    def n_faces(self) -> int:
        return self.faces.shape[0]

    @cached_property
    def facet_cell_map(self) -> tuple[np.ndarray, np.ndarray]:
        """For each boundary facet: (owning cell, local face index).

        Local faces follow reference_element.FACES order, so face geometry
        (normals, face quadrature embedding) can be tabulated per local face.
        Facets that match no cell raise (inconsistent mesh).
        """
        faces = np.array(FACES[self.dim], dtype=np.int64)  # [nf_c, dim]
        cell_faces = self.cells[:, faces]  # [nc, nf_c, dim]
        nf_c = faces.shape[0]
        key = np.sort(cell_faces.reshape(-1, self.dim), axis=1)
        bkey = np.sort(self.boundary_facets.astype(np.int64), axis=1)
        comb = np.concatenate([key, bkey], axis=0)
        uniq, inv = np.unique(comb, axis=0, return_inverse=True)
        first = np.full(len(uniq), -1, dtype=np.int64)
        # reversed fill so the FIRST (cell, face) occurrence wins
        inv_key = inv[: len(key)]
        first[inv_key[::-1]] = np.arange(len(key))[::-1]
        flat = first[inv[len(key) :]]
        if np.any(flat < 0):
            raise ValueError("boundary facet not found in any cell")
        return (flat // nf_c).astype(np.int32), (flat % nf_c).astype(np.int32)

    def facets_with_tag(self, tag: int) -> np.ndarray:
        return np.nonzero(self.boundary_tags == tag)[0]

    @property
    def tags(self) -> np.ndarray:
        return np.unique(self.boundary_tags)

    def summary(self) -> str:
        return (
            f"Mesh({self.name}: dim={self.dim}, nodes={self.n_nodes}, "
            f"cells={self.n_cells}, edges={self.n_edges}, "
            f"boundary facets={len(self.boundary_tags)}, tags={list(self.tags)})"
        )


def retag_boundary(mesh: Mesh, tag_fn) -> Mesh:
    """New Mesh with boundary tags assigned by geometry.

    tag_fn(midpoints [n_bf, dim]) -> int array [n_bf].  Needed for shipped
    meshes without physical groups (e.g. mesh_poli.msh, whose boundary is all
    tag 0 — the reference could not actually run its DFG case on it either).
    """
    mid = mesh.coords[mesh.boundary_facets].mean(axis=1)
    tags = np.asarray(tag_fn(mid), dtype=np.int32)
    return Mesh(
        coords=mesh.coords.copy(),
        cells=mesh.cells.copy(),
        boundary_facets=mesh.boundary_facets.copy(),
        boundary_tags=tags,
        name=mesh.name + "+retag",
        cell_tags=mesh.cell_tags,
    )


def refine_uniform(mesh: Mesh, times: int = 1, snap_boundary: dict | None = None) -> Mesh:
    """Red (regular) uniform refinement: each tri -> 4 tris, each tet -> 8 tets.

    New vertices at edge midpoints; boundary facets split with inherited tags.
    This is the scaling utility used to reach multi-chip problem sizes
    (BASELINE.md's ~10M-DoF configs) from the shipped meshes.

    snap_boundary: optional {tag: project_fn} — this framework's analogue of
    deal.II's manifold attachment for curved boundaries.  New vertices created
    ON a boundary facet with that tag get their coordinates replaced by
    ``project_fn(coords [m, dim]) -> [m, dim]`` (e.g. radial projection onto a
    cylinder).  Without it, refining a polygonal approximation of a curved
    boundary keeps the ORIGINAL polygon forever (new midpoints sit on the old
    chords), so the geometric error never converges.
    """
    m = mesh
    for _ in range(times):
        m = _refine_once(m, snap_boundary)
    return m


def circle_projector(center, radius):
    """snap_boundary projector: radial projection onto a circle/sphere."""
    center = np.asarray(center, dtype=np.float64)

    def project(x):
        d = x - center
        r = np.linalg.norm(d, axis=1, keepdims=True)
        return center + radius * d / np.maximum(r, 1e-300)

    return project


def _refine_once(mesh: Mesh, snap_boundary: dict | None = None) -> Mesh:
    dim = mesh.dim
    edges, cell_edges = mesh.edges, mesh.cell_edges
    mid = 0.5 * (mesh.coords[edges[:, 0]] + mesh.coords[edges[:, 1]])
    coords = np.vstack([mesh.coords, mid])
    e_off = mesh.n_nodes  # new-vertex id of edge e is e_off + e

    c = mesh.cells.astype(np.int64)
    ce = cell_edges.astype(np.int64) + e_off
    if dim == 2:
        # edges order: (0,1),(1,2),(2,0) -> m01, m12, m20
        v0, v1, v2 = c[:, 0], c[:, 1], c[:, 2]
        m01, m12, m20 = ce[:, 0], ce[:, 1], ce[:, 2]
        new_cells = np.concatenate(
            [
                np.stack([v0, m01, m20], 1),
                np.stack([m01, v1, m12], 1),
                np.stack([m20, m12, v2], 1),
                np.stack([m01, m12, m20], 1),
            ],
            axis=0,
        )
    else:
        # tets, EDGES[3] = (0,1),(0,2),(0,3),(1,2),(1,3),(2,3)
        v0, v1, v2, v3 = (c[:, i] for i in range(4))
        m01, m02, m03, m12, m13, m23 = (ce[:, i] for i in range(6))
        corner = [
            np.stack([v0, m01, m02, m03], 1),
            np.stack([v1, m01, m12, m13], 1),
            np.stack([v2, m02, m12, m23], 1),
            np.stack([v3, m03, m13, m23], 1),
        ]
        # interior octahedron split along diagonal (m01, m23)
        octa = [
            np.stack([m01, m02, m03, m23], 1),
            np.stack([m01, m02, m12, m23], 1),
            np.stack([m01, m03, m13, m23], 1),
            np.stack([m01, m12, m13, m23], 1),
        ]
        new_cells = np.concatenate(corner + octa, axis=0)

    # boundary facets: 2D edge -> 2 segments; 3D tri -> 4 tris
    bf = mesh.boundary_facets.astype(np.int64)
    # midpoint vertex ids for boundary facet edges, via the global edge map
    def edge_mid(a, b):
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        key = lo * (coords.shape[0] + 1) + hi
        ekey = edges[:, 0].astype(np.int64) * (coords.shape[0] + 1) + edges[:, 1]
        order = np.argsort(ekey)
        pos = np.searchsorted(ekey[order], key)
        return e_off + order[pos]

    if dim == 2:
        m = edge_mid(bf[:, 0], bf[:, 1])
        new_bf = np.concatenate([np.stack([bf[:, 0], m], 1), np.stack([m, bf[:, 1]], 1)])
        new_tags = np.concatenate([mesh.boundary_tags] * 2)
        facet_new_ids = m[:, None]  # [n_bf, 1] new vertex per facet
    else:
        a, b, cc = bf[:, 0], bf[:, 1], bf[:, 2]
        mab, mbc, mca = edge_mid(a, b), edge_mid(b, cc), edge_mid(cc, a)
        new_bf = np.concatenate(
            [
                np.stack([a, mab, mca], 1),
                np.stack([mab, b, mbc], 1),
                np.stack([mca, mbc, cc], 1),
                np.stack([mab, mbc, mca], 1),
            ]
        )
        new_tags = np.concatenate([mesh.boundary_tags] * 4)
        facet_new_ids = np.stack([mab, mbc, mca], axis=1)  # [n_bf, 3]

    if snap_boundary:
        for tag, proj in snap_boundary.items():
            ids = np.unique(facet_new_ids[mesh.boundary_tags == tag])
            if len(ids):
                coords[ids] = proj(coords[ids])

    return Mesh(
        coords=coords,
        cells=new_cells.astype(np.int32),
        boundary_facets=new_bf.astype(np.int32),
        boundary_tags=new_tags,
        name=mesh.name + "+r",
    )


def _facet_keys(f: np.ndarray, n_nodes: int) -> np.ndarray:
    """Collision-free int64 key per (sorted) facet row.

    Only valid while (n_nodes+1)**n_facet_nodes < 2**63 — callers must use
    :func:`_facet_ids` which falls back to lexicographic row ids when base
    packing would overflow (3D meshes above ~2M nodes)."""
    f = np.sort(f.astype(np.int64), axis=1)
    key = f[:, 0]
    for j in range(1, f.shape[1]):
        key = key * (n_nodes + 1) + f[:, j]
    return key


def _facet_ids(cf: np.ndarray, bf: np.ndarray, n_nodes: int):
    """Shared collision-free int64 ids for two facet-row arrays.

    Fast path: base-(n_nodes+1) packing.  When that would overflow int64,
    rank rows lexicographically over the concatenated set instead
    (np.unique(axis=0) inverse indices) — unbounded node counts."""
    k = cf.shape[1]
    if (n_nodes + 1) ** k < 2**62:  # margin below int64 max
        return _facet_keys(cf, n_nodes), _facet_keys(bf, n_nodes)
    allf = np.sort(np.concatenate([cf, bf]).astype(np.int64), axis=1)
    _, inv = np.unique(allf, axis=0, return_inverse=True)
    inv = inv.astype(np.int64)
    return inv[: len(cf)], inv[len(cf):]


def extract_cells(mesh: Mesh, keep) -> Mesh:
    """Submesh of the cells selected by ``keep`` (bool mask or index array).

    Unreferenced vertices are dropped and renumbered; boundary facets are
    kept only where they are genuine facets of exactly ONE surviving cell
    (deal.II semantics: interior facets carrying boundary ids are ignored).
    A warning is issued if the extraction exposes UNTAGGED boundary facets —
    the solver cannot see those, so they would silently get the natural
    (do-nothing) condition.

    The motivating defect: the shipped DFG channel meshes (mesh_poli*.msh)
    mesh the cylinder INTERIOR as live cells with the circle as an internal
    facet loop.  Solving on them traps fluid inside the cylinder, whose
    near-constant pressure couples into the circle nodes and wipes out the
    front/back pressure difference (measured: dP 0.027 vs the published
    0.1175, Cd 2.95 vs 5.58 on DFG 2D-1).  ``extract_cells(mesh,
    centroid_r > r_cyl)`` recovers the true exterior-flow domain.
    """
    keep = np.asarray(keep)
    cells = mesh.cells[keep]
    if cells.size == 0:
        raise ValueError("extract_cells: empty selection")
    used = np.unique(cells)
    remap = np.full(mesh.n_nodes, -1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    dim = mesh.dim

    from itertools import combinations

    cf = np.concatenate(
        [cells[:, list(c)] for c in combinations(range(dim + 1), dim)]
    )
    cf_keys, bf_keys = _facet_ids(cf, mesh.boundary_facets, mesh.n_nodes)
    cf_keys = np.sort(cf_keys)
    lo = np.searchsorted(cf_keys, bf_keys, side="left")
    hi = np.searchsorted(cf_keys, bf_keys, side="right")
    keep_bf = (hi - lo) == 1  # facet of exactly one surviving cell

    # untagged-boundary check: every once-occurring cell facet should be tagged
    uniq, counts = np.unique(cf_keys, return_counts=True)
    n_true_boundary = int((counts == 1).sum())
    n_tagged = int(np.isin(uniq[counts == 1], bf_keys[keep_bf]).sum())
    if n_tagged < n_true_boundary:
        import warnings

        warnings.warn(
            f"extract_cells: {n_true_boundary - n_tagged} boundary facet(s) of "
            "the extracted mesh carry no tag (natural/do-nothing by default); "
            "retag_boundary() them if they need conditions"
        )

    return Mesh(
        coords=mesh.coords[used],
        cells=remap[cells].astype(np.int32),
        boundary_facets=remap[mesh.boundary_facets[keep_bf]].astype(np.int32),
        boundary_tags=mesh.boundary_tags[keep_bf].copy(),
        name=mesh.name + "+extract",
        cell_tags=None if mesh.cell_tags is None else mesh.cell_tags[keep],
    )
