"""gmsh ``.msh`` reader (MSH 2.2 ASCII and MSH 4.1 ASCII) -> Mesh.

JAX replacement for deal.II ``GridIn::read_msh``
(``/root/reference/src/NavierStokesSolver.cpp:12-16``).  The reference repo
ships meshes in BOTH formats (see BASELINE.md's table), so both are parsed.
Boundary ids follow deal.II semantics: the gmsh *physical* tag of the
codim-1 element (v2.2: first element tag; v4.1: the physical tag of the
geometric entity owning the element block).

A fast C++ path for huge meshes lives in csrc/meshkit.cpp; this module is the
reference implementation and fallback.
"""

from __future__ import annotations

import io
import warnings

import numpy as np

from .mesh import Mesh

__all__ = ["read_msh", "read_msh_bytes"]

# gmsh element types we BUILD cells/facets from -> (n_nodes, dim)
_ETYPES = {
    1: (2, 1),  # 2-node line
    2: (3, 2),  # 3-node triangle
    4: (4, 3),  # 4-node tetrahedron
    15: (1, 0),  # point
}

# node counts of other common gmsh element types, needed to SKIP their
# records while parsing (policy: unsupported types are skipped with a
# warning, identically in the v2.2, v4.1, and native parsers)
_SKIP_NNODES = {
    3: 4, 5: 8, 6: 6, 7: 5, 8: 3, 9: 6, 10: 9, 11: 10, 12: 27, 13: 18,
    14: 14, 16: 8, 17: 20, 26: 4, 27: 5, 28: 6,
}


def _warn_skipped(etype: int, count: int):
    warnings.warn(
        f"gmsh element type {etype} is not a simplex cell/facet: "
        f"skipped {count} element(s)",
        stacklevel=3,
    )


def read_msh(path: str, name: str | None = None, backend: str = "auto") -> Mesh:
    """Read a gmsh mesh.  backend: "auto" prefers the native C++ parser
    (csrc/meshkit.cpp, ~5-10x faster) and falls back to pure Python — also
    when the native parse ERRORS (identical accept set is tested, but the
    python parser is the reference implementation); "python" / "native"
    force one implementation."""
    if backend in ("auto", "native"):
        from . import meshkit

        if meshkit.available():
            try:
                return meshkit.read_msh_native(path, name=name)
            except Exception as e:
                if backend == "native":
                    raise
                warnings.warn(f"native msh parse failed ({e}); using python parser")
        elif backend == "native":
            raise RuntimeError("native meshkit not built (make -C csrc)")
    with open(path, "rb") as f:
        data = f.read()
    return read_msh_bytes(data, name=name or str(path))


def read_msh_bytes(data: bytes, name: str = "msh") -> Mesh:
    text = data.decode("utf-8", errors="replace")
    sections = _split_sections(text)
    if "MeshFormat" not in sections:
        raise ValueError("not a gmsh file: missing $MeshFormat")
    version = sections["MeshFormat"].split()[0]
    if version.startswith("2."):
        nodes, elems = _parse_v2(sections)
    elif version.startswith("4."):
        nodes, elems = _parse_v4(sections)
    else:
        raise ValueError(f"unsupported msh version {version}")
    return _build_mesh(nodes, elems, name)


def _split_sections(text: str) -> dict[str, str]:
    out = {}
    pos = 0
    while True:
        start = text.find("$", pos)
        if start < 0:
            break
        eol = text.find("\n", start)
        tag = text[start + 1 : eol].strip()
        end = text.find(f"$End{tag}", eol)
        if end < 0:
            break
        out[tag] = text[eol + 1 : end]
        pos = end + len(tag) + 4
    return out


def _parse_v2(sec):
    lines = sec["Nodes"].strip().split("\n")
    n = int(lines[0])
    arr = np.loadtxt(io.StringIO("\n".join(lines[1 : n + 1])), dtype=np.float64, ndmin=2)
    node_ids = arr[:, 0].astype(np.int64)
    coords = arr[:, 1:4]

    elines = sec["Elements"].strip().split("\n")
    m = int(elines[0])
    elems = []  # list of (etype, phys_tag, node_ids)
    skipped: dict[int, int] = {}
    for ln in elines[1 : m + 1]:
        parts = ln.split()
        etype = int(parts[1])
        if etype not in _ETYPES:
            skipped[etype] = skipped.get(etype, 0) + 1
            continue
        ntags = int(parts[2])
        phys = int(parts[3]) if ntags >= 1 else 0
        nn = _ETYPES[etype][0]
        nodes = [int(x) for x in parts[3 + ntags : 3 + ntags + nn]]
        elems.append((etype, phys, nodes))
    for etype, cnt in skipped.items():
        _warn_skipped(etype, cnt)
    return (node_ids, coords), elems


def _parse_v4(sec):
    # Entities: map (dim, entity_tag) -> physical tag (first one, 0 if none)
    ent_phys: dict[tuple[int, int], int] = {}
    if "Entities" in sec:
        toks = sec["Entities"].split()
        it = iter(toks)
        counts = [int(next(it)) for _ in range(4)]
        for d, cnt in enumerate(counts):
            for _ in range(cnt):
                tag = int(next(it))
                nbox = 3 if d == 0 else 6
                for _ in range(nbox):
                    next(it)
                nphys = int(next(it))
                phys = [int(next(it)) for _ in range(nphys)]
                ent_phys[(d, tag)] = phys[0] if phys else 0
                if d > 0:
                    nb = int(next(it))
                    for _ in range(nb):
                        next(it)

    ntoks = sec["Nodes"].split()
    it = iter(ntoks)
    n_blocks = int(next(it))
    n_nodes = int(next(it))
    next(it), next(it)  # min/max tag
    node_ids = np.empty(n_nodes, dtype=np.int64)
    coords = np.empty((n_nodes, 3), dtype=np.float64)
    k = 0
    for _ in range(n_blocks):
        bdim = int(next(it))
        next(it)  # entity tag
        parametric = int(next(it))
        nb = int(next(it))
        ids = [int(next(it)) for _ in range(nb)]
        # parametric blocks append the entity-dim parametric coords per node
        stride = 3 + (bdim if parametric else 0)
        for i in range(nb):
            vals = [float(next(it)) for _ in range(stride)]
            node_ids[k] = ids[i]
            coords[k] = vals[:3]
            k += 1

    etoks = sec["Elements"].split()
    it = iter(etoks)
    e_blocks = int(next(it))
    next(it), next(it), next(it)
    elems = []
    skipped: dict[int, int] = {}
    for _ in range(e_blocks):
        edim = int(next(it))
        etag = int(next(it))
        etype = int(next(it))
        nb = int(next(it))
        phys = ent_phys.get((edim, etag), 0)
        if etype not in _ETYPES:
            if etype not in _SKIP_NNODES:
                raise ValueError(f"unknown gmsh element type {etype} (cannot skip)")
            for _ in range(nb * (1 + _SKIP_NNODES[etype])):
                next(it)
            skipped[etype] = skipped.get(etype, 0) + nb
            continue
        nn = _ETYPES[etype][0]
        for _ in range(nb):
            next(it)  # element tag
            nodes = [int(next(it)) for _ in range(nn)]
            elems.append((etype, phys, nodes))
    for etype, cnt in skipped.items():
        _warn_skipped(etype, cnt)
    return (node_ids, coords), elems


def _build_mesh(nodes, elems, name: str) -> Mesh:
    node_ids, coords3 = nodes
    # gmsh node ids may be sparse: remap to dense 0-based
    remap = {}
    for i, nid in enumerate(node_ids):
        remap[int(nid)] = i

    cell_dim = max(_ETYPES[e[0]][1] for e in elems)
    if cell_dim not in (2, 3):
        raise ValueError(f"mesh has no 2D/3D cells (max elem dim {cell_dim})")
    if cell_dim == 2:
        zspan = coords3[:, 2].max() - coords3[:, 2].min()
        if zspan > 1e-12 * max(1.0, np.abs(coords3).max()):
            raise NotImplementedError(
                f"{name}: triangle mesh embedded in 3D (surface mesh) — "
                "only planar 2D and volumetric 3D meshes are supported"
            )
    coords = coords3[:, :cell_dim]

    cells, cell_tags, bfacets, btags = [], [], [], []
    for etype, phys, nds in elems:
        nn, d = _ETYPES[etype]
        mapped = [remap[n] for n in nds]
        if d == cell_dim:
            cells.append(mapped)
            cell_tags.append(phys)
        elif d == cell_dim - 1:
            bfacets.append(mapped)
            btags.append(phys)

    cells = np.array(cells, dtype=np.int64)
    bfacets = np.array(bfacets, dtype=np.int64).reshape(-1, cell_dim)
    coords, cells, bfacets = _delete_unused_vertices(coords, cells, bfacets)
    return Mesh(
        coords=coords,
        cells=cells.astype(np.int32),
        boundary_facets=bfacets.astype(np.int32),
        boundary_tags=np.array(btags, dtype=np.int32),
        name=name,
        cell_tags=np.array(cell_tags, dtype=np.int32),
    )


def _delete_unused_vertices(coords, cells, bfacets):
    """Drop nodes referenced by no cell (deal.II GridIn does the same —
    gmsh files often carry orphan geometry points)."""
    used = np.zeros(len(coords), dtype=bool)
    used[cells.ravel()] = True
    used[bfacets.ravel()] = True
    if used.all():
        return coords, cells, bfacets
    new_id = np.cumsum(used) - 1
    return coords[used], new_id[cells], new_id[bfacets]
