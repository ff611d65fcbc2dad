"""Windowed matrix-free operator application: the solver's hot SpMV.

GMRES tangent solves apply the operator ~200 times per Newton step (SURVEY
§3.3), and every assembly gathers the solution at cell dofs and scatters the
residual back.  This module does all three over a BLOCKED layout, so that a
cell only ever touches a short window of the global vector and the SPMD
path exchanges O(halo) data instead of whole vectors:

  1. DoFs carry a blocked locality renumbering (fem/dofs.renumber_blocked):
     block b OWNS the contiguous scalar ranges [b*OW, (b+1)*OW) and every
     cell's dofs span O(sqrt(n)) positions.
  2. Block b's WINDOW is the (2h+1)-block neighborhood around its owned
     range (h = measured halo reach in blocks): window extraction from the
     global vector is (2h+1) shifted slices.
  3. Every cell is assigned to exactly ONE home block (the block of its
     dof-span midpoint) and stores the window positions of its dofs.  Cells
     are sorted within each block by window position, so neighboring cells
     read and write neighboring addresses.
  4. An apply is three plain XLA steps: one flat gather from the block
     windows, a per-cell contraction with the element matrix (an exact
     multiply-and-sum in x's dtype, which XLA fuses with the gather), and one
     scatter-add into per-block window accumulators.  (On an NVIDIA GPU the
     f32 full-system matvec runs the same three steps as one Pallas kernel,
     ``_onepass_matvec``.)  Overlapping window rows
     of neighboring blocks are then merged by (2h+1) shifted adds
     (``_combine_windows``) — the analogue of the reference's Epetra
     ``compress(add)`` neighbor exchange
     (/root/reference/src/NavierStokesSolver.cpp:345-347).  Under SPMD the
     shifted adds cross device boundaries only in the h edge blocks, so the
     collective volume is O(halo), not O(n).

The operator matrix lives in "cells-last" layout A_t[j, i, c]:
[nl, nli, nb*Bmax] with the (padded, block-ordered) cell axis last — the
layout batched assembly emits directly (fem/windowed_assembly), in which
every per-cell read of one matrix entry is contiguous across cells.

Padded cell slots carry the sentinel position W (one past the window): they
gather zero and scatter into a dump slot that is dropped.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "WindowedLayout",
    "build_windowed_layout",
    "to_block_form",
    "windowed_matvec",
    "windowed_matvec_block",
    "windowed_gather",
    "windowed_scatter",
    "slice_block",
    "block_shape",
]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class WindowedLayout:
    cell_ids: jax.Array  # [nb, Bmax] int32 original cell index (pad: 0)
    # window-local positions of each cell's dofs, cells last [k, nb, Bmax];
    # padded slots carry the sentinel W (one past the window)
    loc_v: jax.Array
    loc_p: jax.Array
    nb: int = field(metadata=dict(static=True))
    Bmax: int = field(metadata=dict(static=True))
    Bc: int = field(metadata=dict(static=True))  # Bmax is a multiple of Bc
    OWv: int = field(metadata=dict(static=True))
    OWp: int = field(metadata=dict(static=True))
    hv: int = field(metadata=dict(static=True))  # halo blocks each side (v)
    hp: int = field(metadata=dict(static=True))
    k_v: int = field(metadata=dict(static=True))  # true scalar dofs/cell (v)
    k_p: int = field(metadata=dict(static=True))
    dim: int = field(metadata=dict(static=True))
    n_vs: int = field(metadata=dict(static=True))
    n_ps: int = field(metadata=dict(static=True))
    pad_factor: float = field(metadata=dict(static=True))  # ncd / n_cells

    @property
    def n_u(self) -> int:
        return self.dim * self.n_vs

    @property
    def nl(self) -> int:
        return self.dim * self.k_v + self.k_p

    @property
    def nli(self) -> int:
        return _round_up(self.nl, 8)

    @property
    def ncd(self) -> int:
        """Flat padded cell count (last axis of A_t)."""
        return self.nb * self.Bmax

    @property
    def Wv(self) -> int:
        """Velocity window length (2h+1 blocks)."""
        return (2 * self.hv + 1) * self.OWv

    @property
    def Wp(self) -> int:
        return (2 * self.hp + 1) * self.OWp

    def valid_slots(self) -> np.ndarray:
        """Host mask [nb, Bmax] of the slots that hold a real cell."""
        return np.asarray(self.loc_p)[0] < self.Wp


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def build_windowed_layout(
    cell_vdofs: np.ndarray,
    cell_pdofs: np.ndarray,
    n_vs: int,
    n_ps: int,
    dim: int,
    block_info: dict | None = None,
    target_ow: int = 1024,
    Bc: int = 128,
) -> WindowedLayout:
    """Host-side layout construction.

    Requires blocked-renumbered dof maps (fem/dofs.renumber_blocked), whose
    ``block_info`` dict {"nb", "OWv", "OWp"} should be passed through; the
    legacy path derives nb from target_ow (works for any low-bandwidth
    numbering, with larger halos).
    """
    if block_info is not None:
        nb, OWv, OWp = block_info["nb"], block_info["OWv"], block_info["OWp"]
        assert nb * OWv == n_vs and nb * OWp == n_ps, "block_info mismatch"
    else:
        nb = max(1, int(round(n_vs / target_ow)))
        OWv = _round_up(-(-n_vs // nb), 128)
        OWp = _round_up(-(-n_ps // nb), 128)
    return _build(cell_vdofs, cell_pdofs, n_vs, n_ps, dim, nb, OWv, OWp, Bc)


def _halo_and_loc(cell_space_dofs, cell_ids, valid, OW, nb, max_halo=6):
    """Halo width (whole blocks) from the ACTUAL reach of the listed cells,
    plus absolute window-local positions [nb, Bmax, k] (-1 on padding)."""
    dofs_b = cell_space_dofs[cell_ids].astype(np.int64)  # [nb, Bmax, k]
    owned_lo = (np.arange(nb) * OW)[:, None, None]
    reach_lo = np.where(valid[:, :, None], owned_lo - dofs_b, 0).max()
    reach_hi = np.where(valid[:, :, None], dofs_b - (owned_lo + OW) + 1, 0).max()
    h = int(max(0, -(-max(reach_lo, reach_hi) // OW)))
    if h > max_halo:
        raise ValueError(
            f"halo {h} blocks exceeds limit (OW={OW}); ordering not local enough"
        )
    W = (2 * h + 1) * OW
    loc = dofs_b - (owned_lo - h * OW)
    loc[~valid] = -1
    if valid.any():
        assert loc[valid].min() >= 0 and loc[valid].max() < W
    return h, loc


def _build(cell_vdofs, cell_pdofs, n_vs, n_ps, dim, nb, OWv, OWp, Bc=128) -> WindowedLayout:
    nc, k_v = cell_vdofs.shape
    k_p = cell_pdofs.shape[1]

    # home block of each cell: block containing the midpoint of its v-dof
    # span (each cell appears exactly ONCE; halo rows it writes outside its
    # home block's owned range are merged by _combine_windows)
    cv = cell_vdofs.astype(np.int64)
    mid = (cv.min(axis=1) + cv.max(axis=1)) // 2
    home = np.clip(mid // OWv, 0, nb - 1)

    counts = np.bincount(home, minlength=nb)
    Bc = _round_up(max(128, Bc), _ONEPASS_BLOCK)
    Bmax = _round_up(max(int(counts.max()), 1), Bc)

    order = np.argsort(home, kind="stable")
    cell_ids = np.zeros((nb, Bmax), dtype=np.int64)
    valid = np.zeros((nb, Bmax), dtype=bool)
    starts = np.concatenate([[0], np.cumsum(counts[:-1])])
    within = np.arange(nc) - starts[home[order]]
    cell_ids[home[order], within] = order
    valid[home[order], within] = True

    hv, loc_v = _halo_and_loc(cell_vdofs, cell_ids, valid, OWv, nb)
    hp, loc_p = _halo_and_loc(cell_pdofs, cell_ids, valid, OWp, nb)

    # sort cells WITHIN each block by window position (invalid slots last)
    Wv, Wp = (2 * hv + 1) * OWv, (2 * hp + 1) * OWp
    key = np.where(valid, np.where(loc_v >= 0, loc_v, Wv + 1).min(axis=2), Wv + 1)
    perm = np.argsort(key, axis=1, kind="stable")  # [nb, Bmax]
    rows = np.arange(nb)[:, None]
    cell_ids = cell_ids[rows, perm]
    loc_v = loc_v[rows, perm]
    loc_p = loc_p[rows, perm]

    def cells_last(loc, W):
        return np.where(loc >= 0, loc, W).astype(np.int32).transpose(2, 0, 1)

    return WindowedLayout(
        cell_ids=jnp.asarray(cell_ids, dtype=jnp.int32),
        loc_v=jnp.asarray(cells_last(loc_v, Wv)),
        loc_p=jnp.asarray(cells_last(loc_p, Wp)),
        nb=nb,
        Bmax=Bmax,
        Bc=Bc,
        OWv=OWv,
        OWp=OWp,
        hv=hv,
        hp=hp,
        k_v=k_v,
        k_p=k_p,
        dim=dim,
        n_vs=n_vs,
        n_ps=n_ps,
        pad_factor=float(nb * Bmax) / max(nc, 1),
    )


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------


def _pad_edges(r: jax.Array, h: int) -> jax.Array:
    """[nb, OW] -> [nb + 2h, OW] with zero edge blocks (single-device)."""
    if h == 0:
        return r
    z = jnp.zeros((h, r.shape[1]), dtype=r.dtype)
    return jnp.concatenate([z, r, z], axis=0)


def _halo_edges(r: jax.Array, h: int, axis_name: str) -> jax.Array:
    """[nb_loc, OW] -> [nb_loc + 2h, OW]: edge blocks fetched from the ring
    neighbors via ppermute (zeros at the global ends — unpaired destinations
    receive zero).  The ghost import of Epetra's SpMV
    (/root/reference/src/NavierStokesSolver.cpp:345-347 compress/ghost
    update): per-matvec collective volume is O(h*OW), not O(n)."""
    if h == 0:
        return r
    n_dev = jax.lax.axis_size(axis_name)
    fwd = [(i, i + 1) for i in range(n_dev - 1)]  # data moves to the right
    bwd = [(i + 1, i) for i in range(n_dev - 1)]
    left = jax.lax.ppermute(r[-h:], axis_name, fwd)  # my left neighbor's tail
    right = jax.lax.ppermute(r[:h], axis_name, bwd)  # right neighbor's head
    return jnp.concatenate([left, r, right], axis=0)


def _windows(
    c: jax.Array, nb: int, OW: int, h: int, axis_name: str | None
) -> jax.Array:
    """One scalar space's planar values -> windows [nb, (2h+1)*OW].

    Window row j*OW + r of block b is global row (b - h + j)*OW + r; with
    ``axis_name`` (inside shard_map, local block range) the edge blocks come
    from the ring neighbors."""
    if c.shape[0] < nb * OW:  # legacy layouts pad the last block
        c = jnp.zeros(nb * OW, c.dtype).at[: c.shape[0]].set(c)
    r = c.reshape(nb, OW)
    ext = _pad_edges(r, h) if axis_name is None else _halo_edges(r, h, axis_name)
    return jnp.concatenate([ext[s : s + nb] for s in range(2 * h + 1)], axis=1)


def _combine_windows(
    win: jax.Array, nb: int, OW: int, h: int, n: int, axis_name: str | None = None
) -> jax.Array:
    """Merge per-block window accumulators [nb, (2h+1)*OW] into the global
    vector: (2h+1) shifted adds.  Under SPMD the h edge rows of the local
    accumulator are the neighbor devices' contributions, exported via
    ppermute (the reverse of ``_halo_edges``: the Epetra ``compress(add)``
    neighbor reduction, O(h*OW) collective volume)."""
    seg = win.reshape(nb, 2 * h + 1, OW)
    acc = jnp.zeros((nb + 2 * h, OW), dtype=win.dtype)
    for j in range(2 * h + 1):
        acc = acc.at[j : j + nb].add(seg[:, j])
    if axis_name is not None and h > 0:
        n_dev = jax.lax.axis_size(axis_name)
        fwd = [(i, i + 1) for i in range(n_dev - 1)]
        bwd = [(i + 1, i) for i in range(n_dev - 1)]
        # acc row p holds local block p - h: rows p < h belong to the LEFT
        # neighbor's tail blocks, rows p >= h + nb to the RIGHT's head
        from_right = jax.lax.ppermute(acc[:h], axis_name, bwd)
        from_left = jax.lax.ppermute(acc[h + nb :], axis_name, fwd)
        mid = acc[h : h + nb]
        mid = mid.at[:h].add(from_left).at[nb - h :].add(from_right)
        return mid.reshape(-1)[:n]
    return acc[h : h + nb].reshape(-1)[:n]


def _components(lay: WindowedLayout, spaces: str):
    """Scalar components of ``spaces`` ("v", "p" or "vp") in planar order:
    (segment length, OW, h, positions [k, nb, Bmax])."""
    comps = []
    if "v" in spaces:
        comps += [(lay.n_vs, lay.OWv, lay.hv, lay.loc_v)] * lay.dim
    if "p" in spaces:
        comps.append((lay.n_ps, lay.OWp, lay.hp, lay.loc_p))
    return comps


def _flat_index(loc: jax.Array, W: int) -> jax.Array:
    """Window positions [k, nb, Bmax] -> indices into the flattened
    [nb, W + 1] window array whose extra column is the sentinel slot."""
    base = jnp.arange(loc.shape[1], dtype=loc.dtype) * (W + 1)
    return loc + base[None, :, None]


def _window_sources(lay: WindowedLayout, x: jax.Array, spaces: str, axis_name):
    """Per scalar component of ``spaces``: its windows with a zero sentinel
    column, flattened to [nb * (W + 1)]."""
    out, i0 = [], 0
    for n, OW, h, _ in _components(lay, spaces):
        w = _windows(x[i0 : i0 + n], lay.nb, OW, h, axis_name)
        i0 += n
        out.append(jnp.concatenate([w, jnp.zeros((lay.nb, 1), w.dtype)], axis=1).reshape(-1))
    return out


def _merge(lay: WindowedLayout, accs, spaces: str, axis_name) -> jax.Array:
    """Per-component flat window accumulators [nb * (W + 1)] -> the planar
    segment of ``spaces`` (sentinel column dropped, overlaps merged)."""
    ys = []
    for acc, (n, OW, h, _) in zip(accs, _components(lay, spaces)):
        W = (2 * h + 1) * OW
        win = acc.reshape(lay.nb, W + 1)[:, :W]
        ys.append(_combine_windows(win, lay.nb, OW, h, n, axis_name))
    return jnp.concatenate(ys) if len(ys) > 1 else ys[0]


def _gather(lay: WindowedLayout, x: jax.Array, spaces: str, axis_name) -> jax.Array:
    """X[l, s] = x[dof_l of cell s] for the dofs of ``spaces``: [n, ncd].

    One flat 1-D gather per component from its zero-extended windows; no
    per-cell copy of a window is ever formed."""
    cols = [
        src[_flat_index(loc, src.shape[0] // lay.nb - 1)].reshape(loc.shape[0], -1)
        for src, (_, _, _, loc) in zip(
            _window_sources(lay, x, spaces, axis_name), _components(lay, spaces)
        )
    ]
    return jnp.concatenate(cols, axis=0)


def _scatter(lay: WindowedLayout, R: jax.Array, spaces: str, axis_name) -> jax.Array:
    """y = sum_cells P_c^T R_c over the dofs of ``spaces`` (rows of R in the
    same order as ``_gather``): scatter-add into per-block windows, then
    merge the overlaps."""
    accs, r0 = [], 0
    for n, OW, h, loc in _components(lay, spaces):
        k = loc.shape[0]
        W = (2 * h + 1) * OW
        acc = jnp.zeros(lay.nb * (W + 1), dtype=R.dtype)
        accs.append(acc.at[_flat_index(loc, W).reshape(-1)].add(R[r0 : r0 + k].reshape(-1)))
        r0 += k
    return _merge(lay, accs, spaces, axis_name)


def _contract(A: jax.Array, X: jax.Array) -> jax.Array:
    """y[i, s] = sum_j A[j, i, s] X[j, s] in X's dtype (A may be stored
    narrower and is widened on read).  A multiply and a sum, not a dot: no
    reduced-precision matrix unit can take part, so f32 stays f32."""
    return (A.astype(X.dtype) * X[:, None, :]).sum(axis=0)


def windowed_gather(
    lay: WindowedLayout, x: jax.Array, *, axis_name: str | None = None
) -> jax.Array:
    """X[l, s] = x[dof_l of cell s] — [nl, nb*Bmax].

    Batched assembly consumes it to evaluate solution fields at cells.
    axis_name: set inside shard_map with a LOCAL layout (contiguous block
    range per device) — windows then fetch only the h edge blocks from the
    ring neighbors (O(halo) collectives).
    """
    return _gather(lay, x, "vp", axis_name)


def windowed_scatter(
    lay: WindowedLayout, R: jax.Array, *, axis_name: str | None = None
) -> jax.Array:
    """y = sum_cells P_c^T R_c for per-cell row values R [>=nl, nb*Bmax].

    Each block accumulates its whole window, then overlaps merge via
    ``_combine_windows``.  Returns the planar vector [n_u + n_ps].
    """
    return _scatter(lay, R, "vp", axis_name)


def windowed_matvec(
    lay: WindowedLayout,
    A_t: jax.Array,
    x: jax.Array,
    *,
    axis_name: str | None = None,
) -> jax.Array:
    """y = A x (no Dirichlet handling here).

    A_t: [nl, nli, nb*Bmax] cells-last block-ordered matrices
    (``to_block_form`` or windowed assembly output), possibly stored
    narrower than x; the result has x's dtype.

    An f32 apply of a 2D element on an NVIDIA GPU runs the one-pass kernel
    (``_onepass_matvec``); every other case runs the plain gather /
    contract / scatter-add path, which is also its reference.
    """
    plain = functools.partial(windowed_matvec_block, axis_name=axis_name)
    if x.dtype != jnp.float32 or lay.nl > _ONEPASS_MAX_NL:
        return plain(lay, A_t, x)
    return jax.lax.platform_dependent(
        lay, A_t, x,
        cuda=functools.partial(_onepass_matvec, axis_name=axis_name),
        default=plain,
    )


_ONEPASS_BLOCK = 128  # cells per program; Bmax is a multiple of it
# the kernel unrolls nl^2 loads: the 2D P2/P1 element (nl = 15) is where it
# was measured faster; the 3D one (nl = 34) took 203 s to compile on an H100
_ONEPASS_MAX_NL = 16


def _onepass_matvec(lay, A_t, x, *, axis_name=None, block: int = _ONEPASS_BLOCK):
    """Full-system f32 y = A x in one Pallas (Triton) pass.

    XLA runs the plain path as one scatter fusion per vector component, each
    recomputing its rows' gathers and contractions per update; on an H100
    that reached ~40% of a plain copy's bandwidth (PERF.md).  Here each
    program takes ``block`` consecutive cells of one layout block, gathers
    their dofs once into registers, contracts with the cells' matrices and
    atomically adds every row into the window accumulators, which merge as
    in the plain path.  The atomic order varies, so results agree with the
    plain path to f32 rounding, not bitwise.
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    dim, k_v, k_p, nb, nl = lay.dim, lay.k_v, lay.k_p, lay.nb, lay.nl
    srcs = _window_sources(lay, x, "vp", axis_name)
    sizes = [s_.shape[0] for s_ in srcs]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
    comp_loc = [0] * (dim * k_v) + [1] * k_p  # which position table per row
    comp_row = [l for _ in range(dim) for l in range(k_v)] + list(range(k_p))
    comp_of = [c for c in range(dim) for _ in range(k_v)] + [dim] * k_p
    Wp1 = [sz // nb for sz in sizes]  # window length + sentinel, per component

    def kernel(A_ref, lv_ref, lp_ref, src_ref, _zero_ref, out_ref):
        pid = pl.program_id(0)
        cells = pl.ds(pid * block, block)
        b = (pid * block) // lay.Bmax
        addr = []
        for r in range(nl):
            ref = lv_ref if comp_loc[r] == 0 else lp_ref
            c = comp_of[r]
            addr.append(offsets[c] + b * Wp1[c] + ref[comp_row[r], cells])
        xs = [src_ref[a] for a in addr]
        for i in range(nl):
            y = xs[0] * A_ref[0, i, cells].astype(jnp.float32)
            for j in range(1, nl):
                y = y + xs[j] * A_ref[j, i, cells].astype(jnp.float32)
            plt.atomic_add(out_ref, addr[i], y)

    src = jnp.concatenate(srcs)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(src.shape, jnp.float32),
        grid=(lay.ncd // block,),
        input_output_aliases={4: 0},
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        name="windowed_matvec_onepass",
    )(
        A_t, lay.loc_v.reshape(k_v, -1), lay.loc_p.reshape(k_p, -1), src,
        jnp.zeros(src.shape, jnp.float32),
    )
    accs = [out[o : o + sz] for o, sz in zip(offsets, sizes)]
    return _merge(lay, accs, "vp", axis_name)


# ---------------------------------------------------------------------------
# block matvec (velocity-only / pressure-only / rectangular couplings)
# ---------------------------------------------------------------------------


def _n_dofs(lay: WindowedLayout, spaces: str) -> int:
    """Dofs per cell of ``spaces``."""
    return (lay.dim * lay.k_v if "v" in spaces else 0) + (
        lay.k_p if "p" in spaces else 0
    )


def block_shape(lay: WindowedLayout, in_spaces: str, out_spaces: str) -> tuple[int, int]:
    """(n_in, n_out_padded) of a sub-block operator A_sub[j_in, i_out, ncd]."""
    return _n_dofs(lay, in_spaces), _round_up(_n_dofs(lay, out_spaces), 8)


def slice_block(lay: WindowedLayout, A_t: jax.Array, in_spaces: str, out_spaces: str) -> jax.Array:
    """Cut a sub-block operator out of the full A_t [nl, nli, ncd].

    Returns [n_in, n_out_pad, ncd] — e.g. the velocity block A00
    (in="v", out="v"), the divergence B (in="v", out="p"), or its
    transpose-coupling B^T (in="p", out="v").
    """
    nvl = lay.dim * lay.k_v
    jsl = {
        "v": slice(0, nvl), "p": slice(nvl, lay.nl), "vp": slice(0, lay.nl)
    }
    A = A_t[jsl[in_spaces], :, :]
    isl = jsl[out_spaces]
    n_in, n_out_pad = block_shape(lay, in_spaces, out_spaces)
    out = jnp.zeros((n_in, n_out_pad, A_t.shape[2]), dtype=A_t.dtype)
    return out.at[:, : isl.stop - isl.start, :].set(A[:, isl, :])


def windowed_matvec_block(
    lay: WindowedLayout,
    A_sub: jax.Array,
    x: jax.Array,
    *,
    in_spaces: str = "vp",
    out_spaces: str = "vp",
    axis_name: str | None = None,
) -> jax.Array:
    """y = A_sub x for a sub-block operator at proportional cost.

    A_sub: [n_in, >=n_out, ncd] (``slice_block`` of the tangent, or a
    dedicated assembled block like the pressure Laplacian Kp_t), possibly
    stored narrower than x.
    x: planar segment of the in-spaces ("v" -> [dim*n_vs], "p" -> [n_ps],
    "vp" -> full).  Returns the out-spaces segment, in x's dtype.

    A "p"->"p" apply gathers, multiplies and scatters only the k_p pressure
    dofs of each cell, ~(k_p/nl)^2 of the full matvec's matrix bytes — what
    makes Cahouet-Chabard pressure-Poisson sweeps affordable.
    """
    assert in_spaces in ("v", "p", "vp") and out_spaces in ("v", "p", "vp")
    X = _gather(lay, x, in_spaces, axis_name)
    yl = _contract(A_sub[:, : _n_dofs(lay, out_spaces)], X)
    return _scatter(lay, yl, out_spaces, axis_name)


def to_block_form(lay: WindowedLayout, cell_mat: jax.Array) -> jax.Array:
    """Natural cell matrices [nc, nl, nl] -> A_t [nl, nli, nb*Bmax].

    A_t[j, i, s] = cell_mat[cell_ids_flat[s], i, j] (row axis i padded to
    nli).  Assembly can also emit this layout directly
    (fem/windowed_assembly) — this helper is the compatibility path.
    """
    nl = cell_mat.shape[1]
    g = cell_mat[lay.cell_ids.reshape(-1)]  # [ncd, nl, nl]
    A_t = jnp.zeros((nl, lay.nli, lay.ncd), dtype=cell_mat.dtype)
    return A_t.at[:, :nl, :].set(g.transpose(2, 1, 0))
