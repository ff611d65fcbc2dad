"""Owned-range domain decomposition for the windowed operator (SPMD v2).

Rebuild of the reference's Epetra owned/ghost vector split
(``/root/reference/src/NavierStokesSolver.hpp:785-794``; ghost exchange in
``compress()``/SpMV, ``cpp:345-347``).  Round-1 SPMD replicated every vector
and psum-ed O(n) per matvec; this module shards everything by CONTIGUOUS
BLOCK RANGES of the windowed layout (fem/dofs.renumber_blocked):

  * device d owns blocks [d*nb_loc, (d+1)*nb_loc) of every scalar space, so
    its slice of the planar vector is [ux_d | uy_d | (uz_d) | p_d] — the
    "device-major" distributed layout.  ``to_dist``/``from_dist`` convert
    (pure reshapes).
  * the windowed operators run per-shard on a LOCAL WindowedLayout (same
    static geometry with nb = nb_loc); window construction and the scatter
    combine exchange only the h edge blocks via ``ppermute``
    (ops/windowed._halo_edges/_combine_windows) — O(halo) per matvec.
  * Krylov dots/norms psum (la/gmres.py, la/cg.py ``axis_name``).
  * Dirichlet rows are pre-localized per device (sentinel-padded), applied
    with dropped out-of-range scatters.

Everything here is host-side precomputation; the device code paths live in
ops/windowed.py (axis_name parameter).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..fem.windowed_assembly import WindowedAssembly
from ..ops.windowed import WindowedLayout

AXIS = "blocks"

__all__ = [
    "AXIS",
    "DistLayout",
    "make_dist_layout",
    "to_dist",
    "from_dist",
    "local_layout",
    "layout_pspecs",
    "shard_layout",
    "wa_pspecs",
    "shard_wa",
    "localize_rows",
    "localize_values",
]


@dataclasses.dataclass(frozen=True)
class DistLayout:
    """Static facts of the device-major distributed vector layout."""

    n_dev: int
    dim: int
    nb: int  # global blocks (divisible by n_dev)
    nb_loc: int
    OWv: int
    OWp: int
    n_vs: int  # global scalar velocity dofs (= nb * OWv)
    n_ps: int

    @property
    def nvs_loc(self) -> int:
        return self.nb_loc * self.OWv

    @property
    def nps_loc(self) -> int:
        return self.nb_loc * self.OWp

    @property
    def llen(self) -> int:
        return self.dim * self.nvs_loc + self.nps_loc

    @property
    def n_total(self) -> int:
        return self.n_dev * self.llen


def make_dist_layout(lay: WindowedLayout, n_dev: int) -> DistLayout:
    if lay.nb % n_dev:
        raise ValueError(
            f"nb={lay.nb} not divisible by {n_dev} devices "
            "(renumber_blocked(nb_multiple=n_dev) enforces this)"
        )
    nb_loc = lay.nb // n_dev
    if nb_loc < max(lay.hv, lay.hp, 1):
        raise ValueError(
            f"{nb_loc} blocks/device < halo {max(lay.hv, lay.hp)}: "
            "problem too small for this device count"
        )
    return DistLayout(
        n_dev=n_dev, dim=lay.dim, nb=lay.nb, nb_loc=nb_loc,
        OWv=lay.OWv, OWp=lay.OWp, n_vs=lay.n_vs, n_ps=lay.n_ps,
    )


def to_dist(x, dl: DistLayout):
    """Planar [n_total] -> device-major [n_dev * llen] (a pure permutation)."""
    xp = jnp if isinstance(x, jax.Array) else np
    comps = [
        x[c * dl.n_vs : (c + 1) * dl.n_vs].reshape(dl.n_dev, dl.nvs_loc)
        for c in range(dl.dim)
    ]
    p = x[dl.dim * dl.n_vs :].reshape(dl.n_dev, dl.nps_loc)
    return xp.concatenate(comps + [p], axis=1).reshape(-1)


def from_dist(xd, dl: DistLayout):
    """Device-major [n_dev * llen] -> planar [n_total]."""
    xp = jnp if isinstance(xd, jax.Array) else np
    chunks = xd.reshape(dl.n_dev, dl.llen)
    comps = [
        chunks[:, c * dl.nvs_loc : (c + 1) * dl.nvs_loc].reshape(-1)
        for c in range(dl.dim)
    ]
    p = chunks[:, dl.dim * dl.nvs_loc :].reshape(-1)
    return xp.concatenate(comps + [p])


def local_layout(lay: WindowedLayout, dl: DistLayout) -> WindowedLayout:
    """The layout each device sees inside shard_map: LOCAL static sizes with
    the GLOBAL arrays as leaves (shard_map's in_specs slice their block axis)."""
    return dataclasses.replace(
        lay,
        nb=dl.nb_loc,
        n_vs=dl.nvs_loc,
        n_ps=dl.nps_loc,
    )


def layout_pspecs(lay: WindowedLayout, axis: str = AXIS) -> WindowedLayout:
    """WindowedLayout pytree of PartitionSpecs (block axis sharded)."""
    sh = P(axis)
    return dataclasses.replace(
        lay,
        cell_ids=sh, loc_v=P(None, axis), loc_p=P(None, axis),
    )


def _place(tree, specs, mesh: Mesh):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    spec_leaves = jax.tree_util.tree_flatten(specs)[0]
    placed = [
        jax.device_put(leaf, NamedSharding(mesh, spec))
        for leaf, spec in zip(leaves, spec_leaves)
    ]
    return jax.tree_util.tree_unflatten(treedef, placed)


def shard_layout(lay: WindowedLayout, dl: DistLayout, mesh: Mesh) -> WindowedLayout:
    """Local-static layout with its arrays placed block-sharded on the mesh."""
    return _place(local_layout(lay, dl), layout_pspecs(lay), mesh)


def wa_pspecs(wa: WindowedAssembly, axis: str = AXIS) -> WindowedAssembly:
    """WindowedAssembly pytree of PartitionSpecs: cell-indexed arrays sharded
    on their cell axis, tabulations replicated, planar vectors by rows."""
    rep = P()
    return dataclasses.replace(
        wa,
        N_v=rep, N_p=rep, NN=rep, G_v=rep,
        invJT_t=P(None, None, axis),  # [dim, dim, ncd]
        W_t=P(None, axis),  # [nq, ncd]
        A_const=P(None, None, axis),  # [nl, nli, ncd]
        r_const=P(axis),  # device-major distributed vector
        inv_mp=P(axis),  # [n_ps] = [nb * OWp], block-contiguous
        Kp_t=P(None, None, axis),  # [k_p, k_p8, ncd]
        diag_kp=P(axis),  # [n_ps], block-contiguous
        # coarse corrections: local rows keep their GLOBAL aggregate ids; the
        # tiny dense inverses are replicated (their psum'd [m] input is global)
        agg_p=None if wa.agg_p is None else P(axis),
        coarse_inv=None if wa.coarse_inv is None else rep,
        agg_v=None if wa.agg_v is None else P(axis),
        coarse_inv_v=None if wa.coarse_inv_v is None else rep,
        # FGMRES deflation rows: planar vectors, device-major like r_const
        kp_modes=None if wa.kp_modes is None else P(None, axis),
    )


def shard_wa(
    wa: WindowedAssembly, dl: DistLayout, mesh: Mesh
) -> WindowedAssembly:
    """Convert r_const to the distributed layout and place every array."""
    r_dist = to_dist(np.asarray(wa.r_const), dl)
    wa = dataclasses.replace(wa, r_const=jnp.asarray(r_dist, wa.r_const.dtype))
    if wa.kp_modes is not None:
        km = np.stack([to_dist(np.asarray(row), dl) for row in wa.kp_modes])
        wa = dataclasses.replace(wa, kp_modes=jnp.asarray(km, wa.kp_modes.dtype))
    return _place(wa, wa_pspecs(wa), mesh)


def localize_rows(rows: np.ndarray, dl: DistLayout) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Global PLANAR dof rows -> per-device local rows, sentinel-padded.

    Returns (local_rows [n_dev, m] int32 with sentinel=llen for padding,
    slot_dev [n_rows], slot_idx [n_rows]) — the slot arrays place per-row
    VALUES (e.g. time-dependent Dirichlet data) into the same [n_dev, m]
    shape (localize_values).
    """
    rows = np.asarray(rows, dtype=np.int64)
    dev = np.empty(len(rows), dtype=np.int64)
    loc = np.empty(len(rows), dtype=np.int64)
    nu = dl.dim * dl.n_vs
    vel = rows < nu
    c = rows[vel] // dl.n_vs
    s = rows[vel] % dl.n_vs
    dev[vel] = s // dl.nvs_loc
    loc[vel] = c * dl.nvs_loc + s % dl.nvs_loc
    sp = rows[~vel] - nu
    dev[~vel] = sp // dl.nps_loc
    loc[~vel] = dl.dim * dl.nvs_loc + sp % dl.nps_loc

    counts = np.bincount(dev, minlength=dl.n_dev)
    m = max(int(counts.max()), 1)
    local_rows = np.full((dl.n_dev, m), dl.llen, dtype=np.int32)  # sentinel
    order = np.argsort(dev, kind="stable")
    slot_idx = np.empty(len(rows), dtype=np.int64)
    slot_idx[order] = np.arange(len(rows)) - np.concatenate(
        [[0], np.cumsum(counts[:-1])]
    )[dev[order]]
    local_rows[dev, slot_idx] = loc
    return local_rows, dev, slot_idx


def localize_values(values: np.ndarray, dev, slot_idx, n_dev: int, m: int) -> np.ndarray:
    """Per-row values -> the [n_dev, m] shape matching localize_rows."""
    out = np.zeros((n_dev, m), dtype=np.asarray(values).dtype)
    out[dev, slot_idx] = values
    return out
