"""SPMD domain decomposition over a JAX device mesh.

JAX replacement for the reference's MPI domain decomposition
(``GridTools::partition_triangulation`` + ``parallel::fullydistributed::
Triangulation``, ``/root/reference/src/NavierStokesSolver.cpp:18-21``, and the
Epetra ghost exchange hidden in ``compress()``/SpMV, SURVEY §2 parallelism
table).  Design (round 1):

  * cells are SPACE-FILLING-CURVE ordered (Morton) and split into equal
    contiguous blocks per device — the role of METIS partitioning, but with
    static shapes: blocks are padded with zero-measure ghost cells whose
    contributions vanish identically (jxw = 0).
  * solution/residual vectors are REPLICATED; each device assembles its cell
    block and one ``psum`` over the mesh axis plays the role of
    ``compress(add)`` + ghost updates.  Krylov dot products need no
    collective at all (vectors replicated).  This replicated path remains as
    the robust fallback for the FLAT matvec; the production SPMD design is
    the owned-range + ``ppermute`` halo exchange in
    ``parallel/windowed_spmd.py`` + ``ops/windowed.py`` (O(halo) per-matvec
    collectives, Epetra-ghost-exchange equivalent).
  * the SAME assembly/matvec kernels run single-device or inside shard_map:
    they psum iff ``ctx.axis_name`` is set.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..fem.assembly import FEMContext

from jax import shard_map as _shard_map


def shard_map(f, mesh, in_specs, out_specs):
    return _shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                      check_vma=False)


__all__ = ["device_mesh", "morton_order", "pad_and_shard_context", "context_pspecs", "shard_map"]

AXIS = "cells"


def device_mesh(n_devices: int | None = None, axis: str = AXIS) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, only {len(devs)} available")
    return Mesh(np.array(devs[:n]), (axis,))


def morton_order(centroids: np.ndarray, bits: int = 16) -> np.ndarray:
    """Space-filling-curve cell ordering for partition locality."""
    x = centroids - centroids.min(axis=0)
    span = x.max(axis=0)
    span[span == 0] = 1.0
    q = np.minimum((x / span * (2**bits - 1)).astype(np.uint64), 2**bits - 1)
    dim = centroids.shape[1]
    key = np.zeros(len(centroids), dtype=np.uint64)
    for b in range(bits):
        for d in range(dim):
            key |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(b * dim + d)
    return np.argsort(key, kind="stable")


def _pad_rows(a: np.ndarray, n_target: int, fill=0):
    if a.shape[0] == n_target:
        return a
    pad = np.full((n_target - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def pad_and_shard_context(
    ctx: FEMContext, mesh: Mesh, cell_order: np.ndarray | None = None, axis: str = AXIS
) -> FEMContext:
    """Reorder, pad, annotate, and device_put a FEMContext for shard_map.

    Padded cells/facets have jxw == 0 so every assembled contribution from
    them vanishes; their dof indices point at dof 0 (harmless zero adds).
    """
    n_dev = mesh.shape[axis]
    nc = ctx.cell_dofs.shape[0]
    nc_pad = -(-nc // n_dev) * n_dev
    order = np.arange(nc) if cell_order is None else cell_order

    def reorder_pad(x, fill=0):
        a = np.asarray(x)[order]
        return _pad_rows(a, nc_pad, fill)

    invJT = reorder_pad(ctx.invJT)
    # keep padded inverse Jacobians finite (identity) to avoid spurious NaNs
    if nc_pad > nc:
        invJT[nc:] = np.eye(ctx.dim)

    nf = ctx.neu_cell_vdofs.shape[0]
    nf_pad = -(-max(nf, 1) // n_dev) * n_dev

    # per-shard transpose gather maps (each shard reduces its LOCAL cells
    # into a full-length vector, then one psum) — stacked on the cell axis so
    # shard_map hands each device its own [n, K] map
    from ..ops.scatter import build_gather_map

    cd_pad = reorder_pad(ctx.cell_dofs)
    per = nc_pad // n_dev
    nb_v = int(ctx.N_v.shape[0])
    nb_p = int(ctx.N_p.shape[0])
    nvl = ctx.dim * nb_v
    n_p = ctx.n_total - ctx.n_u

    def shard_maps(extract, n_rows, src_cols):
        maps = [
            build_gather_map(extract(cd_pad[s * per : (s + 1) * per]), n_rows)
            for s in range(n_dev)
        ]
        K = max(m.shape[1] for m in maps)
        sentinel = per * src_cols
        padded = [
            np.pad(m, ((0, 0), (0, K - m.shape[1])), constant_values=sentinel)
            for m in maps
        ]
        return np.concatenate(padded, axis=0).astype(np.int32)

    scatter_full = shard_maps(lambda c: c, ctx.n_total, cd_pad.shape[1])
    scatter_vel = shard_maps(lambda c: c[:, :nvl], ctx.n_u, nvl)
    scatter_p = shard_maps(
        lambda c: np.maximum(c[:, -nb_p:] - ctx.n_u, 0), n_p, nb_p
    )

    new = dataclasses.replace(
        ctx,
        invJT=jnp.asarray(invJT),
        jxw=jnp.asarray(reorder_pad(ctx.jxw)),
        cell_vdofs=jnp.asarray(reorder_pad(ctx.cell_vdofs)),
        cell_dofs=jnp.asarray(reorder_pad(ctx.cell_dofs)),
        f_q=jnp.asarray(reorder_pad(ctx.f_q)),
        neu_cell_vdofs=jnp.asarray(_pad_rows(np.asarray(ctx.neu_cell_vdofs), nf_pad)),
        neu_N_v=jnp.asarray(_pad_rows(np.asarray(ctx.neu_N_v), nf_pad)),
        neu_normal=jnp.asarray(_pad_rows(np.asarray(ctx.neu_normal), nf_pad)),
        neu_jxw=jnp.asarray(_pad_rows(np.asarray(ctx.neu_jxw), nf_pad)),
        scatter_full=jnp.asarray(scatter_full),
        scatter_vel=jnp.asarray(scatter_vel),
        scatter_p=jnp.asarray(scatter_p),
        axis_name=axis,
    )
    # place: cell/facet arrays sharded on axis 0, tabulations replicated
    specs = context_pspecs(new, axis)
    leaves, treedef = jax.tree_util.tree_flatten(new)
    spec_leaves = jax.tree_util.tree_flatten(specs)[0]
    placed = [
        jax.device_put(leaf, NamedSharding(mesh, spec))
        for leaf, spec in zip(leaves, spec_leaves)
    ]
    return jax.tree_util.tree_unflatten(treedef, placed)


def context_pspecs(ctx: FEMContext, axis: str = AXIS) -> FEMContext:
    """A FEMContext whose leaves are PartitionSpecs (shard_map in_specs)."""
    sh = P(axis)
    rep = P()
    return dataclasses.replace(
        ctx,
        N_v=rep,
        G_v=rep,
        N_p=rep,
        invJT=sh,
        jxw=sh,
        cell_vdofs=sh,
        cell_dofs=sh,
        f_q=sh,
        neu_cell_vdofs=sh,
        neu_N_v=sh,
        neu_normal=sh,
        neu_jxw=sh,
        scatter_full=sh,
        scatter_vel=sh,
        scatter_p=sh,
    )
