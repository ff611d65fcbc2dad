"""Matrix-free distributed linear operators built from element matrices.

JAX replacement for ``TrilinosWrappers::BlockSparseMatrix`` /
``MPI::BlockVector`` (``/root/reference/src/NavierStokesSolver.hpp:765-794``).
Instead of a global sparse matrix assembled via ``matrix.add`` + ``compress``
(cpp:338-347), the global operator stays in unassembled element form

    y = sum_cells  P_c^T  A_c  P_c x      (gather -> batched matvec -> scatter)

which is one XLA gather, one batched einsum over [nc, nl, nl],
and one ``segment_sum`` scatter.  Constrained (Dirichlet) rows are replaced by
``diag * x`` reproducing ``MatrixTools::apply_boundary_values(..., false)``
row-elimination semantics (cpp:375-376).

Block views (the reference's ``matrix.block(i, j)``, hpp:504-639) are static
slices of the element matrices, because the local DoF layout is component-
planar: velocity block = cell_mat[:, :dim*nb_v, :dim*nb_v] acting on the
velocity segment of the planar vector.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp

_PREC = jax.lax.Precision.HIGHEST  # full f32: a GPU f32 dot may run in TF32

__all__ = ["ElementOperator", "matvec", "diagonal", "velocity_block", "pressure_mass_block"]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ElementOperator:
    """Unassembled element-matrix operator on R^n with Dirichlet row fixes."""

    cell_mat: jax.Array  # [nc, nl, nl]
    cell_dofs: jax.Array  # [nc, nl] int32 global ids
    bc_rows: jax.Array  # [nbc] int32 (may be empty)
    bc_diag: jax.Array  # [nbc] replacement diagonal for constrained rows
    # transpose gather map [n, K] (ops/scatter.py) — scatter-free reduction;
    # None falls back to segment_sum
    scatter_idx: jax.Array | None
    n: int = field(metadata=dict(static=True))
    # device-mesh axis cells are sharded over (None = single device); when set
    # every scatter-reduction psums over it (the reference's SpMV ghost
    # exchange / compress, SURVEY §3.3)
    axis_name: str | None = field(default=None, metadata=dict(static=True))
    # symmetric Dirichlet elimination: also zero constrained COLUMNS, keeping
    # the operator SPD so inner CG solves are well-posed.  The outer tangent
    # operator uses False (eliminate_columns=false parity, cpp:376);
    # preconditioner blocks use True (an ILU of a nonsymmetric-row matrix
    # is equally inexact — FGMRES absorbs the difference).
    bc_symmetric: bool = field(default=False, metadata=dict(static=True))


def _maybe_psum(x: jax.Array, axis_name: str | None) -> jax.Array:
    return jax.lax.psum(x, axis_name) if axis_name else x


def _reduce(values_flat, cell_dofs, scatter_idx, n):
    if scatter_idx is not None:
        from ..ops.scatter import gather_scatter

        return gather_scatter(values_flat, scatter_idx, xp=jnp)
    return jax.ops.segment_sum(values_flat, cell_dofs.reshape(-1), num_segments=n)


def matvec(op: ElementOperator, x: jax.Array) -> jax.Array:
    """y = A x with constrained rows y_i = diag_i * x_i."""
    x_in = x
    if op.bc_symmetric and op.bc_rows.shape[0]:
        x_in = x.at[op.bc_rows].set(0.0)
    xl = x_in[op.cell_dofs]  # [nc, nl]
    yl = jnp.einsum("cij,cj->ci", op.cell_mat, xl, precision=_PREC)
    y = _reduce(yl.reshape(-1), op.cell_dofs, op.scatter_idx, op.n)
    y = _maybe_psum(y, op.axis_name)
    if op.bc_rows.shape[0]:
        y = y.at[op.bc_rows].set(op.bc_diag * x[op.bc_rows])
    return y


def diagonal(op: ElementOperator) -> jax.Array:
    """Assembled main diagonal (for Jacobi/Chebyshev preconditioning)."""
    d = raw_diagonal(op.cell_mat, op.cell_dofs, op.n, op.axis_name, op.scatter_idx)
    if op.bc_rows.shape[0]:
        d = d.at[op.bc_rows].set(op.bc_diag)
    return d


def raw_diagonal(
    cell_mat: jax.Array,
    cell_dofs: jax.Array,
    n: int,
    axis_name: str | None = None,
    scatter_idx: jax.Array | None = None,
) -> jax.Array:
    """Assembled diagonal BEFORE boundary conditions — this is the diagonal
    value deal.II's apply_boundary_values keeps on constrained rows."""
    nl = cell_mat.shape[1]
    dl = cell_mat[:, jnp.arange(nl), jnp.arange(nl)]
    d = _reduce(dl.reshape(-1), cell_dofs, scatter_idx, n)
    return _maybe_psum(d, axis_name)


def velocity_block(
    op: ElementOperator, dim: int, nb_v: int, n_u: int, bc_mask=None, scatter_idx=None
) -> ElementOperator:
    """A00 (velocity-velocity) sub-operator on the velocity segment [0, n_u).

    Constrained velocity rows keep their row-replacement semantics.  This is
    the reference's ``jacobian_matrix.block(0, 0)`` (hpp:526, 581).

    bc_mask: STATIC (host) boolean array selecting op.bc_rows < n_u; must be
    concrete because it changes array shapes.  Velocity BC rows are static
    per problem, so the mask is computed once on host; only bc_diag is traced.
    """
    nvl = dim * nb_v
    if bc_mask is None:
        import numpy as np

        bc_mask = np.asarray(op.bc_rows) < n_u  # requires concrete bc_rows
    return ElementOperator(
        cell_mat=op.cell_mat[:, :nvl, :nvl],
        cell_dofs=op.cell_dofs[:, :nvl],
        bc_rows=op.bc_rows[bc_mask],
        bc_diag=op.bc_diag[bc_mask],
        scatter_idx=scatter_idx,
        n=n_u,
        axis_name=op.axis_name,
        bc_symmetric=True,
    )


def pressure_mass_block(
    cell_pmass: jax.Array,
    cell_pdofs: jax.Array,
    n_p: int,
    axis_name: str | None = None,
    scatter_idx: jax.Array | None = None,
) -> ElementOperator:
    """Mp operator on the pressure segment (reference's pressure_mass.block(1,1),
    cpp:163, hpp:527)."""
    return ElementOperator(
        cell_mat=cell_pmass,
        cell_dofs=cell_pdofs,
        bc_rows=jnp.zeros((0,), dtype=jnp.int32),
        bc_diag=jnp.zeros((0,), dtype=cell_pmass.dtype),
        scatter_idx=scatter_idx,
        n=n_p,
        axis_name=axis_name,
    )
