"""Block preconditioners for the [A B^T; B 0] saddle-point system.

JAX replacements for the reference's preconditioner classes
(``/root/reference/src/NavierStokesSolver.hpp:504-639``):

  * identity           <-> PreconditionIdentity (hpp:504-517)
  * block_diagonal     <-> PreconditionBlockDiagonal (hpp:520-572): inner
                           GMRES on A00 and on the pressure mass Mp, absolute
                           tol 1e-2*||src_block||, <=1000 iterations each.
  * block_triangular   <-> PreconditionBlockTriangular (hpp:575-639): inner CG
                           on A00, then tmp = src_p - B dst_u, inner CG on Mp
                           (tol 1e-2*||src_block||, <=2000 its).

The one deliberate substitution: the reference wraps each inner solve in
Trilinos ILU(0).  Sequential triangular solves have no efficient data-parallel mapping
(SURVEY §7 "hard parts" #2), so inner solves are JACOBI-preconditioned — the
diagonal is assembled from element matrices in one segment_sum.  Inner
iteration counts are bounded by the same limits as the reference; the outer
FGMRES is flexible, so a weaker inner preconditioner affects cost only, not
correctness.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from .cg import cg
from .gmres import fgmres
from .operators import ElementOperator, diagonal, matvec

__all__ = [
    "identity",
    "jacobi",
    "coarse_correction",
    "two_level_vcycle",
    "block_diagonal",
    "block_triangular",
    "rect_matvec",
]

_PREC_HI = jax.lax.Precision.HIGHEST


def identity() -> Callable:
    return lambda v: v


def jacobi(diag: jax.Array) -> Callable:
    """Pointwise inverse-diagonal (safe at zeros)."""
    inv = jnp.where(diag != 0, 1.0 / jnp.where(diag != 0, diag, 1.0), 1.0)
    return lambda v: inv * v


def coarse_correction(
    agg: jax.Array,
    coarse_inv: jax.Array,
    agg_size: int,
    ncomp: int = 1,
    axis_name: str | None = None,
) -> Callable:
    """Two-level aggregation correction ``r -> Z Kc^-1 Zt r``.

    The SPD additive coarse term of the Cahouet-Chabard / A00 inner sweeps
    (M^-1 = D^-1 + Z Kc^-1 Zt); shared by the production preconditioner
    (models/navier_stokes.py) and the stage profiler so the two can never
    desynchronize (ADVICE r2).

    agg:        [n_s] int32 GLOBAL aggregate id per local scalar dof
                (sentinel ``m`` marks padding holes, dropped).
    coarse_inv: [m, m] dense inverse of the coarse Galerkin matrix
                (fem/windowed_assembly two-level construction).
    agg_size:   contiguous run length; aggregates are runs of this many
                consecutive scalar dofs, so restriction/prolongation are a
                dense reshape-sum / broadcast instead of a ``segment_sum``
                scatter.  0 selects the general segment-sum path.
    ncomp:      vector components sharing ONE scalar coarse space; the input
                is component-major [ncomp * n_s] and the correction applies
                per component (the constant velocity block is
                component-diagonal, so Kc is shared).
    axis_name:  inside shard_map: agg/r are the device's local chunks, the
                [ncomp, m] coarse residual is one tiny psum, coarse_inv is
                replicated.  The reshape path additionally requires each
                device's range to be WHOLE aggregates (n_s % agg_size == 0,
                guaranteed when agg_size divides the layout's OW).
    """
    m_c = coarse_inv.shape[0]
    n_s = agg.shape[0]
    hole = agg >= m_c  # [n_s]

    def _solve(seg):  # [ncomp, m] coarse residual -> [ncomp, m] correction
        return jnp.einsum("mk,ck->cm", coarse_inv, seg, precision=_PREC_HI)

    if agg_size and axis_name is None:
        sa = int(agg_size)
        mm = -(-n_s // sa)
        npad = mm * sa - n_s

        def coarse(r):
            r2 = r.reshape(ncomp, n_s)
            rm = jnp.where(hole, 0.0, r2).astype(coarse_inv.dtype)
            seg = jnp.pad(rm, ((0, 0), (0, npad))).reshape(ncomp, mm, sa).sum(-1)
            y = _solve(seg)
            corr = jnp.broadcast_to(y[:, :, None], (ncomp, mm, sa)).reshape(
                ncomp, -1
            )[:, :n_s]
            return jnp.where(hole, 0.0, corr).astype(r.dtype).reshape(-1)

        return coarse

    if agg_size and axis_name is not None and n_s % int(agg_size) == 0:
        sa = int(agg_size)
        m_loc = n_s // sa

        def coarse(r):
            r2 = r.reshape(ncomp, n_s)
            rm = jnp.where(hole, 0.0, r2).astype(coarse_inv.dtype)
            seg_loc = rm.reshape(ncomp, m_loc, sa).sum(-1)
            d = jax.lax.axis_index(axis_name)
            s = jax.lax.dynamic_update_slice(
                jnp.zeros((ncomp, m_c), seg_loc.dtype), seg_loc, (d * 0, d * m_loc)
            )
            s = jax.lax.psum(s, axis_name)
            y_loc = jax.lax.dynamic_slice(
                _solve(s), (d * 0, d * m_loc), (ncomp, m_loc)
            )
            corr = jnp.broadcast_to(
                y_loc[:, :, None], (ncomp, m_loc, sa)
            ).reshape(ncomp, -1)
            return jnp.where(hole, 0.0, corr).astype(r.dtype).reshape(-1)

        return coarse

    def coarse(r):  # general path (irregular aggregates / non-aligned shards)
        r2 = r.reshape(ncomp, n_s)
        s = jax.vmap(
            lambda rc: jax.ops.segment_sum(
                rc.astype(coarse_inv.dtype), agg, num_segments=m_c + 1
            )[:m_c]
        )(r2)
        if axis_name is not None:
            s = jax.lax.psum(s, axis_name)
        y = _solve(s)
        y_ext = jnp.concatenate([y, jnp.zeros((ncomp, 1), y.dtype)], axis=1)
        return jnp.take_along_axis(
            y_ext, jnp.broadcast_to(agg[None, :], (ncomp, n_s)), axis=1
        ).astype(r.dtype).reshape(-1)

    return coarse


def two_level_vcycle(
    matvec: Callable,
    diag: jax.Array,
    coarse: Callable,
    omega: float = 0.7,
) -> Callable:
    """Symmetric multiplicative two-level V(1,1) cycle as a linear operator.

    Damped-Jacobi pre-smooth, coarse correction of the updated residual,
    damped-Jacobi post-smooth:

        x1 = w D^-1 r;  x2 = x1 + C (r - A x1);  x  = x2 + w D^-1 (r - A x2)

    Multiplicative composition is strictly stronger per application than the
    additive ``D^-1 + C`` (it damps the mid-range modes both terms handle
    poorly) at the cost of TWO extra ``matvec`` calls — cheap when the
    operator blocks are stored bf16 (KrylovConfig.precond_block_dtype).
    Symmetric (same smoother both sides) and SPD for SPD ``matvec`` with a
    convergent damped Jacobi (omega <= 1/lambda_max(D^-1 A); FEM mass/
    stiffness blocks have lambda_max(D^-1 A) < ~2, so the 0.7 default holds)
    and SPD ``coarse`` — a valid CG preconditioner.
    """
    inv = jnp.where(diag != 0, 1.0 / jnp.where(diag != 0, diag, 1.0), 1.0)
    w_inv = omega * inv

    def apply(r):
        x1 = w_inv * r
        x2 = x1 + coarse(r - matvec(x1))
        return x2 + w_inv * (r - matvec(x2))

    return apply


def rect_matvec(
    cell_block: jax.Array,
    in_dofs: jax.Array,
    out_dofs: jax.Array,
    n_out: int,
    x: jax.Array,
    axis_name: str | None = None,
    scatter_idx: jax.Array | None = None,
) -> jax.Array:
    """Rectangular element-form matvec (e.g. the divergence block B)."""
    from .operators import _reduce

    yl = jnp.einsum("cij,cj->ci", cell_block, x[in_dofs], precision=jax.lax.Precision.HIGHEST)
    y = _reduce(yl.reshape(-1), out_dofs, scatter_idx, n_out)
    return jax.lax.psum(y, axis_name) if axis_name else y


def block_diagonal(
    A00: ElementOperator,
    Mp: ElementOperator,
    *,
    inner_tol: float = 1e-2,
    inner_maxiter: int = 1000,
    inner_restart: int = 50,
) -> Callable:
    """diag(A00, Mp)^{-1} via inner GMRES solves (hpp:537-558)."""
    n_u = A00.n
    pA = jacobi(diagonal(A00))
    pM = jacobi(diagonal(Mp))

    def apply(v):
        vu, vp = v[:n_u], v[n_u:]
        du = fgmres(
            lambda y: matvec(A00, y),
            vu,
            atol=inner_tol * jnp.linalg.norm(vu),
            restart=inner_restart,
            maxiter=inner_maxiter,
            precond=pA,
        ).x
        dp = fgmres(
            lambda y: matvec(Mp, y),
            vp,
            atol=inner_tol * jnp.linalg.norm(vp),
            restart=inner_restart,
            maxiter=inner_maxiter,
            precond=pM,
        ).x
        return jnp.concatenate([du, dp])

    return apply


def block_triangular(
    A00: ElementOperator,
    Mp: ElementOperator,
    B_block: jax.Array,  # [nc, nb_p_loc, nvl] pressure-row/velocity-col cells
    B_in_dofs: jax.Array,  # [nc, nvl] velocity-space ids
    B_out_dofs: jax.Array,  # [nc, nb_p_loc] pressure-space ids
    *,
    inner_tol: float = 1e-2,
    inner_maxiter: int = 2000,
    B_scatter_idx: jax.Array | None = None,
) -> Callable:
    """Lower-triangular Schur sweep (hpp:594-619):
    dst_u = A00^{-1} src_u;  dst_p = Mp^{-1} (src_p - B dst_u)."""
    n_u, n_p = A00.n, Mp.n
    pA = jacobi(diagonal(A00))
    pM = jacobi(diagonal(Mp))

    def apply(v):
        vu, vp = v[:n_u], v[n_u:]
        du = cg(
            lambda y: matvec(A00, y),
            vu,
            atol=inner_tol * jnp.linalg.norm(vu),
            maxiter=inner_maxiter,
            precond=pA,
        ).x
        tmp = vp - rect_matvec(
            B_block, B_in_dofs, B_out_dofs, n_p, du,
            axis_name=A00.axis_name, scatter_idx=B_scatter_idx,
        )
        # tolerance floored relative to the ACTUAL rhs of this solve: the
        # reference's bare 1e-2*||src_p|| is unreachable when src_p = 0 (as on
        # the first Krylov vector, whose pressure block vanishes) — deal.II's
        # SolverCG would throw NoConvergence there.
        atol_p = jnp.maximum(inner_tol * jnp.linalg.norm(vp), 1e-10 * jnp.linalg.norm(tmp))
        dp = cg(
            lambda y: matvec(Mp, y),
            tmp,
            atol=atol_p,
            maxiter=inner_maxiter,
            precond=pM,
        ).x
        return jnp.concatenate([du, dp])

    return apply
