"""Batched Navier-Stokes / Stokes assembly as XLA tensor contractions.

JAX replacement for the reference's hot per-cell quadrature loops
(``/root/reference/src/NavierStokesSolver.cpp:178-378`` Newton tangent,
``cpp:380-531`` Stokes).  deal.II iterates cells and accumulates 15x15
FullMatrix objects; here ALL cells are processed in one batched einsum chain
over static-shape arrays — the form XLA fuses and tiles — and the
global residual is scattered with one ``segment_sum`` (the role of
``matrix.add``/``compress``, cpp:338-347).

Reference quirks are reproduced exactly (each behind a flag, per SURVEY §7):
  * convection_form="reference": the residual's convective term is
    u^T (grad u) (deal.II `vector * Tensor<2>` contracts the FIRST index,
    cpp:297-301), while the Jacobian linearizes the STANDARD (u . grad) u
    (cpp:259-269).  "standard" uses (u . grad) u in the residual too.
  * include_continuity_residual=False: the reference never assembles the
    continuity residual -(div u, q) (no pressure-row residual terms exist in
    cpp:287-310), so pressure residual rows are identically zero.
  * jacobian_mass_rho=False: the Jacobian mass term omits rho (cpp:249-251)
    while the residual time term has it (cpp:288); identical only for rho=1.

Terms assembled into the cell Jacobian (cpp:244-285):
  mass     phi_i . phi_j / dt                        [flag: * rho]
  viscous  nu rho  grad phi_i : grad phi_j
  conv1    rho (grad u^k  phi_j) . phi_i
  conv2    rho (u^k . grad phi_j) . phi_i
  B^T      - (div phi_i) psi_j
  B        - (div phi_j) psi_i
  Mp       psi_i psi_j / nu       (separate pressure-mass operator, cpp:282)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

# a GPU f32 contraction may run in TF32 (~3 digits) unless its precision is
# pinned — fatal for residual assembly, whose small norm comes from
# cancelling O(1/dt)-scale terms.  Force full f32 precision on every
# contraction in this module.
_PREC = jax.lax.Precision.HIGHEST
import numpy as np

from ..mesh.mesh import Mesh
from .dofs import TaylorHoodDofs
from .geometry import cell_geometry, facet_geometry
from .quadrature import gauss_simplex

__all__ = ["FEMContext", "build_context", "assemble_navier_stokes", "assemble_stokes"]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class FEMContext:
    """All static per-mesh arrays consumed by the jitted assembly kernels.

    Array fields are jnp arrays (leaves); sizes/flags are static metadata.
    Cell-indexed leaves (leading axis n_cells or n_facets) are the ones
    sharded across devices for domain decomposition.
    """

    # tabulations (tiny, replicated)
    N_v: jax.Array = field(metadata=dict(pytree_node=True))  # [nb_v, nq]
    G_v: jax.Array  # [nb_v, nq, dim] reference gradients
    N_p: jax.Array  # [nb_p, nq]
    # geometry, cell-indexed
    invJT: jax.Array  # [nc, dim, dim]
    jxw: jax.Array  # [nc, nq]
    # connectivity, cell-indexed
    cell_vdofs: jax.Array  # [nc, nb_v] scalar velocity dof ids
    cell_dofs: jax.Array  # [nc, nl] full-system dof ids
    # forcing values at quadrature points (zero for the reference, hpp:414-439)
    f_q: jax.Array  # [nc, nq, dim]
    # Neumann (outlet do-nothing) facet group, cpp:314-336
    neu_cell_vdofs: jax.Array  # [nf, nb_v] scalar velocity dofs of owner cell
    neu_N_v: jax.Array  # [nf, nb_v, nqf] velocity basis at face quad pts
    neu_normal: jax.Array  # [nf, dim]
    neu_jxw: jax.Array  # [nf, nqf]
    # transpose gather maps (ops/scatter.py): scatter-free global reductions.
    # [n_total, K] / [n_u, Kv] / [n_p, Kp] positions into the flattened
    # cell-value arrays ([nc, nl] / [nc, dim*nb_v] / [nc, nb_p] layouts).
    scatter_full: jax.Array
    scatter_vel: jax.Array
    scatter_p: jax.Array
    # static metadata
    dim: int = field(metadata=dict(static=True))
    n_vs: int = field(metadata=dict(static=True))
    n_u: int = field(metadata=dict(static=True))
    n_total: int = field(metadata=dict(static=True))
    # device-mesh axis cells are sharded over (None = single device).  When
    # set, assembly reductions psum over it so the kernels run unchanged
    # inside shard_map (the reference's compress()/MPI allreduce, cpp:345-347).
    axis_name: str | None = field(default=None, metadata=dict(static=True))

    @property
    def nb_v(self) -> int:
        return self.N_v.shape[0]

    @property
    def nb_p(self) -> int:
        return self.N_p.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cell_dofs.shape[0]


def build_context(
    dofs: TaylorHoodDofs,
    neumann_tags=(),
    forcing: Callable[[np.ndarray], np.ndarray] | None = None,
    quadrature_degree: int | None = None,
    dtype=None,
) -> FEMContext:
    """Precompute geometry/tabulations on host and ship to device.

    quadrature_degree defaults to matching the reference's
    ``QGaussSimplex<dim>(fe->degree + 1)`` (cpp:47): with P2 velocity that is
    a rule exact to degree 2*(degree+1)-1 = 5.
    """
    mesh, elem = dofs.mesh, dofs.element
    dim = mesh.dim
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    deg = quadrature_degree or (2 * (elem.velocity.degree + 1) - 1)
    quad = gauss_simplex(dim, deg)
    geo = cell_geometry(mesh, quad)

    N_v, G_v = elem.velocity.tabulate(quad.points)
    N_p, _ = elem.pressure.tabulate(quad.points)

    if forcing is None:
        f_q = np.zeros((mesh.n_cells, quad.n_points, dim))
    else:
        f_q = np.asarray(forcing(geo.qpts.reshape(-1, dim))).reshape(
            mesh.n_cells, quad.n_points, dim
        )

    # Neumann facet group (possibly empty; keep 0-size arrays, static shapes)
    if len(neumann_tags):
        fids = np.nonzero(np.isin(mesh.boundary_tags, np.atleast_1d(neumann_tags)))[0]
    else:
        fids = np.zeros(0, dtype=np.int64)
    fgeo = facet_geometry(mesh, fids, deg) if len(fids) else None
    if fgeo is not None:
        nf, nqf = fgeo.jxw.shape
        vals, _ = elem.velocity.tabulate(fgeo.ref_qpts.reshape(-1, dim))
        neu_N_v = vals.reshape(elem.n_v, nf, nqf).transpose(1, 0, 2)
        neu_cell_vdofs = dofs.cell_vdofs[fgeo.cell]
        neu_normal, neu_jxw = fgeo.normal, fgeo.jxw
    else:
        nqf = 1
        neu_N_v = np.zeros((0, elem.n_v, nqf))
        neu_cell_vdofs = np.zeros((0, elem.n_v), dtype=np.int32)
        neu_normal = np.zeros((0, dim))
        neu_jxw = np.zeros((0, nqf))

    from ..ops.scatter import build_gather_map

    nvl = dim * elem.n_v
    scatter_full = build_gather_map(dofs.cell_dofs, dofs.n_total)
    scatter_vel = build_gather_map(dofs.cell_dofs[:, :nvl], dofs.n_u)
    scatter_p = build_gather_map(dofs.cell_pdofs, dofs.n_p)

    as_f = lambda a: jnp.asarray(a, dtype=dtype)
    as_i = lambda a: jnp.asarray(a, dtype=jnp.int32)
    return FEMContext(
        N_v=as_f(N_v),
        G_v=as_f(G_v),
        N_p=as_f(N_p),
        invJT=as_f(geo.invJT),
        jxw=as_f(geo.jxw),
        cell_vdofs=as_i(dofs.cell_vdofs),
        cell_dofs=as_i(dofs.cell_dofs),
        f_q=as_f(f_q),
        neu_cell_vdofs=as_i(neu_cell_vdofs),
        neu_N_v=as_f(neu_N_v),
        neu_normal=as_f(neu_normal),
        neu_jxw=as_f(neu_jxw),
        scatter_full=as_i(scatter_full),
        scatter_vel=as_i(scatter_vel),
        scatter_p=as_i(scatter_p),
        dim=dim,
        n_vs=dofs.n_vs,
        n_u=dofs.n_u,
        n_total=dofs.n_total,
    )


# ---------------------------------------------------------------------------
# field evaluation helpers (device)
# ---------------------------------------------------------------------------


def _maybe_psum(x: jax.Array, axis_name: str | None) -> jax.Array:
    return jax.lax.psum(x, axis_name) if axis_name else x


def _gather_velocity(ctx: FEMContext, x: jax.Array) -> jax.Array:
    """[nc, dim, nb_v] local velocity coefficients from the planar layout."""
    idx = ctx.cell_vdofs[:, None, :] + (
        jnp.arange(ctx.dim, dtype=jnp.int32)[None, :, None] * ctx.n_vs
    )
    return x[idx]


def _gather_pressure(ctx: FEMContext, x: jax.Array) -> jax.Array:
    return x[ctx.cell_dofs[:, -ctx.nb_p :]]  # [nc, nb_p]


def _phys_grads(ctx: FEMContext) -> jax.Array:
    """Physical velocity-basis gradients Gp [nc, nb_v, nq, dim]."""
    return jnp.einsum("cda,bqa->cbqd", ctx.invJT, ctx.G_v, precision=_PREC)


def _neumann_residual(ctx: FEMContext, p_out: float) -> jax.Array:
    """Scattered outlet traction residual contribution r_i += -p_out n.phi_i.

    Mirrors cpp:314-336 (boundary id 10) / cpp:466-490 (id 1).
    """
    # [nf, dim, nb_v]
    face_r = -p_out * jnp.einsum("fd,fbq,fq->fdb", ctx.neu_normal, ctx.neu_N_v, ctx.neu_jxw, precision=_PREC)
    gdofs = ctx.neu_cell_vdofs[:, None, :] + (
        jnp.arange(ctx.dim, dtype=jnp.int32)[None, :, None] * ctx.n_vs
    )
    return jax.ops.segment_sum(
        face_r.reshape(-1), gdofs.reshape(-1), num_segments=ctx.n_total
    )


# ---------------------------------------------------------------------------
# Newton tangent system (cpp:178-378)
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=(
        # dt is NOT static: the BDF2 scheme passes it as a traced scalar
        # (models/navier_stokes.py newton_iteration's dt_res)
        "nu",
        "rho",
        "p_out",
        "convection_form",
        "include_continuity_residual",
        "jacobian_mass_rho",
    ),
)
def assemble_navier_stokes(
    ctx: FEMContext,
    u: jax.Array,
    u_old: jax.Array,
    *,
    dt: float,
    nu: float,
    rho: float,
    p_out: float,
    convection_form: str = "reference",
    include_continuity_residual: bool = False,
    jacobian_mass_rho: bool = False,
):
    """One batched Newton-tangent assembly.

    Returns (cell_mat [nc, nl, nl], cell_pmass [nc, nb_p, nb_p],
    residual [n_total]).  Dirichlet rows are NOT yet applied (see fem/bcs.py),
    matching the reference's assemble-then-apply_boundary_values split.
    """
    dim, nb_v, nb_p = ctx.dim, ctx.nb_v, ctx.nb_p
    nl = dim * nb_v + nb_p
    W = ctx.jxw  # [nc, nq]
    Nv, Np = ctx.N_v, ctx.N_p
    Gp = _phys_grads(ctx)  # [nc, b, q, d]

    uc = _gather_velocity(ctx, u)  # [nc, dim, nb_v]
    uoc = _gather_velocity(ctx, u_old)
    pc = _gather_pressure(ctx, u)

    u_q = jnp.einsum("cdb,bq->cqd", uc, Nv, precision=_PREC)  # [nc, nq, dim]
    uo_q = jnp.einsum("cdb,bq->cqd", uoc, Nv, precision=_PREC)
    # grad u[c,q,d,a] = d u_d / d x_a
    gu_q = jnp.einsum("cdb,cbqa->cqda", uc, Gp, precision=_PREC)
    p_q = jnp.einsum("cb,bq->cq", pc, Np, precision=_PREC)

    NvW = jnp.einsum("iq,cq->ciq", Nv, W, precision=_PREC)  # test funcs pre-weighted
    # scalar mass & stiffness
    M = jnp.einsum("ciq,jq->cij", NvW, Nv, precision=_PREC)
    K = jnp.einsum("ciqa,cjqa,cq->cij", Gp, Gp, W, precision=_PREC)
    # conv1[c,a,b,i,j] = grad u_ab N_i N_j W ; conv2[c,i,j] = (u . grad N_j) N_i W
    C1 = jnp.einsum("cqab,ciq,jq->cabij", gu_q, NvW, Nv, precision=_PREC)
    adv = jnp.einsum("cqd,cjqd->cqj", u_q, Gp, precision=_PREC)
    C2 = jnp.einsum("cqj,ciq->cij", adv, NvW, precision=_PREC)
    # D[c,a,i,jp] = dN_i/dx_a P_j W   (divergence coupling)
    D = jnp.einsum("ciqa,jq,cq->caij", Gp, Np, W, precision=_PREC)
    # pressure mass
    Mp = jnp.einsum("iq,jq,cq->cij", Np, Np, W, precision=_PREC) / nu

    mass_coef = (rho if jacobian_mass_rho else 1.0) / dt
    Avv_diag = mass_coef * M + (nu * rho) * K + rho * C2  # same for each comp

    nc = W.shape[0]
    # build the [nl, nl] cell matrix with ONE concatenate per dimension
    # (block .at[].set writes would each copy the whole [nc, nl, nl] buffer)
    rows = []
    for a in range(dim):
        blocks = []
        for b in range(dim):
            blk = rho * C1[:, a, b]
            if a == b:
                blk = blk + Avv_diag
            blocks.append(blk)
        blocks.append(-D[:, a])  # B^T: -(div phi_i) psi_j
        rows.append(jnp.concatenate(blocks, axis=2))
    # pressure row: B blocks -(div phi_j) psi_i, zero pp block
    p_row = jnp.concatenate(
        [-jnp.swapaxes(D[:, a], 1, 2) for a in range(dim)]
        + [jnp.zeros((nc, nb_p, nb_p), dtype=W.dtype)],
        axis=2,
    )
    cell_mat = jnp.concatenate(rows + [p_row], axis=1)

    # ---- residual (cpp:287-311) ----
    if convection_form == "reference":
        conv = jnp.einsum("cqd,cqda->cqa", u_q, gu_q, precision=_PREC)  # u^T grad u
    elif convection_form == "standard":
        conv = jnp.einsum("cqa,cqda->cqd", u_q, gu_q, precision=_PREC)  # (u . grad) u
    else:
        raise ValueError(convection_form)

    # momentum rows: [nc, dim(a), nb_v(i)]
    r_mom = (
        -jnp.einsum("cqa,ciq->cai", rho / dt * (u_q - uo_q), NvW, precision=_PREC)
        - (nu * rho) * jnp.einsum("cqab,ciqb,cq->cai", gu_q, Gp, W, precision=_PREC)
        - rho * jnp.einsum("cqa,ciq->cai", conv, NvW, precision=_PREC)
        + jnp.einsum("cq,ciqa->cai", p_q * W, Gp, precision=_PREC)
        + jnp.einsum("cqa,ciq->cai", ctx.f_q, NvW, precision=_PREC)
    )
    if include_continuity_residual:
        div_u = jnp.einsum("cqdd->cq", gu_q, precision=_PREC)
        r_p = jnp.einsum("cq,iq,cq->ci", div_u, Np, W, precision=_PREC)
    else:
        r_p = jnp.zeros((nc, nb_p), dtype=W.dtype)

    from ..ops.scatter import gather_scatter

    cell_res = jnp.concatenate([r_mom.reshape(nc, dim * nb_v), r_p], axis=1)
    residual = gather_scatter(cell_res.reshape(-1), ctx.scatter_full, xp=jnp)
    residual = _maybe_psum(residual + _neumann_residual(ctx, p_out), ctx.axis_name)
    return cell_mat, Mp, residual


# ---------------------------------------------------------------------------
# Stokes system (cpp:380-531) — the initial-guess / steady path
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("nu", "rho", "p_out"))
def assemble_stokes(ctx: FEMContext, *, nu: float, rho: float, p_out: float):
    """Batched Stokes assembly: (cell_mat, cell_pmass, rhs [n_total])."""
    dim, nb_v, nb_p = ctx.dim, ctx.nb_v, ctx.nb_p
    nl = dim * nb_v + nb_p
    W = ctx.jxw
    Nv, Np = ctx.N_v, ctx.N_p
    Gp = _phys_grads(ctx)

    NvW = jnp.einsum("iq,cq->ciq", Nv, W, precision=_PREC)
    K = jnp.einsum("ciqa,cjqa,cq->cij", Gp, Gp, W, precision=_PREC)
    D = jnp.einsum("ciqa,jq,cq->caij", Gp, Np, W, precision=_PREC)
    Mp = jnp.einsum("iq,jq,cq->cij", Np, Np, W, precision=_PREC) / nu

    nc = W.shape[0]
    rows = []
    for a in range(dim):
        blocks = []
        for b in range(dim):
            blocks.append(
                (nu * rho) * K if a == b else jnp.zeros((nc, nb_v, nb_v), dtype=W.dtype)
            )
        blocks.append(-D[:, a])
        rows.append(jnp.concatenate(blocks, axis=2))
    p_row = jnp.concatenate(
        [-jnp.swapaxes(D[:, a], 1, 2) for a in range(dim)]
        + [jnp.zeros((nc, nb_p, nb_p), dtype=W.dtype)],
        axis=2,
    )
    cell_mat = jnp.concatenate(rows + [p_row], axis=1)

    from ..ops.scatter import gather_scatter

    r_mom = jnp.einsum("cqa,ciq->cai", ctx.f_q, NvW, precision=_PREC)
    cell_rhs = jnp.concatenate(
        [r_mom.reshape(nc, dim * nb_v), jnp.zeros((nc, nb_p), dtype=W.dtype)], axis=1
    )
    rhs = gather_scatter(cell_rhs.reshape(-1), ctx.scatter_full, xp=jnp)
    rhs = _maybe_psum(rhs + _neumann_residual(ctx, p_out), ctx.axis_name)
    return cell_mat, Mp, rhs
