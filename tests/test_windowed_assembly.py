"""Blocked (windowed) assembly must reproduce the natural batched assembly
exactly: residual vector, raw diagonal, and operator action."""

import jax.numpy as jnp
import numpy as np
import pytest

from navier_stokes_tpu.fem.assembly import assemble_navier_stokes, build_context
from navier_stokes_tpu.fem.dofs import make_dofs, renumber_blocked
from navier_stokes_tpu.fem.windowed_assembly import (
    assemble_windowed,
    build_windowed_assembly,
)
from navier_stokes_tpu.la import operators as ops
from navier_stokes_tpu.mesh.generate import unit_square
from navier_stokes_tpu.ops.windowed import (
    build_windowed_layout,
    windowed_matvec,
)

PARAMS = dict(dt=0.1, nu=0.01, rho=1.3, p_out=2.0)


@pytest.fixture(scope="module")
def setup():
    mesh = unit_square(6)
    dofs, binfo = renumber_blocked(make_dofs(mesh), cells_per_block=16)
    ctx = build_context(dofs, neumann_tags=(1,))
    lay = build_windowed_layout(
        dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, mesh.dim,
        block_info=binfo,
    )
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.standard_normal(dofs.n_total))
    u_old = jnp.asarray(rng.standard_normal(dofs.n_total))
    return mesh, dofs, ctx, lay, u, u_old


@pytest.mark.parametrize("conv", ["reference", "standard"])
@pytest.mark.parametrize("cont", [False, True])
def test_windowed_assembly_matches_natural(setup, conv, cont):
    mesh, dofs, ctx, lay, u, u_old = setup
    wa = build_windowed_assembly(ctx, lay, dofs, **PARAMS)
    A_t, r_w, d_w = assemble_windowed(
        wa, lay, u, u_old,
        dt=PARAMS["dt"], nu=PARAMS["nu"], rho=PARAMS["rho"],
        convection_form=conv, include_continuity_residual=cont,
    )
    cell_mat, _, r_n = assemble_navier_stokes(
        ctx, u, u_old, convection_form=conv, include_continuity_residual=cont,
        **PARAMS,
    )
    d_n = ops.raw_diagonal(cell_mat, ctx.cell_dofs, dofs.n_total, None, ctx.scatter_full)
    np.testing.assert_allclose(np.asarray(r_w), np.asarray(r_n), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(d_w), np.asarray(d_n), rtol=1e-10, atol=1e-12)

    # operator action identical to the flat element-form matvec
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal(dofs.n_total))
    op = ops.ElementOperator(
        cell_mat=cell_mat, cell_dofs=ctx.cell_dofs,
        bc_rows=jnp.zeros((0,), jnp.int32), bc_diag=jnp.zeros((0,)),
        scatter_idx=None, n=dofs.n_total,
    )
    y_flat = np.asarray(ops.matvec(op, x))
    y_win = np.asarray(windowed_matvec(lay, A_t, x))
    np.testing.assert_allclose(y_win, y_flat, rtol=1e-9, atol=1e-10)


def test_windowed_assembly_forcing_and_mass_rho(setup):
    """Nonzero forcing folds into r_const; jacobian_mass_rho flag matches."""
    mesh, dofs, ctx, lay, u, u_old = setup
    import dataclasses

    f_q = np.asarray(
        np.random.default_rng(4).standard_normal(ctx.f_q.shape), np.float64
    )
    ctx_f = dataclasses.replace(ctx, f_q=jnp.asarray(f_q))
    wa = build_windowed_assembly(
        ctx_f, lay, dofs, jacobian_mass_rho=True, **PARAMS
    )
    A_t, r_w, d_w = assemble_windowed(
        wa, lay, u, u_old, dt=PARAMS["dt"], nu=PARAMS["nu"], rho=PARAMS["rho"],
    )
    cell_mat, _, r_n = assemble_navier_stokes(
        ctx_f, u, u_old, jacobian_mass_rho=True, **PARAMS
    )
    d_n = ops.raw_diagonal(cell_mat, ctx.cell_dofs, dofs.n_total, None, ctx.scatter_full)
    np.testing.assert_allclose(np.asarray(r_w), np.asarray(r_n), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(d_w), np.asarray(d_n), rtol=1e-10, atol=1e-12)
