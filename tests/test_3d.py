"""3D (tetrahedral P2/P1) solver path: assembly cross-checked in test_assembly;
here the full solvers, windowed layout, and the shipped 3D meshes."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from navier_stokes_tpu.config import SolverConfig
from navier_stokes_tpu.fem.assembly import assemble_navier_stokes, build_context
from navier_stokes_tpu.fem.dofs import make_dofs, renumber_blocked
from navier_stokes_tpu.la import operators as ops
from navier_stokes_tpu.mesh.generate import box
from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
from navier_stokes_tpu.models.stokes import StokesSolver
from navier_stokes_tpu.ops.windowed import (
    build_windowed_layout,
    to_block_form,
    windowed_matvec,
)
from navier_stokes_tpu.utils.logging import RunLog

NU, RHO, POUT = 0.1, 1.0, 5.0


def box_cfg(**kw):
    cfg = SolverConfig(
        inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3, 4, 5),
        nu=NU, rho=RHO, p_out=POUT, dt=0.1, T=0.2,
    )
    for k, v in kw.items():
        setattr(cfg, k, v)
    cfg.krylov.max_iters = 2000
    return cfg


def test_stokes_poiseuille_3d():
    """3D channel: u = (y(1-y)z(1-z)*c, 0, 0) is NOT exact for P2 (degree 4),
    so use the hydrostatic state instead: zero inlet + p_out -> u=0, p=p_out."""
    cfg = box_cfg()
    cfg.krylov.preconditioner = "block_triangular"
    s = StokesSolver(box(2, 2, 2), cfg, log=RunLog(verbose=False))
    s.solve()
    assert np.max(np.abs(s.velocity())) < 1e-4
    assert np.allclose(s.pressure(), POUT, atol=1e-3)


def test_unsteady_ns_3d():
    cfg = box_cfg()
    solver = NavierStokesSolver(box(2, 2, 2), cfg, log=RunLog(verbose=False))
    sol = solver.solve()
    s = np.asarray(sol)
    assert np.all(np.isfinite(s))
    u = solver.velocity()
    bd = solver.dofs.boundary_scalar_vdofs([0, 2, 3, 4, 5])
    assert np.max(np.abs(u[bd])) < 1e-8
    # with the reference's omitted continuity residual and loose tolerances
    # (newton 1e-2 abs / gmres 1e-2 rel), pressure is only determined to O(1)
    # near-null accuracy — same behavior as the as-shipped deal.II run
    assert np.abs(np.mean(solver.pressure()) - POUT) < 1.0


def test_windowed_matvec_3d():
    mesh = box(2, 2, 2)
    dofs, bi = renumber_blocked(make_dofs(mesh), cells_per_block=16)
    ctx = build_context(dofs, neumann_tags=(1,))
    lay = build_windowed_layout(
        dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, 3, block_info=bi
    )
    rng = np.random.default_rng(2)
    u = jnp.asarray(rng.standard_normal(dofs.n_total))
    cell_mat, _, _ = assemble_navier_stokes(
        ctx, u, u, dt=0.1, nu=NU, rho=RHO, p_out=POUT
    )
    x = jnp.asarray(rng.standard_normal(dofs.n_total))
    op = ops.ElementOperator(
        cell_mat=cell_mat, cell_dofs=ctx.cell_dofs,
        bc_rows=jnp.zeros((0,), jnp.int32), bc_diag=jnp.zeros((0,)),
        scatter_idx=None, n=dofs.n_total,
    )
    y_flat = np.asarray(ops.matvec(op, x))
    y_win = np.asarray(windowed_matvec(lay, to_block_form(lay, cell_mat), x))
    np.testing.assert_allclose(y_win, y_flat, rtol=1e-10, atol=1e-10)


def test_backward_step_mesh_solve(ref_mesh_dir):
    """One implicit-Euler step on the shipped 3D backward-step mesh
    (mesh-step-3.msh; BASELINE.md's multi-chip scaling config family).
    Tags in that mesh: boundary tag 0 everywhere -> treat all as walls with a
    Neumann-free, pure initial-transient solve."""
    import navier_stokes_tpu.mesh.msh_io as mio

    mesh = mio.read_msh(os.path.join(ref_mesh_dir, "mesh-step-3.msh"))
    assert mesh.dim == 3
    tags = list(mesh.tags)
    cfg = SolverConfig(
        inlet_tags=(tags[0],), neumann_tags=tuple(tags[1:2]), wall_tags=tuple(tags[2:]),
        nu=NU, rho=RHO, p_out=POUT, dt=0.1, T=0.1,
    )
    cfg.krylov.max_iters = 3000
    solver = NavierStokesSolver(mesh, cfg, log=RunLog(verbose=False))
    sol = solver.solve()
    assert np.all(np.isfinite(np.asarray(sol)))


def test_cahouet_chabard_3d_windowed():
    """CC preconditioner through the windowed path in 3D (Kp assembly +
    outflow pinning are dim-generic); solution matches the flat/identity run."""
    cfg = box_cfg()
    cfg.include_continuity_residual = True
    cfg.newton.tol = 1e-8
    cfg.krylov.rel_tol = 1e-5
    cfg.krylov.matvec = "windowed"
    cfg.krylov.cells_per_block = 16
    cfg.krylov.preconditioner = "cahouet_chabard"
    s1 = NavierStokesSolver(box(2, 2, 2), cfg, log=RunLog(verbose=False))
    s1.solve()
    cfg2 = box_cfg()
    cfg2.include_continuity_residual = True
    cfg2.newton.tol = 1e-8
    cfg2.krylov.rel_tol = 1e-5
    s2 = NavierStokesSolver(box(2, 2, 2), cfg2, log=RunLog(verbose=False))
    s2.solve()
    v1 = {tuple(np.round(c, 10)): v for c, v in
          zip(s1.velocity_coords(real_only=True), s1.velocity(real_only=True))}
    v2 = {tuple(np.round(c, 10)): v for c, v in
          zip(s2.velocity_coords(real_only=True), s2.velocity(real_only=True))}
    err = max(np.max(np.abs(v1[k] - v2[k])) for k in v1)
    assert err < 1e-5, err


def test_p3_tet_dof_map_cubic_exact():
    """P3 tets: nodal interpolation of a global cubic is reproduced exactly
    at interior quadrature points — validates the 20-node tabulation, the
    canonical edge-dof orientation across cells, and the face-bubble map."""
    from navier_stokes_tpu.fem.dofs import scalar_dof_map
    from navier_stokes_tpu.fem.quadrature import gauss_simplex
    from navier_stokes_tpu.fem.reference_element import p_element

    mesh = box(2, 3, 2)
    n, cd, coords = scalar_dof_map(mesh, 3)
    assert n == mesh.n_nodes + 2 * mesh.n_edges + mesh.n_faces
    assert cd.shape == (mesh.n_cells, 20)

    def f(p):
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        return x**3 - 2 * y**3 + 0.5 * z**3 + x * y * z + x**2 * z - y

    el = p_element(3, 3)
    q = gauss_simplex(3, 4)
    N, _ = el.tabulate(q.points)  # [20, nq]
    lam = np.concatenate([(1 - q.points.sum(1))[:, None], q.points], axis=1)
    xq = np.einsum("qv,cvd->cqd", lam, mesh.coords[mesh.cells])
    u_h = np.einsum("cb,bq->cq", f(coords)[cd], N)
    np.testing.assert_allclose(u_h, f(xq), rtol=0, atol=1e-11)


def test_p3_tet_boundary_dofs_geometric():
    """boundary_scalar_vdofs(P3, 3D) == every dof whose support point lies on
    the box boundary (vertices + 2 edge nodes + the facet face bubble)."""
    from navier_stokes_tpu.fem.dofs import make_dofs

    mesh = box(2, 2, 3)
    dofs = make_dofs(mesh, degree_velocity=3, degree_pressure=2)
    got = np.sort(dofs.boundary_scalar_vdofs(tuple(mesh.tags)))
    c = dofs.v_coords
    on_b = np.nonzero(
        (np.abs(c) < 1e-12).any(axis=1) | (np.abs(c - 1.0) < 1e-12).any(axis=1)
    )[0]
    np.testing.assert_array_equal(got, np.sort(on_b))


def test_stokes_p3_p2_3d_cubic_exact():
    """P3/P2 Taylor-Hood on tets solves a divergence-free CUBIC manufactured
    Stokes solution to solver precision (the space contains it exactly)."""
    NU = 0.7

    def u_ex(p):
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        return np.stack([y**3 + z**2, z**3 + x**2, x**3 + y**2], axis=-1)

    def forcing(p):
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        return np.stack(
            [-NU * (6 * y + 2) + 2 * x,
             -NU * (6 * z + 2) + 2 * y,
             -NU * (6 * x + 2) + 2 * z], axis=1
        )

    cfg = SolverConfig(
        inlet_tags=(0, 1, 2, 3, 4, 5), neumann_tags=(), wall_tags=(),
        nu=NU, rho=1.0, p_out=0.0,
    )
    cfg.degree_velocity = 3
    cfg.degree_pressure = 2
    cfg.quadrature_degree = 6
    cfg.krylov.preconditioner = "block_triangular"
    cfg.krylov.stokes_rel_tol = 1e-11
    cfg.krylov.inner_tol = 1e-4
    cfg.krylov.max_iters = 8000
    s = StokesSolver(
        box(2, 2, 2), cfg, log=RunLog(verbose=False),
        forcing=forcing, inlet=lambda x, t=0.0: u_ex(x),
    )
    s.solve()
    sol = np.asarray(s.solution, dtype=np.float64)
    ue = u_ex(s.dofs.v_coords)  # exact at every P3 support point
    err = max(
        float(np.max(np.abs(sol[c * s.dofs.n_vs:(c + 1) * s.dofs.n_vs] - ue[:, c])))
        for c in range(3)
    )
    assert err < 1e-6, err
    # pressure: quadratic, exact in P2 up to its free constant
    pe = np.sum(s.dofs.p_coords**2, axis=1)
    ph = sol[s.dofs.n_u:]
    dp = ph - pe
    assert float(np.max(np.abs(dp - dp.mean()))) < 1e-5
