"""Windowed (SFC-blocked) matvec: layout construction and the windowed
gather/contract/scatter must agree with the flat operator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navier_stokes_tpu.fem.assembly import assemble_navier_stokes, build_context
from navier_stokes_tpu.fem.dofs import make_dofs, renumber_blocked, renumber_sfc
from navier_stokes_tpu.la import operators as ops
from navier_stokes_tpu.mesh.generate import unit_square
from navier_stokes_tpu.ops.windowed import (
    build_windowed_layout,
    to_block_form,
    windowed_gather,
    windowed_matvec,
    windowed_scatter,
)
from navier_stokes_tpu.parallel.spmd import morton_order


@pytest.fixture(scope="module")
def setup():
    mesh = unit_square(6)
    dofs, block_info = renumber_blocked(make_dofs(mesh), cells_per_block=16)
    ctx = build_context(dofs, neumann_tags=(1,))
    rng = np.random.default_rng(5)
    u = jnp.asarray(rng.standard_normal(dofs.n_total))
    u_old = jnp.asarray(rng.standard_normal(dofs.n_total))
    cell_mat, _, _ = assemble_navier_stokes(
        ctx, u, u_old, dt=0.1, nu=0.01, rho=1.0, p_out=2.0
    )
    lay = build_windowed_layout(
        dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, mesh.dim,
        block_info=block_info,
    )
    x = jnp.asarray(rng.standard_normal(dofs.n_total))
    op = ops.ElementOperator(
        cell_mat=cell_mat,
        cell_dofs=ctx.cell_dofs,
        bc_rows=jnp.zeros((0,), jnp.int32),
        bc_diag=jnp.zeros((0,)),
        scatter_idx=None,
        n=dofs.n_total,
    )
    y_flat = np.asarray(ops.matvec(op, x))
    A_t = to_block_form(lay, cell_mat)
    return dofs, lay, cell_mat, A_t, x, y_flat


def test_layout_covers_every_contribution(setup):
    dofs, lay, cell_mat, A_t, x, y_flat = setup
    # every cell appears in exactly one block; padding is modest
    ids = np.asarray(lay.cell_ids)
    valid = lay.valid_slots()
    assert (np.asarray(lay.loc_v)[:, valid] < lay.Wv).all()
    assert (np.asarray(lay.loc_v)[:, ~valid] == lay.Wv).all()  # sentinel
    assert sorted(ids[valid].tolist()) == list(range(dofs.mesh.n_cells))
    # Bmax is the per-block cell count rounded up to a multiple of Bc:
    # padding beyond that rounding would mean misassigned home blocks
    per_block = valid.sum(axis=1).max()
    assert lay.Bmax - lay.Bc < per_block <= lay.Bmax


def test_reference_matches_flat(setup):
    dofs, lay, cell_mat, A_t, x, y_flat = setup
    y_win = np.asarray(windowed_matvec(lay, A_t, x))
    np.testing.assert_allclose(y_win, y_flat, rtol=1e-10, atol=1e-10)


def test_gather_scatter_roundtrip(setup):
    """windowed_gather must return x at every cell dof; windowed_scatter of
    per-cell rows must equal the flat segment-sum (each cell counted once)."""
    dofs, lay, cell_mat, A_t, x, y_flat = setup
    X = np.asarray(windowed_gather(lay, x))  # [nl, ncd]
    ids = np.asarray(lay.cell_ids).reshape(-1)
    valid = lay.valid_slots().reshape(-1)
    cd = np.concatenate(
        [dofs.cell_vdofs + c * dofs.n_vs for c in range(dofs.dim)]
        + [dofs.n_u + dofs.cell_pdofs],
        axis=1,
    )
    expect = np.asarray(x)[cd[ids]].T  # [nl, ncd]
    assert X.shape == (lay.nl, lay.ncd)
    np.testing.assert_allclose(X[:, valid], expect[:, valid], atol=1e-12)
    np.testing.assert_array_equal(X[:, ~valid], 0.0)  # padding gathers zero

    rng = np.random.default_rng(7)
    Rcell = rng.standard_normal((dofs.mesh.n_cells, lay.nl))
    R = np.zeros((lay.nli, lay.ncd))
    R[: lay.nl, valid] = Rcell[ids[valid]].T
    # duplicated slots carry the same rows; scatter keeps owned rows once
    y = np.asarray(windowed_scatter(lay, jnp.asarray(R)))
    y_expect = np.zeros(dofs.n_total)
    np.add.at(y_expect, cd.ravel(), Rcell.ravel())
    np.testing.assert_allclose(y, y_expect, atol=1e-10)


def test_pallas_interpret_matches_flat(setup):
    """The jitted windowed matvec agrees with the flat operator in f64 to
    rounding, and in f32 to f32 accumulation over <= 30 terms per row."""
    dofs, lay, cell_mat, A_t, x, y_flat = setup
    mv = jax.jit(windowed_matvec)
    y64 = np.asarray(mv(lay, A_t, x))
    assert y64.dtype == np.float64
    np.testing.assert_allclose(y64, y_flat, rtol=1e-12, atol=1e-12)
    y32 = np.asarray(
        mv(lay, jnp.asarray(A_t, jnp.float32), jnp.asarray(x, jnp.float32))
    )
    assert y32.dtype == np.float32
    rel = np.linalg.norm(y32 - y_flat) / np.linalg.norm(y_flat)
    assert rel < 1e-6


def _largest_intermediate(jaxpr) -> int:
    """Most elements of any value a jaxpr (or a nested one) produces."""
    m = 0
    for eqn in jaxpr.eqns:
        for v in eqn.outvars:
            m = max(m, int(np.prod(v.aval.shape)))
        for p in eqn.params.values():
            for sub in p if isinstance(p, (list, tuple)) else (p,):
                if hasattr(sub, "eqns"):
                    m = max(m, _largest_intermediate(sub))
                elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    m = max(m, _largest_intermediate(sub.jaxpr))
    return m


def test_matvec_builds_no_per_cell_window_copy(setup):
    """No value of the matvec is larger than the operator itself, and the
    compiled program's scratch stays below it: a gather that broadcast each
    block's window to every cell slot ([nb, Bmax, W] per component) would
    need several times A_t."""
    dofs, lay, cell_mat, A_t, x, y_flat = setup
    per_cell_window = lay.ncd * (lay.Wv + 1)
    assert per_cell_window > 1.5 * A_t.size  # the check can see the regression
    jaxpr = jax.make_jaxpr(windowed_matvec)(lay, A_t, x).jaxpr
    assert _largest_intermediate(jaxpr) <= A_t.size
    ma = jax.jit(windowed_matvec).lower(lay, A_t, x).compile().memory_analysis()
    assert ma.temp_size_in_bytes < A_t.nbytes


def test_solver_with_windowed_matvec():
    """Full NS solve with matvec='windowed' (CPU reference path) matches the
    flat-path solution field at matching support points."""
    from navier_stokes_tpu.config import SolverConfig
    from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
    from navier_stokes_tpu.utils.logging import RunLog

    def run(matvec):
        cfg = SolverConfig(
            inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3),
            nu=0.04, p_out=10.0, dt=0.05, T=0.1,
        )
        cfg.krylov.max_iters = 500
        cfg.krylov.matvec = matvec
        cfg.krylov.cells_per_block = 16
        s = NavierStokesSolver(unit_square(3), cfg, log=RunLog(verbose=False))
        s.solve()
        return {
            tuple(np.round(c, 10)): v
            for c, v in zip(s.dofs.v_coords, s.velocity())
            if np.any(v != 0) or True
        }, s

    f_flat, s_flat = run("flat")
    f_win, s_win = run("windowed")
    # compare only at REAL dofs (windowed layout pads with hole dofs at 0,0)
    real = {tuple(np.round(c, 10)) for c in s_flat.dofs.v_coords}
    err = max(np.max(np.abs(f_flat[k] - f_win[k])) for k in real)
    assert err < 1e-8


def test_solver_windowed_block_triangular():
    """Windowed matvec + the lumped-Schur preconditioner converges to the
    same solution as the flat path with identity preconditioning."""
    from navier_stokes_tpu.config import SolverConfig
    from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
    from navier_stokes_tpu.utils.logging import RunLog

    def run(matvec, precond):
        cfg = SolverConfig(
            inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3),
            nu=0.04, p_out=10.0, dt=0.05, T=0.1,
        )
        cfg.newton.tol = 1e-6
        cfg.krylov.rel_tol = 1e-6
        cfg.krylov.max_iters = 800
        cfg.krylov.matvec = matvec
        cfg.krylov.cells_per_block = 16
        cfg.krylov.preconditioner = precond
        s = NavierStokesSolver(unit_square(3), cfg, log=RunLog(verbose=False))
        s.solve()
        return {tuple(np.round(c, 10)): v for c, v in zip(s.dofs.v_coords, s.velocity())}, s

    f_ref, s_ref = run("flat", "identity")
    f_win, _ = run("windowed", "block_triangular")
    real = {tuple(np.round(c, 10)) for c in s_ref.dofs.v_coords}
    err = max(np.max(np.abs(f_ref[k] - f_win[k])) for k in real)
    # both converged to newton tol 1e-6 (absolute); solutions agree to the
    # solve level times a modest conditioning factor
    assert err < 1e-4


def test_renumbered_solution_equivalent():
    """Same physics under SFC renumbering: fields agree at matching coords."""
    from navier_stokes_tpu.config import SolverConfig
    from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
    from navier_stokes_tpu.utils.logging import RunLog

    cfg = SolverConfig(
        inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3),
        nu=0.04, p_out=10.0, dt=0.05, T=0.1,
    )
    cfg.krylov.max_iters = 500

    base = NavierStokesSolver(unit_square(3), cfg, log=RunLog(verbose=False))
    base.solve()

    # manual renumbered run
    ren = NavierStokesSolver(unit_square(3), cfg, log=RunLog(verbose=False))
    ren.mesh_order = None
    ren.setup()
    order = morton_order(ren.mesh.coords[ren.mesh.cells].mean(axis=1))
    ren.dofs = renumber_sfc(make_dofs(ren.mesh), order)
    from navier_stokes_tpu.fem.assembly import build_context as bc
    from navier_stokes_tpu.fem.bcs import DirichletBC, build_dirichlet

    ren.ctx = bc(ren.dofs, neumann_tags=cfg.neumann_tags, dtype=ren._dtype)
    specs = [DirichletBC(tags=tuple(cfg.inlet_tags), value=ren.inlet), DirichletBC(tags=tuple(cfg.wall_tags))]
    ren.dirichlet = build_dirichlet(ren.dofs, specs)
    ren._bc_rows = jnp.asarray(ren.dirichlet.rows, dtype=jnp.int32)
    ren.solution = jnp.zeros(ren.dofs.n_total, dtype=ren._dtype)
    ren.solution_old = ren.solution
    ren._build_kernels()
    ren.solve()

    # compare velocity fields at matched support points
    def field(s):
        return {tuple(np.round(c, 10)): v for c, v in zip(s.dofs.v_coords, s.velocity())}

    fb, fr = field(base), field(ren)
    err = max(np.max(np.abs(fb[k] - fr[k])) for k in fb)
    assert err < 1e-8


@pytest.fixture(scope="module")
def small_f32():
    """One-block layout (128 cell slots) and a random f32 operator."""
    dofs, block_info = renumber_blocked(make_dofs(unit_square(3)), cells_per_block=64)
    lay = build_windowed_layout(
        dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, 2,
        block_info=block_info,
    )
    rng = np.random.default_rng(3)
    A = jnp.asarray(rng.standard_normal((lay.nl, lay.nli, lay.ncd)), jnp.float32)
    x = jnp.asarray(rng.standard_normal(dofs.n_total), jnp.float32)
    return lay, A, x


def test_onepass_kernel_matches_plain_in_interpret_mode(small_f32, monkeypatch):
    """The one-pass Pallas kernel's addressing, gathers, contraction and
    window merge, run by the Pallas interpreter one cell per program (the
    interpreter applies an atomic add with repeated indices as one store,
    so one cell per program keeps every index of a call distinct)."""
    from jax.experimental import pallas as pl

    from navier_stokes_tpu.ops import windowed as W

    lay, A, x = small_f32
    real = pl.pallas_call

    def interpreted(*args, **kw):
        kw.pop("backend")
        kw.pop("compiler_params")
        return real(*args, interpret=True, **kw)

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    y = np.asarray(W._onepass_matvec(lay, A, x, block=1), np.float64)
    y_ref = np.asarray(W.windowed_matvec_block(lay, A, x), np.float64)
    assert np.linalg.norm(y - y_ref) <= 1e-6 * np.linalg.norm(y_ref)


def test_f32_matvec_lowers_to_plain_path_off_gpu(small_f32):
    """Off an NVIDIA GPU the f32 matvec compiles the plain path only: the
    lowered program holds no Triton kernel, and equals the plain apply."""
    from navier_stokes_tpu.ops import windowed as W

    lay, A, x = small_f32
    text = jax.jit(W.windowed_matvec).lower(lay, A, x).as_text()
    assert "triton" not in text and "onepass" not in text
    np.testing.assert_array_equal(
        np.asarray(W.windowed_matvec(lay, A, x)),
        np.asarray(W.windowed_matvec_block(lay, A, x)),
    )


def test_bf16_operator_kernel_semantics(setup):
    """bf16-stored A (KrylovConfig.operator_dtype): the matvec must compute
    in x's dtype with A widened on read — i.e. match the flat f64 operator
    on the bf16-rounded matrices to f32 accuracy, and the exact operator to
    the bf16 rounding level."""
    dofs, lay, cell_mat, A_t, x, y_flat = setup
    A16 = jnp.asarray(A_t, jnp.bfloat16)
    x32 = jnp.asarray(x, jnp.float32)
    y = windowed_matvec(lay, A16, x32)
    assert y.dtype == jnp.float32  # compute dtype follows x, not A
    ctx = build_context(dofs, neumann_tags=(1,))
    op16 = ops.ElementOperator(
        cell_mat=jnp.asarray(cell_mat, jnp.bfloat16).astype(jnp.float64),
        cell_dofs=ctx.cell_dofs,
        bc_rows=jnp.zeros((0,), jnp.int32),
        bc_diag=jnp.zeros((0,)),
        scatter_idx=None,
        n=dofs.n_total,
    )
    y_ref16 = np.asarray(ops.matvec(op16, jnp.asarray(x32, jnp.float64)))
    scale = np.max(np.abs(y_flat))
    np.testing.assert_allclose(
        np.asarray(y), y_ref16, rtol=0, atol=1e-5 * scale
    )
    # vs the exact f32 operator: bf16 storage rounding only (~3e-3 relative)
    np.testing.assert_allclose(np.asarray(y), y_flat, rtol=0, atol=2e-2 * scale)


def test_operator_dtype_auto_solver():
    """operator_dtype='auto' engages bf16 A_t storage on the f32 path at the
    reference-parity rel_tol (1e-2) and leaves the Newton limit unchanged:
    the residual stays f32-exact, so both runs converge to the same root
    within the Newton tolerance."""
    from navier_stokes_tpu.config import SolverConfig
    from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
    from navier_stokes_tpu.utils.logging import RunLog

    def run(operator_dtype):
        cfg = SolverConfig(
            inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3),
            nu=0.04, p_out=10.0, dt=0.05, T=0.1,
        )
        cfg.dtype = "float32"
        cfg.newton.tol = 1e-5
        cfg.krylov.max_iters = 500
        cfg.krylov.matvec = "windowed"
        cfg.krylov.cells_per_block = 16
        cfg.krylov.operator_dtype = operator_dtype
        log = RunLog(verbose=False)
        s = NavierStokesSolver(unit_square(3), cfg, log=log)
        s.solve()
        final_res = [r["residual"] for r in log.records if r.get("event") == "newton"][-1]
        assert final_res < cfg.newton.tol
        return s

    s32 = run("float32")
    s16 = run("auto")  # f32 run at rel_tol 1e-2 -> bfloat16 engaged
    d = np.max(np.abs(np.asarray(s32.solution) - np.asarray(s16.solution)))
    scale = np.max(np.abs(np.asarray(s32.solution)))
    # both roots satisfy |r| < 1e-5; the solutions differ by the Newton
    # tolerance amplified by local conditioning, far below the bf16 level
    # that a perturbed LIMIT would show
    assert d < 1e-3 * scale
