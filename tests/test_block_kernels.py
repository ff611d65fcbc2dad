"""Sub-block windowed matvecs (A00 / B / B^T / Kp), the Cahouet-Chabard
preconditioner, and the Stokes initial-guess path."""

import jax.numpy as jnp
import numpy as np
import pytest

from navier_stokes_tpu.config import SolverConfig
from navier_stokes_tpu.fem.assembly import assemble_navier_stokes, build_context
from navier_stokes_tpu.fem.dofs import make_dofs, renumber_blocked
from navier_stokes_tpu.fem.windowed_assembly import build_windowed_assembly
from navier_stokes_tpu.la import operators as ops
from navier_stokes_tpu.mesh.generate import unit_square
from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
from navier_stokes_tpu.ops.windowed import (
    build_windowed_layout,
    slice_block,
    to_block_form,
    windowed_matvec_block,
)
from navier_stokes_tpu.utils.logging import RunLog


@pytest.fixture(scope="module")
def setup():
    mesh = unit_square(6)
    dofs, bi = renumber_blocked(make_dofs(mesh), cells_per_block=16)
    ctx = build_context(dofs, neumann_tags=(1,))
    lay = build_windowed_layout(
        dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, mesh.dim,
        block_info=bi,
    )
    rng = np.random.default_rng(5)
    u = jnp.asarray(rng.standard_normal(dofs.n_total))
    cell_mat, _, _ = assemble_navier_stokes(
        ctx, u, 0.9 * u, dt=0.1, nu=0.01, rho=1.0, p_out=2.0
    )
    A_t = to_block_form(lay, cell_mat)
    x = jnp.asarray(rng.standard_normal(dofs.n_total))
    # independent oracle: the flat gather/segment-sum operator
    op = ops.ElementOperator(
        cell_mat=cell_mat,
        cell_dofs=ctx.cell_dofs,
        bc_rows=jnp.zeros((0,), jnp.int32),
        bc_diag=jnp.zeros((0,)),
        scatter_idx=None,
        n=dofs.n_total,
    )
    return dofs, ctx, lay, A_t, x, lambda v: np.asarray(ops.matvec(op, v))


@pytest.mark.parametrize(
    "ins,outs",
    [("v", "v"), ("v", "p"), ("p", "v"), ("p", "p")],
)
def test_block_matvec_matches_full_slices(setup, ins, outs):
    """Each sub-block matvec must equal the corresponding segment of the full
    matvec applied to the zero-extended input."""
    dofs, ctx, lay, A_t, x, flat = setup
    n_u = dofs.n_u
    xf = np.zeros(dofs.n_total)
    if ins == "v":
        seg = np.asarray(x)[:n_u]
        xf[:n_u] = seg
    else:
        seg = np.asarray(x)[n_u:]
        xf[n_u:] = seg
    y_ref = flat(jnp.asarray(xf))
    expect = y_ref[:n_u] if outs == "v" else y_ref[n_u:]
    A_sub = slice_block(lay, A_t, ins, outs)
    got = np.asarray(
        windowed_matvec_block(
            lay, A_sub, jnp.asarray(seg), in_spaces=ins, out_spaces=outs
        )
    )
    np.testing.assert_allclose(got, expect, rtol=1e-10, atol=1e-12)


def test_kp_is_pressure_laplacian(setup):
    """wa.Kp_t applied through the p->p block kernel equals the assembled
    P1 Laplacian (checked against a direct numpy assembly)."""
    dofs, ctx, lay, A_t, x, _ = setup
    wa = build_windowed_assembly(
        ctx, lay, dofs, dt=0.1, nu=0.01, rho=1.0, p_out=2.0
    )
    p = np.asarray(x)[dofs.n_u :]
    got = np.asarray(
        windowed_matvec_block(
            lay, wa.Kp_t, jnp.asarray(p), in_spaces="p", out_spaces="p"
        )
    )
    # direct numpy: per-cell grad psi contributions
    import numpy as _np

    from navier_stokes_tpu.fem.geometry import cell_geometry
    from navier_stokes_tpu.fem.quadrature import gauss_simplex

    quad = gauss_simplex(2, 2 * (dofs.element.velocity.degree + 1) - 1)
    geo = cell_geometry(dofs.mesh, quad)
    _, G_p = dofs.element.pressure.tabulate(quad.points)
    Gp = _np.einsum("cda,bqa->cbqd", geo.invJT, G_p)
    Kc = _np.einsum("ciqd,cjqd,cq->cij", Gp, Gp, geo.jxw)
    expect = _np.zeros(dofs.n_ps)
    pc = p[dofs.cell_pdofs]  # [nc, k_p]
    yc = _np.einsum("cij,cj->ci", Kc, pc)
    _np.add.at(expect, dofs.cell_pdofs.ravel(), yc.ravel())
    _np.testing.assert_allclose(got, expect, rtol=1e-8, atol=1e-10)
    # exact diagonal stored for the Jacobi sweeps
    diag = _np.zeros(dofs.n_ps)
    _np.add.at(diag, dofs.cell_pdofs.ravel(),
               Kc[:, range(3), range(3)].ravel())
    real = diag > 0
    _np.testing.assert_allclose(_np.asarray(wa.diag_kp)[real], diag[real], rtol=1e-8)


def test_coarse_correction_galerkin_and_speedup(setup):
    """KrylovConfig.cc_coarse_agg two-level correction: (a) coarse_inv is the
    inverse of the exact Galerkin restriction Zt Kp Z of the operator the CG
    sweep applies; (b) two-level CG needs strictly fewer iterations than
    Jacobi-CG on the pressure Laplacian (the h^-2 growth killer)."""
    import jax

    from navier_stokes_tpu.la.cg import cg
    from navier_stokes_tpu.la.preconditioners import jacobi

    dofs, ctx, lay, A_t, x, _ = setup
    wa = build_windowed_assembly(
        ctx, lay, dofs, dt=0.1, nu=0.01, rho=1.0, p_out=2.0,
        pin_pdofs=dofs.boundary_scalar_pdofs((1,)), coarse_agg=16,
    )
    assert wa.coarse_inv is not None
    m = wa.coarse_inv.shape[0]
    agg = np.asarray(wa.agg_p)

    # (a) Galerkin consistency: for each coarse basis vector z_a, the
    # restriction of Kp z_a must equal column a of inv(coarse_inv)
    def Kp_mv(p):
        return windowed_matvec_block(
            lay, wa.Kp_t, p, in_spaces="p", out_spaces="p"
        )

    Kc = np.linalg.inv(np.asarray(wa.coarse_inv, np.float64))
    live = np.unique(agg[agg < m]) if dofs.p_mask is None else np.unique(
        agg[(agg < m) & np.asarray(dofs.p_mask, bool)]
    )  # aggregates with >=1 real dof (all-hole ones carry the unit-diag guard)
    for a in live[:: max(1, len(live) // 4)]:
        z = jnp.asarray((agg == a).astype(np.float64))
        col = np.asarray(jax.ops.segment_sum(Kp_mv(z), jnp.asarray(agg), num_segments=m + 1))[:m]
        expect = Kc[:, a].copy()
        expect[np.setdiff1d(np.arange(m), live)] = 0.0  # unit-diag guard rows
        np.testing.assert_allclose(col, expect, rtol=1e-6, atol=1e-8)

    # (b) iteration-count win on a random RHS (real dofs only)
    rng = np.random.default_rng(7)
    b = rng.standard_normal(dofs.n_ps)
    if dofs.p_mask is not None:
        b *= np.asarray(dofs.p_mask, float)
    b = jnp.asarray(b)
    atol = 1e-8 * float(jnp.linalg.norm(b))
    pj = jacobi(wa.diag_kp)
    r_j = cg(Kp_mv, b, atol=atol, maxiter=500, precond=pj)

    def p2(r):
        s = jax.ops.segment_sum(
            r.astype(wa.coarse_inv.dtype), wa.agg_p, num_segments=m + 1
        )[:m]
        y = jnp.dot(wa.coarse_inv, s, precision=jax.lax.Precision.HIGHEST)
        return pj(r) + jnp.concatenate([y, jnp.zeros((1,), y.dtype)])[wa.agg_p]

    r_2 = cg(Kp_mv, b, atol=atol, maxiter=500, precond=p2)
    assert float(r_2.residual) <= atol * 1.01
    assert int(r_2.iters) < int(r_j.iters)

    # (c) the single-device reshape formulation of Z/Zt (contiguous
    # aggregate runs; the fast path in _make_windowed_preconditioner) must
    # equal the segment-sum formulation exactly
    sa = wa.coarse_agg_size
    npad = m * sa - dofs.n_ps
    hole = np.asarray(wa.agg_p) >= m
    rm = jnp.where(jnp.asarray(hole), 0.0, b).astype(wa.coarse_inv.dtype)
    seg_r = jnp.pad(rm, (0, npad)).reshape(m, sa).sum(axis=1)
    seg_s = jax.ops.segment_sum(
        b.astype(wa.coarse_inv.dtype), wa.agg_p, num_segments=m + 1
    )[:m]
    np.testing.assert_allclose(np.asarray(seg_r), np.asarray(seg_s),
                               rtol=1e-12, atol=1e-12)
    y = jnp.dot(wa.coarse_inv, seg_s, precision=jax.lax.Precision.HIGHEST)
    pro_r = jnp.where(
        jnp.asarray(hole), 0.0,
        jnp.broadcast_to(y[:, None], (m, sa)).reshape(-1)[: dofs.n_ps],
    )
    pro_s = jnp.concatenate([y, jnp.zeros((1,), y.dtype)])[wa.agg_p]
    np.testing.assert_allclose(np.asarray(pro_r), np.asarray(pro_s),
                               rtol=1e-12, atol=1e-12)


def test_two_level_vcycle_symmetric_and_stronger(setup):
    """la/preconditioners.two_level_vcycle on the pinned pressure Laplacian:
    (a) symmetric as a linear operator (x.V y == y.V x — the SPD requirement
    for use as a CG preconditioner); (b) CG with the multiplicative V(1,1)
    converges in fewer iterations than with the additive D^-1 + coarse
    composition (KrylovConfig.cc_cycle_ap="vcycle" rationale)."""
    import jax

    from navier_stokes_tpu.la.cg import cg
    from navier_stokes_tpu.la.preconditioners import (
        coarse_correction, jacobi, two_level_vcycle)

    dofs, ctx, lay, A_t, x, _ = setup
    wa = build_windowed_assembly(
        ctx, lay, dofs, dt=0.1, nu=0.01, rho=1.0, p_out=2.0,
        pin_pdofs=dofs.boundary_scalar_pdofs((1,)), coarse_agg=16,
    )

    def Kp_mv(p):
        return windowed_matvec_block(
            lay, wa.Kp_t, p, in_spaces="p", out_spaces="p"
        )

    coarse = coarse_correction(wa.agg_p, wa.coarse_inv, wa.coarse_agg_size)
    V = two_level_vcycle(Kp_mv, wa.diag_kp, coarse, omega=0.7)

    rng = np.random.default_rng(11)
    mask = (
        np.ones(dofs.n_ps) if dofs.p_mask is None
        else np.asarray(dofs.p_mask, float)
    )
    a = jnp.asarray(rng.standard_normal(dofs.n_ps) * mask)
    b = jnp.asarray(rng.standard_normal(dofs.n_ps) * mask)
    lhs = float(jnp.dot(a, V(b)))
    rhs = float(jnp.dot(b, V(a)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-11)

    rhs_v = jnp.asarray(rng.standard_normal(dofs.n_ps) * mask)
    atol = 1e-8 * float(jnp.linalg.norm(rhs_v))
    pj = jacobi(wa.diag_kp)
    r_add = cg(Kp_mv, rhs_v, atol=atol, maxiter=500,
               precond=lambda r: pj(r) + coarse(r))
    r_vc = cg(Kp_mv, rhs_v, atol=atol, maxiter=500, precond=V)
    assert float(r_vc.residual) <= atol * 1.01
    assert int(r_vc.iters) < int(r_add.iters)


def test_bf16_precond_blocks_accuracy(setup):
    """precond_block_dtype="bfloat16": a bf16-STORED A00 block applied through
    the block matvec stays within bf16 rounding (~1e-2 rel) of the f32 block
    (the entries are widened on read; only the storage rounds)."""
    dofs, ctx, lay, A_t, x, _ = setup
    A32 = slice_block(lay, A_t, "v", "v").astype(jnp.float32)
    Abf = A32.astype(jnp.bfloat16)
    xv = jnp.asarray(np.asarray(x)[: dofs.n_u], jnp.float32)
    y32 = np.asarray(
        windowed_matvec_block(lay, A32, xv, in_spaces="v", out_spaces="v")
    )
    ybf = np.asarray(
        windowed_matvec_block(lay, Abf, xv, in_spaces="v", out_spaces="v")
    )
    assert ybf.dtype == np.float32  # compute dtype follows x, not A
    scale = np.abs(y32).max()
    assert np.abs(ybf - y32).max() < 2e-2 * scale


def _solve(precond, initial_guess="zero", n_devices=None, cycle=None):
    cfg = SolverConfig(
        inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3),
        nu=0.04, p_out=10.0, dt=0.05, T=0.1,
    )
    # corrected physics + tight tolerances so different preconditioners reach
    # the SAME solution: with the reference's omitted continuity residual the
    # pressure residual rows are identically zero, so roots form a MANIFOLD
    # and every solver lands on its own point (SURVEY C13 quirk)
    cfg.include_continuity_residual = True
    cfg.newton.tol = 1e-8
    cfg.krylov.rel_tol = 1e-4
    cfg.krylov.max_iters = 800
    cfg.krylov.matvec = "windowed"
    cfg.krylov.cells_per_block = 16
    cfg.krylov.preconditioner = precond
    if cycle is not None:
        # exercise the multiplicative V(1,1) inner-sweep composition with a
        # coarse space small enough for the tiny mesh
        cfg.krylov.cc_cycle_a00 = cycle
        cfg.krylov.cc_cycle_ap = cycle
        cfg.krylov.cc_coarse_agg = 16
        cfg.krylov.cc_coarse_agg_v = 16
    cfg.initial_guess = initial_guess
    s = NavierStokesSolver(
        unit_square(3), cfg, log=RunLog(verbose=False), n_devices=n_devices
    )
    s.solve()
    return s


def test_cahouet_chabard_converges_to_same_solution():
    s_id = _solve("identity")
    s_cc = _solve("cahouet_chabard")
    v1 = {tuple(np.round(c, 10)): v
          for c, v in zip(s_id.velocity_coords(real_only=True), s_id.velocity(real_only=True))}
    v2 = {tuple(np.round(c, 10)): v
          for c, v in zip(s_cc.velocity_coords(real_only=True), s_cc.velocity(real_only=True))}
    err = max(np.max(np.abs(v1[k] - v2[k])) for k in v1)
    assert err < 1e-4  # both Newton-converged to tol 1e-2 (absolute)


def test_cahouet_chabard_vcycle_solve():
    """cc_cycle_a00/ap = "vcycle" converges to the same solution as the
    additive composition (the preconditioner choice must not move the root),
    single-device AND under windowed SPMD."""
    s_add = _solve("cahouet_chabard")
    s_vc = _solve("cahouet_chabard", cycle="vcycle")
    s_vc2 = _solve("cahouet_chabard", cycle="vcycle", n_devices=2)
    ref = {tuple(np.round(c, 10)): v
           for c, v in zip(s_add.velocity_coords(real_only=True),
                           s_add.velocity(real_only=True))}
    for s in (s_vc, s_vc2):
        got = {tuple(np.round(c, 10)): v
               for c, v in zip(s.velocity_coords(real_only=True),
                               s.velocity(real_only=True))}
        err = max(np.max(np.abs(ref[k] - got[k])) for k in ref)
        assert err < 1e-4


def test_cahouet_chabard_spmd():
    s1 = _solve("cahouet_chabard")
    s2 = _solve("cahouet_chabard", n_devices=2)
    assert s2._dist is not None
    v1 = {tuple(np.round(c, 10)): v
          for c, v in zip(s1.velocity_coords(real_only=True), s1.velocity(real_only=True))}
    v2 = {tuple(np.round(c, 10)): v
          for c, v in zip(s2.velocity_coords(real_only=True), s2.velocity(real_only=True))}
    err = max(np.max(np.abs(v1[k] - v2[k])) for k in v1)
    # nb_multiple=2 changes block count -> different renumbering/rounding;
    # both Newton-converged to 1e-8 absolute
    assert err < 1e-4


def test_stokes_initial_guess_reduces_newton_work():
    """cpp:636-644 designed path: starting from the Stokes solve, the first
    Newton residual must be far below the zero-start one."""
    def first_residual(guess):
        s = _solve("identity", initial_guess=guess)
        newtons = [r for r in s.log.records if r.get("event") == "newton"]
        return newtons[0]["residual"], s

    r_zero, _ = first_residual("zero")
    r_stokes, s = first_residual("stokes")
    assert r_stokes < 0.2 * r_zero
    stk = [r for r in s.log.records if r.get("event") == "gmres" and r["system"] == "stokes"]
    assert stk and stk[0]["iters"] > 0


def test_stokes_initial_guess_spmd_matches_single():
    s1 = _solve("cahouet_chabard", initial_guess="stokes")
    s2 = _solve("cahouet_chabard", initial_guess="stokes", n_devices=2)
    v1 = {tuple(np.round(c, 10)): v
          for c, v in zip(s1.velocity_coords(real_only=True), s1.velocity(real_only=True))}
    v2 = {tuple(np.round(c, 10)): v
          for c, v in zip(s2.velocity_coords(real_only=True), s2.velocity(real_only=True))}
    err = max(np.max(np.abs(v1[k] - v2[k])) for k in v1)
    assert err < 1e-4
