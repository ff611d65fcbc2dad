"""Owned-range windowed SPMD (parallel/windowed_spmd): the sharded operator
must match the single-device result exactly, with only O(halo) ppermutes.

Runs on the virtual CPU mesh (conftest forces 8 CPU devices); the windowed
operator runs per shard on a local layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from navier_stokes_tpu.fem.assembly import assemble_navier_stokes, build_context
from navier_stokes_tpu.fem.dofs import make_dofs, renumber_blocked
from navier_stokes_tpu.mesh.generate import unit_square
from navier_stokes_tpu.ops.windowed import (
    build_windowed_layout,
    to_block_form,
    windowed_matvec,
)
from navier_stokes_tpu.parallel import windowed_spmd as wspmd
from navier_stokes_tpu.parallel.spmd import device_mesh, shard_map


def _problem(n_dev, refine=6, cpb=16):
    mesh = unit_square(refine)
    dofs, bi = renumber_blocked(make_dofs(mesh), cells_per_block=cpb, nb_multiple=n_dev)
    lay = build_windowed_layout(
        dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, mesh.dim,
        block_info=bi,
    )
    ctx = build_context(dofs, neumann_tags=(1,))
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.standard_normal(dofs.n_total))
    cell_mat, _, _ = assemble_navier_stokes(
        ctx, u, 0.9 * u, dt=0.1, nu=0.01, rho=1.0, p_out=2.0
    )
    A_t = to_block_form(lay, cell_mat)
    x = jnp.asarray(rng.standard_normal(dofs.n_total))
    return dofs, lay, A_t, x


@pytest.mark.parametrize("n_dev", [2, 4])
def test_dist_roundtrip(n_dev):
    dofs, lay, A_t, x = _problem(n_dev)
    dl = wspmd.make_dist_layout(lay, n_dev)
    xd = wspmd.to_dist(np.asarray(x), dl)
    np.testing.assert_array_equal(wspmd.from_dist(xd, dl), np.asarray(x))


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_matvec_matches_single(n_dev):
    dofs, lay, A_t, x = _problem(n_dev)
    dl = wspmd.make_dist_layout(lay, n_dev)
    mesh = device_mesh(n_dev, axis=wspmd.AXIS)
    lay_s = wspmd.shard_layout(lay, dl, mesh)

    y_single = np.asarray(windowed_matvec(lay, A_t, x))

    fn = shard_map(
        lambda la, A, v: windowed_matvec(la, A, v, axis_name=wspmd.AXIS),
        mesh,
        in_specs=(wspmd.layout_pspecs(lay_s), P(None, None, wspmd.AXIS), P(wspmd.AXIS)),
        out_specs=P(wspmd.AXIS),
    )
    xd = jnp.asarray(wspmd.to_dist(np.asarray(x), dl))
    yd = jax.jit(fn)(lay_s, A_t, xd)
    y_sharded = wspmd.from_dist(np.asarray(yd), dl)
    np.testing.assert_allclose(y_sharded, y_single, rtol=1e-12, atol=1e-12)


def test_localize_rows_roundtrip():
    dofs, lay, A_t, x = _problem(2)
    dl = wspmd.make_dist_layout(lay, 2)
    rng = np.random.default_rng(11)
    rows = np.unique(rng.integers(0, dofs.n_total, size=40))
    local, dev, slot = wspmd.localize_rows(rows, dl)
    vals = rng.standard_normal(len(rows))
    lv = wspmd.localize_values(vals, dev, slot, dl.n_dev, local.shape[1])
    # setting local rows on the dist vector == setting global rows planar
    xd = wspmd.to_dist(np.asarray(x), dl).copy().reshape(dl.n_dev, dl.llen)
    for d in range(dl.n_dev):
        sel = local[d] < dl.llen
        xd[d, local[d][sel]] = lv[d][sel]
    expect = np.asarray(x).copy()
    expect[rows] = vals
    np.testing.assert_array_equal(wspmd.from_dist(xd.reshape(-1), dl), expect)


def test_full_solve_windowed_spmd_matches_single():
    """Unsteady NS, 2 devices, windowed SPMD vs single-device windowed."""
    from navier_stokes_tpu.config import SolverConfig
    from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
    from navier_stokes_tpu.utils.logging import RunLog

    def run(n_devices):
        cfg = SolverConfig(
            inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3),
            nu=0.04, p_out=10.0, dt=0.05, T=0.1,
        )
        cfg.krylov.max_iters = 500
        cfg.krylov.matvec = "windowed"
        cfg.krylov.cells_per_block = 16
        cfg.krylov.preconditioner = "block_triangular"
        s = NavierStokesSolver(
            unit_square(4), cfg, log=RunLog(verbose=False), n_devices=n_devices
        )
        s.solve()
        assert s._matvec == "windowed"
        return s

    s1 = run(None)
    s2 = run(2)
    assert s2._dist is not None, "2-device run must take the windowed SPMD path"
    f1 = {tuple(np.round(c, 10)): v
          for c, v in zip(s1.velocity_coords(real_only=True), s1.velocity(real_only=True))}
    f2 = {tuple(np.round(c, 10)): v
          for c, v in zip(s2.velocity_coords(real_only=True), s2.velocity(real_only=True))}
    err = max(np.max(np.abs(f1[k] - f2[k])) for k in f1)
    assert err < 1e-8


def test_full_solve_spmd_cahouet_chabard_coarse_matches_single():
    """2-device Cahouet-Chabard WITH the two-level coarse correction must
    match single-device: validates the SPMD reshape-based coarse Z/Zt
    (device ranges are whole aggregates; per-aggregate partial sums are
    device-local, so the psum-composed restriction is bit-identical to the
    single-device reshape)."""
    from navier_stokes_tpu.config import SolverConfig
    from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
    from navier_stokes_tpu.utils.logging import RunLog

    def run(n_devices):
        cfg = SolverConfig(
            inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3),
            nu=0.04, p_out=10.0, dt=0.05, T=0.1,
        )
        cfg.krylov.max_iters = 500
        cfg.krylov.matvec = "windowed"
        cfg.krylov.cells_per_block = 16
        cfg.krylov.preconditioner = "cahouet_chabard"
        cfg.krylov.cc_coarse_agg = 128
        s = NavierStokesSolver(
            unit_square(4), cfg, log=RunLog(verbose=False), n_devices=n_devices
        )
        s.solve()
        assert s._matvec == "windowed"
        return s

    s1 = run(None)
    s2 = run(2)
    assert s2._dist is not None
    assert s2._wassembly.coarse_inv is not None, "coarse correction must be on"
    f1 = {tuple(np.round(c, 10)): v
          for c, v in zip(s1.velocity_coords(real_only=True), s1.velocity(real_only=True))}
    f2 = {tuple(np.round(c, 10)): v
          for c, v in zip(s2.velocity_coords(real_only=True), s2.velocity(real_only=True))}
    err = max(np.max(np.abs(f1[k] - f2[k])) for k in f1)
    assert err < 1e-8


def test_cell_owner_and_partitioning_output(tmp_path):
    """SPMD runs must write REAL cell ownership (cpp:702-705), not zeros."""
    import h5py

    from navier_stokes_tpu.config import SolverConfig
    from navier_stokes_tpu.io.xdmf import XdmfWriter
    from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
    from navier_stokes_tpu.utils.logging import RunLog

    cfg = SolverConfig(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3),
                       dt=0.05, T=0.05)
    cfg.krylov.matvec = "windowed"
    cfg.krylov.cells_per_block = 16
    s = NavierStokesSolver(unit_square(4), cfg, log=RunLog(verbose=False),
                           n_devices=2)
    s.setup()
    owner = s.cell_owner
    assert owner.shape == (s.mesh.n_cells,)
    assert set(np.unique(owner)) == {0, 1}
    # roughly balanced (blocked contiguous assignment)
    assert 0.25 < np.mean(owner == 0) < 0.75
    w = XdmfWriter(s.dofs, output_dir=str(tmp_path), partitioning=owner)
    s.output_hooks.append(lambda st, t, sol: w.write(st, t, sol))
    s.solve()
    with h5py.File(tmp_path / "output-0001.h5", "r") as f:
        part = np.asarray(f["partitioning"]).ravel()
    np.testing.assert_array_equal(part, owner.astype(np.float64))


def test_bootstrap_single_process_noop():
    """initialize_distributed is a strict no-op without multi-host env
    (main.cpp:7 equivalent stays dormant on one process)."""
    from navier_stokes_tpu.parallel import bootstrap

    assert bootstrap.initialize_distributed() is False
    assert bootstrap.process_count() == 1
    assert bootstrap.is_coordinator()


def _collect_collectives(jaxpr, out):
    """Walk a (Closed)Jaxpr recursively, recording collective ops."""
    jaxpr = getattr(jaxpr, "jaxpr", jaxpr)
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("ppermute", "psum", "all_gather",
                                  "all_to_all", "reduce_scatter"):
            out.append(
                (eqn.primitive.name,
                 sum(int(np.prod(v.aval.shape)) for v in eqn.invars))
            )
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (tuple, list)) else (p,)):
                if hasattr(sub, "eqns") or hasattr(sub, "jaxpr"):
                    _collect_collectives(sub, out)


def _matvec_collectives(n_dev, refine):
    dofs, lay, A_t, x = _problem(n_dev, refine=refine)
    dl = wspmd.make_dist_layout(lay, n_dev)
    mesh = device_mesh(n_dev, axis=wspmd.AXIS)
    lay_s = wspmd.shard_layout(lay, dl, mesh)
    fn = shard_map(
        lambda la, A, v: windowed_matvec(la, A, v, axis_name=wspmd.AXIS),
        mesh,
        in_specs=(wspmd.layout_pspecs(lay_s), P(None, None, wspmd.AXIS), P(wspmd.AXIS)),
        out_specs=P(wspmd.AXIS),
    )
    xd = jnp.asarray(wspmd.to_dist(np.asarray(x), dl))
    jaxpr = jax.make_jaxpr(fn)(lay_s, A_t, xd)
    ops = []
    _collect_collectives(jaxpr, ops)
    return lay, dofs, ops


def test_sharded_matvec_collective_volume_is_o_halo():
    """VERDICT r1 item 1 'done' criterion: per-matvec collective volume must
    be O(halo) — bounded by the layout's halo constants (h*OW per space) and
    INDEPENDENT of the mesh size — and a pure matvec needs no psum at all
    (round-1's replicated design psum-ed O(n_dofs) per matvec)."""
    lay, dofs, ops = _matvec_collectives(2, refine=6)
    assert ops, "sharded matvec must exchange halos via ppermute"
    assert all(name == "ppermute" for name, _ in ops), (
        f"pure matvec must not use psum/all_gather: {ops}"
    )
    # each transfer is at most one halo edge of one space
    per_edge_max = max(lay.hv * lay.OWv, lay.hp * lay.OWp)
    for name, sz in ops:
        assert sz <= per_edge_max, (name, sz, per_edge_max)
    # O(halo), not O(n): grow the mesh 4x in cells; the collective volume is
    # bounded by the layout's locality constants (h, OW — which may step up
    # with connectivity, but not with nb), so the halo FRACTION of the
    # vector must strictly shrink — round-1's replicated design was O(n)
    lay2, dofs2, ops2 = _matvec_collectives(2, refine=12)
    assert dofs2.n_total >= 3 * dofs.n_total  # the problem really grew
    assert all(name == "ppermute" for name, _ in ops2)
    per_edge_max2 = max(lay2.hv * lay2.OWv, lay2.hp * lay2.OWp)
    assert all(sz <= per_edge_max2 for _, sz in ops2)
    total1 = sum(sz for _, sz in ops)
    total2 = sum(sz for _, sz in ops2)
    assert total2 * dofs.n_total < total1 * dofs2.n_total, (
        f"halo volume must grow sublinearly: {total1}/{dofs.n_total} -> "
        f"{total2}/{dofs2.n_total}"
    )
    # ... and at the larger size it is a small fraction of a device slice
    assert total2 < dofs2.n_total // 2, (total2, dofs2.n_total)


def test_scanned_loop_spmd_matches_single():
    """The device-resident scanned time loop under windowed SPMD (VERDICT r2
    item 3): multi-step lax.scan inside shard_map, pre-localized Dirichlet
    schedule, functional on the all-gathered planar vector — must match the
    single-device scanned loop to 1e-8."""
    from navier_stokes_tpu.config import SolverConfig
    from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
    from navier_stokes_tpu.utils.logging import RunLog

    def functional(u):
        return jnp.stack([jnp.linalg.norm(u), u.sum()])

    def run(n_devices):
        cfg = SolverConfig(
            inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3),
            nu=0.04, p_out=10.0, dt=0.05, T=0.25,
        )
        cfg.time_scheme = "bdf2"
        cfg.krylov.max_iters = 500
        cfg.krylov.matvec = "windowed"
        cfg.krylov.cells_per_block = 16
        cfg.krylov.preconditioner = "cahouet_chabard"
        s = NavierStokesSolver(
            unit_square(4), cfg, log=RunLog(verbose=False), n_devices=n_devices
        )
        out = s.solve_scanned(functional=functional, newton_iters=3, chunk=2)
        assert s._matvec == "windowed"
        return s, out

    s1, out1 = run(None)
    s2, out2 = run(2)
    assert s2._dist is not None, "2-device run must take the windowed SPMD path"
    # the functional (norm/sum over REAL dofs; holes are zero) is
    # numbering-invariant: per-step trajectories must agree
    np.testing.assert_allclose(
        out1["functional"], out2["functional"], rtol=0, atol=1e-8
    )
    f1 = {tuple(np.round(c, 10)): v
          for c, v in zip(s1.velocity_coords(real_only=True), s1.velocity(real_only=True))}
    f2 = {tuple(np.round(c, 10)): v
          for c, v in zip(s2.velocity_coords(real_only=True), s2.velocity(real_only=True))}
    err = max(np.max(np.abs(f1[k] - f2[k])) for k in f1)
    assert err < 1e-8, err


def test_time_dep_forcing_spmd_matches_single():
    """Time-dependent forcing under windowed SPMD (VERDICT r2 item 3): the
    per-step r_const swap must land in the sharded pytree the call-time
    kernels read."""
    from navier_stokes_tpu.config import SolverConfig
    from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
    from navier_stokes_tpu.utils.logging import RunLog

    def forcing(pts, t):
        out = np.zeros_like(pts)
        out[:, 0] = np.sin(2 * np.pi * t) * pts[:, 1]
        out[:, 1] = np.cos(pts[:, 0]) * t
        return out

    def run(n_devices):
        cfg = SolverConfig(
            inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3),
            nu=0.04, p_out=10.0, dt=0.05, T=0.15,
        )
        cfg.krylov.max_iters = 500
        cfg.krylov.matvec = "windowed"
        cfg.krylov.cells_per_block = 16
        cfg.krylov.preconditioner = "cahouet_chabard"
        s = NavierStokesSolver(
            unit_square(4), cfg, log=RunLog(verbose=False),
            n_devices=n_devices, forcing=forcing,
        )
        s.solve()
        assert s._forcing_time_dep
        return s

    s1 = run(None)
    s2 = run(2)
    assert s2._dist is not None
    f1 = {tuple(np.round(c, 10)): v
          for c, v in zip(s1.velocity_coords(real_only=True), s1.velocity(real_only=True))}
    f2 = {tuple(np.round(c, 10)): v
          for c, v in zip(s2.velocity_coords(real_only=True), s2.velocity(real_only=True))}
    err = max(np.max(np.abs(f1[k] - f2[k])) for k in f1)
    assert err < 1e-8, err
    # the forcing must actually matter (guard against a silently-zero f)
    assert float(np.linalg.norm(s1.velocity(real_only=True))) > 1e-3
