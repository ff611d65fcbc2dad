"""Capacity evidence: problems bigger than one device's share.

The reference's ENTIRE reason for MPI is fitting problems no single rank can
hold (/root/reference/src/NavierStokesSolver.cpp:18-21 distributes the
triangulation; hpp:785-794 keeps only owned+ghost vector rows per rank).
These tests prove the JAX equivalent: under windowed SPMD every large
device buffer of the solve state is sharded so PER-DEVICE bytes drop ~1/n_dev
(jax.Array.addressable_shards), i.e. an n-device mesh holds an n-times-larger
problem — memory weak scaling (VERDICT r3 #4).

Companion capacity lever tested here: the bf16 tangent store
(KrylovConfig.tangent_store_dtype), which halves the two largest buffers
(A_const + the assembled A_t) on a single chip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navier_stokes_tpu.config import SolverConfig
from navier_stokes_tpu.mesh.msh_io import read_msh
from navier_stokes_tpu.mesh.mesh import refine_uniform
from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
from navier_stokes_tpu.utils.logging import RunLog

N_DEV = 8


def _solver(mesh, n_devices=None, **krylov):
    cfg = SolverConfig()
    cfg.krylov.matvec = "windowed"
    cfg.krylov.preconditioner = "cahouet_chabard"
    cfg.krylov.max_iters = 200
    for k, v in krylov.items():
        setattr(cfg.krylov, k, v)
    s = NavierStokesSolver(
        mesh, cfg, log=RunLog(verbose=False), n_devices=n_devices
    )
    s.setup()
    return s


@pytest.fixture(scope="module")
def cyl_mesh(ref_mesh_dir):
    return refine_uniform(read_msh(f"{ref_mesh_dir}/correct_mesh_yt.msh"), 1)


def test_sharded_state_bytes_scale_inverse_with_devices(cyl_mesh):
    """Per-device share of every LARGE windowed-SPMD buffer is ~total/n_dev.

    This is the memory-weak-scaling fact that unblocks problems whose
    A_const/A_t exceed one device's HBM: 8 devices hold 1/8 each.
    """
    s = _solver(cyl_mesh, n_devices=N_DEV)
    assert s._dist is not None

    # the buffers that dominate a solve's footprint (bench._estimate_leg_bytes)
    wa = s._wa_sharded
    big = {
        "A_const": wa.A_const,
        "invJT_t": wa.invJT_t,
        "W_t": wa.W_t,
        "Kp_t": wa.Kp_t,
        "r_const": wa.r_const,
        "inv_mp": wa.inv_mp,
        "diag_kp": wa.diag_kp,
        "cell_ids": s._lay_sharded.cell_ids,
        "loc_v": s._lay_sharded.loc_v,
    }
    total_bytes = 0
    max_share = 0
    for name, leaf in big.items():
        shards = leaf.addressable_shards
        assert len(shards) == N_DEV, f"{name}: {len(shards)} shards"
        sizes = [int(np.prod(sh.data.shape)) * leaf.dtype.itemsize for sh in shards]
        assert max(sizes) * N_DEV <= leaf.nbytes * 1.001, (
            f"{name}: per-device share {max(sizes)} x {N_DEV} > total {leaf.nbytes}"
        )
        total_bytes += leaf.nbytes
        max_share += max(sizes)
    # aggregate: one device holds ~1/8 of the sharded state
    assert max_share <= total_bytes / N_DEV * 1.001

    # the replicated leaves are TINY (tabulations, coarse inverses): their
    # full-copy-per-device cost must be negligible vs the sharded state
    rep_bytes = sum(
        leaf.nbytes
        for leaf in (wa.N_v, wa.N_p, wa.NN, wa.G_v)
    )
    if wa.coarse_inv is not None:
        rep_bytes += wa.coarse_inv.nbytes
    if wa.coarse_inv_v is not None:
        rep_bytes += wa.coarse_inv_v.nbytes
    assert rep_bytes < 0.05 * total_bytes / N_DEV + 2**22

    # state vectors live in the device-major distributed layout: sharded too
    for vec in (s.solution, s.solution_old):
        shards = vec.addressable_shards
        assert len(shards) == N_DEV
        assert all(
            int(np.prod(sh.data.shape)) == vec.shape[0] // N_DEV for sh in shards
        )


def test_sharded_newton_step_runs_on_capacity_problem(cyl_mesh):
    """One sharded Newton step executes end-to-end on the same problem —
    the memory claim above is for buffers a real solve actually uses."""
    s = _solver(cyl_mesh, n_devices=N_DEV)
    rng = np.random.default_rng(7)
    # distinct buffer from solution_old: the jitted iteration DONATES u
    u = jax.device_put(
        jnp.asarray(
            0.05 * rng.standard_normal(s.dofs.n_total), s.solution.dtype
        ),
        s.solution.sharding,
    )
    bv = jnp.asarray(
        np.zeros(s._bc_local.shape, np.float64), dtype=u.dtype
    )
    out = s._newton_iteration(u, s.solution_old, bv, s.cfg.dt, True)
    u_new, res_norm, iters, conv, _ = out
    assert bool(jnp.all(jnp.isfinite(u_new)))
    assert int(iters) > 0 and bool(conv)


def test_bf16_tangent_store_halves_big_buffers_and_converges(ref_mesh_dir):
    """KrylovConfig.tangent_store_dtype='bfloat16' (the single-chip 3D
    capacity mode): A_const is stored half-width, the assembled tangent
    inherits it, and the Newton iteration still converges its FGMRES solve
    with the residual norm unchanged (the residual path stays f32-exact)."""
    mesh = read_msh(f"{ref_mesh_dir}/correct_mesh_yt.msh")

    # f32 reference run of the same forced step
    cfg = SolverConfig()
    cfg.dtype = "float32"
    cfg.krylov.matvec = "windowed"
    cfg.krylov.preconditioner = "cahouet_chabard"
    cfg.krylov.max_iters = 200
    sA = NavierStokesSolver(mesh, cfg, log=RunLog(verbose=False))
    sA.setup()
    cfg16 = SolverConfig()
    cfg16.dtype = "float32"
    cfg16.krylov.matvec = "windowed"
    cfg16.krylov.preconditioner = "cahouet_chabard"
    cfg16.krylov.max_iters = 200
    cfg16.krylov.tangent_store_dtype = "bfloat16"
    sB = NavierStokesSolver(mesh, cfg16, log=RunLog(verbose=False))
    sB.setup()

    assert sA._wassembly.A_const.dtype == jnp.float32
    assert sB._wassembly.A_const.dtype == jnp.bfloat16
    assert sB._wassembly.A_const.nbytes * 2 == sA._wassembly.A_const.nbytes

    rng = np.random.default_rng(3)
    u = jnp.asarray(
        0.05 * rng.standard_normal(sA.dofs.n_total), dtype=jnp.float32
    )
    bv = jnp.asarray(sA.dirichlet.values(cfg.dt), dtype=jnp.float32)
    outA = sA._newton_iteration(u.copy(), sA.solution_old, bv, cfg.dt, True)
    outB = sB._newton_iteration(u.copy(), sB.solution_old, bv, cfg.dt, True)
    rA, rB = float(outA[1]), float(outB[1])
    # residual evaluation is tangent-store independent up to the bc_diag
    # row scaling (bf16-rounded diagonal values)
    assert abs(rA - rB) <= 5e-3 * abs(rA)
    assert bool(outB[3]), "bf16-tangent FGMRES did not converge"
    # the updates agree to inexact-Newton accuracy (rel_tol 1e-2 solves on
    # tangents differing by ~3e-3 relative)
    dA = np.asarray(outA[0] - u)
    dB = np.asarray(outB[0] - u)
    rel = np.linalg.norm(dB - dA) / np.linalg.norm(dA)
    assert rel < 0.08, f"bf16-tangent update diverges: rel {rel:.3f}"
