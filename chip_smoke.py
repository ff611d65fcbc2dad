"""Smoke run of the solver's main path on a GPU.

    python chip_smoke.py            # one card: phases 1-5 below
    python chip_smoke.py --multi    # four cards: windowed SPMD only

Single card, through the entry points a user calls (``NavierStokesSolver``,
``setup``, ``solve`` and the jitted Newton step that ``bench.py`` times):

  1. device: platform, kind, count, and the card's name and power limit;
  2. operator parity at real width: the windowed full-system matvec and the
     three Cahouet-Chabard blocks (A00 v->v, B v->p, Kp p->p) in f32 on the
     card against a host float64 ``scipy.sparse`` product of the same
     element matrices (relative 2-norm error <= 1e-5: exact f32
     accumulation over <= 30 terms per row sits near 1e-7, a TF32
     contraction near 1e-3);
  3. main path, 2D: the DFG channel [0,2.2]x[0,0.41] at ~1.8M DoF,
     windowed operator + Cahouet-Chabard, f32, ramped inflow, three BDF1
     steps through ``solve()`` with XDMF output, then one forced Newton step
     from a random state;
  4. main path, 3D: P2/P1 tets on a 40^3 box (~1.6M DoF), bf16 tangent
     store, one forced Newton step;
  5. trajectory parity: a ~100k-DoF channel, three steps in f32 on the card
     against f64 on the CPU (a child process that never opens the card):
     identical Newton stopping decisions, entry residuals within 1e-4.

With ``--multi`` (four cards): (a) the windowed-SPMD scanned BDF2 loop in
f64 against the single-card loop (relative difference <= 1e-8), and (b) one
forced f32 Newton step of the 1.8M-DoF channel sharded over the four cards,
with every large buffer split four ways.

Any failed check exits non-zero.  The last line of standard output is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class Sizes:
    channel: tuple = (1040, 192)  # ~1.8M DoF P2/P1 on [0,2.2]x[0,0.41]
    box: int = 40  # 40^3 Kuhn tets, ~1.6M DoF P2/P1
    parity: tuple = (220, 48)  # ~96k DoF
    dryrun_refine: int = 1  # __graft_entry__.dryrun_multichip's mesh level


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# problem set-up shared by the phases
# ---------------------------------------------------------------------------


def channel_config(dtype: str):
    """DFG-channel configuration on a generated mesh: the generator's tags
    0 (inlet, x=0), 1 (outlet), 2-3 (walls), as the CLI's Stokes path maps
    them; windowed operator + Cahouet-Chabard, ramped (unfrozen) inflow."""
    from navier_stokes_tpu.config import SolverConfig

    cfg = SolverConfig(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3))
    cfg.dtype = dtype
    cfg.T = 0.15  # three BDF1 steps at dt 0.05
    cfg.inlet.freeze_time = False
    cfg.krylov.matvec = "windowed"
    cfg.krylov.preconditioner = "cahouet_chabard"
    cfg.krylov.max_iters = 300
    cfg.krylov.on_failure = "raise"
    cfg.newton.max_iters = 6  # a stalled step fails fast instead of looping
    return cfg


def big_channel_config(dtype: str):
    """The 1.8M-DoF channel's configuration: longer Cahouet-Chabard sweeps
    than the defaults, and the pressure-Laplacian coarse correction forced
    on.  On this uniformly fine mesh the default 4/8 sweeps leave the outer
    FGMRES count growing with refinement (forced step from a random state,
    f32: 20 outer iterations at 115k DoF, 46 at 450k, no convergence within
    300 at 1.8M; 8/16 holds 21 at 450k), and without the Kp coarse term the
    solves stall (450k: 300 iterations without convergence)."""
    cfg = channel_config(dtype)
    cfg.krylov.cc_iters_a00 = 8
    cfg.krylov.cc_iters_ap = 16
    cfg.krylov.cc_coarse_agg = 128
    cfg.krylov.max_iters = 1500
    return cfg


def channel_mesh(nx: int, ny: int):
    from navier_stokes_tpu.mesh.generate import rectangle

    return rectangle(nx, ny, 0.0, 2.2, 0.0, 0.41, name=f"channel_{nx}x{ny}")


def make_solver(mesh, cfg, n_devices=None):
    from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
    from navier_stokes_tpu.utils.logging import RunLog

    t0 = time.perf_counter()
    s = NavierStokesSolver(mesh, cfg, log=RunLog(verbose=False), n_devices=n_devices)
    s.setup()
    check(s._matvec == "windowed", "windowed layout infeasible: flat fallback")
    coarse = s._wassembly.coarse_inv
    say(f"  setup {time.perf_counter() - t0:.1f} s, {s.dofs.n_total} DoF "
        f"(with layout padding), {s._win_layout.nb} blocks, cell pad "
        f"{s._win_layout.pad_factor:.3f}, Kp coarse space "
        f"{'off' if coarse is None else coarse.shape[0]}")
    return s


def random_state(s, seed: int):
    import jax
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(seed)
    u = jnp.asarray(0.05 * rng.standard_normal(s.dofs.n_total), s._dtype)
    if s._dist is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from navier_stokes_tpu.parallel import windowed_spmd as wspmd

        u = jax.device_put(u, NamedSharding(s.spmd_mesh, P(wspmd.AXIS)))
    return u


def forced_newton_step(s, tag: str, reps: int = 2):
    """Compile the jitted Newton step explicitly, print compile time and
    memory analysis, then run it forced from random states."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    cfg = s.cfg
    vals = np.asarray(s.dirichlet.values(cfg.dt))
    if s._dist is not None:
        from navier_stokes_tpu.parallel.windowed_spmd import localize_values

        vals = localize_values(vals, s._bc_dev, s._bc_slot, s._dist.n_dev,
                               s._bc_local.shape[1])
    bc_vals = jnp.asarray(vals, s._dtype)
    t0 = time.perf_counter()
    compiled = s._newton_jit.lower(
        *s._newton_args(random_state(s, 0), s.solution_old, bc_vals, cfg.dt, True)
    ).compile()
    say(f"  [{tag}] compile {time.perf_counter() - t0:.1f} s")
    ma = compiled.memory_analysis()
    if ma is not None:
        say(f"  [{tag}] memory_analysis: argument {ma.argument_size_in_bytes} B, "
            f"output {ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B, "
            f"generated code {ma.generated_code_size_in_bytes} B")
    out = None
    for r in range(reps):
        args = s._newton_args(random_state(s, r + 1), s.solution_old, bc_vals,
                              cfg.dt, True)
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        dt = time.perf_counter() - t0
        u_new, res_norm, iters, conv, kres = out
        say(f"  [{tag}] forced Newton step {r}: {dt * 1e3:.1f} ms, "
            f"{int(iters)} FGMRES iterations, converged {bool(conv)}, "
            f"entry ||r|| {float(res_norm):.6e}, final Krylov residual "
            f"{float(kres):.3e}")
        check(bool(conv), f"{tag}: forced Newton step's tangent solve did not converge")
        check(bool(jnp.all(jnp.isfinite(u_new))), f"{tag}: non-finite Newton update")
    return out


def peak_memory(tag: str) -> None:
    import jax

    ms = jax.devices()[0].memory_stats()
    check(bool(ms), "the device reports no memory statistics")
    say(f"  [{tag}] device 0 peak_bytes_in_use so far {ms['peak_bytes_in_use']} B")


# ---------------------------------------------------------------------------
# phase 2: operator parity against scipy.sparse in float64
# ---------------------------------------------------------------------------


def _host_csr(A_loc, gl_in, gl_out, n_in, n_out):
    """scipy CSR of the element matrices A_loc[j, i, s] (valid slots only):
    entry (gl_out[s, i], gl_in[s, j]) summed over cells."""
    import numpy as np
    import scipy.sparse as sp

    nj, ni = gl_in.shape[1], gl_out.shape[1]
    rows = np.broadcast_to(gl_out[:, None, :], (len(gl_out), nj, ni)).ravel()
    cols = np.broadcast_to(gl_in[:, :, None], (len(gl_in), nj, ni)).ravel()
    vals = A_loc.transpose(2, 0, 1).ravel()
    return sp.csr_matrix((vals, (rows, cols)), shape=(n_out, n_in))


def operator_parity(s) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from navier_stokes_tpu.fem.windowed_assembly import assemble_windowed
    from navier_stokes_tpu.ops.windowed import (
        slice_block, windowed_matvec, windowed_matvec_block)

    lay, wa, cfg = s._win_layout, s._wassembly, s.cfg
    n, n_u = s.dofs.n_total, s.dofs.n_u
    A_t, _, _ = jax.jit(
        lambda wa_, lay_, u_, uo_: assemble_windowed(
            wa_, lay_, u_, uo_, dt=cfg.dt, nu=cfg.nu, rho=cfg.rho,
            convection_form=cfg.convection_form,
            include_continuity_residual=cfg.include_continuity_residual,
        )
    )(wa, lay, random_state(s, 7), s.solution_old)
    check(A_t.dtype == jnp.float32, f"tangent stored as {A_t.dtype}, expected f32")
    x = random_state(s, 8) * 20.0
    A00 = slice_block(lay, A_t, "v", "v")
    B = slice_block(lay, A_t, "v", "p")
    mv = jax.jit(windowed_matvec)
    blk = jax.jit(windowed_matvec_block, static_argnames=("in_spaces", "out_spaces"))
    got = {
        "full": mv(lay, A_t, x),
        "A00": blk(lay, A00, x[:n_u], in_spaces="v", out_spaces="v"),
        "B": blk(lay, B, x[:n_u], in_spaces="v", out_spaces="p"),
        "Kp": blk(lay, wa.Kp_t, x[n_u:], in_spaces="p", out_spaces="p"),
    }
    got = {k: np.asarray(v, np.float64) for k, v in got.items()}

    valid = lay.valid_slots().reshape(-1)
    ids = np.asarray(lay.cell_ids).reshape(-1)[valid]
    d = s.dofs
    gv = np.concatenate(
        [d.cell_vdofs[ids] + c * d.n_vs for c in range(d.dim)], axis=1
    ).astype(np.int32)
    gp = (d.cell_pdofs[ids] + n_u).astype(np.int32)
    gl = np.concatenate([gv, gp], axis=1)
    nl = lay.nl
    A_host = np.asarray(A_t, np.float64)[:, :nl][:, :, valid]
    t0 = time.perf_counter()
    K = _host_csr(A_host, gl, gl, n, n)
    Kp = _host_csr(np.asarray(wa.Kp_t, np.float64)[:, : lay.k_p][:, :, valid],
                   gp - n_u, gp - n_u, d.n_ps, d.n_ps)
    say(f"  host CSR build {time.perf_counter() - t0:.1f} s, nnz {K.nnz}")
    x64 = np.asarray(x, np.float64)
    want = {
        "full": K @ x64,
        "A00": K[:n_u, :n_u] @ x64[:n_u],
        "B": K[n_u:, :n_u] @ x64[:n_u],
        "Kp": Kp @ x64[n_u:],
    }
    for k in ("full", "A00", "B", "Kp"):
        rel = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
        say(f"  operator parity {k}: relative 2-norm error {rel:.3e} "
            f"(n_out {len(want[k])})")
        check(rel <= 1e-5, f"operator {k} error {rel:.3e} > 1e-5")


# ---------------------------------------------------------------------------
# phases 3-4: main path
# ---------------------------------------------------------------------------


def main_path_2d(sizes: Sizes) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    say(f"phase 2+3: 2D channel {sizes.channel}")
    cfg = big_channel_config("float32")
    cfg.newton.min_iters = 1  # every step runs at least one tangent solve
    cfg.krylov.on_failure = "warn"  # failures are listed below, then fail the phase
    s = make_solver(channel_mesh(*sizes.channel), cfg)
    operator_parity(s)
    forced_newton_step(s, "2d")

    records = s.log.records
    with tempfile.TemporaryDirectory() as out_dir:
        writer = None
        if importlib.util.find_spec("h5py") is None:
            say("  note: h5py is not installed; XDMF output skipped")
        else:
            from navier_stokes_tpu.io.xdmf import XdmfWriter

            writer = XdmfWriter(s.dofs, output_dir=out_dir)
            s.output_hooks.append(lambda st, t, sol: writer.write(st, t, sol))
        t0 = time.perf_counter()
        s.solve()
        jax.block_until_ready(s.solution)
        say(f"  solve(): 3 BDF1 steps in {time.perf_counter() - t0:.1f} s "
            "(includes the jit cache lookup of the Newton step)")
        if writer is not None:
            files = sorted(os.listdir(out_dir))
            say(f"  XDMF output: {files}")
            check(any(f.endswith(".h5") for f in files)
                  and any(f.endswith(".xdmf") for f in files), "no XDMF output")
    newton = [r for r in records if r.get("event") == "newton"]
    gmres = [r["iters"] for r in records if r.get("event") == "gmres"]
    fails = [r for r in records if r.get("event") == "krylov_failure"]
    say("  Newton residuals " + " ".join(f"{r['residual']:.3e}" for r in newton))
    say(f"  FGMRES iterations per tangent solve {gmres}")
    for r in fails:
        say(f"  tangent solve failed: {r}")
    check(len(gmres) >= 3 and not fails, "a tangent solve did not converge")
    check(bool(jnp.all(jnp.isfinite(s.solution))), "non-finite solution")
    check(float(np.max(np.abs(np.asarray(s.velocity())))) > 0.0,
          "the inflow did not reach the solution")
    peak_memory("2d")


def main_path_3d(sizes: Sizes) -> None:
    from navier_stokes_tpu.mesh.generate import box

    say(f"phase 4: 3D box {sizes.box}^3")
    cfg = channel_config("float32")
    cfg.inlet_tags, cfg.neumann_tags, cfg.wall_tags = (0,), (1,), (2, 3, 4, 5)
    cfg.inlet.freeze_time = True  # bench's 3D leg: forced step, no inflow
    cfg.krylov.tangent_store_dtype = "bfloat16"
    cfg.krylov.cc_iters_a00 = 6
    n = sizes.box
    s = make_solver(box(n, n, n), cfg)
    forced_newton_step(s, "3d")
    peak_memory("3d")


# ---------------------------------------------------------------------------
# phase 5: trajectory parity, f32 on the card against f64 on the CPU
# ---------------------------------------------------------------------------


def parity_trajectory(nx: int, ny: int, dtype: str) -> list:
    """(step, iter, ||r||) Newton rows of three BDF1 steps on the channel
    with tangents solved tightly (scripts/trajectory_parity.py settings)."""
    from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
    from navier_stokes_tpu.utils.logging import RunLog

    cfg = channel_config(dtype)
    cfg.p_out = 0.0
    cfg.convection_form = "standard"
    cfg.include_continuity_residual = True
    cfg.jacobian_mass_rho = True
    cfg.newton.tol = 3e-6
    cfg.newton.max_iters = 8
    cfg.krylov.rel_tol = 1e-9 if dtype == "float64" else 1e-6
    cfg.krylov.max_iters = 3000
    cfg.krylov.restart = 100
    cfg.krylov.cc_coarse_agg = 128
    # an f32 tangent solve may stall at its rounding floor short of 1e-6;
    # the parity signal is the Newton residual rows, compared below
    cfg.krylov.on_failure = "warn"
    log = RunLog(verbose=False)
    s = NavierStokesSolver(channel_mesh(nx, ny), cfg, log=log)
    s.solve()
    rows, step = [], 0
    for r in log.records:
        if r.get("event") == "time_step":
            step = r["step"]
        elif r.get("event") == "newton":
            rows.append((step, r["iter"], r["residual"]))
    return rows


def cpu_oracle(out_path: str, nx: int, ny: int) -> None:
    """Child-process entry: the f64 CPU leg (run with JAX_PLATFORMS=cpu)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    check(jax.default_backend() == "cpu", "the oracle must run on the CPU")
    with open(out_path, "w") as f:
        json.dump(parity_trajectory(nx, ny, "float64"), f)


def start_cpu_oracle(out_path: str, sizes: Sizes) -> subprocess.Popen:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
        "chip_smoke.cpu_oracle(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))"
    )
    return subprocess.Popen(
        [sys.executable, "-c", code, REPO, out_path, *map(str, sizes.parity)],
        env=env, cwd=REPO,
    )


def trajectory_parity(sizes: Sizes, oracle: subprocess.Popen, oracle_path: str) -> None:
    say(f"phase 5: trajectory parity, channel {sizes.parity}")
    t0 = time.perf_counter()
    rows32 = parity_trajectory(*sizes.parity, "float32")
    say(f"  f32 leg on the device {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rc = oracle.wait()
    say(f"  waited {time.perf_counter() - t0:.1f} s for the f64 CPU leg")
    check(rc == 0, f"the f64 CPU leg failed (exit {rc})")
    with open(oracle_path) as f:
        rows64 = [tuple(r) for r in json.load(f)]
    check([r[:2] for r in rows32] == [r[:2] for r in rows64],
          f"Newton stopping decisions differ: f32 {[r[:2] for r in rows32]} "
          f"vs f64 {[r[:2] for r in rows64]}")
    worst = 0.0
    for (st, it, r32), (_, _, r64) in zip(rows32, rows64):
        rel = abs(r32 - r64) / abs(r64)
        say(f"  step {st} iter {it}: ||r|| f64 {r64:.9e} f32 {r32:.9e} rel {rel:.2e}")
        if it == 0:
            worst = max(worst, rel)
    say(f"  entry-row agreement: max relative difference {worst:.3e}")
    check(worst <= 1e-4, f"entry residuals differ by {worst:.3e} > 1e-4")


# ---------------------------------------------------------------------------
# --multi: windowed SPMD on four cards
# ---------------------------------------------------------------------------


def multi_channel_step(sizes: Sizes, n_dev: int) -> None:
    import numpy as np

    say(f"--multi (b): 2D channel {sizes.channel} on {n_dev} devices, f32")
    s = make_solver(channel_mesh(*sizes.channel), big_channel_config("float32"),
                    n_devices=n_dev)
    check(s._dist is not None, "the windowed SPMD path was not taken")
    out = forced_newton_step(s, f"{n_dev}dev", reps=1)
    named = {"A_const": s._wa_sharded.A_const, "invJT_t": s._wa_sharded.invJT_t,
             "solution": out[0]}
    for name, leaf in named.items():
        shards = leaf.addressable_shards
        per_dev = max(int(np.prod(sh.data.shape)) * leaf.dtype.itemsize for sh in shards)
        say(f"  {name}: {per_dev} B on the fullest of {len(shards)} devices, "
            f"{leaf.nbytes} B in all")
        check(len(shards) == n_dev and per_dev <= leaf.nbytes / n_dev * 1.001,
              f"{name} is not split {n_dev} ways")
    import jax

    leaves = jax.tree_util.tree_leaves((s._wa_sharded, s._lay_sharded))
    for leaf in leaves:
        check(len(leaf.sharding.device_set) == n_dev,
              f"a {leaf.shape} buffer sits on {len(leaf.sharding.device_set)} device(s)")


def multi_equivalence(sizes: Sizes, n_dev: int) -> None:
    say(f"--multi (a): scanned BDF2 loop, {n_dev} devices vs 1, f64")
    os.environ["DRYRUN_REFINE"] = str(sizes.dryrun_refine)
    sys.path.insert(0, REPO)
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(n_dev)


# ---------------------------------------------------------------------------


def nvidia_smi() -> None:
    """The card's name and power limit, read by a child that never imports
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    for line in out.splitlines():
        say(f"nvidia-smi: {line}")


def run_single(sizes: Sizes) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        oracle_path = os.path.join(tmp, "oracle_f64.json")
        oracle = start_cpu_oracle(oracle_path, sizes)
        try:
            main_path_2d(sizes)
            gc.collect()
            main_path_3d(sizes)
            gc.collect()
            trajectory_parity(sizes, oracle, oracle_path)
        finally:
            if oracle.poll() is None:
                oracle.kill()
                oracle.wait()


def run_multi(sizes: Sizes, n_dev: int) -> None:
    multi_channel_step(sizes, n_dev)
    gc.collect()
    multi_equivalence(sizes, n_dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card windowed-SPMD phase")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    d0 = devs[0]
    say(f"device: platform {d0.platform}, kind {d0.device_kind}, count {len(devs)}")
    if d0.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {d0.platform}", file=sys.stderr)
        return 2
    n_dev = 4 if args.multi else 1
    if len(devs) < n_dev:
        print(f"chip_smoke: needs {n_dev} GPUs, JAX found {len(devs)}", file=sys.stderr)
        return 2
    nvidia_smi()

    sys.path.insert(0, REPO)
    from navier_stokes_tpu.utils.compile_cache import enable_compile_cache

    say(f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    if args.multi:
        run_multi(Sizes(), n_dev)
    else:
        run_single(Sizes())
    say(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind, "count": n_dev,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
