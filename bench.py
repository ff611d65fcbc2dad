"""Benchmark: assembled MDoF/s + GMRES time per Newton step (BASELINE.json).

Runs the flagship unsteady Navier-Stokes configuration (the reference's
cylinder case, uniformly refined for a device-sized problem) on a GPU and
prints ONE JSON line:  {"metric", "value", "unit", "vs_baseline", ...extras}.
A run that finds no GPU fails.

Baseline: the reference publishes NO numbers (BASELINE.md), so the
comparison value is MEASURED on this host (VERDICT r4 #6): the independent
from-scratch CPU implementation (scripts/cpu_baseline.py: oracle P2/P1
basis, vectorized numpy einsum element tensors, scipy CSR scatter — work-
equivalent to the reference's per-Newton-iteration assemble_system,
cpp:593-612) takes 4.548 s single-threaded for one full tangent+residual
assembly of the SAME mesh as the headline leg (correct_mesh_yt refined 2x;
artifact examples/artifacts/cpu_baseline_543k.json).  In this bench's
padded-n convention that is 542976/4.548 s = 0.119 MDoF/s, so vs_baseline
is the same-mesh wall-time ratio t_cpu/t_device.  (Vectorized numpy is, if
anything, faster than deal.II's FEValues cell loop per core, so the ratio
is conservative.)  The driver's target is >10x per chip.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REFINE = int(os.environ.get("BENCH_REFINE", "2"))
DTYPE = os.environ.get("BENCH_DTYPE", "float32")
REPS = int(os.environ.get("BENCH_REPS", "20"))
PRECOND = os.environ.get("BENCH_PRECOND", "cahouet_chabard")
BIG = os.environ.get("BENCH_BIG", "1") != "0"  # extra >=1M-DoF Newton step
HUGE = os.environ.get("BENCH_HUGE", "1") != "0"  # extra >=5M-DoF Newton step
BENCH_3D = os.environ.get("BENCH_3D", "1") != "0"  # extra 3D (P2/P1 tet) leg
# Wall-clock budget for the OPTIONAL extra legs (big/huge/3d).  The headline
# metric + 543k legs always run; each extra leg is skipped (and recorded as
# skipped) if starting it would exceed the remaining budget.  The budget
# cannot protect against a driver-side timeout LANDING mid-leg — that is what
# the incremental JSON emission handles: the metric line is printed after the
# headline legs and re-printed after EVERY optional leg, so whatever the
# driver's tail capture sees last is a complete, parseable record of all
# finished legs (the driver parses the last parseable line).
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "2400"))
BASELINE_CPU_ASSEMBLY_S = 4.548  # MEASURED same-mesh single-core CPU
# tangent-assembly seconds (see docstring; scripts/cpu_baseline.py,
# examples/artifacts/cpu_baseline_543k.json).  vs_baseline is the exact
# same-mesh wall-time ratio t_cpu / t_device; the MDoF/s baseline below uses
# the bench's own n so numerator conventions can never diverge.

# Published peaks by jax device_kind.  Source: NVIDIA H100 SXM data sheet
# (dense rates, 700 W power limit): 3.35 TB/s HBM3, 67 TFLOP/s f32 outside
# the tensor cores, 495 TFLOP/s TF32, 989 TFLOP/s bf16.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "f32_flop_per_s": 67e12,
        "tf32_flop_per_s": 495e12,
        "bf16_flop_per_s": 989e12,
    },
}


def device_peaks(kind: str) -> dict:
    """Published peaks of a device kind; an unknown kind is an error."""
    if kind not in DEVICE_PEAKS:
        raise KeyError(
            f"no published peaks for device kind {kind!r} (bench.DEVICE_PEAKS)"
        )
    return DEVICE_PEAKS[kind]


def gpu_power_limit() -> str:
    """'name, power.limit' of each card, from nvidia-smi (no JAX involved)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _err_str(e: BaseException) -> str:
    """Truncated error for the metric line: jaxlib RESOURCE_EXHAUSTED
    messages embed multi-KB per-buffer allocation dumps, which round 3
    proved can blow the JSON line past the driver's tail capture
    (a parsed-null record whose tail was an HLO allocation table)."""
    return f"{type(e).__name__}: {str(e)[:300]}"


def _free_hbm_bytes() -> float:
    """Free device memory from the device's own statistics."""
    ms = jax.local_devices()[0].memory_stats()
    if not ms or not ms.get("bytes_limit"):
        raise RuntimeError("the device reports no memory statistics")
    return float(ms["bytes_limit"]) - float(ms.get("bytes_in_use", 0))


def _estimate_leg_bytes(dim: int, n_cells: int, *, restart: int,
                        tangent_bf16: bool) -> float:
    """Host-side peak-HBM estimate of one windowed Newton-step leg.

    Counts the device-resident windowed buffers (A_const, the assembled
    tangent A_t, the bf16 preconditioner block slices, geometry) plus the
    dominant assembly transients (the convection blocks) and the Krylov
    basis.  Used to SKIP-AND-RECORD a leg that would fault the device with
    RESOURCE_EXHAUSTED after minutes of compilation (round-3 failure mode).
    """
    k_v, k_p, nq = (6, 3, 7) if dim == 2 else (10, 4, 27)
    nl = dim * k_v + k_p
    nli = -(-nl // 8) * 8
    dkv = dim * k_v
    dkv8 = -(-dkv // 8) * 8
    # padded cell axis: measured pad factor is ~1.05; 1.15 adds a safety
    # margin on purpose (the estimate gates a leg whose failure mode is a
    # device fault after minutes of compile — overestimating is the cheap
    # direction)
    ncd = 1.15 * n_cells
    n = (5.3 if dim == 2 else 4.4) * n_cells  # P2/P1 DoF per cell (measured)
    sA = 2 if tangent_bf16 else 4
    resident = (
        nl * nli * ncd * sA * 2  # A_const + assembled A_t
        + (0 if tangent_bf16 else nl * nli * ncd * 2)  # bf16 operator copy
        + (dkv * dkv8 + dkv * 8 + k_p * 8) * ncd * 2  # precond block slices
        + (dim * dim + nq + k_p * 8) * ncd * 4  # invJT_t + W_t + Kp_t
    )
    # assembly transient: one [k_v, k_v] convection block at a time (blocked
    # in-place adds) + the gradient-field intermediates
    transient = (k_v * k_v + 3 * dim * dim * nq + 2 * dim * nq) * ncd * 4
    krylov = (2 * restart + 4) * n * 4
    vectors = 24 * n * 4
    return resident + max(transient, krylov) + vectors


def main():
    t_bench0 = time.perf_counter()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, JAX found {dev.platform}", file=sys.stderr)
        return 2
    from navier_stokes_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    peaks = device_peaks(dev.device_kind)
    power_limit = gpu_power_limit()
    from navier_stokes_tpu.config import SolverConfig
    from navier_stokes_tpu.fem.assembly import assemble_navier_stokes
    from navier_stokes_tpu.mesh.generate import rectangle
    from navier_stokes_tpu.mesh.mesh import refine_uniform
    from navier_stokes_tpu.mesh.msh_io import read_msh
    from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver
    from navier_stokes_tpu.utils.logging import RunLog

    cfg = SolverConfig()  # reference as-shipped physics/tolerances
    mesh_path = "/root/reference/mesh/correct_mesh_yt.msh"
    if os.path.exists(mesh_path):
        mesh = read_msh(mesh_path)
    else:  # generated channel: map the generator's tags 0/1/2-3
        mesh = rectangle(80, 40, 0, 7, 0, 4)
        cfg.inlet_tags, cfg.neumann_tags, cfg.wall_tags = (0,), (1,), (2, 3)
    mesh = refine_uniform(mesh, REFINE)

    cfg.dtype = DTYPE
    cfg.krylov.max_iters = 2000
    # restart bounds BOTH the Krylov memory and the per-iteration CGS2 cost:
    # orthogonalization runs four full [restart+1, n] contractions per
    # iteration, so an oversized window taxes every iteration's HBM traffic
    cfg.krylov.restart = int(os.environ.get("BENCH_RESTART", "60"))
    cfg.krylov.matvec = os.environ.get("BENCH_MATVEC", "windowed")
    cfg.krylov.preconditioner = PRECOND  # flagship: windowed Cahouet-Chabard
    # inner-sweep knobs track the mesh (Kp condition ~ h^-2; see the DFG
    # example's guidance): env-overridable for on-hardware sweeps
    if os.environ.get("BENCH_CC_A00"):
        cfg.krylov.cc_iters_a00 = int(os.environ["BENCH_CC_A00"])
    if os.environ.get("BENCH_CC_AP"):
        cfg.krylov.cc_iters_ap = int(os.environ["BENCH_CC_AP"])
    if os.environ.get("BENCH_A00_SOLVER"):
        cfg.krylov.a00_solver = os.environ["BENCH_A00_SOLVER"]
    if os.environ.get("BENCH_CPB"):
        cfg.krylov.cells_per_block = int(os.environ["BENCH_CPB"])
    if os.environ.get("BENCH_BC"):
        cfg.krylov.chunk_cells = int(os.environ["BENCH_BC"])

    solver = NavierStokesSolver(mesh, cfg, log=RunLog(verbose=False))
    solver.setup()
    print("# setup done", file=sys.stderr, flush=True)
    n = solver.dofs.n_total
    ctx = solver.ctx

    kw = dict(
        dt=cfg.dt,
        nu=cfg.nu,
        rho=cfg.rho,
        p_out=cfg.p_out,
        convection_form=cfg.convection_form,
        include_continuity_residual=cfg.include_continuity_residual,
        jacobian_mass_rho=cfg.jacobian_mass_rho,
    )

    # Micro-op legs (assembly, matvec) are timed as the MARGINAL cost of one
    # iteration inside a jitted lax.scan whose per-iteration input depends on
    # the previous iteration's OUTPUT:
    #     t = (T(scan length=REPS+1) - T(scan length=1)) / REPS
    # The difference cancels the fixed launch cost, and the output->input
    # chaining defeats loop-invariant hoisting, as inside a Krylov loop.
    import functools

    if solver._win_layout is not None:
        # the flagship path: blocked windowed assembly (what newton_iteration
        # actually runs; the flat [nc,15,15] assembly is the legacy path)
        from navier_stokes_tpu.fem.windowed_assembly import assemble_windowed

        wa, lay = solver._wassembly, solver._win_layout

        # wa/lay as ARGUMENTS: baking their multi-hundred-MB buffers as jit
        # constants faults the device at scale (newton_iteration's rule)
        @functools.partial(jax.jit, static_argnames=("length",))
        def assemble_loop(wa_a, lay_a, u0, u_old, length):
            def body(uc, _):
                A_t, r, diag0 = assemble_windowed(
                    wa_a, lay_a, uc, u_old, dt=cfg.dt, nu=cfg.nu, rho=cfg.rho,
                    convection_form=cfg.convection_form,
                    include_continuity_residual=cfg.include_continuity_residual,
                )
                s = jnp.linalg.norm(r) + A_t[:, :, ::4096].sum() + diag0[0]
                return uc * (1.0 + 1e-9 * jnp.tanh(s)), s

            uf, ss = jax.lax.scan(body, u0, None, length=length)
            return uf[0], ss.sum()

        def assemble_reps(u, u_old, length):
            return assemble_loop(wa, lay, u, u_old, length)
    else:

        @functools.partial(jax.jit, static_argnames=("length",))
        def assemble_reps(u0, u_old, length):
            def body(uc, _):
                cm, pm, r = assemble_navier_stokes(ctx, uc, u_old, **kw)
                s = jnp.linalg.norm(r) + cm.ravel()[::1000].sum() + pm.ravel()[0]
                return uc * (1.0 + 1e-9 * jnp.tanh(s)), s

            uf, ss = jax.lax.scan(body, u0, None, length=length)
            return uf[0], ss.sum()

    u = solver.solution
    u_old = solver.solution_old

    sync = jax.block_until_ready

    def best_time(fn, args, length):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            sync(fn(*args, length))
            best = min(best, time.perf_counter() - t0)
        return best

    def marginal_time(fn, reps, args):
        """(T(length=reps+1) - T(length=1)) / reps, both lengths pre-compiled
        and each the best of 3 runs; None when the loop is too short for the
        difference to rise above the launch noise."""
        sync(fn(*args, 1))  # compile
        sync(fn(*args, reps + 1))  # compile
        t = (best_time(fn, args, reps + 1) - best_time(fn, args, 1)) / reps
        return t if t > 0 else None

    def ms(t):
        return None if t is None else round(t * 1e3, 3)

    t_assembly = marginal_time(assemble_reps, REPS, (u + 1e-7, u_old))
    print(f"# assembly {ms(t_assembly)} ms", file=sys.stderr, flush=True)
    mdofs = None if t_assembly is None else n / t_assembly / 1e6

    # full Newton step (assembly + Dirichlet + FORCED GMRES tangent solve) at
    # a non-trivial flow state: the as-shipped zero-inflow quirk leaves the
    # zero state's residual under newton.tol, which would take the
    # cond-skip branch and time an assembly instead of a solve
    rng = np.random.default_rng(0)
    n_newton_reps = max(2, min(4, REPS // 5))
    state0 = np.asarray(0.05 * rng.standard_normal(n))
    bc_vals = jnp.asarray(solver.dirichlet.values(cfg.dt), dtype=u.dtype)

    def newton_step():
        # a fresh state array each call: the step donates its state buffer
        state = jnp.asarray(state0, dtype=u.dtype)
        return solver._newton_iteration(state, u_old, bc_vals, cfg.dt, True)

    sync(newton_step())  # compile warmup
    t_newtons, newton_iters, newton_conv = [], [], []
    for _ in range(n_newton_reps):
        t0 = time.perf_counter()
        newton_out = sync(newton_step())
        t_newtons.append(time.perf_counter() - t0)
        newton_iters.append(int(newton_out[2]))
        newton_conv.append(bool(newton_out[3]))
    t_newton = float(np.median(t_newtons))
    print(
        f"# newton {t_newton*1e3:.1f} ms  iters={newton_iters} conv={newton_conv}",
        file=sys.stderr, flush=True,
    )
    gmres_iters = newton_iters[0]

    if solver._win_layout is not None:
        # single windowed matvec (VERDICT r1 item 3's roofline metric)
        from navier_stokes_tpu.fem.windowed_assembly import assemble_windowed
        from navier_stokes_tpu.ops.windowed import windowed_matvec

        @jax.jit
        def _amat(wa_a, lay_a, uu, uo):
            A_t, _, _ = assemble_windowed(
                wa_a, lay_a, uu, uo, dt=cfg.dt, nu=cfg.nu, rho=cfg.rho,
                convection_form=cfg.convection_form,
                include_continuity_residual=cfg.include_continuity_residual,
            )
            return A_t

        MV_REPS = 4 * REPS  # cheap op: more reps for a cleaner marginal

        @functools.partial(jax.jit, static_argnames=("length",))
        def _mv_loop(lay_a, A_t, x0, length):
            # chained-input scan: every matvec input is the (constant-rescaled)
            # previous OUTPUT.  The 1e-3 rescale keeps the chain finite over
            # 4*REPS iterations (the tangent's ||A|| ~ 1e2-1e3)
            def body(x, _):
                y = windowed_matvec(lay_a, A_t, x)
                return y * 1e-3, y[0]

            xf, nn = jax.lax.scan(body, x0, None, length=length)
            return xf[0], nn.sum()

        u_state = jnp.asarray(0.05 * rng.standard_normal(n), dtype=u.dtype)
        A_t = _amat(wa, lay, u_state, u_old)
        t_mv = marginal_time(_mv_loop, MV_REPS, (lay, A_t, u_state))
        print(f"# matvec {ms(t_mv)} ms", file=sys.stderr, flush=True)
        # bf16-stored operator (KrylovConfig.operator_dtype): what the Newton
        # tangent solve actually streams at the reference-parity rel_tol —
        # halves the A_t memory traffic, entries widened to f32 on read
        t_mv16 = None
        if A_t.dtype == jnp.float32:
            A16 = jax.jit(lambda a: a.astype(jnp.bfloat16))(A_t)
            t_mv16 = marginal_time(_mv_loop, MV_REPS, (lay, A16, u_state))
            print(f"# matvec(bf16 A) {ms(t_mv16)} ms", file=sys.stderr, flush=True)
    else:
        t_mv = t_mv16 = None

    extra = {
        "n_dofs": n,
        "n_cells": mesh.n_cells,
        "dtype": DTYPE,
        "preconditioner": PRECOND,
        # knob provenance so the artifact can't silently diverge from the
        # configuration that produced it (VERDICT r4 #8)
        "knobs": {
            "restart": cfg.krylov.restart,
            "cells_per_block": cfg.krylov.cells_per_block,
            "chunk_cells": cfg.krylov.chunk_cells,
            "cc_iters_a00": cfg.krylov.cc_iters_a00,
            "cc_iters_ap": cfg.krylov.cc_iters_ap,
        },
        "assembly_ms": ms(t_assembly),
        "matvec_ms": ms(t_mv),
        "matvec_bf16_ms": ms(t_mv16),
        # share of the memory-bandwidth roofline the f32 matvec achieves:
        # the mandatory traffic is one A_t stream + x + y, over the
        # device's published peak (bench.DEVICE_PEAKS)
        "matvec_roofline_frac": (
            None if t_mv is None else round(
                ((A_t.nbytes + 2 * n * 4) / peaks["hbm_bytes_per_s"]) / t_mv, 3
            )
        ),
        "newton_step_ms": round(t_newton * 1e3, 3),
        "newton_step_ms_all": [round(t * 1e3, 1) for t in t_newtons],
        "gmres_iters_first_step": gmres_iters,
        "gmres_converged": newton_conv[0],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "nvidia_smi_name_power_limit": power_limit,
        "baseline_note": (
            "MEASURED 1-core CPU tangent assembly on the same mesh: 4.548 s "
            "= 0.119 MDoF/s in this padded-n convention (independent "
            "numpy/scipy implementation, scripts/cpu_baseline.py; the "
            "reference publishes no numbers)"
        ),
    }

    def emit():
        """Print the complete metric JSON line with everything known SO FAR.

        Called after the headline legs and re-called after every optional
        leg: the driver parses the LAST parseable line of the captured tail,
        so a timeout/OOM/watchdog kill mid-leg still leaves a full record of
        all finished legs (the round-3 artifact was lost to exactly this)."""
        print(json.dumps({
            "metric": "ns_assembly_throughput",
            "value": None if mdofs is None else round(mdofs, 3),
            "unit": "MDoF/s",
            "vs_baseline": (
                None if t_assembly is None
                else round(BASELINE_CPU_ASSEMBLY_S / t_assembly, 2)
            ),
            "extra": extra,
        }), flush=True)

    emit()  # headline legs are in; optional legs below only ever ADD to this

    def newton_leg(tag, mesh_fn, cfg_leg, dim, n_cells_est, min_budget_s=120):
        """One warmed + one timed forced Newton step on a separate problem;
        records n_dofs/newton_step_ms/gmres_iters/converged under _{tag}.
        Never fails the headline metric.  Skipped (and recorded as skipped)
        when the remaining wall budget or the host-side HBM estimate says the
        leg cannot finish — a pre-check, not a post-mortem: round 3 spent
        minutes compiling toward a RESOURCE_EXHAUSTED device fault.
        mesh_fn is a THUNK so a skipped leg pays no host refine cost."""
        elapsed = time.perf_counter() - t_bench0
        if elapsed > BUDGET_S - min_budget_s:
            extra[f"{tag}_skipped"] = (
                f"budget: {elapsed:.0f}s elapsed of {BUDGET_S:.0f}s"
            )
            print(f"# {tag} skipped (budget)", file=sys.stderr, flush=True)
            emit()
            return
        tangent_bf16 = cfg_leg.krylov.tangent_store_dtype == "bfloat16"
        est = _estimate_leg_bytes(
            dim, n_cells_est, restart=cfg_leg.krylov.restart,
            tangent_bf16=tangent_bf16,
        )
        free = _free_hbm_bytes()
        if est > 0.92 * free:
            extra[f"{tag}_skipped"] = (
                f"hbm: est {est/1e9:.1f} GB > 0.92 * free {free/1e9:.1f} GB"
            )
            print(f"# {tag} skipped (hbm est)", file=sys.stderr, flush=True)
            emit()
            return
        try:
            s2 = NavierStokesSolver(mesh_fn(), cfg_leg, log=RunLog(verbose=False))
            s2.setup()
            n2 = s2.dofs.n_total
            uo2 = s2.solution_old
            bv2 = jnp.asarray(s2.dirichlet.values(cfg_leg.dt), dtype=uo2.dtype)

            state2 = np.asarray(0.05 * rng.standard_normal(n2))

            def u_leg():  # a fresh array per call: the step donates it
                return jnp.asarray(state2, dtype=uo2.dtype)

            sync(s2._newton_iteration(u_leg(), uo2, bv2, cfg_leg.dt, True))
            t0 = time.perf_counter()
            out2 = sync(s2._newton_iteration(u_leg(), uo2, bv2, cfg_leg.dt, True))
            extra[f"n_dofs_{tag}"] = n2
            extra[f"newton_step_ms_{tag}"] = round(
                (time.perf_counter() - t0) * 1e3, 3
            )
            extra[f"gmres_iters_{tag}"] = int(out2[2])
            extra[f"gmres_converged_{tag}"] = bool(out2[3])
            extra[f"matvec_{tag}"] = s2._matvec
            del s2
            print(
                f"# {tag} {extra[f'newton_step_ms_{tag}']:.0f} ms "
                f"iters={extra[f'gmres_iters_{tag}']} n={n2}",
                file=sys.stderr, flush=True,
            )
        except Exception as e:
            extra[f"{tag}_error"] = _err_str(e)
        import gc

        gc.collect()
        emit()

    import dataclasses as _dc

    # bound the extra legs' tangent solves: healthy solves here take ~20
    # iterations, and an uncapped 2000-iteration runaway at >=1.5M DoF would
    # spend the bench's budget
    cfg_leg = _dc.replace(cfg, krylov=_dc.replace(cfg.krylov, max_iters=300))

    if BIG or HUGE:
        del solver
        big_path = "/root/reference/mesh/mesh_poli.msh"
        if os.path.exists(big_path):
            big_base = read_msh(big_path)
        else:  # generated channel: map the generator's tags 0/1/2-3
            big_base = rectangle(160, 80, 0, 7, 0, 4)
            cfg_leg = _dc.replace(
                cfg_leg, inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3)
            )
    if BIG:
        # the BASELINE.json "GMRES ms per Newton step at 1M DoF" metric:
        # mesh_poli (DFG channel) refined 2x -> ~1.78M DoF, one chip
        newton_leg(
            "big", lambda: refine_uniform(big_base, 2), cfg_leg,
            2, big_base.n_cells * 16,
        )
    if HUGE:
        # the h-robustness leg (VERDICT r2 #1): ~7.1M DoF, one device; the
        # outer FGMRES count must stay ~flat vs the 543k/1.78M legs (11-13
        # outer iterations in f32 on the previous accelerator).  bf16 tangent
        # store and cpb=512 / Bc=128 are that accelerator's capacity and
        # compile settings, kept until the leg is re-sized for this card.
        # Needs its own compile: reserve a larger minimum budget slice.
        cfg_huge = _dc.replace(
            cfg_leg,
            krylov=_dc.replace(
                cfg_leg.krylov, tangent_store_dtype="bfloat16",
                cells_per_block=int(os.environ.get("BENCH_CPB_HUGE", "512")),
                chunk_cells=int(os.environ.get("BENCH_BC_HUGE", "128")),
            ),
        )
        newton_leg(
            "huge", lambda: refine_uniform(big_base, 3), cfg_huge,
            2, big_base.n_cells * 64, min_budget_s=300,
        )
    if BENCH_3D:
        # 3D P2/P1 tets through the windowed + Cahouet-Chabard path
        # (VERDICT r2 #7, r3 #3).  The 3D tangent is stored bf16
        # (KrylovConfig.tangent_store_dtype), the single-device capacity mode.
        try:
            step_name = os.environ.get("BENCH_3D_MESH", "mesh-step-3.msh")
            step_path = f"/root/reference/mesh/{step_name}"
            if os.path.exists(step_path):
                m3_base = read_msh(step_path)
                tags = list(m3_base.tags)
            else:
                from navier_stokes_tpu.mesh.generate import box

                m3_base = box(8, 8, 8)
                tags = [0, 1, 2, 3, 4, 5]
            r3d = int(os.environ.get("BENCH_3D_REFINE", "2"))
            # cc_iters_a00=6 for the tet legs: the 3D sweep
            # (scripts/sweep_3d.py, step-3 refine=2) measured 23-24 outer
            # iterations vs 26 at the a00=4 default — the h-robustness
            # target — at +10% step time (1562 vs 1411 ms; both far below
            # round 4's 2381 ms / 40 iterations)
            cfg3 = _dc.replace(
                cfg_leg,
                inlet_tags=(tags[0],),
                neumann_tags=tuple(tags[1:2]),
                wall_tags=tuple(tags[2:]),
                krylov=_dc.replace(
                    cfg_leg.krylov, tangent_store_dtype="bfloat16",
                    cc_iters_a00=int(os.environ.get("BENCH_CC_A00_3D", "6")),
                ),
            )
            newton_leg(
                "3d", lambda: refine_uniform(m3_base, r3d), cfg3,
                3, m3_base.n_cells * 8**r3d, min_budget_s=240,
            )
            # stretch leg, DEFAULT OFF: the 3.75M-DoF step-5 mesh (858k
            # tets).  The midpoint home-block assignment leaves this mesh's
            # block occupancy ~1.5x imbalanced (Bmax rounds the max count up
            # to Bc); per-block occupancy balancing would bring pad toward
            # 1.1.  The memory gate (_estimate_leg_bytes) skips it when it
            # cannot fit.
            xl_name = os.environ.get("BENCH_3DXL_MESH", "mesh-step-5.msh")
            xl_path = f"/root/reference/mesh/{xl_name}"
            if os.environ.get("BENCH_3DXL", "0") != "0" and os.path.exists(xl_path):
                mxl_base = read_msh(xl_path)
                xtags = list(mxl_base.tags)
                # restart 40 for the 3.75M-DoF leg: frees ~0.6 GB of Krylov
                # basis vs 60 (fill-aware CGS2 makes the shorter window cost-
                # neutral; 3D solves run 23-33 iterations, within one cycle)
                cfgxl = _dc.replace(
                    cfg3,
                    inlet_tags=(xtags[0],),
                    neumann_tags=tuple(xtags[1:2]),
                    wall_tags=tuple(xtags[2:]),
                    krylov=_dc.replace(
                        cfg3.krylov,
                        restart=int(os.environ.get("BENCH_RESTART_3DXL", "40")),
                    ),
                )
                newton_leg(
                    "3dxl", lambda: refine_uniform(mxl_base, r3d), cfgxl,
                    3, mxl_base.n_cells * 8**r3d, min_budget_s=300,
                )
        except Exception as e:
            extra["3d_error"] = _err_str(e)
            emit()

    emit()  # the authoritative final line (identical to the last emit)


if __name__ == "__main__":
    sys.exit(main())
