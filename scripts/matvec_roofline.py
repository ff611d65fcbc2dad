"""Time the windowed full-system matvec on a GPU against the bytes it moves.

    python scripts/matvec_roofline.py [NX NY] [--trace DIR] [--newton-pairs N]

Sets up the 2D DFG channel of chip_smoke.py (default 1040 x 192 squares,
~1.8M DoF P2/P1), assembles an f32 tangent at a random state, and times, in
one process on one card:

  * the one-pass Pallas kernel that ``windowed_matvec`` runs for f32 on the
    GPU, against the plain gather / contract / scatter-add path (with the
    contraction as a multiply-and-sum, and as an einsum at
    Precision.HIGHEST), after checking the kernel against the plain path;
  * the same with the tangent stored in bf16 (the outer solve's default);
  * a large plain copy (read + write of 1 GiB), the bandwidth a simple
    kernel reaches on this card.

Each time is a warmed, jitted fori_loop of chained matvecs ending in
block_until_ready, divided by its length.  The mandatory bytes of a matvec
are A_t + x + y; the share printed is bytes/s over the copy's bytes/s and
over the published peak (bench.DEVICE_PEAKS).  With --trace DIR a profiler
trace of a few matvecs is written and its device time summed per kernel.
With --newton-pairs N, whole forced Newton steps (median of 3) are timed in
N alternating pairs of the kernel and the plain path.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed_loop(fn, consts, x, reps: int) -> float:
    """Seconds per call of fn(consts, x) in a jitted chained loop (warmed).
    Large arrays travel in ``consts`` as arguments, never as constants
    baked into the program."""
    import jax

    @jax.jit
    def loop(c, x0):
        return jax.lax.fori_loop(0, reps, lambda i, v: fn(c, v) * 1e-3, x0)

    jax.block_until_ready(loop(consts, x))  # compile + warm
    t0 = time.perf_counter()
    jax.block_until_ready(loop(consts, x))
    return (time.perf_counter() - t0) / reps


def device_kernel_times(trace_dir: str) -> Counter:
    """Device time (ns) per (trace line, event name) over the GPU planes;
    lines such as "XLA Ops" and the stream lines cover the same time, so
    shares are read within one line."""
    from jax.profiler import ProfileData

    totals: Counter = Counter()
    for path in glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True):
        for plane in ProfileData.from_file(path).planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                for ev in line.events:
                    totals[(line.name, ev.name)] += ev.duration_ns
    return totals


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("nx", type=int, nargs="?", default=1040)
    ap.add_argument("ny", type=int, nargs="?", default=192)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--trace", help="write a profiler trace of 5 matvecs here")
    ap.add_argument("--newton-pairs", type=int, default=0)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    import chip_smoke
    from navier_stokes_tpu.fem.windowed_assembly import assemble_windowed
    from navier_stokes_tpu.ops import windowed as W
    from navier_stokes_tpu.ops.windowed import (
        _gather, _scatter, windowed_matvec, windowed_matvec_block)
    from navier_stokes_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"matvec_roofline: needs a GPU, JAX found {dev.platform}", file=sys.stderr)
        return 2
    enable_compile_cache()
    print(f"device: {dev.device_kind}; nvidia-smi: {bench.gpu_power_limit()}", flush=True)

    s = chip_smoke.make_solver(
        chip_smoke.channel_mesh(args.nx, args.ny),
        chip_smoke.big_channel_config("float32"),
    )
    lay, wa, cfg = s._win_layout, s._wassembly, s.cfg
    A_t = jax.jit(
        lambda wa_, lay_, u_: assemble_windowed(
            wa_, lay_, u_, u_, dt=cfg.dt, nu=cfg.nu, rho=cfg.rho,
            convection_form=cfg.convection_form,
            include_continuity_residual=cfg.include_continuity_residual,
        )[0]
    )(wa, lay, chip_smoke.random_state(s, 1))
    A16 = A_t.astype(jnp.bfloat16)
    x = chip_smoke.random_state(s, 2)

    def mv_kernel(c, v):
        return windowed_matvec(c[0], c[1], v)

    def mv_plain(c, v):
        return windowed_matvec_block(c[0], c[1], v)

    def mv_einsum(c, v):
        lay_, A = c
        X = _gather(lay_, v, "vp", None)
        yl = jnp.einsum("jis,js->is", A[:, : lay_.nl].astype(v.dtype), X,
                        precision=jax.lax.Precision.HIGHEST)
        return _scatter(lay_, yl, "vp", None)

    copy_src = jnp.ones(2**28, jnp.float32)  # 1 GiB
    t_copy = timed_loop(lambda c, v: v * 1.0001, (), copy_src, 20)
    bw_copy = 2 * copy_src.nbytes / t_copy
    print(f"plain copy: {t_copy * 1e3:.3f} ms per 1 GiB read+write, "
          f"{bw_copy / 1e9:.1f} GB/s", flush=True)

    for name, A in (("f32 A", A_t), ("bf16 A", A16)):
        y0 = np.asarray(mv_plain((lay, A), x), np.float64)
        y1 = np.asarray(jax.jit(mv_kernel)((lay, A), x), np.float64)
        rel = np.linalg.norm(y1 - y0) / np.linalg.norm(y0)
        print(f"kernel vs plain [{name}]: relative 2-norm difference {rel:.3e}", flush=True)
        if not rel < 1e-5:
            print("matvec_roofline: the kernel disagrees with the plain path",
                  file=sys.stderr)
            return 1

    idx_bytes = lay.loc_v.nbytes + lay.loc_p.nbytes
    results = {}
    for name, A, fn in (
        ("kernel f32 A", A_t, mv_kernel),
        ("plain multiply-sum f32 A", A_t, mv_plain),
        ("plain einsum HIGHEST f32 A", A_t, mv_einsum),
        ("kernel bf16 A", A16, mv_kernel),
        ("plain multiply-sum bf16 A", A16, mv_plain),
        ("plain einsum HIGHEST bf16 A", A16, mv_einsum),
    ):
        t = timed_loop(fn, (lay, A), x, args.reps)
        nbytes = A.nbytes + 2 * x.nbytes
        results[name] = t
        print(f"matvec [{name}]: {t * 1e3:.3f} ms, mandatory bytes {nbytes} "
              f"(+ {idx_bytes} index bytes), {nbytes / t / 1e9:.1f} GB/s = "
              f"{nbytes / t / bw_copy:.3f} of the copy", flush=True)

    peak = bench.device_peaks(dev.device_kind)["hbm_bytes_per_s"]
    for name, t in results.items():
        A = A16 if "bf16" in name else A_t
        print(f"roofline share [{name}]: "
              f"{(A.nbytes + 2 * x.nbytes) / peak / t:.3f} of {peak / 1e12:.2f} TB/s")

    y = jax.jit(windowed_matvec)
    ma = y.lower(lay, A_t, x).compile().memory_analysis()
    print(f"matvec memory_analysis: temp {ma.temp_size_in_bytes} B "
          f"(A_t {A_t.nbytes} B)", flush=True)
    if args.trace:
        jax.block_until_ready(y(lay, A_t, x))
        with jax.profiler.trace(args.trace):
            for _ in range(5):
                x = jax.block_until_ready(y(lay, A_t, x) * 1e-3)
        total = device_kernel_times(args.trace)
        per_line = Counter()
        for (line, _), ns in total.items():
            per_line[line] += ns
        for line, line_ns in per_line.most_common():
            print(f"trace line {line!r}: {line_ns / 5e6:.3f} ms per matvec")
            for (ln, ev), ns in total.most_common():
                if ln == line and ns >= 0.02 * line_ns:
                    print(f"  {ns / 5e6:9.3f} ms  {ns / line_ns:6.1%}  {ev[:100]}")
    if args.newton_pairs:
        newton_pairs(s, args.newton_pairs, W)
    return 0


def newton_pairs(s, pairs: int, W) -> None:
    """Forced Newton steps, median of 3, in alternating pairs of the
    one-pass kernel and the plain path for the outer operator."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import chip_smoke

    bc_vals = jnp.asarray(s.dirichlet.values(s.cfg.dt), s._dtype)
    kernel = W.windowed_matvec

    def compiled_step():
        s._build_kernels()  # a fresh jit picks up the current operator
        args = s._newton_args(chip_smoke.random_state(s, 0), s.solution_old,
                              bc_vals, s.cfg.dt, True)
        return s._newton_jit.lower(*args).compile()

    steps = {"kernel": compiled_step()}
    W.windowed_matvec = lambda lay, A, x, axis_name=None: W.windowed_matvec_block(
        lay, A, x, axis_name=axis_name)
    try:
        steps["plain"] = compiled_step()
    finally:
        W.windowed_matvec = kernel
    wins = 0
    for pair in range(pairs):
        t = {}
        for label in (("plain", "kernel") if pair % 2 == 0 else ("kernel", "plain")):
            times, iters = [], []
            for r in range(3):
                a = s._newton_args(chip_smoke.random_state(s, r + 1), s.solution_old,
                                   bc_vals, s.cfg.dt, True)
                t0 = time.perf_counter()
                out = jax.block_until_ready(steps[label](*a))
                times.append(time.perf_counter() - t0)
                iters.append(int(out[2]))
            t[label] = float(np.median(times))
            print(f"pair {pair} forced Newton step {label}: median "
                  f"{t[label] * 1e3:.2f} ms of 3, FGMRES iterations {iters}", flush=True)
        wins += t["kernel"] < t["plain"]
    print(f"kernel faster in {wins} of {pairs} pairs", flush=True)


if __name__ == "__main__":
    sys.exit(main())
