"""Solver configuration: every hardcoded constant of the reference as a field.

The reference hardcodes everything (SURVEY §5 "Config/flag system: No"):
mesh path (cpp:15), nu/rho/p_out (hpp:703-709), degrees/T/dt (main.cpp:9-13),
boundary ids (cpp:320,357,367), solver tolerances (cpp:538,566,593).  This
dataclass is the single source of truth; ``default()`` reproduces the
reference's as-shipped run exactly, including its quirks (each has a flag).

Loadable from JSON/TOML via ``SolverConfig.from_file``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

__all__ = ["SolverConfig", "NewtonConfig", "KrylovConfig", "InletConfig"]


@dataclass
class NewtonConfig:
    max_iters: int = 1000  # cpp:593
    tol: float = 1e-2  # cpp:594 — ABSOLUTE residual tolerance
    damping: float = 1.0  # full step (cpp:616; damped variants commented out)
    # minimum tangent solves per time step.  With an ABSOLUTE tol, a
    # near-steady flow exits Newton at iteration 0 and the solution FREEZES
    # exactly — which quenches slowly-growing physics (e.g. the Karman
    # instability) below the tol amplitude.  min_iters=1 forces one
    # GMRES-corrected update per step regardless of the entry residual
    # (cheap: the solve stops at rel_tol of an already-small residual).
    min_iters: int = 0  # reference parity: 0 (cpp:593-612)


@dataclass
class KrylovConfig:
    rel_tol: float = 1e-2  # cpp:566: 1e-2 * ||rhs||
    # (see NewtonConfig.min_iters for the anti-freeze companion knob)
    max_iters: int = 2000  # practical cap (reference allows 100000, cpp:566)
    # FGMRES restart window.  Since the fill-aware CGS2 (la/gmres.py) the
    # window size no longer taxes per-iteration cost — orthogonalization
    # streams only the FILLED tiles of V — so 60 keeps the long-window
    # robustness (3D ~40-iteration solves, weakly-pinned channels)
    restart: int = 60
    preconditioner: str = "identity"  # cpp:570 | "block_diagonal" |
    # "block_triangular" | "cahouet_chabard" (windowed path only; our
    # flagship: pressure-Laplacian Schur for the mass-dominated tangent)
    # operator application: "flat" = gather/segment-sum over [nc, nl, nl];
    # "windowed" = the blocked-window operator (ops/windowed.py; requires
    # blocked dof renumbering, done automatically), which the
    # Cahouet-Chabard preconditioner, the steady driver and the
    # halo-exchange SPMD path are built on
    matvec: str = "flat"
    # windowed-layout block size (dofs owned per block follow from it).  The
    # solver's setup retry-doubles this until the halo fits, so
    # wide-bandwidth 3D meshes self-adjust upward.
    cells_per_block: int = 448
    # the padded per-block cell count Bmax is the largest block occupancy
    # rounded up to a multiple of this (at least 128)
    chunk_cells: int = 256
    # storage dtype of the preconditioner's sliced operator blocks (A00/B/Kp)
    # on the f32 path: "bfloat16" halves their memory reads — the dominant
    # per-outer-iteration cost (the CC apply streams the A00 block per inner
    # CG iteration).  The block matvec widens entries to f32 on read, so
    # accumulation precision is unchanged; only the stored block values are
    # rounded (~3e-3 relative — M only steers FGMRES).  "float32" restores
    # exact blocks.  Ignored on the f64 (CPU-parity) path.
    precond_block_dtype: str = "bfloat16"
    # storage dtype of the OUTER tangent operator A_t inside the unsteady
    # Newton tangent solve: "bfloat16" halves the dominant memory stream of
    # the outer FGMRES matvec (entries are widened to f32 on read, so
    # accumulation precision is unchanged; only the stored entries are
    # rounded, ~3e-3 relative).  The Newton RESIDUAL stays f32-exact, so
    # this is plain inexact-Newton: a 3e-3-relative Jacobian perturbation is
    # far below the rel_tol 1e-2 forcing term (cpp:566) and leaves the Newton
    # limit unchanged.  "auto" = bfloat16 iff the run is f32 AND
    # rel_tol >= 5e-3 (the reference-parity default); tighter tangent solves
    # (DFG production at 1e-3/1e-4, steady/Stokes parity paths) keep f32.
    operator_dtype: str = "auto"
    # STORAGE dtype of the assembled windowed tangent (A_const and the
    # per-iteration A_t it produces) on the f32 path: "bfloat16" halves the
    # two largest device-resident buffers of a windowed solve.  This is the
    # single-device capacity knob for 3D: at step-5 refine=2 (3.75M DoF
    # tets, nl=34) the f32 A_const + A_t alone are ~11 GB.  Numerics: the residual
    # (Newton RHS) is still assembled f32-exact — only the TANGENT entries
    # are rounded (~3e-3 relative), the same inexact-Newton perturbation as
    # operator_dtype="bfloat16" (which this subsumes: the operator is then
    # stored bf16 with no extra cast copy), far below the rel_tol 1e-2
    # forcing term.  Preconditioner blocks are sliced from the bf16 store
    # (they default to bf16 anyway, precond_block_dtype).  The raw-diagonal
    # extraction (Dirichlet bc_diag, Jacobi) widens to f32 before its
    # cross-cell accumulation.  Ignored on the f64 path.
    tangent_store_dtype: str = "float32"
    inner_tol: float = 1e-2  # hpp:542,599
    inner_max_iters: int = 2000  # hpp:598
    # cahouet_chabard inner sweep lengths (fixed-iteration coarse-corrected
    # Jacobi-CG on the velocity block and on the pressure-Laplacian Schur
    # term).  Outer FGMRES iterations per forced Newton step at the 543k
    # bench mesh (scripts/sweep_r5.py, f32 on the previous accelerator;
    # not yet rerun on the GPU):
    #   a00=2, ap=8  -> 21 outer iterations
    #   a00=3, ap=8  -> 16-18
    #   a00=4, ap=8  -> 14-16   <- default
    #   a00=4, ap=6  -> 16-17
    #   a00=1 or ap<6 degrade the outer count outright (29+ / 22+).
    # Whether the longer A00 sweep pays for itself in time depends on the
    # device's cost of an inner CG iteration against a saved outer
    # iteration; the defaults have not been re-timed on the GPU.  With
    # cc_coarse_agg_v the stronger sweep translates into outer-count wins at
    # every probed size.  Coarser aggregates (64) DEGRADE (211 outer
    # iterations at 1.78M).
    cc_iters_a00: int = 4
    cc_iters_ap: int = 8
    # inner-sweep preconditioner composition (when the matching coarse space
    # is built): "additive" = D^-1 + Z Kc^-1 Zt (no extra matvecs);
    # "vcycle" = symmetric multiplicative two-level V(1,1) — damped-Jacobi
    # smooth, coarse-correct the residual, smooth again (two extra bf16
    # block matvecs per application, but a much stronger contraction: the
    # additive form leaves the mid-range modes to the inner CG, whose
    # fixed iteration count is exactly what degrades as the mesh refines)
    cc_cycle_a00: str = "additive"
    cc_cycle_ap: str = "additive"
    # damped-Jacobi weight of the vcycle smoother (lambda_max(D^-1 A) < ~2
    # for FEM mass/stiffness blocks, so 0.7 keeps the smoother convergent)
    cc_vcycle_omega: float = 0.7
    # two-level coarse correction for the cahouet_chabard pressure-Laplacian
    # sweep: aggregate this many consecutive pressure dofs (SFC/blocked
    # numbering => spatially compact aggregates) into one piecewise-constant
    # coarse basis function; the coarse Galerkin matrix Zt Kp Z is inverted
    # densely ONCE on host and applied per CG iteration as one tiny dense
    # matmul (M^-1 = diag^-1 + Z Kc^-1 Zt, SPD).  0 disables (pure Jacobi).
    #
    # DEFAULT -1 = AUTO (r3): enable the coarse term (agg 128) only when the
    # f64 pinning probe certifies the mesh WELL-pinned (no Kp mode with
    # amplification > kp_deflate_min_amp).  On weakly outflow-pinned meshes
    # the refined Kp's coarse matrix develops a near-null mode whose Galerkin
    # inverse amplifies ~5e3x over the Jacobi term; the f32 outer FGMRES then
    # STALLS outright at >=1.78M DoF in every regime (measured on mesh_poli
    # refine=2: rel residual stuck at 0.18-0.96 after 300 iterations with
    # agg=128 / cond caps 1e2-1e4, vs CONVERGED in 18-19 iterations with the
    # coarse term off — scripts/sweep_hrobust.py); there the near-null modes
    # are handled exactly by kp_deflate instead, with plain Jacobi-CG Kp
    # sweeps + the A00 velocity coarse space keeping the outer count flat
    # (1.78M: 18).  Unpinned (enclosed) meshes skip the probe: coarse off.
    # On well-pinned meshes the coarse term is the measured winner (543k
    # cylinder: 17 outer iterations vs 45 without).  Explicit 0 disables,
    # explicit N>0 forces agg N.
    cc_coarse_agg: int = -1
    # two-level coarse correction for the A00 (velocity) inner sweeps: one
    # SCALAR coarse space shared by the velocity components, built from the
    # constant tangent block (mass/dt + viscous) with Dirichlet dofs
    # decoupled (fem/windowed_assembly).  This is the h-robustness knob for
    # the OUTER FGMRES count: with plain Jacobi sweeps the count grew
    # 17 -> 48 from 543k -> 1.78M DoF (the sweep contraction degrades as
    # nu*dt/h^2 grows); a fixed dofs-per-aggregate coarse space bounds the
    # sweep's condition number independent of h.  0 disables (round-2
    # behavior).  The run length is fitted to divide the layout's OWv so the
    # SPMD restriction stays on the dense reshape path.
    cc_coarse_agg_v: int = 256
    # EXPERIMENTAL outer-FGMRES deflation: compute this many of the pinned
    # pressure Laplacian's smallest eigenmodes (f64 shift-invert Lanczos on
    # host, once at setup), pair each with its constant-A00 velocity
    # response (an approximate invariant subspace of the saddle tangent),
    # and force the pairs into EVERY FGMRES restart cycle as fixed flexible
    # directions — GCRO-style augmentation targeting the weakly-pinned
    # channel's near-null Schur modes.
    #
    # DEFAULT 0 (off): measured on hardware, the augmentation does NOT move
    # the weakly-pinned stall (DFG refine=2 tangent floors at rel ~1e-3 in
    # f32 and ~1e-4 in f64 with or without it, raw modes or Schur pairs,
    # any restart), and it DEGRADES well-pinned tight-tolerance solves
    # (cylinder mesh f64 rel 1e-10: 235 -> 420+cap outer iterations) — the
    # forced slots displace Krylov directions without contributing.  Kept
    # as an opt-in for further study; the same eigsh probe powers the
    # cc_coarse_agg AUTO decision regardless of this flag.
    kp_deflate: int = 0
    kp_deflate_min_amp: float = 100.0
    # condition cap on the coarse Galerkin matrix: eigenvalues of Kc are
    # floored at max_eig/cap before inverting.  A weakly pinned Kp (short
    # outlet edge, long domain) leaves Kc a near-null mode whose uncapped
    # inverse amplifies ~1e5x against the O(1) Jacobi term — a mismatch with
    # the outer tangent's (mass-bounded) Schur complement that stalls the f32
    # FGMRES (measured: 1.78M-DoF big leg, 300-iteration stall vs 17 without
    # the coarse term; fem/windowed_assembly.py coarse construction).
    cc_coarse_cond_cap: float = 1e4
    # inner solver for the windowed Schur preconditioners' A00 sweeps
    # (cahouet_chabard, block_triangular, block_diagonal): "cg" matches the
    # reference (hpp:598) and is valid for the mass-dominated tangents of
    # small-dt time stepping; "gmres" (same cost per iteration) for
    # large-dt / steady-ish tangents where A00 is convection-dominated and
    # NONSYMMETRIC — CG there returns garbage directions that poison the
    # outer Krylov space (measured: total FGMRES stagnation with the
    # 60-iteration block_triangular CG sweep on DFG 2D-1 at dt=2)
    a00_solver: str = "cg"
    stokes_rel_tol: float = 1e-6  # cpp:538 (steady Stokes solve)
    # tangent-solve non-convergence policy: "warn" logs a structured failure
    # record; "raise" matches deal.II SolverControl::NoConvergence (cpp:566)
    on_failure: str = "warn"


@dataclass
class InletConfig:
    u_m: float = 1.5  # hpp:473
    H: float = 0.41  # hpp:474
    freeze_time: bool = True  # reference quirk: set_time never called (SURVEY C4)


@dataclass
class SolverConfig:
    # discretization (main.cpp:9-13)
    degree_velocity: int = 2
    degree_pressure: int = 1
    T: float = 1.0
    dt: float = 0.05

    # physics (hpp:703-709)
    nu: float = 0.001
    rho: float = 1.0
    p_out: float = 10.0

    # boundary ids (cpp:320,357,367-368; Stokes path uses 0/1/2/3, cpp:472,511,520)
    inlet_tags: tuple = (11,)
    wall_tags: tuple = (12, 13)
    neumann_tags: tuple = (10,)

    inlet: InletConfig = field(default_factory=InletConfig)
    newton: NewtonConfig = field(default_factory=NewtonConfig)
    krylov: KrylovConfig = field(default_factory=KrylovConfig)

    # reference-quirk flags (SURVEY §7 hard part 5) — defaults = parity
    convection_form: str = "reference"  # residual uses u^T grad u (cpp:297-301)
    include_continuity_residual: bool = False  # cpp:287-310 omits it
    jacobian_mass_rho: bool = False  # cpp:249-251 omits rho in the mass term
    # Newton Dirichlet handling: "increment" solves delta = g - u_k at
    # constrained rows (classic Newton BC; IDENTICAL to the reference when
    # g = 0, which is always true as shipped since the inlet is frozen at
    # sin(0)=0).  "reference" reproduces apply_boundary_values on the raw
    # tangent system (delta = g every iteration, cpp:375-376), which
    # double-applies a nonzero g across Newton iterations.
    dirichlet_mode: str = "increment"

    # initial condition for the time loop: "zero" reproduces the as-shipped
    # VectorTools::interpolate(u_0) (cpp:650); "stokes" enables the
    # reference's DESIGNED-but-commented path (cpp:636-644): solve steady
    # Stokes first and start Newton from it
    initial_guess: str = "zero"

    # time integrator: "bdf1" = implicit Euler (reference parity, cpp:249,
    # 629-679); "bdf2" = second-order backward differences — the framework's
    # own extension, needed for physics like DFG vortex shedding where
    # BDF1's numerical dissipation damps the Cl amplitude.  BDF2's first
    # step is an exact BDF1 residual solved with the BDF2 tangent
    # (quasi-Newton; the root is unchanged).
    time_scheme: str = "bdf1"

    # numerics
    dtype: str = "auto"  # "auto" | "float32" | "float64"
    quadrature_degree: int | None = None

    # output
    output_dir: str = "."
    write_output: bool = False
    output_every: int = 1

    @staticmethod
    def reference_run() -> "SolverConfig":
        """The exact as-shipped configuration (main.cpp:9-13 + defaults)."""
        return SolverConfig()

    @staticmethod
    def from_file(path: str) -> "SolverConfig":
        if path.endswith(".toml"):
            import tomllib

            with open(path, "rb") as f:
                raw = tomllib.load(f)
        else:
            with open(path) as f:
                raw = json.load(f)
        return SolverConfig.from_dict(raw)

    @staticmethod
    def from_dict(raw: dict) -> "SolverConfig":
        kw = dict(raw)
        for key, cls in (("inlet", InletConfig), ("newton", NewtonConfig), ("krylov", KrylovConfig)):
            if key in kw and isinstance(kw[key], dict):
                kw[key] = cls(**kw[key])
        for key in ("inlet_tags", "wall_tags", "neumann_tags"):
            if key in kw:
                kw[key] = tuple(kw[key])
        return SolverConfig(**kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
