"""Blocked (windowed) Navier-Stokes assembly: cells last, windowed gathers.

The natural batched assembly (fem/assembly.py) mirrors the reference's cell
loop (/root/reference/src/NavierStokesSolver.cpp:178-378) with [nc, nl, nl]
arrays.  This module assembles the SAME terms directly in the windowed
operator layout, so the matvec consumes its output with no reordering:

  * solution values at cell dofs come from ``ops.windowed.windowed_gather``
    (one gather over the block windows);
  * every contraction is batched over the block-ordered cell axis placed
    LAST, so each per-cell read is contiguous across cells;
  * u-independent terms (mass/dt, viscous stiffness, divergence couplings)
    are precomputed ONCE into ``A_const`` — each Newton iteration only adds
    the two convection blocks and the residual;
  * per-cell geometry is the 9-float ``invJT_t`` (inverse-transpose
    Jacobian), NOT a per-(basis, qpt) physical-gradient table: every
    gradient contraction goes through the tiny replicated reference table
    ``G_v`` first, so the per-cell memory is O(dim^2) instead of
    O(k_v * nq * dim) — the term that made 3D (k_v=10, nq=27) single-chip
    infeasible;
  * ``store_dtype=bfloat16`` keeps A_const (and the A_t each assembly
    emits) half-width — the single-chip capacity mode for large problems;
  * the residual reduction uses ``windowed_scatter`` (per-block window
    accumulation merged by aligned shifted adds; every cell counted exactly
    once), plus precomputed constant contributions (outlet Neumann traction
    of cpp:314-336, forcing).

Output is A_t [nl, nli, nb*Bmax] — the windowed matvec consumes it as-is.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.windowed import WindowedLayout, windowed_gather, windowed_scatter

_PREC = jax.lax.Precision.HIGHEST  # full f32: a GPU f32 dot may run in TF32

__all__ = ["WindowedAssembly", "build_windowed_assembly", "assemble_windowed"]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class WindowedAssembly:
    """Precomputed device arrays for blocked assembly (cells-last layout)."""

    # tabulations (tiny, replicated)
    N_v: jax.Array  # [k_v, nq]
    N_p: jax.Array  # [k_p, nq]
    NN: jax.Array  # [k_v, k_v, nq]  N_i N_j products
    G_v: jax.Array  # [k_v, nq, dim]  REFERENCE velocity-basis gradients
    # per-cell geometry, cells last.  Physical gradients are
    # NOT stored per (basis, qpt) — a [k_v, nq, dim, ncd] table is ~3.4 GB
    # at 858k 3D tets (k_v=10, nq=27; VERDICT r3 #3's dominant term) — they
    # are recontracted in-kernel from the replicated reference table G_v and
    # this 9-floats-per-cell inverse-transpose Jacobian:
    #   Gp[b, q, d, c] = sum_a invJT_t[d, a, c] * G_v[b, q, a]
    # with every einsum in assemble_windowed restructured to contract G_v
    # FIRST (small [*, nq, dim, ncd] intermediates, never the k_v-sized one).
    invJT_t: jax.Array  # [dim, dim, ncd]
    W_t: jax.Array  # [nq, ncd] quadrature jxw (zero on padded slots is NOT
    # needed: padded slots never scatter and their A values are never read)
    # u-independent part of the tangent matrix, windowed layout
    A_const: jax.Array  # [nl, nli, ncd]
    # constant residual contributions: outlet Neumann traction + forcing
    r_const: jax.Array  # [n_total]
    # lumped inverse pressure mass (Schur surrogate, psi_i psi_j / nu)
    inv_mp: jax.Array  # [n_ps]
    # pressure Laplacian grad psi_i . grad psi_j in block layout (the
    # Cahouet-Chabard Schur term; constant, geometry-only) + its assembled
    # diagonal (Jacobi for the inner Poisson sweeps)
    Kp_t: jax.Array  # [k_p, roundup(k_p, 8), ncd]
    diag_kp: jax.Array  # [n_ps]
    dim: int = field(metadata=dict(static=True))
    # two-level coarse correction for the Kp sweeps (KrylovConfig.
    # cc_coarse_agg): global aggregate id per pressure dof (holes -> sentinel
    # m, dropped) and the dense inverse of the coarse Galerkin matrix
    # Zt Kp Z [m, m].  None when disabled.
    agg_p: jax.Array | None = None  # [n_ps] int32, values in [0, m]
    coarse_inv: jax.Array | None = None  # [m, m]
    # aggregate run length: aggregates are CONTIGUOUS runs of this many
    # pressure dofs, so single-device restriction/prolongation is a dense
    # reshape-sum/broadcast instead of a segment_sum scatter
    coarse_agg_size: int = field(default=0, metadata=dict(static=True))
    # two-level coarse correction for the A00 (velocity) inner sweeps
    # (KrylovConfig.cc_coarse_agg_v): one SCALAR coarse space shared by all
    # velocity components (the constant block mass/dt + nu*rho*K is
    # component-diagonal with identical blocks).  This is what makes the
    # outer FGMRES iteration count h-robust: with plain Jacobi the sweep's
    # contraction degrades as nu*dt/h^2 grows (measured 17 -> 48 outer
    # iterations from 543k -> 1.78M DoF, VERDICT r2), while a fixed
    # dofs-per-aggregate coarse space bounds the preconditioned condition
    # number independent of h.
    agg_v: jax.Array | None = None  # [n_vs] int32, values in [0, m_v]
    coarse_inv_v: jax.Array | None = None  # [m_v, m_v]
    coarse_agg_size_v: int = field(default=0, metadata=dict(static=True))
    # near-null modes of the pinned pressure Laplacian, embedded as FULL
    # planar vectors (velocity part zero), unit-normalized — the outer
    # FGMRES deflation space (KrylovConfig.kp_deflate).  A weakly
    # outflow-pinned Kp (short outlet edge, long channel) has modes with
    # 1e3-1e4x amplification whose Schur response neither a stable f32
    # preconditioner nor a restarted Krylov space can carry; forcing the
    # raw directions into every FGMRES cycle handles them exactly.
    kp_modes: jax.Array | None = None  # [k_d, n_total]


def _capped_spd_inverse(Kc: np.ndarray, cond_cap: float) -> np.ndarray:
    """Spectral-floored SPD inverse: eigenvalues floored at max_eig/cond_cap.

    Guards (ADVICE r2): eigh on a pathological coarse matrix can fail to
    converge — retry once with a diagonal shift; a degenerate coarse space
    (w_max <= 0) would flip the floor's sign and break SPD — floor against a
    trace-scaled tiny positive value instead.
    """
    m = Kc.shape[0]
    try:
        w, V = np.linalg.eigh(Kc)
    except np.linalg.LinAlgError:
        shift = 1e-8 * max(float(np.trace(Kc)) / max(m, 1), 1.0)
        w, V = np.linalg.eigh(Kc + shift * np.eye(m))
    tiny = 1e-12 * max(abs(float(np.trace(Kc))) / max(m, 1), 1.0)
    w_max = max(float(w[-1]), tiny)
    w = np.maximum(w, w_max / float(cond_cap))
    return (V / w) @ V.T


def _fit_agg_to_ow(s: int, OW: int) -> int:
    """Smallest multiple of 128 dividing OW that is >= s (OW qualifies).

    Keeps aggregate runs aligned to the per-device owned ranges (nb_loc * OW),
    so the SPMD coarse restriction stays on the dense reshape path
    (la/preconditioners.coarse_correction)."""
    for d in range(1, OW // 128 + 1):
        c = d * 128
        if OW % c == 0 and c >= s:
            return c
    return OW


def _pin_cell_mats(M: np.ndarray, cell_dofs: np.ndarray, pinned: np.ndarray) -> np.ndarray:
    """Decouple pinned dofs in per-cell matrices: zero their off-diagonal
    rows/cols in every copy, keep each copy's own diagonal entry.

    M: [k, k, nv]; cell_dofs: [nv, k]; pinned: [n_dofs] bool."""
    k = M.shape[0]
    alive = ~pinned[cell_dofs]  # [nv, k]
    out = M.copy()
    diag_save = out[np.arange(k), np.arange(k), :].copy()
    out *= alive.T[:, None, :]
    out *= alive.T[None, :, :]
    out[np.arange(k), np.arange(k), :] = diag_save
    return out


def _coarse_space(
    cell_mats: np.ndarray,
    cell_dofs: np.ndarray,
    n_dofs: int,
    mask: np.ndarray | None,
    s_agg: int,
    cond_cap: float,
    shift_nullspace: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Aggregation coarse space: contiguous runs of ``s_agg`` dofs, Galerkin
    coarse matrix Kc = Zt A Z assembled from the SAME (pinned) cell copies the
    windowed operator scatters, dense spectrally-capped inverse.

    cell_mats: [k, k, nv] valid-copy cell matrices; cell_dofs: [nv, k];
    mask: real-dof mask (padding holes -> sentinel aggregate m, dropped).
    Returns (agg [n_dofs] int64 in [0, m], coarse_inv [m, m])."""
    m = -(-n_dofs // s_agg)
    agg = np.arange(n_dofs, dtype=np.int64) // s_agg
    if mask is not None:
        agg = np.where(np.asarray(mask, bool), agg, m)
    a_cell = agg[np.asarray(cell_dofs, np.int64)]
    nv, k = a_cell.shape
    ii = np.broadcast_to(a_cell[:, :, None], (nv, k, k))
    jj = np.broadcast_to(a_cell[:, None, :], (nv, k, k))
    Kc = np.zeros((m + 1, m + 1))
    np.add.at(Kc, (ii.ravel(), jj.ravel()), cell_mats.transpose(2, 0, 1).ravel())
    Kc = Kc[:m, :m]
    d = np.diagonal(Kc).copy()
    Kc[np.arange(m), np.arange(m)] = np.where(d > 0, d, 1.0)  # all-hole aggs
    if shift_nullspace:
        # pure-Neumann operator: shift off the constant nullspace
        # (preconditioner quality is insensitive to the exact shift)
        Kc[np.arange(m), np.arange(m)] += 1e-6 * (np.trace(Kc) / m)
    Kc = 0.5 * (Kc + Kc.T)
    return agg, _capped_spd_inverse(Kc, cond_cap)


def _kp_near_null_modes(
    Kp_cells: np.ndarray,
    cell_pdofs: np.ndarray,
    n_ps: int,
    p_mask,
    diag_kp: np.ndarray,
    k_req: int,
    min_amp: float,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Smallest eigenmodes of the assembled pinned pressure Laplacian with
    amplification ``median(diag)/lambda > min_amp`` — the directions that
    stall restarted f32 FGMRES (see KrylovConfig.kp_deflate).

    Kp_cells: [k_p, k_p, nv] pinned per-cell matrices (valid copies);
    computed in f64 on host via shift-invert Lanczos (scipy); returns
    ([k_kept, n_ps] unit rows, [k_kept] amplifications) sorted by
    descending amplification (k_kept may be 0: probe ran, Kp is
    WELL-pinned) or None (probe itself failed)."""
    try:
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        k_p, _, nv = Kp_cells.shape
        cd = np.asarray(cell_pdofs, np.int64)
        ii = np.broadcast_to(cd[:, :, None], (nv, k_p, k_p))
        jj = np.broadcast_to(cd[:, None, :], (nv, k_p, k_p))
        A = sp.coo_matrix(
            (Kp_cells.transpose(2, 0, 1).ravel(), (ii.ravel(), jj.ravel())),
            shape=(n_ps, n_ps),
        ).tocsr()
        # decouple padding holes at the median diagonal scale (their
        # eigenvalues then sit mid-spectrum, never near-null)
        d = np.asarray(A.diagonal())
        scale = float(np.median(d[d > 0])) if np.any(d > 0) else 1.0
        hole = d <= 0
        if p_mask is not None:
            hole |= ~np.asarray(p_mask, bool)
        if hole.any():
            A = A + sp.diags(np.where(hole, scale, 0.0))
        A = 0.5 * (A + A.T)
        k = min(int(k_req), n_ps - 2)
        w, V = spla.eigsh(A.tocsc(), k=k, sigma=0.0, which="LM")
        # keep only WEAKLY-pinned modes: exact/near-exact nullspace
        # (amplification ~1/eps) is the enclosed-domain constant mode, which
        # the preconditioner's shift machinery already handles — deflating it
        # injects a (near-)nullspace direction of the full saddle system into
        # the basis and degrades the solve (measured: enclosed-cavity Newton
        # residual 3x worse)
        keep = (w < scale / float(min_amp)) & (w > scale * 1e-10)
        if not keep.any():
            # probe ran: WELL-pinned Kp
            return np.zeros((0, n_ps)), np.zeros(0)
        V, w = V[:, keep], w[keep]
        order = np.argsort(w)  # ascending eigenvalue = descending amp
        V, w = V[:, order], w[order]
        V = V / np.linalg.norm(V, axis=0, keepdims=True)
        if p_mask is not None:
            V = V * np.asarray(p_mask, float)[:, None]
        return V.T, scale / w  # [k_kept, n_ps], [k_kept]
    except Exception as e:  # pragma: no cover - scipy/convergence issues
        import warnings

        warnings.warn(f"kp_deflate: eigsh failed ({e}); deflation disabled")
        return None


def _kp_mode_velocity_responses(
    blk_v: np.ndarray,
    cvd: np.ndarray,
    D_valid: np.ndarray,
    modes: np.ndarray,
    cpd: np.ndarray,
    n_vs: int,
    v_mask,
) -> np.ndarray | None:
    """u_w = A00c^-1 (B^T w) per near-null Kp mode w — the velocity half of
    the Schur pair (f64 host CG, once at setup).

    Why pairs: augmenting FGMRES with the raw pressure mode z1 = (0, w)
    alone is USELESS for the saddle tangent (measured: zero effect on the
    1.78M stall): A z1 = (B^T w, 0) lands in velocity space, far outside
    span{z1}, so the cycle must still resolve the coupling — and restarts
    lose it again.  With z2 = (A00c^-1 B^T w, 0) also in the space,
    A (z2 - z1) = (0, -S w) is NEAR-NULL (S w = B A00^-1 B^T w is tiny for a
    weakly-pinned near-constant w), i.e. span{z1, z2} is an approximate
    invariant subspace of the tangent — exactly what GCRO-style augmentation
    requires to remove a slow mode.

    blk_v: [k_v, k_v, nv] pinned constant velocity block (per valid cell);
    D_valid: [dim, k_p, k_v, nv] divergence coupling on the same cells;
    modes: [k_m, n_ps].  Returns [k_m, dim, n_vs] responses or None on
    solver failure."""
    try:
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        k_v = blk_v.shape[0]
        cd = np.asarray(cvd, np.int64)
        ii = np.broadcast_to(cd.T[:, None, :], (k_v, k_v, cd.shape[0]))
        jj = np.broadcast_to(cd.T[None, :, :], (k_v, k_v, cd.shape[0]))
        A = sp.coo_matrix(
            (blk_v.ravel(), (ii.ravel(), jj.ravel())), shape=(n_vs, n_vs)
        ).tocsr()
        d = np.asarray(A.diagonal())
        scale = float(np.median(d[d > 0])) if np.any(d > 0) else 1.0
        dead = d <= 0
        if v_mask is not None:
            dead |= ~np.asarray(v_mask, bool)
        if dead.any():
            A = A + sp.diags(np.where(dead, scale, 0.0))
        A = (0.5 * (A + A.T)).tocsr()
        dinv = 1.0 / np.asarray(A.diagonal())
        M = spla.LinearOperator(A.shape, matvec=lambda r: dinv * r)

        dim = D_valid.shape[0]
        out = np.zeros((modes.shape[0], dim, n_vs))
        for m_i, w in enumerate(modes):
            wc = w[np.asarray(cpd, np.int64)]  # [nv, k_p]
            for a in range(dim):
                # velocity-row image of (0, w): rows a of A_const carry -D
                r_cells = -np.einsum("pic,cp->ci", D_valid[a], wc)
                rhs = np.zeros(n_vs)
                np.add.at(rhs, cd.ravel(), r_cells.ravel())
                rhs[dead] = 0.0
                u, info = spla.cg(A, rhs, M=M, rtol=1e-10, maxiter=5000)
                if info != 0:
                    raise RuntimeError(f"A00 CG info={info}")
                out[m_i, a] = u
        return out
    except Exception as e:  # pragma: no cover - scipy/convergence issues
        import warnings

        warnings.warn(f"kp_deflate pairing: velocity response failed ({e})")
        return None


def compute_r_const(ctx, p_out, f_q=None) -> np.ndarray:
    """Solution-independent residual terms in the ctx's (natural/blocked)
    numbering: outlet Neumann traction (cpp:314-336) + forcing.  f_q
    overrides ctx.f_q — the hook for time-dependent forcing, where the solver
    re-evaluates this each step and swaps wa.r_const (a pytree leaf, so no
    recompile)."""
    from .assembly import _neumann_residual

    r = np.asarray(jax.device_get(_neumann_residual(ctx, p_out)), np.float64)
    f_q = np.asarray(ctx.f_q if f_q is None else f_q, np.float64)
    if np.any(f_q):
        N_v = np.asarray(ctx.N_v, np.float64)
        NvW = np.einsum("iq,cq->ciq", N_v, np.asarray(ctx.jxw, np.float64))
        r_f = np.einsum("cqa,ciq->cai", f_q, NvW)
        nc = r_f.shape[0]
        flat = np.zeros(ctx.n_total)
        cd = np.asarray(ctx.cell_dofs, np.int64)[:, : ctx.dim * ctx.nb_v]
        np.add.at(flat, cd.ravel(), r_f.reshape(nc, -1).ravel())
        r = r + flat
    return r


def build_windowed_assembly(ctx, lay: WindowedLayout, dofs, *, dt, nu, rho, p_out,
                            jacobian_mass_rho=False, terms="navier_stokes",
                            pin_pdofs=None, coarse_agg=0, coarse_agg_v=0,
                            pin_vdofs=None, coarse_cond_cap=1e4,
                            kp_deflate=0, kp_deflate_min_amp=100.0,
                            store_dtype=None):
    """Precompute geometry + constant terms from a FEMContext (natural order).

    ctx: fem.assembly.FEMContext on the SAME blocked-renumbered dofs.
    terms: "navier_stokes" (mass/dt + viscous + divergence) or "stokes"
    (viscous + divergence only, cpp:380-531).
    pin_pdofs: pressure dofs at which the Cahouet-Chabard Laplacian Kp is
    decoupled (off-diagonal row/col entries zeroed, assembled diagonal kept)
    — the outflow pinning that makes the otherwise pure-Neumann Kp SPD
    nonsingular, so the inner Jacobi-CG sweeps cannot blow up along the
    constant-pressure nullspace.
    coarse_agg / coarse_agg_v: aggregate run lengths of the two-level coarse
    spaces for the Kp and A00 inner sweeps (0 disables either).
    pin_vdofs: scalar velocity dofs decoupled in the A00 coarse Galerkin
    matrix (the Dirichlet set, matching the bc-row substitution the inner
    A00 matvec applies).
    store_dtype: device storage dtype of A_const (None = ctx dtype).
    bfloat16 halves the largest resident buffer — and assemble_windowed
    emits A_t in A_const's dtype, halving the second-largest too (the 3D
    single-chip capacity lever, KrylovConfig.tangent_store_dtype).
    """
    from .assembly import _neumann_residual

    dtype = ctx.jxw.dtype
    dim, k_v, k_p = ctx.dim, ctx.nb_v, ctx.nb_p
    nl = dim * k_v + k_p
    nli = lay.nli
    ids = np.asarray(lay.cell_ids).reshape(-1)  # [ncd]
    ncd = len(ids)

    N_v = np.asarray(ctx.N_v, np.float64)  # [k_v, nq]
    G_v = np.asarray(ctx.G_v, np.float64)  # [k_v, nq, dim]
    N_p = np.asarray(ctx.N_p, np.float64)
    invJT = np.asarray(ctx.invJT, np.float64)[ids]  # [ncd, dim, dim]
    W_t = np.asarray(ctx.jxw, np.float64)[ids].T  # [nq, ncd]
    NN = np.einsum("iq,jq->ijq", N_v, N_v)

    # pressure-basis reference gradients at a matching quadrature (P1
    # gradients are constant, so the exact point set is immaterial as long
    # as the count pairs with W_t)
    from .quadrature import gauss_simplex

    nq = N_p.shape[1]
    for deg in range(1, 12):
        quad = gauss_simplex(dim, deg)
        if quad.n_points == nq:
            break
    else:
        raise ValueError(f"no simplex rule with {nq} points for Kp tabulation")
    _, G_p = dofs.element.pressure.tabulate(quad.points)  # [k_p, nq, dim]
    G_p = np.asarray(G_p, np.float64)

    # ---- constant tangent terms (A_t[j, i, c] = cell_mat[i, j]) ----------
    # Assembled in CELL CHUNKS: the per-(basis, qpt) physical-gradient table
    # Gp[b, q, d, c] is a transient of each chunk, never a full-ncd array —
    # at 3D scale (k_v=10, nq=27, ncd ~1M) the full table is multi-GB in
    # f64 and the un-optimized einsum path is minutes on one host core;
    # chunked optimize=True einsums are BLAS-backed and bounded-memory.
    if terms == "navier_stokes":
        mass_coef = (rho if jacobian_mass_rho else 1.0) / dt
    elif terms == "stokes":
        mass_coef = 0.0
    else:
        raise ValueError(terms)
    A_const = np.zeros((nl, nli, ncd))
    diag_blk = np.empty((k_v, k_v, ncd))  # constant velocity block (reused
    # below for the A00 coarse space and the kp-mode velocity responses)
    D = np.empty((dim, k_p, k_v, ncd))  # divergence coupling (ditto)
    Kp = np.empty((k_p, k_p, ncd))  # pressure Laplacian (CC Schur term)
    CHUNK = 1 << 16
    for lo in range(0, ncd, CHUNK):
        sl = slice(lo, min(lo + CHUNK, ncd))
        Gp = np.einsum("cda,bqa->bqdc", invJT[sl], G_v, optimize=True)
        Wc = W_t[:, sl]
        K_c = np.einsum("iqbc,jqbc,qc->ijc", Gp, Gp, Wc, optimize=True)
        if mass_coef:
            M_c = np.einsum("ijq,qc->ijc", NN, Wc, optimize=True)
            diag_blk[:, :, sl] = mass_coef * M_c + (nu * rho) * K_c
        else:  # steady/Stokes path: skip the zero-coefficient mass chunk
            diag_blk[:, :, sl] = (nu * rho) * K_c
        D[:, :, :, sl] = np.einsum("iqac,jq,qc->ajic", Gp, N_p, Wc,
                                   optimize=True)
        Gpp = np.einsum("cda,bqa->bqdc", invJT[sl], G_p, optimize=True)
        Kp[:, :, sl] = np.einsum("iqbc,jqbc,qc->ijc", Gpp, Gpp, Wc,
                                 optimize=True)
    for a in range(dim):
        sl = slice(a * k_v, (a + 1) * k_v)
        A_const[sl, sl, :] = diag_blk
        # B^T: row (a, i_v), col (p, j_p) -> A_t[dim*k_v + j, a*k_v + i]
        A_const[dim * k_v : nl, sl, :] = -D[a]
        # B: row (p, i_p), col (a, j_v) -> A_t[a*k_v + j, dim*k_v + i]
        A_const[sl, dim * k_v : nl, :] = -D[a].transpose(1, 0, 2)

    # ---- constant residual: Neumann traction + forcing -------------------
    r_const = compute_r_const(ctx, p_out)

    # ---- lumped inverse pressure mass (Mp = psi_i psi_j / nu) ------------
    jxw_nat = np.asarray(ctx.jxw, np.float64)
    mp_rows = np.einsum("iq,cq->ci", N_p, jxw_nat) / nu  # row sums per cell
    lumped = np.zeros(dofs.n_ps)
    cp = np.asarray(ctx.cell_dofs[:, -k_p:], np.int64) - dofs.n_u
    np.add.at(lumped, cp.ravel(), mp_rows.ravel())
    inv_mp = np.where(lumped > 0, 1.0 / np.where(lumped > 0, lumped, 1.0), 1.0)

    # ---- pressure Laplacian Kp (Cahouet-Chabard Schur term) --------------
    # per-cell matrices computed in the chunked loop above
    k_p8 = -(-k_p // 8) * 8
    Kp_t = np.zeros((k_p, k_p8, len(ids)))
    Kp_t[:, :k_p, :] = Kp
    # assembled diagonal: accumulate only each cell's HOME copy (ids are
    # unique per cell, padding slots excluded)
    diag_kp = np.zeros(dofs.n_ps)
    valid = lay.valid_slots().reshape(-1)
    cpd = np.asarray(dofs.cell_pdofs, np.int64)[ids[valid]]
    np.add.at(diag_kp, cpd.ravel(), Kp[np.arange(k_p), np.arange(k_p)].T[valid].ravel())
    diag_kp = np.where(diag_kp > 0, diag_kp, 1.0)

    # outflow pinning: decouple pinned pressure dofs (zero their off-diagonal
    # rows/cols in every cell copy, keep each copy's own diagonal entry so the
    # assembled diagonal — and diag_kp — are unchanged)
    if pin_pdofs is not None and len(pin_pdofs):
        pinned = np.zeros(dofs.n_ps, dtype=bool)
        pinned[np.asarray(pin_pdofs, np.int64)] = True
        alive = ~pinned[np.asarray(dofs.cell_pdofs, np.int64)[ids]]  # [ncd, k_p]
        diag_save = Kp_t[np.arange(k_p), np.arange(k_p), :].copy()
        Kp_t[:k_p] *= alive.T[:, None, :]
        Kp_t[:, :k_p] *= alive.T[None, :, :]
        Kp_t[np.arange(k_p), np.arange(k_p), :] = diag_save

    # ---- two-level coarse space for the Kp sweeps -------------------------
    # Piecewise-constant aggregation over runs of coarse_agg consecutive
    # pressure dofs (the blocked/SFC numbering makes runs spatially compact).
    # Kc = Zt Kp_pinned Z is assembled from the SAME valid cell copies the
    # windowed operator scatters, so the coarse matrix is the exact Galerkin
    # restriction of the operator the CG sweep sees; its dense inverse is a
    # host one-time cost (m capped at 4096).
    #
    # The inverse is spectrally floored: cond(Kc) is capped at
    # coarse_cond_cap before inverting.  A weakly pinned Kp (e.g. mesh_poli's
    # short outlet edge at the end of the long DFG channel, refined 2x)
    # leaves Kc with a near-null mode — measured eig(Kc^-1) up to 5.1e3 vs
    # <=24 on the well-pinned cylinder mesh — and the correction then
    # amplifies that mode ~128*5e3 against the O(1) Jacobi term.  The outer
    # tangent's Schur complement does NOT share that near-singularity (its
    # pressure-mass term bounds it), so the mismatched amplification poisons
    # the f32 Krylov basis: the 1.78M-DoF tangent solve stalled at 1.6x its
    # tolerance for 300 FGMRES iterations with the uncapped inverse vs 17
    # iterations with the coarse term disabled.  Flooring keeps the
    # correction SPD, leaves well-conditioned coarse spaces untouched
    # (cylinder mesh: cond 1.4e4 -> barely clipped), and restores big-leg
    # convergence.
    # ---- pinning-quality probe + outer-FGMRES deflation modes -------------
    # One f64 host eigsh of the pinned Kp serves two decisions:
    #   * kp_modes: weakly-pinned near-null modes forced into every FGMRES
    #     cycle (kp_deflate) — unrepresentable by a stable f32 preconditioner;
    #   * coarse_agg < 0 (AUTO): enable the Kp coarse correction only when
    #     the worst amplification stays below ~5e5.  Calibration (measured
    #     2026-08, f64 eigsh amp = median(diag)/lambda_min): cylinder mesh
    #     refine=2 amp 1.4e5 -> coarse WORKS (17 outer iters vs 45 without);
    #     DFG channel refine<=1 amp <=3.2e5 -> works (validated production
    #     config); DFG refine=2 amp 1.3e6 -> coarse STALLS the f32 outer
    #     solve outright (the Galerkin inverse's amplified response x f32
    #     eps ~ the solve tolerance).  Unpinned (enclosed) domains keep the
    #     shift-handled exact nullspace and the probe is skipped: coarse off.
    AMP_COARSE_CUTOFF = 5e5
    pinned_kp = pin_pdofs is not None and len(pin_pdofs) > 0
    probe, probe_amps = None, None
    if pinned_kp and dim == 2 and (
        (kp_deflate and kp_deflate > 0) or (coarse_agg is not None and coarse_agg < 0)
    ):
        res = _kp_near_null_modes(
            Kp_t[:, :k_p, :][:, :, valid], cpd, dofs.n_ps, dofs.p_mask,
            diag_kp, max(int(kp_deflate), 2), kp_deflate_min_amp,
        )
        if res is not None:
            probe, probe_amps = res
    if coarse_agg is not None and coarse_agg < 0:
        coarse_safe = probe is not None and (
            probe.shape[0] == 0 or float(probe_amps.max()) < AMP_COARSE_CUTOFF
        )
        coarse_agg = 128 if coarse_safe else 0

    kp_modes = None
    if kp_deflate and kp_deflate > 0 and probe is not None and probe.shape[0]:
        modes = probe[: int(kp_deflate)]
        rows = []
        # Schur PAIRS: each near-null pressure mode w enters with its
        # constant-A00 velocity response u_w, so span{(0,w), (u_w,0)} is an
        # approximate invariant subspace of the tangent (see
        # _kp_mode_velocity_responses — the raw mode alone is measurably
        # useless for the saddle system)
        cvd_d = np.asarray(dofs.cell_vdofs, np.int64)[ids[valid]]
        blk_d = diag_blk[:, :, valid]
        if pin_vdofs is not None and len(pin_vdofs):
            pv = np.zeros(dofs.n_vs, dtype=bool)
            pv[np.asarray(pin_vdofs, np.int64)] = True
            blk_d = _pin_cell_mats(blk_d, cvd_d, pv)
        resp = _kp_mode_velocity_responses(
            blk_d, cvd_d, D[:, :, :, valid], modes, cpd, dofs.n_vs,
            dofs.v_mask,
        )
        for m_i, w in enumerate(modes):
            z1 = np.zeros(dofs.n_total)
            z1[dofs.n_u:] = w
            rows.append(z1)
            if resp is not None:
                z2 = np.zeros(dofs.n_total)
                z2[: dofs.n_u] = resp[m_i].reshape(-1)
                nrm = np.linalg.norm(z2)
                if nrm > 0:
                    rows.append(z2 / nrm)
        kp_modes = np.stack(rows)

    agg_p = None
    coarse_inv = None
    if coarse_agg and coarse_agg > 0:
        s_agg = _fit_agg_to_ow(
            max(int(coarse_agg), -(-dofs.n_ps // 4096)), lay.OWp
        )
        agg_p, coarse_inv = _coarse_space(
            Kp_t[:, :k_p, :][:, :, valid],  # pinned cell matrices
            cpd,
            dofs.n_ps,
            dofs.p_mask,
            s_agg,
            coarse_cond_cap,
            shift_nullspace=(pin_pdofs is None or not len(pin_pdofs)),
        )

    # ---- two-level coarse space for the A00 (velocity) sweeps -------------
    # One scalar coarse space shared by all velocity components, built from
    # the CONSTANT part of the tangent's velocity block (mass/dt + viscous;
    # the convection perturbation is left to the Jacobi term and the sweep
    # itself).  Dirichlet velocity dofs (pin_vdofs) are decoupled exactly
    # like Kp's outflow pinning, matching the bc-row substitution the inner
    # A00 matvec applies.  This bounds the Jacobi-CG sweep's effective
    # condition number independent of h — the h-robustness fix for the
    # outer FGMRES count (VERDICT r2 #1).
    agg_v = None
    coarse_inv_v = None
    s_agg_v = 0
    if coarse_agg_v and coarse_agg_v > 0:
        s_agg_v = _fit_agg_to_ow(
            max(int(coarse_agg_v), -(-dofs.n_vs // 4096)), lay.OWv
        )
        cvd = np.asarray(dofs.cell_vdofs, np.int64)[ids[valid]]  # [nv, k_v]
        blk_v = diag_blk[:, :, valid]
        if pin_vdofs is not None and len(pin_vdofs):
            pinned_v = np.zeros(dofs.n_vs, dtype=bool)
            pinned_v[np.asarray(pin_vdofs, np.int64)] = True
            blk_v = _pin_cell_mats(blk_v, cvd, pinned_v)
        agg_v, coarse_inv_v = _coarse_space(
            blk_v,
            cvd,
            dofs.n_vs,
            dofs.v_mask,
            s_agg_v,
            coarse_cond_cap,
            shift_nullspace=(pin_vdofs is None or not len(pin_vdofs)),
        )

    as_f = lambda a: jnp.asarray(a, dtype=dtype)
    return WindowedAssembly(
        N_v=as_f(N_v),
        N_p=as_f(N_p),
        NN=as_f(NN),
        G_v=as_f(G_v),
        # invJT_t[d, a, c] pairs with G_v[b, q, a]: Gp[b,q,d,c] = sum_a
        invJT_t=as_f(invJT.transpose(1, 2, 0)),
        W_t=as_f(W_t),
        A_const=jnp.asarray(A_const, dtype=store_dtype or dtype),
        r_const=as_f(r_const),
        inv_mp=as_f(inv_mp),
        Kp_t=as_f(Kp_t),
        diag_kp=as_f(diag_kp),
        dim=dim,
        agg_p=None if agg_p is None else jnp.asarray(agg_p, jnp.int32),
        coarse_inv=None if coarse_inv is None else as_f(coarse_inv),
        coarse_agg_size=0 if coarse_inv is None else s_agg,
        agg_v=None if agg_v is None else jnp.asarray(agg_v, jnp.int32),
        coarse_inv_v=None if coarse_inv_v is None else as_f(coarse_inv_v),
        coarse_agg_size_v=0 if coarse_inv_v is None else s_agg_v,
        kp_modes=None if kp_modes is None else as_f(kp_modes),
    )


def assemble_windowed(
    wa: WindowedAssembly,
    lay: WindowedLayout,
    u: jax.Array,
    u_old: jax.Array,
    *,
    dt: float,
    nu: float,
    rho: float,
    convection_form: str = "reference",
    include_continuity_residual: bool = False,
    include_time_term: bool = True,
    axis_name: str | None = None,
):
    """One Newton-tangent assembly in the windowed layout.

    Returns (A_t [nl, nli, ncd], residual [n_total], diag0 [n_total]) with the
    exact same values as fem.assembly.assemble_navier_stokes scattered flat
    (cross-checked in tests/test_windowed_assembly.py).  Dirichlet rows are
    NOT applied here, matching the reference's assemble-then-BC split.

    include_time_term=False drops the residual's -(rho/dt)(u - u_old) term:
    the STEADY Navier-Stokes residual (the reference's legacy variant,
    hpp:1-368), paired with a wa built with terms="stokes" so A_const carries
    no mass block.  dt/u_old are then ignored.

    axis_name: inside shard_map with a LOCAL layout + block-sharded wa arrays
    (parallel/windowed_spmd), all contractions stay local; only the window
    gathers/scatter exchange O(halo) edge blocks.
    """
    dim, k_v, k_p = wa.dim, lay.k_v, lay.k_p
    nl = lay.nl
    Nv, Np, W = wa.N_v, wa.N_p, wa.W_t
    Gr = wa.G_v  # [k_v, nq, dim] reference gradients (replicated)
    iJ = wa.invJT_t  # [dim, dim, ncd]; Gp[b,q,d,c] = sum_a iJ[d,a,c] Gr[b,q,a]

    X = windowed_gather(lay, u, axis_name=axis_name)  # [nli, ncd]
    Xv = X[: dim * k_v].reshape(dim, k_v, -1)
    Xp = X[dim * k_v : nl]

    # fields at quadrature points (cells last).  Every physical-gradient
    # contraction goes through the REFERENCE gradient table first and applies
    # invJT per cell afterwards, so no [k_v, nq, dim, ncd] intermediate ever
    # materializes (the 3D memory hog VERDICT r3 #3; the largest transient
    # here is [dim, nq, dim, ncd]).
    u_q = jnp.einsum("bq,dbc->dqc", Nv, Xv, precision=_PREC)
    if include_time_term:
        Xo = windowed_gather(lay, u_old, axis_name=axis_name)
        Xov = Xo[: dim * k_v].reshape(dim, k_v, -1)
        uo_q = jnp.einsum("bq,dbc->dqc", Nv, Xov, precision=_PREC)
    # du_d/dx_a at qpts: contract the cell dofs with Gr, then invJT
    gu_ref = jnp.einsum("dbc,bqe->dqec", Xv, Gr, precision=_PREC)
    gu_q = jnp.einsum("dqec,aec->daqc", gu_ref, iJ, precision=_PREC)
    p_q = jnp.einsum("bq,bc->qc", Np, Xp, precision=_PREC)

    # ---- convection blocks of the tangent (cpp:259-269) -------------------
    guW = gu_q * W  # [dim, dim, nq, ncd]
    # C2[(a,j) col, (a,i) row] = rho (u . grad N_j) N_i W (j carries the grad)
    u_ref = jnp.einsum("dqc,dec->eqc", u_q, iJ, precision=_PREC)
    adv = jnp.einsum("jqe,eqc->jqc", Gr, u_ref, precision=_PREC)
    C2 = jnp.einsum("jqc,iq->jic", adv * W, rho * Nv, precision=_PREC)

    st = wa.A_const.dtype  # tangent STORE dtype (bf16 capacity mode keeps
    # the two big buffers half-width; compute above stays f32/f64)
    # per-(a,b) blocked accumulation: adding each [k_v, k_v, ncd] convection
    # block into A_t in place keeps the transient footprint to ONE block —
    # the all-at-once [dim, dim, k_v, k_v, ncd] form plus its concatenated
    # copy peaked at ~7 GB for 3D meshes near 1M cells (2x 900 floats/cell)
    A_t = wa.A_const
    for b in range(dim):  # column component (A_t dim 0)
        for a in range(dim):  # row component (A_t dim 1)
            # C1 block [(b,j), (a,i)] = rho gu[a,b] N_i N_j W (sym. in i, j)
            blk = rho * jnp.einsum(
                "qc,ijq->jic", guW[a, b], wa.NN, precision=_PREC
            )
            if a == b:
                blk = blk + C2
            A_t = A_t.at[
                b * k_v : (b + 1) * k_v, a * k_v : (a + 1) * k_v, :
            ].add(blk.astype(st))

    # ---- residual (cpp:287-311), momentum rows [dim, k_v, ncd] ------------
    if convection_form == "reference":
        conv = jnp.einsum("dqc,daqc->aqc", u_q, gu_q, precision=_PREC)  # u^T grad u
    elif convection_form == "standard":
        conv = jnp.einsum("dqc,adqc->aqc", u_q, gu_q, precision=_PREC)
    else:
        raise ValueError(convection_form)
    src = -rho * conv  # [dim, nq, ncd]
    if include_time_term:
        src = src - (rho / dt) * (u_q - uo_q)
    r_mom = jnp.einsum("aqc,iq->aic", src * W, Nv, precision=_PREC)
    guW_ref = jnp.einsum("abqc,bec->aeqc", guW, iJ, precision=_PREC)
    r_mom = r_mom - (nu * rho) * jnp.einsum(
        "aeqc,iqe->aic", guW_ref, Gr, precision=_PREC
    )
    pW_ref = jnp.einsum("qc,iqe->iec", p_q * W, Gr, precision=_PREC)
    r_mom = r_mom + jnp.einsum("iec,aec->aic", pW_ref, iJ, precision=_PREC)
    if include_continuity_residual:
        div_u = jnp.einsum("ddqc->qc", gu_q, precision=_PREC)
        r_p = jnp.einsum("qc,iq->ic", div_u * W, Np, precision=_PREC)
    else:
        r_p = jnp.zeros((k_p, r_mom.shape[2]), dtype=r_mom.dtype)

    R = jnp.zeros((lay.nli, lay.ncd), dtype=r_mom.dtype)
    R = R.at[: dim * k_v].set(r_mom.reshape(dim * k_v, -1))
    R = R.at[dim * k_v : nl].set(r_p)
    residual = windowed_scatter(lay, R, axis_name=axis_name) + wa.r_const

    # ---- raw diagonal (pre-BC, deal.II apply_boundary_values keeps it) ----
    # widened to the residual dtype BEFORE the cross-cell accumulation: on
    # the bf16 tangent-store path only the per-entry rounding remains (the
    # Dirichlet rows scale residual and matvec with the SAME bc_diag, so the
    # constrained system stays exactly consistent)
    d_loc = A_t[jnp.arange(nl), jnp.arange(nl), :].astype(r_mom.dtype)
    Dv = jnp.zeros((lay.nli, lay.ncd), dtype=d_loc.dtype).at[:nl].set(d_loc)
    diag0 = windowed_scatter(lay, Dv, axis_name=axis_name)

    return A_t, residual, diag0
