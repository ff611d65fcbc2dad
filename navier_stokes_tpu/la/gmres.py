"""Restarted (F)GMRES, fully jit-compatible, with blocked orthogonalization.

JAX replacement for deal.II ``SolverGMRES`` as used by the reference
(``/root/reference/src/NavierStokesSolver.cpp:566-585`` tangent solve with
identity preconditioner, ``cpp:538-554`` Stokes solve with the block
preconditioner).  Stopping matches ``SolverControl(maxit, tol)``: iterate
until the TRUE preconditioned-residual estimate drops to an ABSOLUTE
tolerance (the reference passes ``1e-2 * rhs.l2_norm()``).

Design notes (XLA semantics):
  * static shapes everywhere: Krylov basis V is a fixed [restart+1, n] buffer;
    a ``lax.while_loop`` over restart cycles wraps a ``lax.fori_loop`` over
    the inner iterations, with converged iterations masked to no-ops.
  * orthogonalization is classical Gram-Schmidt with reorthogonalization
    (CGS2): the m+1 dot products become ONE [m+1, n] @ [n] matvec — a single
    dense contraction instead of deal.II's sequential MGS dots, and a
    single ``psum``-able reduction when sharded.
  * flexible variant (preconditioner may itself be an iterative solve, like
    the reference's inner CG/GMRES preconditioners, hpp:520-639): Z buffer
    stores preconditioned directions.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

_PREC = jax.lax.Precision.HIGHEST  # full f32 orthogonalization (a GPU f32
# dot may otherwise run in TF32, ~3 digits, which destroys CGS2)

# Krylov-basis row-tile size of the fill-aware CGS2 streams (f32 sublane
# tile).  The orthogonalization loops touch ceil((k+1)/TILE) tiles of V —
# cost follows the FILLED prefix, not the restart window (VERDICT r4 #1:
# the fixed-window form streamed the full [restart+1, n] buffer four times
# per iteration, taxing every iteration ~3x at the bench fill levels).
_ORTHO_TILE = 8

__all__ = ["GmresResult", "fgmres"]


class GmresResult(NamedTuple):
    x: jax.Array
    # accepted Arnoldi iterations; actual matvecs = iters + one true-residual
    # matvec per restart cycle (+1 when x0 is given) — see the cost model in
    # the fgmres docstring
    iters: jax.Array
    residual: jax.Array  # final (estimated) residual norm
    converged: jax.Array


def _identity(x):
    return x


def _norm(v, axis_name):
    if axis_name is None:
        return jnp.linalg.norm(v)
    return jnp.sqrt(jax.lax.psum(jnp.vdot(v, v, precision=_PREC), axis_name))


def _cgs_pass(V, w, k, axis_name, mp1p):
    """One classical Gram-Schmidt pass of ``w`` against the filled prefix
    ``V[0..k]`` — fill-aware: streams only ``ceil((k+1)/TILE)`` row tiles.

    Returns ``(h, w_proj)`` with ``h`` the [mp1p] projection coefficients
    (zero beyond row k) and ``w_proj = w - V^T h``.  Rows of V beyond the
    filled prefix are zero, so tile-granular over-read is exact.  Locally the
    dot and the projection fuse into ONE stream of each tile (the tile is
    read once and used for both); under SPMD the projection must use the
    globally summed coefficients, so the two loops split around one psum
    (two tile streams, same as the dot/update split of the full-buffer form).
    """
    T = _ORTHO_TILE
    nt = k // T + 1  # tiles covering rows 0..k

    if axis_name is None:

        def body(t, carry):
            h, wacc = carry
            Vt = lax.dynamic_slice_in_dim(V, t * T, T)
            ht = jnp.matmul(Vt, w, precision=_PREC)
            wacc = wacc - jnp.matmul(ht, Vt, precision=_PREC)
            return lax.dynamic_update_slice(h, ht, (t * T,)), wacc

        return lax.fori_loop(
            0, nt, body, (jnp.zeros(mp1p, V.dtype), w)
        )

    def dot_body(t, h):
        Vt = lax.dynamic_slice_in_dim(V, t * T, T)
        ht = jnp.matmul(Vt, w, precision=_PREC)
        return lax.dynamic_update_slice(h, ht, (t * T,))

    h = lax.psum(
        lax.fori_loop(0, nt, dot_body, jnp.zeros(mp1p, V.dtype)), axis_name
    )

    def proj_body(t, wacc):
        Vt = lax.dynamic_slice_in_dim(V, t * T, T)
        ht = lax.dynamic_slice(h, (t * T,), (T,))
        return wacc - jnp.matmul(ht, Vt, precision=_PREC)

    return h, lax.fori_loop(0, nt, proj_body, w)


def fgmres(
    matvec: Callable,
    b: jax.Array,
    x0: jax.Array | None = None,
    *,
    atol: jax.Array | float,
    restart: int = 60,
    maxiter: int = 1000,
    precond: Callable | None = None,
    axis_name: str | None = None,
    deflate: jax.Array | None = None,
) -> GmresResult:
    """Right-preconditioned flexible GMRES; stops at ||r||_2 <= atol.

    Everything is traceable: call under jit with `matvec`/`precond` closures.
    axis_name: inside shard_map with sharded vectors, the CGS2 projection
    dots and all norms psum over the mesh axis (Krylov coefficients stay
    replicated, basis vectors stay sharded).

    Cost model (matvec/precond dominate): the Arnoldi loop EXITS at
    the converged iteration (lax.while_loop, not a fixed restart-window
    sweep), the true residual computed at each cycle end is CARRIED into the
    next cycle (one matvec per cycle, not two), and ``x0=None`` starts from
    ``r0 = b`` without spending a matvec on A@0 (the operator is linear).
    A solve converging at k iterations therefore costs exactly
    k + ceil(k/restart) matvecs and k preconditioner applications.

    deflate: optional [k_d, n] FIXED solution-space directions forced into
    EVERY restart cycle as the first k_d flexible (Z) directions, bypassing
    the preconditioner.  This is GCRO-style augmentation for near-null modes
    the preconditioner cannot represent stably: a restarted solver loses its
    slowly-converging mode components at every restart (measured: the DFG
    channel's weakly-pinned pressure mode stalls restarted FGMRES at rel
    ~1e-3 in f32 and ~1e-4 in f64 for thousands of iterations), while an
    augmented cycle spans them exactly, so the least-squares solve removes
    them in the first cycle and restarts cannot reintroduce them.  Rows
    should be ~unit-normalized; a direction that breaks down (already
    spanned) is skipped, not treated as convergence.
    """
    n = b.shape[0]
    dtype = b.dtype
    m = restart
    # V/Z row counts padded to the ortho tile so the fill-aware loops slice
    # whole tiles; the extra rows stay zero forever
    _T = _ORTHO_TILE
    mp1p = -(-(m + 1) // _T) * _T
    mzp = -(-m // _T) * _T
    M = precond or _identity
    k_d = 0 if deflate is None else deflate.shape[0]
    assert k_d < restart, "deflation space must be smaller than the restart window"
    atol = jnp.asarray(atol, dtype=dtype)
    eps_break = jnp.asarray(1e-30 if dtype == jnp.float64 else 1e-18, dtype=dtype)

    def cycle(state):
        x, total_iters, prev_res, _, r = state
        # r is the TRUE residual of x, carried from the previous cycle's
        # end-of-cycle evaluation (or the initial residual)
        beta = _norm(r, axis_name)
        done0 = beta <= atol

        V = jnp.zeros((mp1p, n), dtype=dtype)
        Z = jnp.zeros((mzp, n), dtype=dtype)
        V = V.at[0].set(jnp.where(done0, 0.0, r / jnp.where(done0, 1.0, beta)))
        g = jnp.zeros(m + 1, dtype=dtype).at[0].set(beta)
        cs = jnp.ones(m, dtype=dtype)
        sn = jnp.zeros(m, dtype=dtype)
        R = jnp.eye(m, dtype=dtype)  # unused columns stay identity

        def body(carry):
            # k: accepted Arnoldi position (V[0..k] filled, compact — a
            # discarded direction leaves NO gap); jd: next deflation slot;
            # nreg: accepted regular steps; t: trip counter
            V, Z, R, g, cs, sn, res, done, k, jd, nreg, t = carry
            j = k  # Arnoldi/least-squares index of this candidate step

            # the FIRST regular step must seed the Krylov chain from V[0]
            # (the residual direction): deflation slots occupy the leading
            # rows, and chaining from their images would explore
            # Krylov(A, A d) instead of Krylov(A, r) — measured to stall
            # restarted cycles completely once r is orthogonal-ish to d.
            # Subsequent regular steps chain from the previous regular
            # image V[k] as usual.
            vidx = jnp.where(nreg == 0, 0, k)
            if k_d:
                # augmentation slots: fixed deflation directions bypass M
                use_defl = jd < k_d
                z = lax.cond(
                    use_defl,
                    lambda _: deflate[jnp.minimum(jd, k_d - 1)].astype(dtype),
                    lambda _: M(V[vidx]),
                    None,
                )
            else:
                use_defl = jnp.bool_(False)
                z = M(V[vidx])
            w = matvec(z)
            w0n = _norm(w, axis_name)  # pre-orthogonalization magnitude
            if k_d:
                # UNIT-IMAGE scaling of deflation slots: a near-null
                # direction has a tiny ||A d||, which would put a ~1e-6
                # diagonal into R and poison the least-squares conditioning
                # for the whole cycle (measured: an identity-preconditioned
                # solve ran 10x past its usual count to the iteration cap).
                # Scaling (z, w) by 1/||A d|| keeps the H column O(1) —
                # the least-squares solution is unchanged in exact
                # arithmetic, y just absorbs the scale.
                dscale = jnp.where(
                    jnp.logical_and(use_defl, w0n > eps_break), 1.0 / jnp.where(w0n > eps_break, w0n, 1.0), 1.0
                )
                z = z * dscale
                w = w * dscale
                w0n = w0n * dscale
            # CGS2, fill-aware: two Gram-Schmidt passes touching only the
            # filled tiles of V (rows beyond the prefix are zero)
            h1, w = _cgs_pass(V, w, k, axis_name, mp1p)
            h2, w = _cgs_pass(V, w, k, axis_name, mp1p)
            h = (h1 + h2)[: m + 1]
            hw = _norm(w, axis_name)
            # RELATIVE breakdown: a direction whose image is (numerically)
            # already spanned leaves hw ~ roundoff * ||A z||; accepting it
            # would put a near-zero diagonal into R and blow up the
            # least-squares solve.  Regular steps hitting this are a happy
            # breakdown (cycle ends on the finite prefix); deflation slots
            # are simply skipped.
            eps_rel = jnp.asarray(1e-12 if dtype == jnp.float64 else 1e-6, dtype)
            hw_ok = hw > jnp.maximum(eps_rel * w0n, eps_break)
            inv_hw = jnp.where(hw_ok, 1.0 / jnp.where(hw_ok, hw, 1.0), 0.0)

            # apply previous rotations (identity beyond k: cs=1, sn=0)
            def rot(i, hv):
                hi, hi1 = hv[i], hv[i + 1]
                return hv.at[i].set(cs[i] * hi + sn[i] * hi1).at[i + 1].set(
                    -sn[i] * hi + cs[i] * hi1
                )

            h = lax.fori_loop(0, j, rot, h.at[j + 1].set(hw))

            # new rotation annihilating h[j+1]
            denom = jnp.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            safe = denom > eps_break
            c_new = jnp.where(safe, h[j] / jnp.where(safe, denom, 1.0), 1.0)
            s_new = jnp.where(safe, h[j + 1] / jnp.where(safe, denom, 1.0), 0.0)
            h_col = h.at[j].set(denom).at[j + 1].set(0.0)

            g_new = g.at[j + 1].set(-s_new * g[j]).at[j].set(c_new * g[j])
            res_new = jnp.abs(g_new[j + 1])

            # breakdown guard: if this iteration produced non-finite values
            # (preconditioner blowup, overflow) or a relatively-spanned
            # direction, discard it — the least-squares solve then uses only
            # the accepted prefix.
            apply_it = jnp.logical_and(
                jnp.logical_and(jnp.isfinite(hw), hw_ok),
                jnp.all(jnp.isfinite(h_col)),
            )

            # masked state update (row-level wheres keep this O(n) per iter)
            V = V.at[j + 1].set(jnp.where(apply_it, w * inv_hw, V[j + 1]))
            Z = Z.at[j].set(jnp.where(apply_it, z, Z[j]))
            R = R.at[:, j].set(jnp.where(apply_it, h_col[:m], R[:, j]))
            g = jnp.where(apply_it, g_new, g)
            cs = jnp.where(apply_it, cs.at[j].set(c_new), cs)
            sn = jnp.where(apply_it, sn.at[j].set(s_new), sn)
            res = jnp.where(apply_it, res_new, res)
            k = k + apply_it.astype(jnp.int32)
            # a discarded DEFLATION slot (direction already spanned / not
            # useful this cycle) is simply skipped — the basis stays compact
            # at V[0..k], so the rest of the cycle proceeds normally; only a
            # discarded REGULAR step ends the cycle (breakdown / converged)
            bad = jnp.logical_and(~apply_it, ~use_defl)
            done = jnp.logical_or(res <= atol, bad)
            jd = jd + jnp.asarray(use_defl, jnp.int32)
            nreg = nreg + jnp.asarray(
                jnp.logical_and(apply_it, ~use_defl), jnp.int32
            )
            return V, Z, R, g, cs, sn, res, done, k, jd, nreg, t + 1

        def body_cond(carry):
            done, k, t = carry[-5], carry[-4], carry[-1]
            return jnp.logical_and(
                jnp.logical_and(k < m, t < m + k_d), jnp.logical_not(done)
            )

        # EARLY-EXIT Arnoldi: a cycle converging at iteration k costs k
        # matvec+precond applications, not a fixed restart-window sweep of
        # masked no-ops (each of which would still run the full operator)
        carry = (
            V, Z, R, g, cs, sn, beta, done0,
            jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.int32(0),
        )
        V, Z, R, g, cs, sn, res, done, k, _, _, _ = lax.while_loop(
            body_cond, body, carry
        )

        # solve R y = g on the active prefix (inactive columns are identity
        # with masked g = 0 so y vanishes there)
        g_solve = jnp.where(jnp.arange(m) < k, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(R, g_solve, lower=False)
        # fill-aware solution update: y vanishes beyond the accepted prefix,
        # so only the filled tiles of Z are streamed
        ypad = jnp.zeros(mzp, dtype).at[:m].set(y)
        ntz = jnp.maximum(k - 1, 0) // _T + 1

        def upd(t, xacc):
            Zt = lax.dynamic_slice_in_dim(Z, t * _T, _T)
            yt = lax.dynamic_slice(ypad, (t * _T,), (_T,))
            return xacc + jnp.matmul(yt, Zt, precision=_PREC)

        x_new = lax.fori_loop(0, ntz, upd, x)
        # TRUE residual at cycle end: in reduced precision the Arnoldi/Givens
        # estimate drifts below the true residual (orthogonality loss) and
        # would report false convergence; restarting on the true residual
        # turns the outer loop into iterative refinement.  Costs one matvec
        # per cycle (amortized over <= restart iterations) — and the residual
        # VECTOR is carried into the next cycle, which starts from it instead
        # of recomputing b - A x.
        r_new = b - matvec(x_new)
        res_true = _norm(r_new, axis_name)
        # keep the better iterate; stop on breakdown or no true headway
        better = res_true < prev_res
        x_out = jnp.where(better, x_new, x)
        r_out = jnp.where(better, r_new, r)
        res_out = jnp.minimum(res_true, prev_res)
        stalled = jnp.logical_or(k == 0, ~better)
        return x_out, total_iters + k, res_out, stalled, r_out

    def cond(state):
        _, iters, res, stalled, _ = state
        ok = jnp.logical_and(res > atol, jnp.isfinite(res))
        return jnp.logical_and(jnp.logical_and(ok, iters < maxiter), ~stalled)

    if x0 is None:
        # linear operator: r(0) = b exactly; skip the A@0 matvec
        x0 = jnp.zeros_like(b)
        r0 = b
    else:
        r0 = b - matvec(x0)
    beta0 = _norm(r0, axis_name)
    state = (x0, jnp.int32(0), beta0, beta0 <= atol, r0)
    x, iters, res, _, _ = lax.while_loop(cond, cycle, state)
    return GmresResult(x=x, iters=iters, residual=res, converged=res <= atol)
