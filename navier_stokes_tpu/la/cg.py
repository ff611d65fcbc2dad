"""Preconditioned conjugate gradients, jit-compatible.

JAX replacement for deal.II ``SolverCG`` as used inside the
reference's block-triangular preconditioner
(``/root/reference/src/NavierStokesSolver.hpp:598-618``: CG on the velocity
stiffness block and on the pressure mass, absolute tolerance
``1e-2 * ||src||``, <= 2000 iterations).  One ``lax.while_loop``; every
reduction is a single dot (``psum``-able under shard_map).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

_PREC = jax.lax.Precision.HIGHEST

__all__ = ["CgResult", "cg"]


class CgResult(NamedTuple):
    x: jax.Array
    iters: jax.Array
    residual: jax.Array
    converged: jax.Array


def cg(
    matvec: Callable,
    b: jax.Array,
    x0: jax.Array | None = None,
    *,
    atol: jax.Array | float,
    maxiter: int = 2000,
    precond: Callable | None = None,
    axis_name: str | None = None,
) -> CgResult:
    """Solve SPD system to ABSOLUTE residual tolerance ||b - A x|| <= atol.

    axis_name: inside shard_map with sharded vectors, every dot/norm is
    psum-reduced over the mesh axis (the Epetra all-reduce of SURVEY L1)."""
    atol = jnp.asarray(atol, dtype=b.dtype)
    M = precond or (lambda v: v)

    def vdot(a, c):
        d = jnp.vdot(a, c, precision=_PREC)
        return jax.lax.psum(d, axis_name) if axis_name else d

    def norm(v):
        return jnp.sqrt(vdot(v, v))

    if x0 is None:
        # linear operator: r(0) = b exactly; skip the A@0 matvec (the CC
        # preconditioner's fixed micro-sweeps call this with x0=None every
        # outer FGMRES iteration — one matvec of 3-5 saved per sweep)
        x0 = jnp.zeros_like(b)
        r0 = b
    else:
        r0 = b - matvec(x0)
    z0 = M(r0)
    rz0 = vdot(r0, z0)

    def cond(state):
        _, r, _, _, _, k = state
        nrm = norm(r)
        return jnp.logical_and(
            jnp.logical_and(nrm > atol, jnp.isfinite(nrm)), k < maxiter
        )

    def body(state):
        x, r, z, p, rz, k = state
        Ap = matvec(p)
        pAp = vdot(p, Ap)
        # breakdown detection: in exact SPD arithmetic pAp > 0; at extreme
        # stagnation (unreachable atol) p can overflow -> pAp Inf/NaN/<=0.
        # Freeze the state and exit instead of polluting x with 0 * Inf.
        ok = jnp.logical_and(jnp.isfinite(pAp), pAp > 0)
        alpha = jnp.where(ok, rz / jnp.where(ok, pAp, 1.0), 0.0)
        x = jnp.where(ok, x + alpha * p, x)
        r = jnp.where(ok, r - alpha * Ap, r)
        z = M(r)
        rz_new = vdot(r, z)
        beta = jnp.where(
            jnp.logical_and(ok, rz != 0), rz_new / jnp.where(rz != 0, rz, 1.0), 0.0
        )
        p = jnp.where(ok, z + beta * p, p)
        k = jnp.where(ok, k + 1, jnp.int32(maxiter))  # breakdown -> exit loop
        return x, r, z, p, rz_new, k

    x, r, _, _, _, k = lax.while_loop(cond, body, (x0, r0, z0, z0, rz0, jnp.int32(0)))
    res = norm(r)
    return CgResult(x=x, iters=k, residual=res, converged=res <= atol)
