"""Flow functionals: boundary forces (Cd/Cl), Strouhal number, divergence norms.

The reference computes NO functionals (its validation is visual, SURVEY §4),
but BASELINE.json's north-star metric is "Cd/Cl err vs deal.II" on the
cylinder case, so these are first-class here.

Force on a boundary = integral of sigma . n with the GRADIENT-form stress
sigma = -p I + nu rho grad u (consistent with the reference's weak form,
which uses (nu rho grad u, grad v) rather than the symmetric-gradient form,
cpp:254-257 — the do-nothing outflow condition implies this stress).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.dofs import TaylorHoodDofs
from ..fem.geometry import facet_geometry

_PREC = jax.lax.Precision.HIGHEST  # full f32: a GPU f32 dot may run in TF32

__all__ = ["BoundaryForce", "BoundaryReaction", "strouhal_number", "divergence_l2"]


class BoundaryReaction:
    """Superconvergent boundary force via the reaction functional.

    The force exerted BY the fluid ON a Dirichlet boundary equals the
    UNCONSTRAINED weak residual summed over that boundary's velocity dofs
    (the discrete reaction of the no-slip constraint).  This converges ~one
    order faster than the surface-traction quadrature of BoundaryForce and is
    the standard high-accuracy evaluator for the DFG benchmark coefficients
    (validated against the independent oracle in scripts/oracle_steady_ns.py:
    Cd 5.5585 vs surface-traction 5.4967 at h=D/10, published 5.5795).

    For unsteady runs pass (u, u_old, dt) so the reaction includes the
    genuine inertial term; for steady evaluation call force(u) (u_old=u
    kills the time term).

    Caveat: ``tags`` should form a CLOSED boundary (like the cylinder) or at
    least not touch boundaries of other types — at a junction, the corner
    dof's test function extends onto the adjacent face, so the reaction
    includes that face's traction weighted by the corner basis function
    (see test_boundary_reaction_poiseuille_exact for the quantified effect).
    """

    def __init__(self, solver, tags):
        dofs = solver.dofs
        sdofs = dofs.boundary_scalar_vdofs(list(np.atleast_1d(tags)))
        if len(sdofs) == 0:
            raise ValueError(f"no boundary velocity dofs with tags {tags}")
        dim = dofs.dim
        self.idx = jnp.asarray(
            sdofs[None, :] + np.arange(dim)[:, None] * dofs.n_vs, dtype=jnp.int32
        )  # [dim, m]
        cfg = solver.cfg
        ctx = solver.ctx
        kw = dict(
            nu=cfg.nu, rho=cfg.rho, p_out=cfg.p_out,
            convection_form=cfg.convection_form,
            include_continuity_residual=cfg.include_continuity_residual,
            jacobian_mass_rho=cfg.jacobian_mass_rho,
        )

        from ..fem.assembly import assemble_navier_stokes

        def _force(u, u_old, dt):
            # framework residual = -R_weak (the Newton RHS, cpp:287-310), so
            # force BY fluid ON boundary = +sum of residual rows (reaction)
            _, _, r = assemble_navier_stokes(ctx, u, u_old, dt=dt, **kw)
            return jnp.stack(
                [r[self.idx[d]].sum() for d in range(dim)]
            )

        self._eval = jax.jit(_force)
        self._dt = cfg.dt
        self.rho = cfg.rho

    def force(self, u, u_old=None, dt=None) -> np.ndarray:
        u = jnp.asarray(u)
        uo = u if u_old is None else jnp.asarray(u_old)
        return np.asarray(self._eval(u, uo, self._dt if dt is None else dt))

    def coefficients(self, u, u_mean, length, u_old=None, dt=None):
        f = self.force(u, u_old, dt)
        scale = 2.0 / (self.rho * u_mean**2 * length)
        return float(f[0] * scale), float(f[1] * scale)


@dataclass
class BoundaryForce:
    """Precomputed evaluator for the traction integral over one boundary tag
    group (e.g. the cylinder, tag 13 — BASELINE.md)."""

    def __init__(self, dofs: TaylorHoodDofs, tags, nu: float, rho: float, degree: int = 5):
        mesh = dofs.mesh
        fids = np.nonzero(np.isin(mesh.boundary_tags, np.atleast_1d(tags)))[0]
        if len(fids) == 0:
            raise ValueError(f"no boundary facets with tags {tags}")
        fg = facet_geometry(mesh, fids, degree)
        elem = dofs.element
        dim = mesh.dim
        vals, grads = elem.velocity.tabulate(fg.ref_qpts.reshape(-1, dim))
        nqf = fg.jxw.shape[1]
        nf = len(fids)
        pvals, _ = elem.pressure.tabulate(fg.ref_qpts.reshape(-1, dim))

        self.dofs = dofs
        self.nu, self.rho = nu, rho
        self.dim = dim
        # [nf, nb, nqf] / [nf, nb, nqf, dim]
        self.N_v = jnp.asarray(vals.reshape(elem.n_v, nf, nqf).transpose(1, 0, 2))
        self.G_ref = jnp.asarray(
            grads.reshape(elem.n_v, nf, nqf, dim).transpose(1, 0, 2, 3)
        )
        self.N_p = jnp.asarray(pvals.reshape(elem.n_p, nf, nqf).transpose(1, 0, 2))
        self.normal = jnp.asarray(fg.normal)
        self.jxw = jnp.asarray(fg.jxw)
        self.cell_vdofs = jnp.asarray(dofs.cell_vdofs[fg.cell], dtype=jnp.int32)
        self.cell_pdofs = jnp.asarray(dofs.cell_pdofs[fg.cell], dtype=jnp.int32)
        # owning-cell inverse Jacobians for physical gradients
        from ..fem.geometry import cell_geometry
        from ..fem.quadrature import gauss_simplex

        geo = cell_geometry(mesh, gauss_simplex(dim, 1))
        self.invJT = jnp.asarray(geo.invJT[fg.cell])
        self._eval = jax.jit(self._force)

    def _force(self, solution: jax.Array) -> jax.Array:
        dim = self.dim
        n_vs, n_u = self.dofs.n_vs, self.dofs.n_u
        idx = self.cell_vdofs[:, None, :] + (
            jnp.arange(dim, dtype=jnp.int32)[None, :, None] * n_vs
        )
        uc = solution[idx]  # [nf, dim, nb_v]
        pc = solution[n_u + self.cell_pdofs]  # [nf, nb_p]
        # physical gradients of basis at face qpts: [nf, nb, q, d]
        Gp = jnp.einsum("fda,fbqa->fbqd", self.invJT, self.G_ref, precision=_PREC)
        gradu = jnp.einsum("fcb,fbqd->fqcd", uc, Gp, precision=_PREC)  # du_c/dx_d
        p_q = jnp.einsum("fb,fbq->fq", pc, self.N_p, precision=_PREC)
        # traction on the FLUID: t = sigma . n with n out of the fluid;
        # the force exerted BY the fluid ON the boundary is the negative
        # (DFG convention: integrate with the normal pointing INTO the fluid)
        tr = -p_q[:, :, None] * self.normal[:, None, :] + (self.nu * self.rho) * jnp.einsum(
            "fqcd,fd->fqc", gradu, self.normal, precision=_PREC
        )
        return -jnp.einsum("fqc,fq->c", tr, self.jxw, precision=_PREC)

    def force(self, solution) -> np.ndarray:
        """Total force vector exerted BY the fluid ON the boundary (DFG sign:
        drag of forward flow on an obstacle is positive)."""
        return np.asarray(self._eval(jnp.asarray(solution)))

    def coefficients(self, solution, u_mean: float, length: float) -> tuple[float, float]:
        """(Cd, Cl) with the DFG normalization 2 F / (rho u_mean^2 L)."""
        f = self.force(solution)
        scale = 2.0 / (self.rho * u_mean**2 * length)
        return float(f[0] * scale), float(f[1] * scale)


def strouhal_number(lift_series, dt: float, D: float, U: float) -> float:
    """Dominant shedding frequency from the lift time series: St = f D / U.

    The raw FFT peak is quantized to 1/(N dt) Hz (e.g. a 2.8 s statistics
    window bins St in steps of ~0.036); refine the peak by quadratic
    interpolation of the windowed log-magnitude spectrum, which recovers the
    true frequency of an off-bin sinusoid to ~1e-3 relative error."""
    y = np.asarray(lift_series, dtype=np.float64)
    y = y - y.mean()
    if len(y) < 8 or np.allclose(y, 0):
        return 0.0
    spec = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    freqs = np.fft.rfftfreq(len(y), d=dt)
    k = int(np.argmax(spec[1:]) + 1)
    f = freqs[k]
    if 1 <= k < len(spec) - 1 and spec[k - 1] > 0 and spec[k + 1] > 0:
        la, lb, lc = np.log(spec[k - 1]), np.log(spec[k]), np.log(spec[k + 1])
        den = la - 2.0 * lb + lc
        if den < 0:  # genuine local max
            f = (k + 0.5 * (la - lc) / den) * (freqs[1] - freqs[0])
    return float(f * D / U)


def divergence_l2(ctx, solution) -> float:
    """|| div u ||_L2 over the mesh — the quantity whose residual the
    reference never assembles (SURVEY C13); useful as a diagnostic."""
    from ..fem.assembly import _gather_velocity, _phys_grads

    uc = _gather_velocity(ctx, jnp.asarray(solution))
    Gp = _phys_grads(ctx)
    gu = jnp.einsum("cdb,cbqa->cqda", uc, Gp, precision=_PREC)
    div = jnp.einsum("cqdd->cq", gu)
    val = jnp.sum(div**2 * ctx.jxw)
    if ctx.axis_name:
        val = jax.lax.psum(val, ctx.axis_name)
    return float(jnp.sqrt(val))
