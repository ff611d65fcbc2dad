"""Dirichlet boundary conditions: interpolation + row constraint arrays.

JAX replacement for deal.II ``VectorTools::interpolate_boundary_values``
+ ``MatrixTools::apply_boundary_values`` (``/root/reference/src/
NavierStokesSolver.cpp:349-377``).  Instead of mutating a sparse matrix, the
constrained rows become static index arrays; the matrix-free operator replaces
constrained rows by ``diag * x`` (eliminate_columns=false semantics, matching
the reference's ``apply_boundary_values(..., false)``), and the residual gets
``r[rows] = diag[rows] * value``.

Override semantics match the reference: specs later in the list WIN on shared
DoFs (walls override inlet where boundaries touch, cpp:354-373).

The reference's as-shipped quirk — ``InletVelocity::set_time`` is never called
so the sin(pi t / 8) factor stays sin(0) = 0 and the inlet is identically zero
(SURVEY C4) — is reproduced by the models layer via ``freeze_inlet_time``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from .dofs import TaylorHoodDofs

__all__ = ["DirichletBC", "DirichletSet", "build_dirichlet"]

# value function: (coords [n, dim], t) -> [n, dim] velocity values
ValueFn = Callable[[np.ndarray, float], np.ndarray]


def zero_velocity(x: np.ndarray, t: float = 0.0) -> np.ndarray:
    return np.zeros_like(x)


@dataclass(frozen=True)
class DirichletBC:
    """One boundary condition: tags -> velocity value function.

    components: mask over velocity components (reference uses {true,true,false}
    i.e. velocity-only — pressure is never constrained, cpp:361-362).
    """

    tags: tuple
    value: ValueFn = zero_velocity
    components: tuple | None = None  # default: all velocity components


@dataclass
class DirichletSet:
    """Frozen constrained-row structure + host-side value evaluation."""

    rows: np.ndarray  # [n_bc] global dof ids (into the [u|p] planar layout)
    _scalar_dofs: np.ndarray  # [n_bc] scalar velocity dof of each row
    _comps: np.ndarray  # [n_bc] component of each row
    _spec_of_row: np.ndarray  # [n_bc] which BC spec provides the value
    _specs: Sequence[DirichletBC]
    _coords: np.ndarray  # [n_bc, dim] support point of each constrained dof

    @property
    def n(self) -> int:
        return len(self.rows)

    def values(self, t: float = 0.0) -> np.ndarray:
        """Evaluate constrained values at time t (host, tiny)."""
        out = np.zeros(self.n)
        for s, spec in enumerate(self._specs):
            m = self._spec_of_row == s
            if not np.any(m):
                continue
            v = np.asarray(spec.value(self._coords[m], t))
            out[m] = v[np.arange(m.sum()), self._comps[m]]
        return out


def build_dirichlet(dofs: TaylorHoodDofs, specs: Sequence[DirichletBC]) -> DirichletSet:
    """Resolve BC specs into constrained rows; later specs override earlier."""
    dim = dofs.dim
    owner = {}  # (scalar_dof, comp) -> spec index ; insertion order = priority
    for s, spec in enumerate(specs):
        comps = spec.components if spec.components is not None else tuple(range(dim))
        sdofs = dofs.boundary_scalar_vdofs(list(spec.tags))
        for c in comps:
            for d in sdofs:
                owner[(int(d), c)] = s  # later specs overwrite

    if not owner:
        return DirichletSet(
            rows=np.zeros(0, dtype=np.int32),
            _scalar_dofs=np.zeros(0, dtype=np.int32),
            _comps=np.zeros(0, dtype=np.int32),
            _spec_of_row=np.zeros(0, dtype=np.int32),
            _specs=list(specs),
            _coords=np.zeros((0, dim)),
        )

    items = sorted(owner.items())
    sdofs = np.array([k[0] for k, _ in items], dtype=np.int32)
    comps = np.array([k[1] for k, _ in items], dtype=np.int32)
    spec_of = np.array([v for _, v in items], dtype=np.int32)
    rows = (comps.astype(np.int64) * dofs.n_vs + sdofs).astype(np.int32)
    return DirichletSet(
        rows=rows,
        _scalar_dofs=sdofs,
        _comps=comps,
        _spec_of_row=spec_of,
        _specs=list(specs),
        _coords=dofs.v_coords[sdofs],
    )
