"""Problem-definition functions (forcing, inlet profile, initial condition).

JAX equivalents of the reference's Function subclasses
(``/root/reference/src/NavierStokesSolver.hpp:414-497``): plain numpy
callables evaluated on host at DoF support points / quadrature points, then
shipped to device as arrays.

Reference quirk (SURVEY C4): ``InletVelocity`` carries a factor
``sin(pi * get_time() / 8)`` but ``set_time`` is NEVER called in the shipped
code, so the factor stays sin(0) = 0 and the inlet is identically zero.  The
model layer reproduces this via ``freeze_inlet_time=True`` (default); set it
False to get the intended DFG-benchmark time-ramped profile.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["ZeroForcing", "ConstantForcing", "InletVelocity", "zero_initial_condition"]


@dataclass(frozen=True)
class ZeroForcing:
    """g = 0 (hpp:438: the reference's gravity constant is 0)."""

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return np.zeros_like(x)


@dataclass(frozen=True)
class ConstantForcing:
    """f = (0, ..., -g): the reference's ForcingTerm shape (hpp:417-425)."""

    g: float = 0.0

    def __call__(self, x: np.ndarray) -> np.ndarray:
        f = np.zeros_like(x)
        f[:, -1] = -self.g
        return f


@dataclass(frozen=True)
class InletVelocity:
    """Parabolic DFG profile 4 u_m y (H - y) sin(pi t / 8) / H^2 (hpp:447-475).

    x-component only; vanishes for y outside [0, H] is NOT enforced (the
    reference evaluates the same formula at every inlet DoF, whatever the
    mesh's y-extent — reproduced faithfully).
    """

    u_m: float = 1.5
    H: float = 0.41
    freeze_time: bool = True  # reference as-shipped: set_time never called

    def __call__(self, x: np.ndarray, t: float = 0.0) -> np.ndarray:
        v = np.zeros_like(x)
        t_eff = 0.0 if self.freeze_time else t
        y = x[:, 1]
        v[:, 0] = 4.0 * self.u_m * y * (self.H - y) * np.sin(np.pi * t_eff / 8.0) / self.H**2
        return v


def zero_initial_condition(n_total: int) -> np.ndarray:
    """u_0 = 0 (hpp:478-497)."""
    return np.zeros(n_total)
