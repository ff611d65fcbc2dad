"""navier_stokes_tpu — incompressible Navier-Stokes FEM framework in JAX.

A ground-up JAX/XLA re-design with the capability surface of
giuseppeegentile/Navier-Stokes-dealii (deal.II + Trilinos + MPI; see SURVEY.md
at the repo root for the layer-by-layer mapping):

  mesh/      gmsh .msh reader (v2.2/v4.1), generators, uniform refinement
  fem/       simplex quadrature, P1/P2/P3 elements, DoFs, batched assembly, BCs
  la/        matrix-free element operators, FGMRES, CG, block preconditioners
  models/    StokesSolver, NavierStokesSolver (Newton + implicit Euler),
             flow functionals (Cd/Cl/Strouhal)
  parallel/  shard_map domain decomposition over a device mesh
  io/        HDF5+XDMF visualization output, checkpoint/restore
  utils/     parity-format run logging
"""

from .config import SolverConfig
from .fem.assembly import FEMContext, assemble_navier_stokes, assemble_stokes, build_context
from .fem.dofs import make_dofs
from .mesh.generate import box, rectangle, unit_square
from .mesh.mesh import Mesh, refine_uniform
from .mesh.msh_io import read_msh
from .models.navier_stokes import NavierStokesSolver
from .models.stokes import StokesSolver
from .utils.logging import RunLog

__version__ = "0.1.0"

__all__ = [
    "SolverConfig",
    "FEMContext",
    "assemble_navier_stokes",
    "assemble_stokes",
    "build_context",
    "make_dofs",
    "box",
    "rectangle",
    "unit_square",
    "Mesh",
    "refine_uniform",
    "read_msh",
    "NavierStokesSolver",
    "StokesSolver",
    "RunLog",
    "__version__",
]
