"""Scatter-free global assembly: transpose gather maps.

An alternative to the scatter-add of element contributions (SURVEY §7
"hard parts" #1).  deal.II assembles with random scatter-add
(``matrix.add(dof_indices, cell_matrix)``, cpp:340); the XLA equivalent is
``segment_sum``, a scatter-add.

Instead we precompute, per global DoF, the (padded) list of flat positions of
its per-cell contributions.  The reduction

    y = segment_sum(yl.ravel(), cell_dofs.ravel(), n)

becomes the gather + dense row-sum

    y = yl_ext[gather_idx].sum(axis=1)        # [n, K] gather, K ~ max valence

which is a plain gather followed by a dense reduction.  K is
the max DoF valence (number of cells sharing a DoF; ~6-8 for 2D vertex DoFs,
2 for edge DoFs).  Padding rows point at a zero sentinel appended to the
source.
"""

from __future__ import annotations

import numpy as np

__all__ = ["build_gather_map", "gather_scatter"]


def build_gather_map(cell_dofs: np.ndarray, n: int) -> np.ndarray:
    """Transpose map: [n, K] flat positions into cell_dofs-shaped values.

    Position ``cell_dofs.size`` (one past the end) is the zero sentinel —
    callers append a single 0 to the flattened source before gathering.
    """
    flat = np.asarray(cell_dofs, dtype=np.int64).ravel()
    order = np.argsort(flat, kind="stable")
    sorted_dofs = flat[order]
    counts = np.bincount(sorted_dofs, minlength=n)
    K = int(counts.max()) if len(flat) else 1
    sentinel = flat.size
    idx = np.full((n, K), sentinel, dtype=np.int64)
    # row-major fill: position j within each dof's run
    starts = np.concatenate([[0], np.cumsum(counts[:-1])])
    within = np.arange(len(flat)) - starts[sorted_dofs]
    idx[sorted_dofs, within] = order
    return idx.astype(np.int32)


def gather_scatter(values_flat, gather_idx, *, xp):
    """y[i] = sum_k values_ext[gather_idx[i, k]] with a zero sentinel row.

    `values_flat`: flattened per-cell values [nc * nl]; `xp` = jnp (or np for
    testing).
    """
    ext = xp.concatenate([values_flat, xp.zeros((1,), dtype=values_flat.dtype)])
    return ext[gather_idx].sum(axis=1)
