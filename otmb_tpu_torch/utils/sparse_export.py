"""Export the stencil operator to a scipy sparse matrix over wet cells,
the reference's user-facing artifact (a SparseMatrixCSC over the N wet
cells, matrixbuilding.jl:41)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..grid.indices import Indices
from ..grid.topology import DIRECTIONS, GridTopology
from ..ops.coeffs import StencilCoeffs


def neighbor_index_map(direction: str, topo: GridTopology) -> np.ndarray:
    """(nz, ny, nx) linear index of each cell's neighbour, -1 where none
    (the numpy mirror of grid/topology.py)."""
    nz, ny, nx = topo.shape3d
    idx = np.arange(nz * ny * nx, dtype=np.int64).reshape(nz, ny, nx)
    out = np.full_like(idx, -1)
    if direction == "east":
        out = np.roll(idx, -1, axis=-1)
    elif direction == "west":
        out = np.roll(idx, 1, axis=-1)
    elif direction == "north":
        out[:, :-1, :] = idx[:, 1:, :]
        if topo.is_tripolar:
            out[:, -1, :] = idx[:, -1, ::-1]
    elif direction == "south":
        out[:, 1:, :] = idx[:, :-1, :]
    elif direction == "bottom":
        out[:-1] = idx[1:]
    elif direction == "top":
        out[1:] = idx[:-1]
    else:
        raise ValueError(direction)
    return out


def coeffs_to_scipy(coeffs: StencilCoeffs, indices: Indices,
                    topo: GridTopology) -> sp.csr_matrix:
    """The N x N wet-cell sparse matrix equal to the stencil operator, in
    the wet-linear order of `indices` (C order over (nz, ny, nx))."""
    n = indices.nwet
    lwet3d_flat = indices.lwet3d.reshape(-1)
    host = lambda t: t.detach().cpu().numpy().reshape(-1)[indices.lwet]

    rows, cols, vals = [np.arange(n)], [np.arange(n)], [host(coeffs.diag)]
    for d in DIRECTIONS:
        coef = host(coeffs[d])
        nb_lin = neighbor_index_map(d, topo).reshape(-1)[indices.lwet]
        has_nb = nb_lin >= 0
        nb_wet_idx = np.where(has_nb, lwet3d_flat[nb_lin], -1)
        if np.any(has_nb & (nb_wet_idx < 0) & (coef != 0)):
            raise ValueError(f"nonzero {d} coefficient pointing at a dry cell")
        active = has_nb & (nb_wet_idx >= 0) & (coef != 0)
        rows.append(np.flatnonzero(active))
        cols.append(nb_wet_idx[active])
        vals.append(coef[active])

    mat = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )
    mat.sum_duplicates()
    return mat
