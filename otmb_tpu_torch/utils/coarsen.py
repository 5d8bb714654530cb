"""LUMP/SPRAY matrix coarsening.

Counterpart of `otmb_tpu.utils.coarsen` and the reference `lump_and_spray`
(src/extratools.jl:38-112): block-coarsen the wet grid by (di, dj, dk),
using the transport operator's sparsity as a connectivity graph so that
cells which are not connected (across a land bridge, say) are not lumped
together; LUMP is volume-conserving, SPRAY copies coarse values back.

This is host work with scipy, as in the reference and the JAX package: T
leaves the card once through `utils.sparse_export.coeffs_to_scipy`, and
the coarse system is solved with a sparse direct solve. The full-resolution
path for the same physics is `models.solvers.ideal_age`.

The block labelling runs in a C++ core (`native/coarsen_native.cpp`), built
with g++ at its first use into the git-ignored `_build/` beside the
package's CUDA library, keyed by a hash of the source. `use_native=True`
(the default) builds and loads it or raises; `use_native=False` runs the
pure-Python labeller, the tests' oracle. The JAX package falls back to
Python silently; the port does not.

Layout: wet3d is (nz, ny, nx); di coarsens the i (lon) axis, dj the j
(lat) axis, dk the k (depth) axis, as the reference's (di, dj, dk) on its
(nx, ny, nz) arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components

from .. import _build

logger = logging.getLogger(__name__)

NATIVE_SOURCE = Path(__file__).resolve().parents[1] / "native" / "coarsen_native.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_native: ctypes.CDLL | None = None


def native_library_path() -> Path:
    """Where the labelling core for the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(NATIVE_SOURCE.read_bytes())
    return _build.BUILD_DIR / f"libcoarsen_native-{h.hexdigest()[:16]}.so"


def load_native() -> ctypes.CDLL:
    """Build (if needed) and load the C++ labelling core; raise
    RuntimeError with the compiler's output if g++ is missing or fails."""
    global _native
    if _native is not None:
        return _native
    path = native_library_path()
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        try:
            out = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(NATIVE_SOURCE)],
                                 capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"coarsen_native: g++ could not run ({e}); pass "
                               f"use_native=False for the Python labeller") from e
        if out.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"coarsen_native: g++ failed ({out.returncode}):\n{out.stderr}")
        os.replace(tmp, path)  # atomic under concurrent builds
    lib = ctypes.CDLL(str(path))
    lib.assign_lump_labels.restype = ctypes.c_int64
    lib.assign_lump_labels.argtypes = [ctypes.c_int64] * 6 + [ctypes.c_void_p] * 6
    _native = lib
    return lib


def _assign_lump_labels_py(nz, ny, nx, dk, dj, di, wet_ext, lwet_ext, mask, pattern):
    """Pure-Python block labelling (the semantics oracle of the C++ core)."""
    ez, ey, ex = nz + dk - 1, ny + dj - 1, nx + di - 1
    lump_idx = np.zeros((ez, ey, ex), dtype=np.int64)
    next_id = 2  # 1 is reserved for dry cells (reference extratools.jl:55)
    off_k, off_j, off_i = np.meshgrid(np.arange(dk), np.arange(dj), np.arange(di),
                                      indexing="ij")
    off_k, off_j, off_i = off_k.ravel(), off_j.ravel(), off_i.ravel()
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                if lump_idx[k, j, i] > 0 and mask[k, j, i]:
                    continue  # already assigned and inside the region
                if mask[k, j, i]:
                    bk, bj, bi = k + off_k, j + off_j, i + off_i
                    block_wet = wet_ext[bk, bj, bi]
                    lump_idx[bk[~block_wet], bj[~block_wet], bi[~block_wet]] = 1
                    wk, wj, wi = bk[block_wet], bj[block_wet], bi[block_wet]
                    widx = lwet_ext[wk, wj, wi]
                    if widx.size == 0:
                        continue
                    local = pattern[widx][:, widx]
                    ncomp, labels = connected_components(local, directed=False)
                    lump_idx[wk, wj, wi] = next_id + labels
                    next_id += ncomp
                else:
                    lump_idx[k, j, i] = next_id
                    next_id += 1
    return lump_idx, next_id - 1


def _assign_lump_labels_native(nz, ny, nx, dk, dj, di, wet_ext, lwet_ext, mask, pattern):
    """The C++ union-find core on the same arguments."""
    if dk * dj * di > 512:
        raise ValueError(f"coarsen_native: a block of {dk * dj * di} cells exceeds its 512")
    fn = load_native().assign_lump_labels
    ez, ey, ex = nz + dk - 1, ny + dj - 1, nx + di - 1
    lump_idx = np.zeros((ez, ey, ex), dtype=np.int64)
    buffers = (np.ascontiguousarray(wet_ext, dtype=np.uint8),
               np.ascontiguousarray(lwet_ext, dtype=np.int64),
               np.ascontiguousarray(mask, dtype=np.uint8),
               np.ascontiguousarray(pattern.indptr, dtype=np.int64),
               np.ascontiguousarray(pattern.indices, dtype=np.int64), lump_idx)
    n_ids = fn(nz, ny, nx, dk, dj, di, *(b.ctypes.data for b in buffers))
    if n_ids < 0:
        raise RuntimeError(f"coarsen_native: assign_lump_labels returned {n_ids}")
    return lump_idx, int(n_ids)


def lump_and_spray(wet3d, vol, T, mask=None, di: int = 2, dj: int = 2, dk: int = 1,
                   use_native: bool = True):
    """Return (LUMP, SPRAY, vol_c), host scipy matrices and a numpy vector.

    * `wet3d`: (nz, ny, nx) bool.
    * `vol`: length-N wet-cell volume vector (N = wet3d.sum(), C order).
    * `T`: N x N scipy sparse operator (`utils.sparse_export.coeffs_to_scipy`
      gives one from stencil coefficients); only its sparsity is used.
    * `mask`: optional (nz, ny, nx) bool region; outside it cells are not
      lumped (each keeps its own coarse cell), as in the reference.
    * `use_native`: the C++ labelling core (built on first use, raising if
      it cannot be), or the Python labeller with False.

    To coarsen a vector: LUMP @ x. To coarsen an operator: LUMP @ T @ SPRAY.
    """
    wet3d = np.asarray(wet3d, bool)
    nz, ny, nx = wet3d.shape
    mask = np.ones_like(wet3d) if mask is None else np.asarray(mask, bool)

    ez, ey, ex = nz + dk - 1, ny + dj - 1, nx + di - 1  # ghost-extended shape
    wet_ext = np.zeros((ez, ey, ex), dtype=bool)
    wet_ext[:nz, :ny, :nx] = wet3d
    # Wet linear index in the extended grid (reference extratools.jl:46-52).
    lwet_ext = np.full((ez, ey, ex), -1, dtype=np.int64)
    lwet_ext[wet_ext] = np.arange(int(wet_ext.sum()))
    n = int(wet3d.sum())

    # Connectivity among wet cells from T's pattern, symmetrised so that
    # components do not depend on the flow's direction. T.nonzero() drops
    # stored zeros, so the data array is sized from the indices.
    rows_nz, cols_nz = T.nonzero()
    pattern = sp.csr_matrix((np.ones(len(rows_nz), dtype=bool), (rows_nz, cols_nz)),
                            shape=T.shape)
    pattern = (pattern + pattern.T).tocsr()

    label = _assign_lump_labels_native if use_native else _assign_lump_labels_py
    lump_idx, n_ids = label(nz, ny, nx, dk, dj, di, wet_ext, lwet_ext, mask, pattern)

    # Drop ghost cells; map original cells -> lump ids (extratools.jl:85).
    ids = lump_idx[:nz, :ny, :nx].ravel()
    ncells = ids.size
    lump_full = sp.csr_matrix((np.ones(ncells), (ids - 1, np.arange(ncells))),
                              shape=(n_ids, ncells))
    wet = wet3d.ravel()
    wet_c = np.asarray(lump_full @ wet.astype(float)).ravel() > 0
    lump = lump_full[wet_c][:, wet]

    vol = np.asarray(vol, dtype=np.float64).ravel()
    vol_c = np.asarray(lump @ vol).ravel()
    lump = sp.diags(1.0 / vol_c) @ lump @ sp.diags(vol)
    spray = lump.T.tocsr().copy()
    spray.data = np.ones_like(spray.data)
    logger.info("LUMP and SPRAY: matrix size reduction %.0f%% (%d -> %d)",
                100 * (1 - lump.shape[0] / n), n, lump.shape[0])
    return lump.tocsr(), spray, vol_c


def ideal_age_coarsened(coeffs, indices, topology, v3d, mask=None, di: int = 2, dj: int = 2,
                        dk: int = 1, surface_rate: float = 1.0):
    """The reference's headline downstream workload end to end
    (test/local_full.jl:151-188): export T to a host sparse matrix,
    LUMP/SPRAY-coarsen it, build the coarse surface-restoring mask
    M_c = diag(LUMP @ 1_surface > 0), solve the coarse steady state

        (T_c + M_c) gamma_c = LUMP @ 1

    with scipy's sparse direct solve, and SPRAY the ages back to the fine
    grid. Host work by design, as in the reference (a laptop's direct
    solve); the card's path for the same physics is
    `models.solvers.ideal_age`. Returns (gamma3d seconds, NaN on land, as
    numpy; gamma_c; vol_c)."""
    from scipy.sparse.linalg import spsolve

    from ..grid.indices import _host, as3d, wet_vector
    from .sparse_export import coeffs_to_scipy

    T = coeffs_to_scipy(coeffs, indices, topology)
    wet = indices.wet3d.cpu().numpy().astype(bool)
    v = wet_vector(np.nan_to_num(_host(v3d).astype(np.float64)), indices)
    lump, spray, vol_c = lump_and_spray(wet, v, T, mask=mask, di=di, dj=dj, dk=dk)

    # surface mask (reference local_full.jl:154-163): the k = 0 layer
    issrf3d = wet.copy()
    issrf3d[1:] = False
    issrf = wet_vector(issrf3d.astype(np.float64), indices)

    T_c = (lump @ T @ spray).tocsc()
    issrf_c = np.asarray(lump @ issrf).ravel() > 0
    M_c = sp.diags(surface_rate * issrf_c.astype(np.float64))
    s_c = np.asarray(lump @ np.ones(T.shape[0])).ravel()
    gamma_c = spsolve((T_c + M_c).tocsc(), s_c)
    gamma = np.asarray(spray @ gamma_c).ravel()
    return as3d(gamma, wet), gamma_c, vol_c
