"""Diagnostic plots (matplotlib, optional).

Counterpart of `otmb_tpu.utils.plotting`: surface maps and zonal sections
of canonical-layout fields, NaN-masked like the reference's Makie plots
(test/local_fast.jl, test/local_full.jl). matplotlib is imported only when
a plot is made, so nothing else in the port needs it. Tensors are copied
to the host first.
"""

from __future__ import annotations

import numpy as np

from ..grid.indices import _host


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError as e:
        raise ImportError("matplotlib is required for plotting") from e


def plot_surface(field2d, gridmetrics=None, title: str = "", units: str = "",
                 path: str | None = None, cmap: str = "viridis"):
    """Surface map of a (ny, nx) field (NaN = land, drawn blank). Returns
    `path` when given (the figure saved and closed), else the figure."""
    plt = _plt()
    field2d = _host(field2d)
    fig, ax = plt.subplots(figsize=(9, 4.5), constrained_layout=True)
    if gridmetrics is not None:
        pc = ax.pcolormesh(_host(gridmetrics.lon), _host(gridmetrics.lat), field2d, cmap=cmap,
                           shading="nearest")
        ax.set_xlabel("longitude (°)")
        ax.set_ylabel("latitude (°)")
    else:
        pc = ax.pcolormesh(field2d, cmap=cmap, shading="nearest")
        ax.set_xlabel("i")
        ax.set_ylabel("j")
    fig.colorbar(pc, ax=ax, label=units)
    ax.set_title(title)
    if path:
        fig.savefig(path, dpi=130)
        plt.close(fig)
        return path
    return fig


def plot_zonal_section(field3d, gridmetrics, v3d=None, title: str = "", units: str = "",
                       path: str | None = None, cmap: str = "viridis"):
    """Volume-weighted zonal-mean section (depth against latitude), the
    reference's ideal-age diagnostic plot (test/local_full.jl:171-183)."""
    plt = _plt()
    field3d = _host(field3d)
    lat = _host(gridmetrics.lat)
    zt = _host(gridmetrics.zt)
    w = _host(gridmetrics.v3d if v3d is None else v3d)
    w = np.where(np.isfinite(w) & np.isfinite(field3d), w, 0.0)
    f = np.where(w > 0, field3d, 0.0)
    num = (f * w).sum(axis=-1)  # (nz, ny)
    den = w.sum(axis=-1)
    zonal = np.where(den > 0, num / np.where(den > 0, den, 1.0), np.nan)
    fig, ax = plt.subplots(figsize=(8, 4.5), constrained_layout=True)
    pc = ax.pcolormesh(lat.max(axis=-1), zt, zonal, cmap=cmap, shading="nearest")
    ax.invert_yaxis()
    ax.set_xlabel("latitude (°)")
    ax.set_ylabel("depth (m)")
    fig.colorbar(pc, ax=ax, label=units)
    ax.set_title(title)
    if path:
        fig.savefig(path, dpi=130)
        plt.close(fig)
        return path
    return fig
