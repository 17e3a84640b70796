"""Sampling of a GRMHD grid at ray sample points, on tensors.

Port of ``blacklight_tpu/grid/sampling.py`` (:37-353) for the port's
slice: one mesh block, trilinear interpolation inside the block with
extrapolation near its edges (``simulation_interp = true``,
``simulation_block_interp = false``, simulation_sampling.cpp:495-516),
no slow light. For each (B,) batch of CKS positions the sampler converts
to SKS, locates the cell on each axis, blends the 8 corner values of
every primitive, repairs non-positive rho/pgas against the anchor cell,
rounds through float32 as the reference stores samples, and substitutes
the fallback values off the grid (with a ``nan_mask`` that the transfer
turns into NaN pixels under ``fallback_nan``).

The JAX package's TPU-shaped forms (one-hot centre lookups, the packed
corner table) compute the same values as plain indexing; the port
indexes.
"""

from __future__ import annotations

import dataclasses

import torch

from blacklight_tpu_torch.grid.athena import SimulationGrid
from blacklight_tpu_torch.ops import sks

# Corner order (dk, dj, di) of the reference's 8-term trilinear sum
# (InterpolateSimple, simulation_sampling.cpp:1334-1351)
CORNER_ORDER = ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
                (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))
SAMPLE_NAMES = ("rho", "pgas", "uu1", "uu2", "uu3", "bb1", "bb2", "bb3")


@dataclasses.dataclass(frozen=True)
class SamplerOptions:
    fallback_nan: bool = True
    fallback_rho: float = 0.0
    fallback_pgas: float = 0.0


def locate(xf_row, xv_row, x):
    """Cell index, trilinear anchor and fraction along one axis.

    xf_row: (n+1,) faces; xv_row: (n,) centres; x: (B,) coordinates.
    i is the containing cell (the count of faces below x, less one,
    clamped); the anchor i_m backs off by one when x lies before the
    cell centre (except at the block edges), and the fraction may leave
    [0, 1] near the edges (extrapolation). Returns (i, i_m, f).
    """
    n = xv_row.shape[-1]
    idx = torch.sum(xf_row < x[..., None], dim=-1, dtype=torch.int64)
    i = torch.clamp(idx - 1, 0, n - 1)
    xv_i = xv_row[i]
    xv_im1 = xv_row[(i - 1) % n]
    xv_ip1 = xv_row[(i + 1) % n]
    use_i = (i == 0) | ((i != n - 1) & (x >= xv_i))
    i_m = torch.where(use_i, i, i - 1)
    lo = torch.where(use_i, xv_i, xv_im1)      # xv[i_m]
    hi = torch.where(use_i, xv_ip1, xv_i)      # xv[i_m + 1]
    f = (x - lo) / (hi - lo)
    return i, i_m, f


def locate_anchor(grid: SimulationGrid, r, th, ph):
    """Single-block cell location: ((i, j, k), (i_m, j_m, k_m) unclamped,
    (f_i, f_j, f_k), off_grid)."""
    if grid.n_blocks != 1:
        raise ValueError("the port's sampler covers single-block grids")
    x1f, x1v = grid.x1f[0], grid.x1v[0]
    x2f, x2v = grid.x2f[0], grid.x2v[0]
    x3f, x3v = grid.x3f[0], grid.x3v[0]
    off_grid = ((r < x1f[0]) | (r > x1f[-1]) | (th < x2f[0])
                | (th > x2f[-1]) | (ph < x3f[0]) | (ph > x3f[-1]))
    i, i_m, f_i = locate(x1f, x1v, r)
    j, j_m, f_j = locate(x2f, x2v, th)
    k, k_m, f_k = locate(x3f, x3v, ph)
    return (i, j, k), (i_m, j_m, k_m), (f_i, f_j, f_k), off_grid


def trilinear_weights(f_i, f_j, f_k):
    """The reference's 8-term corner weights, in CORNER_ORDER."""
    return [(1 - f_k) * (1 - f_j) * (1 - f_i),
            (1 - f_k) * (1 - f_j) * f_i,
            (1 - f_k) * f_j * (1 - f_i),
            (1 - f_k) * f_j * f_i,
            f_k * (1 - f_j) * (1 - f_i),
            f_k * (1 - f_j) * f_i,
            f_k * f_j * (1 - f_i),
            f_k * f_j * f_i]


def finalize_sample(named, off_grid, opts: SamplerOptions, pos_dtype):
    """Round through float32 (the reference stores samples as float,
    simulation_sampling.cpp:836-844) and substitute the fallback values
    off the grid (:376-384, 676-707). Values stay finite; ``nan_mask``
    marks the samples the transfer turns into NaN pixels."""
    fallback = {"rho": opts.fallback_rho, "pgas": opts.fallback_pgas}
    out = {}
    for name in SAMPLE_NAMES:
        v = named[name].to(torch.float32).to(pos_dtype)
        out[name] = torch.where(off_grid, fallback.get(name, 0.0), v)
    out["off_grid"] = off_grid
    out["nan_mask"] = off_grid if opts.fallback_nan \
        else torch.zeros_like(off_grid)
    return out


def sample_grid(grid: SimulationGrid, pos, spin, opts: SamplerOptions):
    """Sample the primitives at CKS positions ``pos`` (B, 4).

    Returns a dict of (B,) values keyed by SAMPLE_NAMES in the working
    dtype, plus "off_grid" and "nan_mask" (B,) bool.
    """
    x, y, z = pos[..., 1], pos[..., 2], pos[..., 3]
    r, th, ph = sks.cks_to_sks(x, y, z, spin)
    nvar, _, n_k, n_j, n_i = grid.prim.shape
    _, (i_m, j_m, k_m), (f_i, f_j, f_k), off_grid = locate_anchor(
        grid, r, th, ph)
    # clamp the anchors so that every read stays in the block (off-grid
    # samples are overwritten in finalize_sample)
    i_m = torch.clamp(i_m, 0, n_i - 2)
    j_m = torch.clamp(j_m, 0, n_j - 2)
    k_m = torch.clamp(k_m, 0, n_k - 2)

    flat = grid.prim.reshape(nvar, -1)
    corners = [flat[:, ((k_m + dk) * n_j + (j_m + dj)) * n_i + (i_m + di)]
               for dk, dj, di in CORNER_ORDER]            # 8 x (nvar, B)
    w = trilinear_weights(f_i, f_j, f_k)
    vals = sum(wc * cc for wc, cc in zip(w, corners))
    anchor = corners[0]
    named = {}
    for name in SAMPLE_NAMES:
        v = vals[grid.ind[name]]
        if name in ("rho", "pgas"):
            # positivity repair against the anchor cell
            # (simulation_sampling.cpp:821-827)
            v = torch.where(v <= 0.0, anchor[grid.ind[name]].to(v.dtype), v)
        named[name] = v
    return finalize_sample(named, off_grid, opts, pos.dtype)
