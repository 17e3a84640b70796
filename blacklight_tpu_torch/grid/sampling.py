"""Sampling of a GRMHD grid at ray sample points, on tensors.

Port of ``blacklight_tpu/grid/sampling.py`` (:37-591) for Athena++
grids without slow light: one or many mesh blocks, trilinear
interpolation inside a block with extrapolation near its edges
(``simulation_interp = true``, simulation_sampling.cpp:495-516), the
nearest cell (``simulation_interp = false``), or exact trilinear
interpolation across block boundaries, at the same, a coarser or a
finer refinement level (``simulation_block_interp = true``, :505-552,
1068-1386; the neighbour table of ``grid/amr.py``). For each (B,) batch
of CKS positions the sampler converts to SKS, finds the block (the first
in file order whose closed box holds the point) and the cell on each
axis, blends the 8 corner values of every primitive, repairs
non-positive rho/pgas (and kappa, the electron entropy of plasma_model =
code_kappa, sampled as a ninth primitive where ``has_kappa``) against
the anchor cell, rounds through float32 as
the reference stores samples, and substitutes the fallback values off
the grid (with a ``nan_mask`` that the transfer turns into NaN pixels
under ``fallback_nan``).

The JAX package's TPU-shaped forms (one-hot centre lookups, the packed
corner table) compute the same values as plain indexing; the port
indexes. Its approximate interblock branch, for grids without refinement
metadata, is not ported (ROADMAP B.5b): Athena++ files carry the
metadata.

An FMKS grid (iharm3d, one block; grid/iharm3d.py) keeps its native
(x^1, x^2) coordinates: the off-grid test is made in SKS against the
grid's ``bounds``, and each sample's (r, theta) becomes (x^1, x^2) by a
bilinear lookup in the grid's inverse table ``sks_map`` (the JAX
package's forms and clamps, blacklight_tpu/grid/sampling.py:104-128)
before the cell search on the native faces.

A CKS grid (AthenaK; grid/athenak.py) is sampled at the positions' own
(x, y, z), which are its coordinates (the JAX package's :245-251): no
conversion, no periodic axis (its neighbour table has none either), and
a point outside every block is off the grid.
"""

from __future__ import annotations

import dataclasses

import torch

from blacklight_tpu_torch.grid.athena import SimulationGrid
from blacklight_tpu_torch.ops import sks
from blacklight_tpu_torch.utils.errors import BlacklightError

# Corner order (dk, dj, di) of the reference's 8-term trilinear sum
# (InterpolateSimple, simulation_sampling.cpp:1334-1351)
CORNER_ORDER = ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
                (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))
SAMPLE_NAMES = ("rho", "pgas", "uu1", "uu2", "uu3", "bb1", "bb2", "bb3")
# The sampled values repaired against the anchor cell where an
# interpolated one is not positive (simulation_sampling.cpp:821-827)
POSITIVE_NAMES = ("rho", "pgas", "kappa")

# Sampling modes (csrc/sim_sample.cuh SAMPLE_*): one block, trilinear
# clamped to it; many blocks (or nearest cell), the block search first;
# many blocks with exact interblock interpolation; one FMKS block, its
# map first, then trilinear clamped to it or the nearest cell.
SINGLE, BLOCKS, INTERBLOCK, FMKS = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class SamplerOptions:
    interp: bool = True
    # interpolate across block boundaries (simulation_block_interp)
    block_interp: bool = False
    fallback_nan: bool = True
    fallback_rho: float = 0.0
    fallback_pgas: float = 0.0
    fallback_kappa: float = 0.0
    # sample the ninth primitive, "kappa" (plasma_model = code_kappa)
    has_kappa: bool = False


def sample_names(opts: SamplerOptions) -> tuple:
    """The names sample_grid returns values of: SAMPLE_NAMES, then
    "kappa" where ``opts.has_kappa``."""
    return SAMPLE_NAMES + (("kappa",) if opts.has_kappa else ())


def locate(xf_row, xv_row, x):
    """Cell index, trilinear anchor and fraction along one axis.

    xf_row: (n+1,) faces, or (B, n+1), one row a sample; xv_row: (n,)
    centres, or (B, n); x: (B,) coordinates. i is the containing cell
    (the count of faces below x, less one, clamped); the anchor i_m backs
    off by one when x lies before the cell centre (except at the block
    edges), and the fraction may leave [0, 1] near the edges
    (extrapolation). Returns (i, i_m, f).
    """
    n = xv_row.shape[-1]
    idx = torch.sum(xf_row < x[..., None], dim=-1, dtype=torch.int64)
    i = torch.clamp(idx - 1, 0, n - 1)

    def at(c):
        if xv_row.dim() == 1:
            return xv_row[c]
        return torch.gather(xv_row, 1, c[:, None])[:, 0]

    xv_i = at(i)
    xv_im1 = at((i - 1) % n)
    xv_ip1 = at((i + 1) % n)
    use_i = (i == 0) | ((i != n - 1) & (x >= xv_i))
    i_m = torch.where(use_i, i, i - 1)
    lo = torch.where(use_i, xv_i, xv_im1)      # xv[i_m]
    hi = torch.where(use_i, xv_ip1, xv_i)      # xv[i_m + 1]
    f = (x - lo) / (hi - lo)
    return i, i_m, f


def sampling_mode(grid: SimulationGrid, opts: SamplerOptions) -> int:
    """The sampler's mode for ``grid`` under ``opts``: SINGLE (one block,
    trilinear), BLOCKS (many blocks, or the nearest cell), INTERBLOCK
    (many blocks, simulation_block_interp, on the neighbour table of
    grid/amr.with_amr_table) or FMKS (a grid with an FMKS map, trilinear
    or the nearest cell). Raises BlacklightError for interblock sampling
    of a grid without refinement metadata, ValueError for one whose table
    is not attached and for an FMKS grid of more than one block."""
    if grid.sks_map is not None:
        if grid.n_blocks != 1:
            raise ValueError("an FMKS grid has one block")
        return FMKS
    if grid.n_blocks == 1:
        return SINGLE if opts.interp else BLOCKS
    if not (opts.interp and opts.block_interp):
        return BLOCKS
    if grid.levels is None or grid.locations is None:
        raise BlacklightError(
            "blacklight_tpu_torch does not support simulation_block_interp "
            "on grids without refinement metadata (Levels, "
            "LogicalLocations) yet (ROADMAP B.5b); use blacklight_tpu for "
            "this input.")
    if grid.amr_table is None:
        raise ValueError("interblock sampling needs the grid's neighbour "
                         "table (grid.amr.with_amr_table)")
    return INTERBLOCK


def fmks_native(grid: SimulationGrid, r, th):
    """Native (x^1, x^2) of SKS (r, theta) on an FMKS grid: bilinear in
    the inverse table (simulation_sampling.cpp:397-412, bilinear where
    the reference interpolates x^1 in r only and x^2 in theta only), the
    table cell clamped to the table and the weights to [0, 1]. The cell
    index is clamped before its conversion to an integer (0 for NaN),
    which gives the JAX package's saturating conversion."""
    table = grid.sks_map
    n2m, n1m = table.shape[1], table.shape[2]
    fi = (r - grid.map_r_in) / grid.map_dr
    fj = th / grid.map_dtheta

    def cell(t, top):
        t = torch.floor(t)
        return torch.where(t > 0.0, t.clamp(max=top), 0.0).long()

    i0, j0 = cell(fi, n1m - 2), cell(fj, n2m - 2)
    wi = torch.clamp(fi - i0, 0.0, 1.0)
    wj = torch.clamp(fj - j0, 0.0, 1.0)
    x1, x2 = table[0], table[1]
    q1 = (1 - wi) * x1[j0, i0] + wi * x1[j0, i0 + 1]
    q2 = ((1 - wj) * ((1 - wi) * x2[j0, i0] + wi * x2[j0, i0 + 1])
          + wj * ((1 - wi) * x2[j0 + 1, i0] + wi * x2[j0 + 1, i0 + 1]))
    return q1, q2


def locate_anchor(grid: SimulationGrid, r, th, ph):
    """Block and cell location: (b, (i, j, k), (i_m, j_m, k_m)
    unclamped, (f_i, f_j, f_k), off_grid). The block is the first in file
    order whose closed box holds the point (the reference's linear
    search, simulation_sampling.cpp:352-394); off_grid where none does.
    An FMKS grid is tested against its SKS bounds and searched at the
    point's native (x^1, x^2) (fmks_native).
    """
    if grid.sks_map is not None:
        r_lo, r_hi, th_lo, th_hi, ph_lo, ph_hi = grid.bounds
        off_grid = ((r < r_lo) | (r > r_hi) | (th < th_lo) | (th > th_hi)
                    | (ph < ph_lo) | (ph > ph_hi))
        r, th = fmks_native(grid, r, th)
    if grid.n_blocks == 1:
        b = torch.zeros(r.shape, dtype=torch.int64, device=r.device)
        x1f, x1v = grid.x1f[0], grid.x1v[0]
        x2f, x2v = grid.x2f[0], grid.x2v[0]
        x3f, x3v = grid.x3f[0], grid.x3v[0]
        if grid.sks_map is None:
            off_grid = ((r < x1f[0]) | (r > x1f[-1]) | (th < x2f[0])
                        | (th > x2f[-1]) | (ph < x3f[0]) | (ph > x3f[-1]))
    else:
        contains = ((r[:, None] >= grid.x1f[None, :, 0])
                    & (r[:, None] <= grid.x1f[None, :, -1])
                    & (th[:, None] >= grid.x2f[None, :, 0])
                    & (th[:, None] <= grid.x2f[None, :, -1])
                    & (ph[:, None] >= grid.x3f[None, :, 0])
                    & (ph[:, None] <= grid.x3f[None, :, -1]))
        off_grid = ~torch.any(contains, dim=-1)
        b = torch.argmax(contains.to(torch.uint8), dim=-1)
        x1f, x1v = grid.x1f[b], grid.x1v[b]
        x2f, x2v = grid.x2f[b], grid.x2v[b]
        x3f, x3v = grid.x3f[b], grid.x3v[b]
    i, i_m, f_i = locate(x1f, x1v, r)
    j, j_m, f_j = locate(x2f, x2v, th)
    k, k_m, f_k = locate(x3f, x3v, ph)
    return b, (i, j, k), (i_m, j_m, k_m), (f_i, f_j, f_k), off_grid


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
    fallback = {"rho": opts.fallback_rho, "pgas": opts.fallback_pgas,
                "kappa": opts.fallback_kappa}
    out = {}
    for name in sample_names(opts):
        v = named[name].to(torch.float32).to(pos_dtype)
        out[name] = torch.where(off_grid, fallback.get(name, 0.0), v)
    out["off_grid"] = off_grid
    out["nan_mask"] = off_grid if opts.fallback_nan \
        else torch.zeros_like(off_grid)
    return out


def interblock_corners(grid: SimulationGrid, b, cells, coords):
    """Exact interblock interpolation (simulation_sampling.cpp:505-552,
    FindNearbyInds :1068-1321; the JAX package's :371-475): the corner
    cells and the fractions of samples in blocks ``b`` with containing
    cells ``cells`` (i, j, k) at SKS ``coords`` (r, th, ph).

    The anchors are not clamped to the block: a fraction takes the ghost
    centre past a block face (the mirror of the edge centre through the
    lower face; past the upper face the reference's read of x?v(b, n),
    which its contiguous array answers with the next block's first
    centre, and the last block with the mirror through its upper face),
    and each corner outside the block resolves through the neighbour
    table to a block at the same, a coarser or a finer level. Returns
    ([(b, k, j, i)] * 8 in CORNER_ORDER, (f_i, f_j, f_k)).
    """
    n_b = grid.n_blocks
    axes = ((grid.x1f, grid.x1v), (grid.x2f, grid.x2v), (grid.x3f, grid.x3v))
    anchors, fracs, centres = [], [], []
    for (xf, xv), c, x in zip(axes, cells, coords):
        n = xv.shape[1]
        rows = xv[b]
        xv_c = torch.gather(rows, 1, c[:, None])[:, 0]
        base = torch.where(x >= xv_c, c, c - 1)   # in [-1, n - 1]
        xv0, xf0 = xv[b, 0], xf[b, 0]
        xv_last, xf_last = xv[b, -1], xf[b, -1]
        lo = torch.where(base == -1, 2.0 * xf0 - xv0, torch.gather(
            rows, 1, torch.clamp(base, 0, n - 1)[:, None])[:, 0])
        flat = xv.reshape(-1)
        nxt = torch.where(b == n_b - 1, 2.0 * xf_last - xv_last,
                          flat[torch.clamp(b * n + n, max=flat.numel() - 1)])
        hi = torch.where(base + 1 == n, 2.0 * nxt - xv_last, torch.gather(
            rows, 1, torch.clamp(base + 1, 0, n - 1)[:, None])[:, 0])
        anchors.append(base)
        fracs.append((x - lo) / (hi - lo))
        centres.append(xv_c)

    n_i, n_j, n_k = (xv.shape[1] for _, xv in axes)
    table = grid.amr_table.reshape(-1, grid.amr_table.shape[-1]).long()
    parity = grid.loc_parity[b].long()                 # (B, 3)

    def axis_index(e, par, ck, upper, n, c, x, xv_c, case):
        # a crossed axis with no grid there was clamped onto the home
        # block (":1224-1229"): e == 0 takes the clamped index, the upper
        # flags stay the raw index's
        cs = torch.clamp(ck, 0, n - 1)
        same = torch.where(e == 0, cs, torch.where(e == -1, n - 1, 0))
        coarse = torch.where(e == 0, (par * n + cs) >> 1,
                             torch.where(e == -1, n - 1, 0))
        fine = torch.where(e == 0, torch.where(upper, (cs - n // 2) * 2,
                                               cs * 2),
                           torch.where(e == -1, n - 2, 0))
        # the fine cell nudged toward the sample (":1310-1312"): a crossed
        # axis that exists compares its raw index (-1 or n)
        ca = torch.where(e == 0, cs, ck)
        fine = fine + ((ca < c) | ((ca == c) & (x > xv_c))).long()
        return torch.where(case == 0, same, torch.where(case == 1, coarse,
                                                        fine))

    corners = []
    for dk, dj, di in CORNER_ORDER:
        ck = [anchors[0] + di, anchors[1] + dj, anchors[2] + dk]
        n = (n_i, n_j, n_k)
        side = [torch.where(ck[a] == -1, -1, torch.where(ck[a] == n[a], 1, 0))
                for a in range(3)]
        upper = [ck[a] > n[a] // 2 for a in range(3)]
        dir_idx = (side[2] + 1) * 9 + (side[1] + 1) * 3 + (side[0] + 1)
        half = upper[2].long() * 4 + upper[1].long() * 2 + upper[0].long()
        entry = table[(b * 27 + dir_idx) * 8 + half]   # (B, 5)
        ii, jj, kk = (axis_index(entry[:, 2 + a], parity[:, a], ck[a],
                                 upper[a], n[a], cells[a], coords[a],
                                 centres[a], entry[:, 1])
                      for a in range(3))
        corners.append((entry[:, 0], kk, jj, ii))
    return corners, tuple(fracs)


def sample_grid(grid: SimulationGrid, pos, spin, opts: SamplerOptions):
    """Sample the primitives at CKS positions ``pos`` (B, 4), converted to
    SKS for an SKS grid and taken as they are for a CKS grid.

    Returns a dict of (B,) values keyed by sample_names(opts) in the
    working dtype, plus "off_grid" and "nan_mask" (B,) bool.
    """
    x, y, z = pos[..., 1], pos[..., 2], pos[..., 3]
    if grid.coords == "cks":
        return sample_sks(grid, x, y, z, opts)
    r, th, ph = sks.cks_to_sks(x, y, z, spin)
    return sample_sks(grid, r, th, ph, opts)


def sample_sks(grid: SimulationGrid, r, th, ph, opts: SamplerOptions):
    """sample_grid at the grid's own coordinates (r, th, ph), (B,) each:
    SKS, or (x, y, z) on a CKS grid."""
    mode = sampling_mode(grid, opts)
    nvar, n_b, n_k, n_j, n_i = grid.prim.shape
    b, (i, j, k), (i_m, j_m, k_m), (f_i, f_j, f_k), off_grid = \
        locate_anchor(grid, r, th, ph)

    if mode == INTERBLOCK:
        corners, (f_i, f_j, f_k) = interblock_corners(
            grid, b, (i, j, k), (r, th, ph))
    elif opts.interp:
        # clamp the anchors so that every read stays in the block
        # (off-grid samples are overwritten in finalize_sample)
        i_m = torch.clamp(i_m, 0, n_i - 2)
        j_m = torch.clamp(j_m, 0, n_j - 2)
        k_m = torch.clamp(k_m, 0, n_k - 2)
        corners = [(b, k_m + dk, j_m + dj, i_m + di)
                   for dk, dj, di in CORNER_ORDER]
    else:
        corners = [(b, k, j, i)]

    flat = grid.prim.reshape(nvar, -1)
    n_cells = flat.shape[1]
    # a fine-level corner may index one cell past its row; the flat index
    # then reads on, as the reference's contiguous array does, and is
    # clamped at the table's end, as the JAX package's gather clamps
    values = [flat[:, torch.clamp(((bb * n_k + kk) * n_j + jj) * n_i + ii,
                                  0, n_cells - 1)]
              for bb, kk, jj, ii in corners]              # (nvar, B) each
    if len(values) == 1:
        vals = anchor = values[0]
    else:
        w = trilinear_weights(f_i, f_j, f_k)
        vals = sum(wc * cc for wc, cc in zip(w, values))
        anchor = values[0]
    named = {}
    for name in sample_names(opts):
        v = vals[grid.ind[name]]
        if opts.interp and name in POSITIVE_NAMES:
            # positivity repair against the anchor cell
            # (simulation_sampling.cpp:821-827)
            v = torch.where(v <= 0.0, anchor[grid.ind[name]].to(v.dtype), v)
        named[name] = v
    return finalize_sample(named, off_grid, opts, r.dtype)
