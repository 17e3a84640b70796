"""The neighbour table of exact interblock sampling on AMR grids.

Port of ``blacklight_tpu/grid/amr.py`` (:36-262). The reference resolves
every trilinear corner that leaves its mesh block with FindNearbyInds
(simulation_sampling.cpp:1068-1321): the neighbour block may be at the
same refinement level, one coarser or one finer; phi neighbours wrap the
periodic boundary of an SKS grid (a CKS grid, AthenaK's, has no periodic
axis, :1183-1211); a direction with no grid falls back to constant
extrapolation (the corner clamps onto the home block). Which block that
is depends only on the home block, the axes the corner crossed and the
half of the block the sample lies in, so the host works it out once for
every such key into a dense (n_b, 27, 8, 5) int32 table; the cell
indices are a few integer operations per corner at sample time
(grid/sampling.py, csrc/sim_sample.cuh).

The block lookups go through a dictionary of the blocks' (level, i, j,
k) where the JAX package scans the block list; each key keeps its first
block in file order, which is the block that scan finds, so the tables
are equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blacklight_tpu_torch.utils.errors import BlacklightError

# Table fields (int32): 0 the neighbour block b_alt; 1 its case, 0 same
# level, 1 coarser, 2 finer; 2..4 the per-axis crossing (-1, 0, +1) that
# remains after clamping where the grid ends, in (di, dj, dk) order.
TABLE_FIELDS = 5


def _d2(x):
    """C++ division by 2, truncating toward zero ((-1) / 2 == 0): the
    reference's coarser-level location arithmetic relies on it
    (simulation_sampling.cpp:1118-1121)."""
    return x // 2 if x >= 0 else -((-x) // 2)


def _find_nearby_block(where, level, li, lj, lk, max_level, n_3_level,
                       periodic_phi, di, dj, dk, ui, uj, uk):
    """FindNearbyInds' block resolution (simulation_sampling.cpp:
    1068-1321) for one key of the block at ``level`` and logical location
    (li, lj, lk) of a grid whose third axis wraps where ``periodic_phi``
    (SKS; not CKS): ``where`` maps (level, i, j, k) to the first block
    there. di/dj/dk in {-1, 0, +1}: the corner
    index below, inside or above the block's range; ui/uj/uk the
    reference's upper flags (corner index > n / 2). Returns (b_alt, case,
    eff_di, eff_dj, eff_dk)."""

    def exists(*keys):
        return any(key in where for key in keys)

    # does the grid continue in each crossed direction, at the same, a
    # coarser or a finer level (":1099-1211")
    def x1_exists():
        return exists(
            (level, li - 1 if di == -1 else li + 1, lj, lk),
            (level - 1, _d2(li - 1) if di == -1 else _d2(li + 1), _d2(lj),
             _d2(lk)),
            (level + 1, li * 2 - 1 if di == -1 else li * 2 + 2,
             lj * 2 + 1 if uj else lj * 2, lk * 2 + 1 if uk else lk * 2))

    def x2_exists():
        return exists(
            (level, li, lj - 1 if dj == -1 else lj + 1, lk),
            (level - 1, li // 2, _d2(lj - 1) if dj == -1 else _d2(lj + 1),
             _d2(lk)),
            (level + 1, li * 2 + 1 if ui else li * 2,
             lj * 2 - 1 if dj == -1 else lj * 2 + 2,
             lk * 2 + 1 if uk else lk * 2))

    def x3_exists():
        fine_i = li * 2 + 1 if ui else li * 2
        fine_j = lj * 2 + 1 if uj else lj * 2
        if exists((level, li, lj, lk - 1 if dk == -1 else lk + 1),
                  (level - 1, _d2(li), _d2(lj),
                   _d2(lk - 1) if dk == -1 else _d2(lk + 1)),
                  (level + 1, fine_i, fine_j,
                   lk * 2 - 1 if dk == -1 else lk * 2 + 2)):
            return True
        if not periodic_phi:
            return False
        # the periodic wrap (":1183-1211"); n_3_level holds the levels
        # that exist, and a level outside it has no block
        def last(lev):
            return n_3_level[lev] - 1 if 0 <= lev < len(n_3_level) else None
        if dk == -1 and lk == 0:
            return exists((level, li, lj, last(level)),
                          (level - 1, _d2(li), _d2(lj), last(level - 1)),
                          (level + 1, fine_i, fine_j, last(level + 1)))
        if dk == 1 and lk == n_3_level[level] - 1:
            return exists((level, li, lj, 0), (level - 1, _d2(li), _d2(lj), 0),
                          (level + 1, fine_i, fine_j, 0))
        return False

    # constant extrapolation where the grid ends (":1224-1229")
    if di != 0 and not x1_exists():
        di = 0
    if dj != 0 and not x2_exists():
        dj = 0
    if dk != 0 and not x3_exists():
        dk = 0

    phi_wrap_lo = periodic_phi and dk == -1 and lk == 0
    phi_wrap_hi = periodic_phi and dk == 1 and lk == n_3_level[level] - 1

    # same level (":1232-1258")
    ka = lk + dk
    if phi_wrap_lo:
        ka = n_3_level[level] - 1
    if phi_wrap_hi:
        ka = 0
    b = where.get((level, li + di, lj + dj, ka))
    if b is not None:
        return b, 0, di, dj, dk

    # coarser level (":1260-1288")
    if level - 1 >= 0:
        ia = _d2(li + di) if di != 0 else _d2(li)
        ja = _d2(lj + dj) if dj != 0 else _d2(lj)
        ka = _d2(lk + dk) if dk != 0 else _d2(lk)
        if phi_wrap_lo:
            ka = n_3_level[level - 1] - 1
        if phi_wrap_hi:
            ka = 0
        b = where.get((level - 1, ia, ja, ka))
        if b is not None:
            return b, 1, di, dj, dk

    # finer level (":1290-1316")
    ia = li * 2 + di + (1 if ui else 0)
    ja = lj * 2 + dj + (1 if uj else 0)
    ka = lk * 2 + dk + (1 if uk else 0)
    if phi_wrap_lo and level + 1 <= max_level:
        ka = n_3_level[level + 1] - 1
    if phi_wrap_hi:
        ka = 0
    b = where.get((level + 1, ia, ja, ka))
    if b is not None:
        return b, 2, di, dj, dk

    raise BlacklightError("Grid interpolation failed.")


def build_neighbor_table(levels, locations, n_k, n3_root,
                         periodic_phi=True):
    """The neighbour table of every (block, crossing, half) key of a grid,
    in numpy on the host: an SKS grid's third axis (phi) wraps
    (``periodic_phi``), a CKS grid's does not.

    Returns (table, loc_parity):
      table: (n_b, 27, 8, TABLE_FIELDS) int32 indexed by
        [b, (dk+1)*9 + (dj+1)*3 + (di+1), uk*4 + uj*2 + ui];
      loc_parity: (n_b, 3) int32, each location modulo 2 (the coarser
        level's cell offset, simulation_sampling.cpp:1281-1283).
    n_k: a block's phi cells, which with n3_root give each level's phi
    blocks (unused without ``periodic_phi``).
    """
    levels = np.asarray(levels, dtype=np.int64)
    locations = np.asarray(locations, dtype=np.int64)
    n_b = len(levels)
    max_level = int(levels.max())
    n_3_level = [max(n3_root // n_k, 1) << lev
                 for lev in range(max_level + 1)]
    where = {}
    for b in range(n_b):
        where.setdefault((int(levels[b]), *map(int, locations[b])), b)

    table = np.zeros((n_b, 27, 8, TABLE_FIELDS), dtype=np.int32)
    for b in range(n_b):
        home = (int(levels[b]), *map(int, locations[b]))
        for dk in (-1, 0, 1):
            for dj in (-1, 0, 1):
                for di in (-1, 0, 1):
                    dir_idx = (dk + 1) * 9 + (dj + 1) * 3 + (di + 1)
                    for half in range(8):
                        ui, uj, uk = (bool(half & 1), bool(half & 2),
                                      bool(half & 4))
                        # a crossed axis fixes its upper flag (index -1 is
                        # never upper, index n always is): other keys are
                        # never looked up and get the home block
                        reachable = ((di == 0 or ui == (di > 0))
                                     and (dj == 0 or uj == (dj > 0))
                                     and (dk == 0 or uk == (dk > 0)))
                        entry = (b, 0, 0, 0, 0)
                        if reachable:
                            try:
                                entry = _find_nearby_block(
                                    where, *home, max_level, n_3_level,
                                    periodic_phi, di, dj, dk, ui, uj, uk)
                            except BlacklightError:
                                # the reference fails only when a ray
                                # queries such a corner; a block whose
                                # neighbourhood no ray samples (a sentinel
                                # block) keeps the home block
                                pass
                        table[b, dir_idx, half] = entry
    loc_parity = (locations % 2).astype(np.int32)
    return table, loc_parity


def with_amr_table(grid):
    """``grid`` with its neighbour table on its device (no periodic axis
    on a CKS grid); the grid itself where it has one already, lacks the
    refinement metadata or is one block."""
    if grid.amr_table is not None or grid.levels is None \
            or grid.locations is None or grid.n_blocks <= 1:
        return grid
    table, parity = build_neighbor_table(
        grid.levels, grid.locations, grid.prim.shape[2], grid.n3_root,
        periodic_phi=grid.coords != "cks")
    device = grid.prim.device
    return dataclasses.replace(
        grid, amr_table=torch.from_numpy(table).to(device),
        loc_parity=torch.from_numpy(parity).to(device))
