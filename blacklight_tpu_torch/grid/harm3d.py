"""harm3d ASCII + binary snapshot loader.

Port of ``blacklight_tpu/grid/harm3d.py`` (:25-115): the reference's
harm3d branch (src/simulation_reader/simulation_reader.cpp:661-718
header and uniform MKS grid, :808-850 binary cell block). A whitespace
ASCII header

  time n1 n2 n3 startx1 startx2 startx3 dx1 dx2 dx3 a gamma r_in hslope n

is followed by one separator byte and float32 cell data laid out (i, j,
k, 6 coordinate columns + rho, ugas, u^0..u^3, b^0..b^3 [, kappa]). The
primitives are 4-vectors in the coordinate frame of modified (MKS)
coordinates, converted to the SKS normal frame as in
simulation_geometry.cpp:242-317 (grid/mks.convert_primitives_4); the
grid's coordinates become SKS, so the snapshot is a one-block SKS grid.
"""

from __future__ import annotations

import numpy as np
import torch

from blacklight_tpu_torch.constants import Coordinates, PlasmaModel
from blacklight_tpu_torch.grid import mks
from blacklight_tpu_torch.grid.athena import SimulationGrid, simulation_grid
from blacklight_tpu_torch.grid.iharm3d import faces_centers, gas_pressure
from blacklight_tpu_torch.utils.errors import (
    BlacklightError,
    blacklight_warning,
)

# Tokens of the ASCII header
HEADER_TOKENS = 15
# Coordinate columns before the primitives of a cell
COORD_COLUMNS = 6
# Slots of the primitives in a cell after the coordinate columns
PRIMITIVE_SLOTS = {"rho": 0, "pgas": 1, "u0": 2, "uu1": 3, "uu2": 4,
                   "uu3": 5, "b0": 6, "bb1": 7, "bb2": 8, "bb3": 9}


def _header_tokens(f) -> list:
    """The header's HEADER_TOKENS whitespace-separated tokens; the file
    is left just past the separator after the last one, where the cells
    start."""
    tokens = []
    while len(tokens) < HEADER_TOKENS:
        tok = b""
        c = f.read(1)
        while c in b" \t\r\n" and c:
            c = f.read(1)
        while c not in b" \t\r\n" and c:
            tok += c
            c = f.read(1)
        if not tok:
            raise BlacklightError("Could not parse harm3d header.")
        tokens.append(tok)
    return tokens


def load_harm3d(path: str, cfg, *, device,
                dtype=torch.float64) -> SimulationGrid:
    """Load a harm3d snapshot onto ``device``; cfg supplies the
    simulation_* and plasma_* options."""
    coord = cfg.require("simulation_coord")
    if coord != Coordinates.sks:
        raise BlacklightError("Invalid simulation_coord for Harm format.")
    spin = cfg.require("simulation_a")
    has_kappa = cfg.require("plasma_model") == PlasmaModel.code_kappa

    with open(path, "rb") as f:
        tokens = _header_tokens(f)
        time = float(tokens[0])
        n1, n2, n3 = (int(t) for t in tokens[1:4])
        startx = [float(t) for t in tokens[4:7]]
        dx = [float(t) for t in tokens[7:10]]
        metric_a = float(tokens[10])
        file_gamma = float(tokens[11])
        hslope = float(tokens[13])
        n_var = len(PRIMITIVE_SLOTS) + (1 if has_kappa else 0)
        n_cols = n_var + COORD_COLUMNS
        raw = np.fromfile(f, dtype=np.float32, count=n1 * n2 * n3 * n_cols)

    if metric_a != spin:
        blacklight_warning(
            f"Given spin of {spin} does not match file value of {metric_a}; "
            "ignoring the latter.")
    gamma = cfg.plasma_gamma
    if gamma is None:
        gamma = file_gamma
    elif gamma != file_gamma:
        blacklight_warning(
            f"Given total adiabatic index of {gamma} does not match file "
            f"value of {file_gamma}; ignoring the latter.")
    if raw.size != n1 * n2 * n3 * n_cols:
        raise BlacklightError("harm3d file truncated.")

    # File layout (i, j, k, col); internal layout (var, block, k, j, i)
    table = raw.reshape(n1, n2, n3, n_cols)[..., COORD_COLUMNS:]
    prim = np.ascontiguousarray(table.transpose(3, 2, 1, 0))[:, None]
    ind = dict(PRIMITIVE_SLOTS)
    if has_kappa:
        ind["kappa"] = len(PRIMITIVE_SLOTS)
    gas_pressure(prim, ind["pgas"], gamma)

    x1f, x1v = faces_centers(startx[0], dx[0], n1)
    x2f, x2v = faces_centers(startx[1], dx[1], n2)
    x3f, x3v = faces_centers(startx[2], dx[2], n3)

    # MKS -> SKS grid coordinates (simulation_geometry.cpp:62-82)
    x2v_alt = x2v.copy()
    x1f_sks, x1v_sks = np.exp(x1f), np.exp(x1v)
    x2f_sks = mks.mks_theta(x2f, hslope)
    x2v_sks = mks.mks_theta(x2v, hslope)
    mks.snap_angular_domain(x2f_sks, x3f, blacklight_warning)
    mks.convert_primitives_4(prim, ind, x2v_alt, x1v_sks, x2v_sks, spin,
                             hslope)

    return simulation_grid(
        prim, *(a[None] for a in (x1f_sks, x1v_sks, x2f_sks, x2v_sks, x3f,
                                  x3v)),
        ind, time, device=device, dtype=dtype)
