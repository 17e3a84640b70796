"""iharm3d HDF5 snapshot loader.

Port of ``blacklight_tpu/grid/iharm3d.py`` (:37-177): what the reference
reads from iharm-family dumps (src/simulation_reader/simulation_reader.cpp
:345-431 metric parameters, :622-660 uniform-grid reconstruction,
:782-807 transpose and internal energy -> pressure, VerifyVariablesHarm
:1302-1424), followed by the coordinate and primitive conversions of
simulation_geometry.cpp (grid/mks.py). ``simulation_coord = sks``
(metric MKS) transforms the grid coordinates to SKS at load, which gives
a one-block SKS grid; ``fmks`` (metric MMKS / FMKS) keeps the native
grid and attaches the inverse SKS -> FMKS lookup table that the sampler
maps each sample through (grid/sampling.py, csrc/sim_sample.cuh
SAMPLE_FMKS).

The file is read by ``grid/hdf5.py`` (numpy and struct), so no h5py is
needed: ``read_iharm3d`` turns it into named arrays, and ``iharm3d_grid``
builds the grid from them (the ingest transpose and the UU -> pgas scale
in numpy).
"""

from __future__ import annotations

import numpy as np
import torch

from blacklight_tpu_torch.constants import Coordinates, PlasmaModel
from blacklight_tpu_torch.grid import hdf5, mks
from blacklight_tpu_torch.grid.athena import SimulationGrid, simulation_grid
from blacklight_tpu_torch.utils.errors import (
    BlacklightError,
    blacklight_warning,
)

# Slots of the grid's named primitives: name in the sampler -> name in
# header/prim_names
PRIMITIVE_NAMES = {"rho": "RHO", "pgas": "UU", "uu1": "U1", "uu2": "U2",
                   "uu3": "U3", "bb1": "B1", "bb2": "B2", "bb3": "B3"}


def read_iharm3d(path: str) -> dict:
    """Every dataset of the HDF5 file at ``path``: {"group/.../name":
    numpy array}."""
    out = {}

    def walk(node, prefix):
        for name, child in node.children.items():
            if child.is_dataset:
                out[prefix + name] = child.read()
            else:
                walk(child, prefix + name + "/")

    walk(hdf5.read_file(path), "")
    return out


def _scalar(datasets: dict, name: str):
    return np.asarray(datasets[name]).reshape(-1)[0]


def _text(value) -> str:
    return value.decode() if isinstance(value, bytes) else str(value)


def faces_centers(start: float, dx: float, n: int):
    """(n + 1) uniform faces from ``start`` in steps of ``dx`` and the n
    centres between them, float64."""
    xf = start + dx * np.arange(n + 1, dtype=np.float64)
    return xf, 0.5 * (xf[:-1] + xf[1:])


def gas_pressure(prim: np.ndarray, slot: int, gamma: float) -> None:
    """prim[slot] (internal energy) *= gamma - 1 in float32, in place."""
    prim[slot] *= np.float32(gamma - 1.0)


def _check_coord(cfg):
    """cfg's simulation_coord, which must be SKS or FMKS."""
    coord = cfg.require("simulation_coord")
    if coord not in (Coordinates.sks, Coordinates.fmks):
        raise BlacklightError("Invalid simulation_coord for Harm format.")
    return coord


def iharm3d_grid(datasets: dict, cfg, *, device,
                 dtype=torch.float64) -> SimulationGrid:
    """SimulationGrid on ``device`` from an iharm3d dump's datasets
    (read_iharm3d); cfg supplies the simulation_* and plasma_* options."""
    coord = _check_coord(cfg)
    spin = cfg.require("simulation_a")
    plasma_model = cfg.require("plasma_model")
    kappa_name = cfg.require("simulation_kappa_name") \
        if plasma_model == PlasmaModel.code_kappa else None
    f = datasets
    time = float(_scalar(f, "t"))

    # Metric parameters (simulation_reader.cpp:364-431)
    metric = _text(_scalar(f, "header/metric"))
    if metric not in ("MKS", "MMKS", "FMKS"):
        blacklight_warning(
            f"Given metric mks does not match file value of {metric}; "
            "ignoring the latter.")
    geom = f"header/geom/{metric.lower()}"
    metric_a = float(_scalar(f, f"{geom}/a"))
    if metric_a != spin:
        blacklight_warning(
            f"Given spin of {spin} does not match file value of {metric_a}; "
            "ignoring the latter.")
    hslope = float(_scalar(f, f"{geom}/hslope"))
    fmks_params = None
    if metric in ("MMKS", "FMKS"):
        r_in = next((float(_scalar(f, f"{geom}/{key}"))
                     for key in ("r_in", "Rin") if f"{geom}/{key}" in f),
                    None)
        if r_in is None:
            raise BlacklightError(
                "Unable to identify r_in parameter for iharm3d-format file.")
        fmks_params = mks.FmksParams(
            h=hslope, r_in=r_in,
            poly_xt=float(_scalar(f, f"{geom}/poly_xt")),
            poly_alpha=float(_scalar(f, f"{geom}/poly_alpha")),
            mks_smooth=float(_scalar(f, f"{geom}/mks_smooth")))
    if coord == Coordinates.fmks and fmks_params is None:
        raise BlacklightError(
            f"simulation_coord = fmks needs an FMKS file, not {metric}.")

    # Uniform native-coordinate grid (simulation_reader.cpp:622-660)
    n1, n2, n3 = (int(_scalar(f, f"header/n{a}")) for a in (1, 2, 3))
    x1f, x1v = faces_centers(float(_scalar(f, "header/geom/startx1")),
                             float(_scalar(f, "header/geom/dx1")), n1)
    x2f, x2v = faces_centers(float(_scalar(f, "header/geom/startx2")),
                             float(_scalar(f, "header/geom/dx2")), n2)
    x3f, x3v = faces_centers(float(_scalar(f, "header/geom/startx3")),
                             float(_scalar(f, "header/geom/dx3")), n3)

    # Variable layout (VerifyVariablesHarm, simulation_reader.cpp:1302-1424)
    prim_names = [_text(n) for n in
                  np.asarray(f["header/prim_names"]).reshape(-1)]
    wanted = dict(PRIMITIVE_NAMES)
    if kappa_name is not None:
        wanted["kappa"] = kappa_name
    ind = {}
    for key, var in wanted.items():
        if var not in prim_names:
            raise BlacklightError(
                f'Unable to locate "{var}" slice of "prims" in data file.')
        ind[key] = prim_names.index(var)

    # Adiabatic index, preferring user input (simulation_reader.cpp:1372-1423)
    gamma = cfg.plasma_gamma
    if "header/gam" in f:
        file_gam = float(_scalar(f, "header/gam"))
        if gamma is None:
            gamma = file_gam
        elif gamma != file_gam:
            blacklight_warning(
                f"Given total adiabatic index of {gamma} does not match "
                f"file value of {file_gam}; ignoring the latter.")
    elif gamma is None:
        raise BlacklightError(
            "Could not find total adiabatic index in input or data file.")

    # Cell data: file layout (n1, n2, n3, nvar) -> (nvar, 1, n3, n2, n1),
    # a copy whatever the given array's memory order (the conversions
    # below work in place)
    prim = np.array(np.transpose(f["prims"], (3, 2, 1, 0)),
                    dtype=np.float32, order="C")[:, None]
    gas_pressure(prim, ind["pgas"], gamma)

    fmks_map = None
    if coord == Coordinates.fmks:
        # Grid stays native; the inverse lookup (simulation_geometry.cpp
        # :38-59), built on the grid's device
        r_in_map, r_out_map = float(np.exp(x1f[0])), float(np.exp(x1f[-1]))
        table, dr, dtheta = mks.generate_sks_map(fmks_params, r_in_map,
                                                 r_out_map, device=device)
        r_lo, th_lo = mks.fmks_sks_coords(x1f[0], 0.0, fmks_params)
        r_hi, th_hi = mks.fmks_sks_coords(x1f[-1], 1.0, fmks_params)
        # phi bounds are literal [0, 2 pi]: the reference always passes 0
        # and 2 pi to GetSKSCoordinates (simulation_geometry.cpp:47-58)
        fmks_map = (table, r_in_map, dr, dtheta,
                    (r_lo, r_hi, th_lo, th_hi, 0.0, 2.0 * np.pi))
        r_v, th_v = mks.fmks_sks_coords(
            x1v[None, None, :], x2v[None, :, None], fmks_params)
        mks.convert_primitives_3(prim, ind, x1v, x2v, x3v, r_v, th_v, spin,
                                 "fmks", fmks_params)
        mks.snap_angular_domain(x2f, x3f, blacklight_warning,
                                snap_theta=False)
        x1f_out, x1v_out, x2f_out, x2v_out = x1f, x1v, x2f, x2v
    else:
        # MKS: transform grid coordinates to SKS (simulation_geometry.cpp
        # :62-82)
        x2v_alt = x2v.copy()
        x1f_out, x1v_out = np.exp(x1f), np.exp(x1v)
        x2f_out = mks.mks_theta(x2f, hslope)
        x2v_out = mks.mks_theta(x2v, hslope)
        mks.snap_angular_domain(x2f_out, x3f, blacklight_warning)
        mks.convert_primitives_3(prim, ind, np.log(x1v_out), x2v_alt, x3v,
                                 x1v_out, x2v_out, spin, "mks", hslope)

    return simulation_grid(
        prim, *(a[None] for a in (x1f_out, x1v_out, x2f_out, x2v_out, x3f,
                                  x3v)),
        ind, time, device=device, dtype=dtype, fmks_map=fmks_map)


def load_iharm3d(path: str, cfg, *, device,
                 dtype=torch.float64) -> SimulationGrid:
    """Load an iharm3d dump onto ``device``; cfg supplies the
    simulation_* and plasma_* options. The coordinates are checked before
    the file is read, as the JAX package's loader checks them."""
    _check_coord(cfg)
    return iharm3d_grid(read_iharm3d(path), cfg, device=device, dtype=dtype)
