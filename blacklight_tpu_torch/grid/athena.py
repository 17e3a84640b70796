"""Athena++ ``.athdf`` snapshot loader.

Port of ``blacklight_tpu/grid/athena.py`` (``SimulationGrid`` :23-94,
``load_athdf`` :170-222, with its kappa slot) for the port's slice: the
grid holds tensors on one device, and the file is read by
``grid/hdf5.py`` (numpy and struct), so no h5py is needed. The layout is the one the reference parses
(simulation_reader.cpp:593-781): datasets ``prim`` (rho, press, vel1-3)
and ``B`` (Bcc1-3) with per-block face and centre coordinates, and the
mesh's refinement metadata (``Levels``, ``LogicalLocations``, the
``RootGridSize`` attribute; :697-712) that exact interblock sampling
needs (``grid/amr.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from blacklight_tpu_torch.utils.errors import BlacklightError
from blacklight_tpu_torch.grid import hdf5

# Slots of the grid's named primitives: name in the sampler -> name in
# the file's VariableNames
PRIMITIVE_NAMES = {"rho": "rho", "pgas": "press", "uu1": "vel1",
                   "uu2": "vel2", "uu3": "vel3", "bb1": "Bcc1",
                   "bb2": "Bcc2", "bb3": "Bcc3"}


@dataclasses.dataclass(frozen=True)
class SimulationGrid:
    """A GRMHD snapshot on one device.

    prim is (n_var, n_b, n_k, n_j, n_i) float32 in the file's variable
    order; ``ind`` maps the sampler's names to its first axis. The face
    (x?f, (n_b, n+1)) and centre (x?v, (n_b, n)) coordinates are in the
    working dtype. ``host_faces`` holds every block's faces x1f, x2f, x3f
    once more on the host, in float64, for what a kernel launch works out
    there without reading the device (ops/simulation_kernel.kernel_grid).

    The refinement metadata stays on the host as numpy: ``levels``
    (n_b,) int32, ``locations`` (n_b, 3) int64, the logical (i, j, k) of
    each block at its level, and ``n3_root``, the root grid's phi cells
    (None / 0 where the file has none). ``amr_table`` (n_b, 27, 8, 5) and
    ``loc_parity`` (n_b, 3), int32 on the grid's device, are the neighbour
    table of exact interblock sampling (grid/amr.with_amr_table).

    An FMKS grid (grid/iharm3d.py, one block) keeps its native (x^1, x^2)
    faces and centres: ``sks_map`` (2, n2m, n1m) in the working dtype on
    the grid's device holds x^1 and x^2 at uniform (r, theta), r from
    ``map_r_in`` in steps of ``map_dr`` and theta from 0 in steps of
    ``map_dtheta`` (grid/mks.generate_sks_map), and ``bounds`` the SKS
    domain (r, theta, phi low and high; Python floats) of the off-grid
    test. None for a grid whose coordinates are SKS.

    ``coords`` names the grid's coordinates: "sks" (spherical Kerr-Schild:
    Athena++, and iharm3d and harm3d once converted or mapped) or "cks"
    (Cartesian Kerr-Schild: AthenaK, grid/athenak.py), whose faces and
    centres are x, y and z.
    """

    prim: torch.Tensor
    x1f: torch.Tensor
    x1v: torch.Tensor
    x2f: torch.Tensor
    x2v: torch.Tensor
    x3f: torch.Tensor
    x3v: torch.Tensor
    ind: dict
    time: float
    host_faces: tuple = dataclasses.field(compare=False, repr=False)
    levels: Optional[np.ndarray] = dataclasses.field(
        default=None, compare=False, repr=False)
    locations: Optional[np.ndarray] = dataclasses.field(
        default=None, compare=False, repr=False)
    n3_root: int = 0
    amr_table: Optional[torch.Tensor] = dataclasses.field(
        default=None, compare=False, repr=False)
    loc_parity: Optional[torch.Tensor] = dataclasses.field(
        default=None, compare=False, repr=False)
    sks_map: Optional[torch.Tensor] = dataclasses.field(
        default=None, compare=False, repr=False)
    map_r_in: float = 0.0
    map_dr: float = 0.0
    map_dtheta: float = 0.0
    bounds: Optional[tuple] = None
    coords: str = "sks"

    @property
    def n_blocks(self) -> int:
        return self.prim.shape[1]


def simulation_grid(prim, x1f, x1v, x2f, x2v, x3f, x3v, ind, time, *,
                    device, dtype, levels=None, locations=None,
                    n3_root: int = 0, fmks_map=None,
                    coords: str = "sks") -> SimulationGrid:
    """SimulationGrid on ``device`` from array-likes: prim (n_var, n_b,
    n_k, n_j, n_i) as float32, the coordinates (n_b, n + 1) and (n_b, n)
    in ``dtype``, and the optional refinement metadata (levels (n_b,),
    locations (n_b, 3), n3_root) or FMKS map (sks_map, map_r_in, map_dr,
    map_dtheta, bounds; the table a float64 tensor or array); ``coords``
    "sks" or "cks". The loaders end here, and so does any caller that
    builds a snapshot in memory."""
    if coords not in ("sks", "cks"):
        raise ValueError(f"unknown grid coordinates {coords!r}")

    def host(a, dt):
        # torch takes no read-only arrays (a JAX array's numpy view is one)
        return torch.as_tensor(np.require(a, dt, "W"))

    def axis(a):
        return host(a, np.float64).to(device=device, dtype=dtype)

    return SimulationGrid(
        prim=host(prim, np.float32).to(device),
        x1f=axis(x1f), x1v=axis(x1v), x2f=axis(x2f), x2v=axis(x2v),
        x3f=axis(x3f), x3v=axis(x3v), ind=dict(ind), time=float(time),
        host_faces=tuple(np.array(f, np.float64) for f in (x1f, x2f, x3f)),
        levels=None if levels is None else np.array(levels, np.int32),
        locations=None if locations is None else np.array(locations,
                                                          np.int64),
        n3_root=int(n3_root), coords=coords,
        **_fmks_fields(fmks_map, device, dtype))


def _fmks_fields(fmks_map, device, dtype) -> dict:
    if fmks_map is None:
        return {}
    table, r_in, dr, dtheta, bounds = fmks_map
    return dict(sks_map=torch.as_tensor(table).to(device=device,
                                                  dtype=dtype),
                map_r_in=float(r_in), map_dr=float(dr),
                map_dtheta=float(dtheta),
                bounds=tuple(float(b) for b in bounds))


def load_athdf(path: str, kappa_name: Optional[str] = None, *, device,
               dtype=torch.float64) -> SimulationGrid:
    """Load an Athena++ .athdf file onto ``device``; ``kappa_name`` names
    the file's variable of the kappa slot (the electron entropy of
    plasma_model = code_kappa), if any."""
    f = hdf5.read_file(path)
    dataset_names = [n.decode() for n in f.attrs["DatasetNames"]]
    variable_names = [n.decode() for n in f.attrs["VariableNames"]]
    prim = np.concatenate([f[name].read().astype(np.float32)
                           for name in dataset_names], axis=0)

    wanted = dict(PRIMITIVE_NAMES)
    if kappa_name is not None:
        wanted["kappa"] = kappa_name
    ind = {}
    for key, var in wanted.items():
        if var not in variable_names:
            raise BlacklightError(
                f'Unable to locate "{var}" slice of "prim" in data file.')
        ind[key] = variable_names.index(var)

    return simulation_grid(
        prim, *(f[name].read() for name in
                ("x1f", "x1v", "x2f", "x2v", "x3f", "x3v")),
        ind, float(f.attrs["Time"]), device=device, dtype=dtype,
        levels=f["Levels"].read() if "Levels" in f else None,
        locations=(f["LogicalLocations"].read()
                   if "LogicalLocations" in f else None),
        n3_root=(int(f.attrs["RootGridSize"][2])
                 if "RootGridSize" in f.attrs else 0))
