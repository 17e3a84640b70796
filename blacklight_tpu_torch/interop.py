"""Carry the JAX package's state into this package.

This repository has no weights; its state is the parameter sets, the
camera rays and the GRMHD snapshot. These helpers copy them from
``blacklight_tpu`` objects as Python scalars and numpy arrays, so the tests can feed both packages the
same inputs. Nothing here imports jax: the JAX objects are read through
their dataclass fields and ``numpy.asarray``.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from blacklight_tpu_torch import constants
from blacklight_tpu_torch.camera import CameraGeometry, CameraRays
from blacklight_tpu_torch.grid.athena import SimulationGrid, simulation_grid
from blacklight_tpu_torch.models.cuts import GeometricCuts
from blacklight_tpu_torch.models.formula import FormulaParams
from blacklight_tpu_torch.models.synchrotron import CutParams, PlasmaParams
from blacklight_tpu_torch.ops.geodesic import GeodesicParams


def _scalar(v):
    """A Python scalar (or tuple of them) from a numpy or jax scalar; an
    enum member becomes the member of the same name in this package's
    enum of the same class name (``constants``)."""
    if isinstance(v, tuple):
        return tuple(_scalar(x) for x in v)
    if isinstance(v, enum.Enum):
        return getattr(constants, type(v).__name__)[v.name]
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return np.asarray(v).item()


def _copy_dataclass(src, cls):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{f.name: _scalar(getattr(src, f.name))
                  for f in dataclasses.fields(src) if f.name in names})


def geodesic_params_from_jax(params) -> GeodesicParams:
    """GeodesicParams from ``blacklight_tpu.ops.geodesic.GeodesicParams``."""
    return _copy_dataclass(params, GeodesicParams)


def formula_params_from_jax(fp) -> FormulaParams:
    """FormulaParams from ``blacklight_tpu.models.formula.FormulaParams``."""
    return _copy_dataclass(fp, FormulaParams)


def plasma_params_from_jax(plasma) -> PlasmaParams:
    """PlasmaParams from ``blacklight_tpu.models.synchrotron.PlasmaParams``."""
    return _copy_dataclass(plasma, PlasmaParams)


def cut_params_from_jax(cuts) -> CutParams:
    """CutParams from ``blacklight_tpu.models.synchrotron.CutParams``."""
    return _copy_dataclass(cuts, CutParams)


def geometric_cuts_from_jax(cuts) -> GeometricCuts:
    """GeometricCuts from ``blacklight_tpu.models.cuts.GeometricCuts``."""
    return _copy_dataclass(cuts, GeometricCuts)


def simulation_grid_from_jax(grid, *, device, dtype) -> SimulationGrid:
    """SimulationGrid on ``device`` from a JAX package SimulationGrid: its
    float32 ``prim`` and the face and centre rows as numpy arrays, the
    coordinates in ``dtype``."""
    return simulation_grid(
        np.asarray(grid.prim), *(np.asarray(getattr(grid, name)) for name in
                                 ("x1f", "x1v", "x2f", "x2v", "x3f", "x3v")),
        grid.ind, grid.time, device=device, dtype=dtype)


def camera_rays_from_numpy(positions, directions, momentum_factors, *,
                           device, dtype) -> CameraRays:
    """CameraRays on ``device`` in ``dtype`` from array-likes (for example
    a JAX CameraRays' fields)."""
    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return CameraRays(positions=t(positions), directions=t(directions),
                      momentum_factors=t(momentum_factors))


def camera_geometry_from_numpy(geom, *, device, dtype) -> CameraGeometry:
    """CameraGeometry on ``device`` in ``dtype`` from any object with the
    seven (4,) fields of ``blacklight_tpu.camera.CameraGeometry``."""
    return CameraGeometry(**{
        f.name: torch.tensor(np.asarray(getattr(geom, f.name)), dtype=dtype,
                             device=device)
        for f in dataclasses.fields(CameraGeometry)})
