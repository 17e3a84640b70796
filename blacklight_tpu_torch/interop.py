"""Carry the JAX package's state into this package.

This repository has no weights; its state is the parameter sets and the
camera rays. These helpers copy them from ``blacklight_tpu`` objects as
Python scalars and numpy arrays, so the tests can feed both packages the
same inputs. Nothing here imports jax: the JAX objects are read through
their dataclass fields and ``numpy.asarray``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blacklight_tpu_torch.camera import CameraGeometry, CameraRays
from blacklight_tpu_torch.models.formula import FormulaParams
from blacklight_tpu_torch.ops.geodesic import GeodesicParams


def _scalar(v):
    """A Python scalar (or tuple of them) from a numpy or jax scalar."""
    if isinstance(v, tuple):
        return tuple(_scalar(x) for x in v)
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if hasattr(v, "value") and not hasattr(v, "shape"):  # enum members
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
