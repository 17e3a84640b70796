"""Fused simulation-model kernel: geodesics + GRMHD grid sampling +
synchrotron coefficients + unpolarized transfer.

Port of ``blacklight_tpu/ops/pallas_simulation.py`` (``_make_kernel``
:795, launched by ``render_simulation`` :1400; K2.1 rk4/rk2 and K2.2
dp) for Athena++ SKS grids, ti_te_beta electrons and any number of
frequencies. The values follow the JAX package's exact (XLA) path,
``pipeline_simulation.make_simulation_coeff_fns`` inside
``transfer/unpolarized.integrate_unpolarized``, in each dtype's forms.
The TPU kernel is thermal ti_te_beta only; a configuration that mixes in
power-law or kappa electrons, or takes the code_kappa temperature from
the snapshot's electron entropy (``is_mixture``), launches the same
kernel's mixture instantiation (csrc/simulation_kernel.cuh POP_MIXTURE),
whose constants ``mixture_params`` folds and which reads the entropy
from a table of its own (``KernelGrid.kappa``), where the JAX package
takes its XLA path.

``render_simulation`` dispatches on the device of the rays it is given:
on a CUDA device it launches the hand-written kernel
(``csrc/simulation_kernel.cuh``) or raises; on the CPU it runs
``render_simulation_reference``, the same function in plain torch ops
built from ``grid/sampling``, ``models/cuts`` and
``models/synchrotron``. There is no fallback from one to the other.
A grid in Cartesian Kerr-Schild coordinates (AthenaK's, ``grid.coords``
"cks") takes the kernels' CKS modes (``kernel_mode``), which the JAX
package renders on its XLA path.

Phased dispatch (K2.3, ``render_simulation_phase`` :1484 and
``render_simulation_phased`` :1588 of the JAX module) runs the same
function a phase of steps at a time from a carried state
(``SimCarry``), through the phase kernel of the same CUDA header or
``render_simulation_phase_reference``, and drops finished rays between
phases. ``spatial_order`` and ``angular_order`` are the JAX module's ray
orderings (:440, :474), on the rays' device.

A launch hands the kernel its constants by value (``launch_consts``: the
parameter vector, the frequencies and the image scales rounded once to
the rays' type on the host) and the snapshot's tables with a guide per
axis, where a ray's first cell search starts (``kernel_grid``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from blacklight_tpu_torch.constants import Math, Physics, PlasmaModel
from blacklight_tpu_torch.grid import amr
from blacklight_tpu_torch.grid.athena import SimulationGrid
from blacklight_tpu_torch.grid.sampling import (
    FMKS,
    INTERBLOCK,
    SAMPLE_NAMES,
    SINGLE,
    SamplerOptions,
    sample_grid,
    sample_names,
    sampling_mode,
)
from blacklight_tpu_torch.models import synchrotron
from blacklight_tpu_torch.models.cuts import (
    CUT_PARAM_NAMES,
    GeometricCuts,
    cut_param_values,
    geometric_keep,
)
from blacklight_tpu_torch.ops import _build
from blacklight_tpu_torch.ops import geodesic as geo
from blacklight_tpu_torch.ops.formula_kernel import (
    INTEGRATORS,
    _DTYPE_CODES,
    _NUMPY_DTYPES,
    _check_rays,
)
from blacklight_tpu_torch.transfer import unpolarized as tu

# Frequencies one launch takes (csrc/simulation_kernel.cuh): one frequency
# keeps its accumulators in registers, more hold them in a local array.
# render_simulation launches once per this many frequencies.
MAX_FREQUENCIES = 16

# The kernels' modes of a CKS grid (csrc/sim_sample.cuh SAMPLE_CKS_*),
# after grid/sampling.py's SINGLE, BLOCKS, INTERBLOCK and FMKS: the block
# search in (x, y, z), then trilinear interpolation clamped to the block or
# the nearest cell (one block takes it too), or exact interblock
# interpolation without a periodic axis. KernelGrid.mode is one of the
# six.
CKS_BLOCKS, CKS_INTERBLOCK = 4, 5
KERNEL_MODES = 6

# Kernel launches so far; render_simulation adds one per launch of the CUDA
# kernel and nowhere else.
LAUNCHES = 0
# Of those, the launches of each kernel mode's kernel (kernel_mode; SINGLE:
# simulation_kernel; BLOCKS, INTERBLOCK, CKS_BLOCKS, CKS_INTERBLOCK:
# simulation_mode_kernel; FMKS: simulation_fmks_kernel), and the launches
# of the mixture's kernel
# (simulation_mixture_kernel, any mode), also by mode.
MODE_LAUNCHES = [0] * KERNEL_MODES
MIXTURE_LAUNCHES = 0
MIXTURE_MODE_LAUNCHES = [0] * KERNEL_MODES
# Of the mixture's launches, those at the code_kappa temperature, by mode.
CODE_KAPPA_MODE_LAUNCHES = [0] * KERNEL_MODES

# Most bins of an axis' guide (csrc/sim_sample.cuh GridAxis): 64 KB of
# int32 an axis at most.
GUIDE_MAX_BINS = 1 << 14
# Values of an axis in KernelGrid's axes array (GUIDE_AXIS_VALUES of
# csrc/sim_sample.cuh): lo, hi, scale, bins.
GUIDE_AXIS_VALUES = 4
# Values of an FMKS map after the axes' (FMKS_MAP_VALUES of
# csrc/sim_sample.cuh): r_in, dr, dtheta, the SKS bounds (r, theta, phi
# low and high), n1m, n2m.
FMKS_MAP_VALUES = 11

# Index order of the kernel's float64 parameter vector: the enum in
# csrc/simulation_params.cuh with its "S_" prefix dropped. The geodesic
# block comes first, then the geometric-cut block, in the orders
# csrc/trace.cuh and csrc/cuts.cuh read.
VALUE_CUT_NAMES = ("RHO", "N_E", "P_GAS", "THETA_E", "B", "SIGMA",
                   "BETA_INV")
PARAM_NAMES = geo.GEODESIC_PARAM_NAMES + CUT_PARAM_NAMES + (
    "D_UNIT", "E_UNIT", "B_UNIT", "MU_MP", "NE_DIV", "RAT_HIGH", "RAT_LOW",
    "KB_TOT", "USE_P", "ONE_PLUS_NE_NI", "NE_NI", "GAMMA_M1", "GAMMA_I_M1",
    "NE_NI_OVER_GAMMA_E_M1", "ME_C2",
) + tuple(f"{name}_{end}" for name in VALUE_CUT_NAMES
          for end in ("MIN", "MAX")) + (
    "THERMAL_FRAC", "E_CHARGE", "NU_C_DIV", "TWO_NINTHS", "VAR_A", "VAR_B",
    "H_PLANCK", "NU0", "KIRCHHOFF",
    "CAM_X1", "CAM_X2", "CAM_X3", "X_UNIT",
)


# Index order of a mixture launch's constants after the launch constants:
# the enum MixtureParam in csrc/simulation_params.cuh with its "M_" prefix
# dropped.
MIX_PARAM_NAMES = (
    "THERMAL_ON", "POWER_ON", "KAPPA_ON", "KA",
    "PL_FRAC", "PL_J_EXP", "PL_A_EXP", "PL_JJ", "PL_AA", "PL_JJ_Q", "PL_JJ_V",
    "PL_AA_Q", "PL_AA_V", "PL_FRAC_RHO", "PL_RHO_Q", "PL_RHO_V", "PL_GMIN2",
    "PL_E3_EXP",
    "KP_FRAC", "KP_NEG_FRAC", "KP_TWO_FRAC", "KP_W", "KP_KAPPA", "KP_J_EXP",
    "KP_A_EXP", "KP_JJ_LOW", "KP_JJ_HIGH", "KP_AA_LOW", "KP_AA_HIGH",
    "KP_AA_HIGH_I", "KP_JJ_LOW_Q", "KP_JJ_HIGH_Q", "KP_JJ_LOW_V",
    "KP_JJ_HIGH_V", "KP_AA_LOW_Q", "KP_AA_HIGH_Q", "KP_AA_LOW_V",
    "KP_AA_HIGH_V",
) + tuple(f"KP_{kind}_{c}" for c in ("JI", "JQ", "JV", "AI", "AQ", "AV")
          for kind in ("X", "NX")) + (
    "KP_RHO_V", "KP_RHO_FRAC", "KP_RHO_1M_FRAC",
) + tuple(f"KP_Q{b}_{v}" for b in "LH" for v in "ABCDE") + (
    "KP_VL_A", "KP_VL_B", "KP_VH_A", "KP_VH_B",
    "CODE_KAPPA", "CK_ME", "CK_MU_E_MP", "CK_C2", "FALLBACK_KAPPA")


def is_code_kappa(plasma: synchrotron.PlasmaParams) -> bool:
    """Whether the electron temperature is plasma_model = code_kappa's,
    from the snapshot's electron entropy."""
    return plasma.model == PlasmaModel.code_kappa


def is_mixture(plasma: synchrotron.PlasmaParams) -> bool:
    """Whether a launch takes the kernels' POP_MIXTURE instantiations:
    power-law or kappa electrons mixed into the thermal ones, or the
    code_kappa temperature (a launch constant of those instantiations, so
    that the thermal ti_te_beta ones compile as they did)."""
    return (plasma.power_frac != 0.0 or plasma.kappa_frac != 0.0
            or is_code_kappa(plasma))


def mixture_params(plasma: synchrotron.PlasmaParams, polarized: bool,
                   fallback_kappa: float = 0.0) -> list:
    """The mixture's constants in MIX_PARAM_NAMES order
    (models/synchrotron.py powerlaw_constants, kappa_constants with the
    route's ``polarized``, code_kappa_temperature's constants and the
    sampler's ``fallback_kappa``), each folded in float64 as the plain
    version's Python expressions fold it before it meets a tensor; zeros
    for a population the mixture leaves out."""
    pl, kp = synchrotron.population_constants(plasma, polarized)
    values = dict.fromkeys(MIX_PARAM_NAMES, 0.0)
    values.update({
        "THERMAL_ON": plasma.thermal_frac != 0.0,
        "POWER_ON": pl is not None, "KAPPA_ON": kp is not None,
        "KA": Physics.e * Physics.e / (Physics.m_e * Physics.c),
        "FALLBACK_KAPPA": fallback_kappa})
    if is_code_kappa(plasma):
        values.update({
            "CODE_KAPPA": True, "CK_ME": Physics.m_e,
            "CK_MU_E_MP": plasma.mu * (1.0 + 1.0 / plasma.ne_ni)
            * Physics.m_p,
            "CK_C2": Physics.c ** 2})
    if pl is not None:
        pp, frac = plasma.power_p, plasma.power_frac
        values.update({
            "PL_FRAC": frac, "PL_J_EXP": -(pp - 1.0) / 2.0,
            "PL_A_EXP": -(pp + 2.0) / 2.0, "PL_FRAC_RHO": frac * pl["rho"],
            "PL_GMIN2": plasma.gamma_min ** 2, "PL_E3_EXP": pp / 2.0 - 1.0,
            **{f"PL_{k.upper()}": pl[k] for k in (
                "jj", "aa", "jj_q", "jj_v", "aa_q", "aa_v", "rho_q",
                "rho_v")}})
    if kp is not None:
        kap, frac = plasma.kappa, plasma.kappa_frac
        values.update({
            "KP_FRAC": frac, "KP_NEG_FRAC": -frac, "KP_TWO_FRAC": frac * 2.0,
            "KP_W": plasma.w, "KP_KAPPA": kap, "KP_J_EXP": -(kap - 2.0) / 2.0,
            "KP_A_EXP": -(1.0 + kap) / 2.0, "KP_RHO_V": kp["rho_v"],
            "KP_RHO_FRAC": kp["rho_frac"],
            "KP_RHO_1M_FRAC": 1.0 - kp["rho_frac"],
            **{f"KP_{k.upper()}": kp[k] for k in (
                "jj_low", "jj_high", "aa_low", "aa_high", "aa_high_i",
                "jj_low_q", "jj_high_q", "jj_low_v", "jj_high_v", "aa_low_q",
                "aa_high_q", "aa_low_v", "aa_high_v")}})
        for c, key in (("JI", "jj_x_i"), ("JQ", "jj_x_q"), ("JV", "jj_x_v"),
                       ("AI", "aa_x_i"), ("AQ", "aa_x_q"), ("AV", "aa_x_v")):
            values[f"KP_X_{c}"], values[f"KP_NX_{c}"] = kp[key], -1.0 / kp[key]
        for b, bracket in (("L", "low"), ("H", "high")):
            q = kp[f"rho_q_{bracket}"]
            for v in "abcde":
                values[f"KP_Q{b}_{v.upper()}"] = q[v]
            values[f"KP_V{b}_A"], values[f"KP_V{b}_B"] = kp[f"rho_v_{bracket}"]
    return [float(values[name]) for name in MIX_PARAM_NAMES]


@dataclasses.dataclass(frozen=True)
class SimKernelParams:
    """Everything the kernel needs besides GeodesicParams, the rays and
    the grid: the plasma model, the value and geometric cuts, the
    sampler's options and the code density unit."""

    plasma: synchrotron.PlasmaParams
    cuts: synchrotron.CutParams
    geometric: GeometricCuts
    sampler: SamplerOptions
    rho_unit: float


def sim_kernel_params(cfg, cuts_geo: GeometricCuts,
                      plasma: synchrotron.PlasmaParams,
                      cuts_val: synchrotron.CutParams) -> SimKernelParams:
    return SimKernelParams(
        plasma=plasma, cuts=cuts_val, geometric=cuts_geo,
        sampler=SamplerOptions(
            interp=cfg.require("simulation_interp"),
            block_interp=bool(cfg.simulation_block_interp),
            fallback_nan=cfg.require("fallback_nan"),
            fallback_rho=cfg.fallback_rho or 0.0,
            fallback_pgas=cfg.fallback_pgas or 0.0,
            fallback_kappa=cfg.fallback_kappa or 0.0,
            has_kappa=is_code_kappa(plasma)),
        rho_unit=cfg.require("simulation_rho_cgs"))


def kernel_params(params: geo.GeodesicParams, sp: SimKernelParams,
                  nu0: float, mass_msun: float, camera_x) -> list:
    """The kernel's parameter vector in PARAM_NAMES order, every derived
    constant folded here in float64 as the JAX package folds it in
    Python before it meets an array."""
    pl = sp.plasma
    e_unit = sp.rho_unit * Physics.c ** 2
    values = geo.geodesic_param_values(params, sp.sampler.fallback_nan)
    values.update(cut_param_values(sp.geometric))
    values.update({
        "D_UNIT": sp.rho_unit, "E_UNIT": e_unit,
        "B_UNIT": math.sqrt(4.0 * Math.pi * e_unit),
        "MU_MP": pl.mu * Physics.m_p, "NE_DIV": 1.0 + 1.0 / pl.ne_ni,
        "RAT_HIGH": pl.rat_high, "RAT_LOW": pl.rat_low,
        "KB_TOT": pl.mu * Physics.m_p * Physics.c ** 2, "USE_P": pl.use_p,
        "ONE_PLUS_NE_NI": 1.0 + pl.ne_ni, "NE_NI": pl.ne_ni,
        "GAMMA_M1": pl.gamma - 1.0, "GAMMA_I_M1": pl.gamma_i - 1.0,
        "NE_NI_OVER_GAMMA_E_M1": pl.ne_ni / (pl.gamma_e - 1.0),
        "ME_C2": Physics.m_e * Physics.c ** 2,
        "THERMAL_FRAC": pl.thermal_frac, "E_CHARGE": Physics.e,
        "NU_C_DIV": 2.0 * Math.pi * Physics.m_e * Physics.c,
        "TWO_NINTHS": 2.0 / 9.0, "VAR_A": Math.sqrt2 * Math.pi / 27.0,
        "VAR_B": 2.0 ** (11.0 / 12.0), "H_PLANCK": Physics.h,
        "NU0": nu0, "KIRCHHOFF": math.exp(synchrotron.log_kirchhoff(nu0)),
        "CAM_X1": float(camera_x[1]), "CAM_X2": float(camera_x[2]),
        "CAM_X3": float(camera_x[3]),
        "X_UNIT": Physics.gg_msun * mass_msun / (Physics.c * Physics.c),
    })
    for name, (_, lo, hi) in zip(VALUE_CUT_NAMES, sp.cuts.pairs()):
        values[f"{name}_MIN"], values[f"{name}_MAX"] = lo, hi
    return geo.pack_params(PARAM_NAMES, values)


# Blocks a step of check_grid's overlap test compares with all the others.
OVERLAP_ROWS = 256


def check_grid(grid: SimulationGrid,
               sampler: SamplerOptions = SamplerOptions()) -> None:
    """Raise ValueError for a grid outside the kernels' cover: a grid
    without a primitive ``sampler`` samples (sample_names: the kappa slot
    too where ``sampler.has_kappa``; the loaders raise the JAX package's
    error for a file without it), blocks of
    at least 2 cells per axis with faces in non-decreasing order (the
    cell search then finds the cell the comparison count finds); and, of
    many blocks, each with some extent on every axis and no two
    overlapping in volume, in float64 and rounded to float32 (a point
    strictly inside a block then lies in no other block's closed box, so
    the kernels keep the previous sample's block while the point stays
    strictly inside it). Checked on the grid's host copy of its faces, in
    the grid's coordinates: (r, theta, phi), or (x, y, z) of a CKS
    grid."""
    if min(grid.prim.shape[2:]) < 2:
        raise ValueError("the simulation kernel needs 2 cells per axis")
    for faces in grid.host_faces:
        if bool((faces[:, 1:] < faces[:, :-1]).any()):
            raise ValueError("grid faces must be non-decreasing")
    missing = [n for n in sample_names(sampler) if n not in grid.ind]
    if missing:
        raise ValueError(f"grid lacks {missing}")
    if grid.n_blocks == 1:
        return
    for dtype in (np.float64, np.float32):
        lo = np.stack([f[:, 0] for f in grid.host_faces], 1).astype(dtype)
        hi = np.stack([f[:, -1] for f in grid.host_faces], 1).astype(dtype)
        if not (lo < hi).all():
            raise ValueError("every mesh block needs some extent on each "
                             "axis")
        for first in range(0, grid.n_blocks, OVERLAP_ROWS):
            rows = slice(first, first + OVERLAP_ROWS)
            meets = ((lo[rows, None] < hi[None]) & (hi[rows, None] > lo[None])
                     ).all(axis=2)
            meets[np.arange(meets.shape[0]), np.arange(first, first
                                                       + meets.shape[0])] = 0
            if meets.any():
                b, c = np.argwhere(meets)[0]
                raise ValueError(f"mesh blocks {first + b} and {c} overlap")


def kernel_tables(grid: SimulationGrid, dtype):
    """The two tables the kernel reads from device memory.

    table: (n_b, n_k, n_j, n_i, 8) float32, the SAMPLE_NAMES primitives of
      a cell side by side (32 bytes, two 16-byte loads per corner);
    coords: x1f, x1v, x2f, x2v, x3f, x3v, each (n_b, n + 1) or (n_b, n)
      in block order, concatenated, in ``dtype``.
    Built on the grid's device at each launch (one pass over the table).
    """
    rows = torch.tensor([grid.ind[n] for n in SAMPLE_NAMES],
                        device=grid.prim.device)
    table = grid.prim.index_select(0, rows).permute(1, 2, 3, 4, 0)
    coords = torch.cat([c.reshape(-1).to(dtype) for c in (
        grid.x1f, grid.x1v, grid.x2f, grid.x2v, grid.x3f, grid.x3v)])
    return table.contiguous(), coords.contiguous()


def axis_bins(faces):
    """Where one axis' guide (csrc/sim_sample.cuh GridAxis) puts its bins,
    from the axis' n + 1 non-decreasing faces in the kernel's type (numpy,
    on the host): (lo, hi, scale, bins). The bins are uniform over
    [lo, hi] = [faces[0], faces[n]], as many as the span holds of the
    smallest positive gap between faces (at most GUIDE_MAX_BINS, at least
    1)."""
    xf = np.asarray(faces, dtype=np.float64)
    lo, hi = float(xf[0]), float(xf[-1])
    span = hi - lo
    gaps = np.diff(xf)
    gaps = gaps[gaps > 0.0]
    bins = 1
    if gaps.size and np.isfinite(span) and span > 0.0:
        bins = int(min(GUIDE_MAX_BINS, math.ceil(span / gaps.min())))
    scale = bins / span if bins > 1 else 0.0
    return lo, hi, scale, bins


def axis_guide(faces, lo: float, scale: float, bins: int):
    """The guide of one axis on its faces' device: (bins,) int32, bin b
    holding the count of ``faces`` (a tensor in the kernel's type) below
    its lower edge lo + b / scale (axis_bins). The card walks from there
    to the exact count, so these counts only decide how far it walks."""
    xf = faces.to(torch.float64)
    edges = lo + torch.arange(bins, dtype=torch.float64,
                              device=xf.device) / scale if bins > 1 else \
        torch.full((1,), lo, dtype=torch.float64, device=xf.device)
    return torch.searchsorted(xf, edges, side="left", out_int32=True)


# ctypes of KernelGrid.args() in the C interfaces: table, coords, guides,
# axes, n_i, n_j, n_k, mode, nearest, n_b, bounds, amr, parity, map; the
# mixture's interfaces take the kappa table after them
# (KernelGrid.mixture_args()).
GRID_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6 \
    + (ctypes.c_void_p,) * 4
MIXTURE_GRID_ARGTYPES = GRID_ARGTYPES + (ctypes.c_void_p,)


class KernelGrid(NamedTuple):
    """The snapshot as a kernel launch takes it, on the grid's device:
    kernel_tables' table and coords, the three axes' guides concatenated,
    and under the modes of many blocks the (n_b, 6) block bounds (the low
    and high faces of r, theta and phi, or of x, y and z, in the
    coordinates' dtype) and, under
    INTERBLOCK, the neighbour table and location parities (int32), under
    FMKS the map's table (2, n2m, n1m) in the coordinates' dtype; on the
    host the axes array: lo, hi, scale and bins of each axis
    (GUIDE_AXIS_VALUES float64 values an axis; under the modes of many
    blocks the box of every block and one bin), under FMKS followed by the
    map's FMKS_MAP_VALUES; the kernel mode (kernel_mode: grid/sampling.py
    SINGLE, BLOCKS, INTERBLOCK, FMKS, or CKS_BLOCKS, CKS_INTERBLOCK) and
    the nearest-cell flag; where the sampler takes the kappa slot
    (plasma_model = code_kappa), its (n_b, n_k, n_j, n_i) float32 table, a
    ninth value a cell that the mixture's kernels read beside the 32-byte
    rows of the others, which stay as they are."""

    table: torch.Tensor
    coords: torch.Tensor
    guides: torch.Tensor
    axes: np.ndarray
    bounds: torch.Tensor
    amr: torch.Tensor | None
    parity: torch.Tensor | None
    mode: int
    nearest: bool
    map: torch.Tensor | None = None
    kappa: torch.Tensor | None = None

    def args(self) -> tuple:
        """The C interfaces' table, coords, guides, axes, n_i, n_j, n_k,
        mode, nearest, n_b, bounds, amr, parity, map (a missing table as a
        null pointer)."""
        n_b, n_k, n_j, n_i = self.table.shape[:4]
        return (self.table.data_ptr(), self.coords.data_ptr(),
                self.guides.data_ptr(), self.axes.ctypes.data, n_i, n_j, n_k,
                self.mode, int(self.nearest), n_b, self.bounds.data_ptr(),
                None if self.amr is None else self.amr.data_ptr(),
                None if self.parity is None else self.parity.data_ptr(),
                None if self.map is None else self.map.data_ptr())

    def mixture_args(self) -> tuple:
        """args() and the kappa table (a null pointer where none), as the
        mixture's C interfaces take them."""
        return (*self.args(),
                None if self.kappa is None else self.kappa.data_ptr())


def kernel_mode(grid: SimulationGrid, sampler: SamplerOptions) -> int:
    """The mode of the kernel a launch on ``grid`` under ``sampler`` takes:
    grid/sampling.sampling_mode's (which raises for a mode the grid cannot
    take), or on a CKS grid CKS_INTERBLOCK for its INTERBLOCK and
    CKS_BLOCKS for the others (one block, many, the nearest cell)."""
    mode = sampling_mode(grid, sampler)
    if grid.coords != "cks":
        return mode
    return CKS_INTERBLOCK if mode == INTERBLOCK else CKS_BLOCKS


def kernel_grid(grid: SimulationGrid, dtype,
                sampler: SamplerOptions = SamplerOptions()) -> KernelGrid:
    """kernel_tables and what else a launch in ``dtype`` under
    ``sampler``'s mode (kernel_mode, which raises for a mode the grid
    cannot take) reads of ``grid``. The guides of a single
    block follow from the grid's host copy of its faces rounded to
    ``dtype``, as its device coordinates were, and are counted on the
    device, so nothing is read back; the modes of many blocks search each
    block's faces and take no guide. FMKS guides its native faces as
    SINGLE does, and adds the grid's map: its table rounded to ``dtype``
    and its values (grid.map_r_in, map_dr, map_dtheta, bounds and the
    table's shape), which the card rounds to ``dtype`` as the plain
    version's Python floats are rounded. A CKS grid's modes are those of
    many blocks, one block included. The kappa table is the grid's kappa
    slot where ``sampler.has_kappa``."""
    mode = kernel_mode(grid, sampler)
    table, coords = kernel_tables(grid, dtype)
    rounded = [h.astype(_NUMPY_DTYPES[dtype]) for h in grid.host_faces]
    bounds = torch.stack([c for f in (grid.x1f, grid.x2f, grid.x3f)
                          for c in (f[:, 0], f[:, -1])], dim=1).to(dtype)
    guides, axes, at = [], [], 0
    for host in rounded:
        n = host.shape[1] - 1
        if mode in (SINGLE, FMKS):
            lo, hi, scale, bins = axis_bins(host[0])
            guides.append(axis_guide(coords[at:at + n + 1], lo, scale, bins))
        else:
            lo, hi, scale, bins = float(host[:, 0].min()), \
                float(host[:, -1].max()), 0.0, 1
            guides.append(torch.zeros(1, dtype=torch.int32,
                                      device=coords.device))
        axes += (lo, hi, scale, bins)
        at += host.size + host.shape[0] * n
    interblock = mode in (INTERBLOCK, CKS_INTERBLOCK)
    fmks = mode == FMKS
    if fmks:
        axes += (grid.map_r_in, grid.map_dr, grid.map_dtheta, *grid.bounds,
                 grid.sks_map.shape[2], grid.sks_map.shape[1])
    return KernelGrid(table, coords, torch.cat(guides),
                      np.asarray(axes, dtype=np.float64), bounds.contiguous(),
                      grid.amr_table.contiguous() if interblock else None,
                      grid.loc_parity.contiguous() if interblock else None,
                      mode, not sampler.interp,
                      grid.sks_map.to(dtype).contiguous() if fmks else None,
                      grid.prim[grid.ind["kappa"]].contiguous()
                      if sampler.has_kappa else None)


def frequency_bucket(nf: int, one: bool = True) -> int:
    """The compile-time frequency bucket of a launch of nf frequencies
    (csrc/simulation_kernel.cuh NF): 1, or MAX_FREQUENCIES; always
    MAX_FREQUENCIES where the instantiation has no bucket of one
    (``one`` False: the mixture's kernels of many blocks and its phase
    kernels, csrc/simulation_kernel.cuh OneFrequencyBucket)."""
    if not 1 <= nf <= MAX_FREQUENCIES:
        raise ValueError(f"a launch takes 1..{MAX_FREQUENCIES} frequencies")
    return 1 if nf == 1 and one else MAX_FREQUENCIES


def launch_consts(values, nus, scales, dtype: torch.dtype, mix=None,
                  bucket=None) -> np.ndarray:
    """The kernels' launch constants (SimLaunchConsts) as the host packs
    them: ``values`` (kernel_params) rounded once to the rays' dtype, each
    value cut that is off (a negative value, the same float64 test the
    JAX package makes) as -inf for a minimum and +inf for a maximum, then
    the launch's frequencies ``nus`` and image ``scales`` (already in the
    rays' dtype), each padded with zeros to the launch's frequency
    ``bucket`` (frequency_bucket(len(nus)) by default); for a mixture
    launch (SimMixLaunchConsts) then ``mix`` (mixture_params) rounded
    once to the rays' dtype. numpy rounds float64 to float32 to nearest,
    as the card's conversion does."""
    if len(values) != len(PARAM_NAMES) or len(nus) != len(scales):
        raise ValueError("launch_consts takes PARAM_NAMES values and one "
                         "image scale per frequency")
    if mix is not None and len(mix) != len(MIX_PARAM_NAMES):
        raise ValueError("launch_consts takes MIX_PARAM_NAMES values")
    if bucket is None:
        bucket = frequency_bucket(len(nus))
    if not len(nus) <= bucket:
        raise ValueError("more frequencies than the bucket holds")
    v = np.asarray(values, dtype=np.float64).copy()
    for name in VALUE_CUT_NAMES:
        for end, off in (("MIN", -math.inf), ("MAX", math.inf)):
            at = PARAM_NAMES.index(f"{name}_{end}")
            if not v[at] >= 0.0:
                v[at] = off
    n = len(PARAM_NAMES) + 2 * bucket
    out = np.zeros(n + (0 if mix is None else len(mix)),
                   dtype=_NUMPY_DTYPES[dtype])
    out[:len(PARAM_NAMES)] = v
    out[len(PARAM_NAMES):len(PARAM_NAMES) + len(nus)] = np.asarray(nus)
    out[len(PARAM_NAMES) + bucket:len(PARAM_NAMES) + bucket + len(scales)] = \
        np.asarray(scales)
    if mix is not None:
        out[n:] = np.asarray(mix, dtype=np.float64)
    return out


def host_consts_sizes(mixture: bool = False) -> dict:
    """The bytes launch_consts packs per (dtype, frequency bucket), of a
    thermal or a ``mixture`` launch."""
    values = [0.0] * len(PARAM_NAMES)
    mix = [0.0] * len(MIX_PARAM_NAMES) if mixture else None
    return {(dtype, bucket): launch_consts(values, [1.0] * bucket,
                                           [1.0] * bucket, dtype, mix).nbytes
            for dtype in _DTYPE_CODES for bucket in (1, MAX_FREQUENCIES)}


def consts_sizes(lib, mixture: bool = False) -> dict:
    """sizeof(SimLaunchConsts) (or, for a ``mixture``, of
    SimMixLaunchConsts) per (dtype, frequency bucket), from the C side."""
    fn = lib.blacklight_simulation_mixture_consts_bytes if mixture \
        else lib.blacklight_simulation_consts_bytes
    return {(dtype, bucket): fn(code, bucket)
            for dtype, code in _DTYPE_CODES.items()
            for bucket in (1, MAX_FREQUENCIES)}


def render_simulation(positions, directions, momentum_factors, frequencies,
                      params: geo.GeodesicParams, sp: SimKernelParams,
                      grid: SimulationGrid, mass_msun: float, camera_x,
                      log_j_scale: float, integrator: str = "rk4"):
    """Fused render of a ray bundle through a GRMHD snapshot.

    Args:
      positions, directions: (B, 4) camera rays (covariant momenta),
        float32 or float64, contiguous; momentum_factors: (B,).
      frequencies: (F,) image frequencies in Hz, in the rays' dtype and
        on their device, F >= 1.
      params / sp: geodesic and simulation parameters; grid: the snapshot
        on the rays' device; camera_x: the camera position (4 values);
      log_j_scale: synchrotron.log_j_scale(frequencies[0]).
      integrator: "dp", "rk4" or "rk2".

    Returns (I_nu (B, F), flags (B,) bool, n_samples (B,) int32), on the
    rays' device and in their dtype. A CUDA device runs the CUDA kernel;
    the CPU runs ``render_simulation_reference``.
    """
    _check_rays(positions, directions, momentum_factors)
    _check_frequencies(frequencies, positions)
    if integrator not in INTEGRATORS:
        raise ValueError(f"integrator must be one of {INTEGRATORS}")
    check_grid(grid, sp.sampler)
    if grid.prim.device != positions.device:
        raise TypeError("the grid and the rays must share one device")
    device = positions.device
    if device.type == "cuda":
        return _render_cuda(positions, directions, momentum_factors,
                            frequencies, params, sp, grid, mass_msun,
                            camera_x, log_j_scale, integrator)
    if device.type == "cpu":
        return render_simulation_reference(
            positions, directions, momentum_factors, frequencies, params, sp,
            grid, mass_msun, camera_x, log_j_scale, integrator=integrator)
    raise ValueError(f"no simulation kernel for device {device}")


def image_scale(frequencies, log_j_scale: float):
    """(F,) factor from the scaled transfer sums to I_nu: the unit scale
    with the nu^3 factor, formed in log space in the working dtype as
    integrate_unpolarized forms it (the unit alone, ~1e-41, underflows
    float32)."""
    return torch.exp(torch.tensor(log_j_scale, dtype=frequencies.dtype,
                                  device=frequencies.device)
                     + 3.0 * torch.log(frequencies))


def _check_frequencies(frequencies, positions):
    if frequencies.dim() != 1 or frequencies.shape[0] < 1:
        raise ValueError(f"expected 1 or more frequencies, got shape "
                         f"{tuple(frequencies.shape)}")
    if (frequencies.dtype != positions.dtype
            or frequencies.device != positions.device):
        raise TypeError("frequencies must share the rays' dtype and device")


def _render_cuda(positions, directions, momentum_factors, frequencies,
                 params, sp, grid, mass_msun, camera_x, log_j_scale,
                 integrator):
    """One launch per MAX_FREQUENCIES frequencies; every launch traces the
    same rays, so the flags and sample counts of the first stand. The
    frequencies and their image scales, formed on the card in the rays'
    dtype, are read back once into the launch constants. The temporaries
    (tables, guides) may be freed before the kernel ends: the caching
    allocator hands their memory only to work queued after it on the same
    stream."""
    global LAUNCHES, MIXTURE_LAUNCHES
    lib = _library()
    device = positions.device
    b, nf = positions.shape[0], frequencies.shape[0]
    i_nu = torch.empty((b, nf), dtype=positions.dtype, device=device)
    flags = torch.empty(b, dtype=torch.int32, device=device)
    n_samples = torch.empty(b, dtype=torch.int32, device=device)
    if not b:
        return i_nu, flags.bool(), n_samples
    values = kernel_params(params, sp, float(frequencies[0]), mass_msun,
                           camera_x)
    kgrid = kernel_grid(grid, positions.dtype, sp.sampler)
    nus = frequencies.cpu().numpy()
    scales = image_scale(frequencies, log_j_scale).cpu().numpy()
    code, integ = _DTYPE_CODES[positions.dtype], INTEGRATORS.index(integrator)
    mixture = is_mixture(sp.plasma)
    mix = mixture_params(sp.plasma, False, sp.sampler.fallback_kappa) \
        if mixture else None
    launch = lib.blacklight_simulation_mixture_launch if mixture \
        else lib.blacklight_simulation_launch
    grid_args = kgrid.mixture_args() if mixture else kgrid.args()
    for start in range(0, nf, MAX_FREQUENCIES):
        stop = min(start + MAX_FREQUENCIES, nf)
        consts = launch_consts(
            values, nus[start:stop], scales[start:stop], positions.dtype, mix,
            frequency_bucket(stop - start,
                             one=not mixture or kgrid.mode == SINGLE))
        out = i_nu if stop - start == nf else torch.empty(
            (b, stop - start), dtype=positions.dtype, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = launch(
                code, integ, stop - start, positions.data_ptr(),
                directions.data_ptr(), momentum_factors.data_ptr(),
                consts.ctypes.data, consts.nbytes, *grid_args,
                out.data_ptr(), flags.data_ptr(), n_samples.data_ptr(), b,
                stream)
        if rc != 0:
            msg = lib.blacklight_cuda_error_string(rc).decode()
            raise RuntimeError(f"simulation kernel launch failed: {msg} "
                               f"({rc})")
        LAUNCHES += 1
        if mixture:
            MIXTURE_LAUNCHES += 1
            MIXTURE_MODE_LAUNCHES[kgrid.mode] += 1
            if kgrid.kappa is not None:
                CODE_KAPPA_MODE_LAUNCHES[kgrid.mode] += 1
        else:
            MODE_LAUNCHES[kgrid.mode] += 1
        if out is not i_nu:
            i_nu[:, start:stop] = out
    return i_nu, flags.bool(), n_samples


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library with the C interface of csrc/simulation_kernel.cu
    declared: every pointer and the stream as c_void_p."""
    lib = _build.load_library()
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, grid_args in (
            ("blacklight_simulation_launch", GRID_ARGTYPES),
            ("blacklight_simulation_mixture_launch", MIXTURE_GRID_ARGTYPES)):
        getattr(lib, name).argtypes = [
            i32, i32, i32, ptr, ptr, ptr, ptr, i64, *grid_args, ptr, ptr,
            ptr, i64, ptr]
        getattr(lib, name).restype = i32
    for name in ("blacklight_simulation_consts_bytes",
                 "blacklight_simulation_mixture_consts_bytes"):
        getattr(lib, name).argtypes = [i32, i32]
        getattr(lib, name).restype = i64
    for name in ("blacklight_simulation_param_count",
                 "blacklight_simulation_mixture_param_count",
                 "blacklight_simulation_max_frequencies",
                 "blacklight_simulation_guide_axis_values",
                 "blacklight_simulation_amr_table_fields",
                 "blacklight_simulation_fmks_map_values"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    lib.blacklight_cuda_error_string.argtypes = [i32]
    lib.blacklight_cuda_error_string.restype = ctypes.c_char_p
    if (lib.blacklight_simulation_param_count() != len(PARAM_NAMES)
            or lib.blacklight_simulation_mixture_param_count()
            != len(MIX_PARAM_NAMES)):
        raise RuntimeError("csrc/simulation_params.cuh and PARAM_NAMES or "
                           "MIX_PARAM_NAMES disagree")
    if (lib.blacklight_simulation_max_frequencies() != MAX_FREQUENCIES
            or lib.blacklight_simulation_guide_axis_values()
            != GUIDE_AXIS_VALUES
            or lib.blacklight_simulation_amr_table_fields()
            != amr.TABLE_FIELDS
            or lib.blacklight_simulation_fmks_map_values()
            != FMKS_MAP_VALUES):
        raise RuntimeError("csrc/simulation_kernel.cuh and MAX_FREQUENCIES, "
                           "GUIDE_AXIS_VALUES, FMKS_MAP_VALUES or "
                           "grid/amr.TABLE_FIELDS disagree")
    for mixture in (False, True):
        if consts_sizes(lib, mixture) != host_consts_sizes(mixture):
            raise RuntimeError(
                "SimLaunchConsts (SimMixLaunchConsts) and launch_consts "
                f"disagree: {consts_sizes(lib, mixture)} != "
                f"{host_consts_sizes(mixture)}")
    return lib


def fluid_sample(pos, sp: SimKernelParams, grid: SimulationGrid, spin,
                 camera_x, zero_cut: bool = False):
    """The grid sampled at CKS positions ``pos`` (B, 4) and the fluid
    state there: (samples, state, keep_geo, keep_val, b_zero), the cut
    masks and where the field vanishes (make_simulation_coeff_fns'
    state_at). With ``zero_cut`` the primitives are zeroed at
    geometrically cut samples before the fluid state, as the polarized
    route takes them (the reference's sampler leaves zeros there)."""
    samples = sample_grid(grid, pos, spin, sp.sampler)
    keep_geo = geometric_keep(pos, spin, camera_x, sp.geometric)
    if zero_cut:
        samples = {k: v if k in ("off_grid", "nan_mask")
                   else torch.where(keep_geo, v, 0.0)
                   for k, v in samples.items()}
    state = synchrotron.fluid_state(pos, samples, spin, sp.plasma,
                                    sp.rho_unit, coords=grid.coords)
    keep_val = synchrotron.value_cuts(state, sp.cuts)
    b_zero = ((samples["bb1"] == 0.0) & (samples["bb2"] == 0.0)
              & (samples["bb3"] == 0.0))
    return samples, state, keep_geo, keep_val, b_zero


def sample_coefficients(pos, kcov, momentum_factors, frequencies,
                        sp: SimKernelParams, grid: SimulationGrid, spin,
                        camera_x, nu0: float, fluid=None):
    """Invariant j (scaled by exp(-log_j_scale)) and alpha, (B, F) each,
    and the (B, F) mask of samples the reference would NaN, at CKS
    positions ``pos`` (B, 4) with covariant momenta ``kcov`` (four (B,)
    components): make_simulation_coeff_fns' coeff_fn for the slice.
    Coefficients are zero where a cut holds or the field vanishes.
    ``fluid``: ``fluid_sample`` at ``pos``, where already formed."""
    samples, state, keep_geo, keep_val, b_zero = \
        fluid_sample(pos, sp, grid, spin, camera_x) if fluid is None \
        else fluid
    sin_b, cos_b, sin2_b, u_dot_k = synchrotron.pitch_angle(kcov, state)
    nu_cgs = -u_dot_k[:, None] * frequencies[None, :] \
        * momentum_factors[:, None]
    j, alpha = synchrotron.all_coefficients(
        nu_cgs, nu0, state, sin_b, sp.plasma, cos_theta_b=cos_b,
        sin2_theta_b=sin2_b)
    keep = (keep_geo & keep_val & ~b_zero)[:, None]
    j = torch.where(keep, j, 0.0)
    alpha = torch.where(keep, alpha, 0.0)
    bad = (samples["nan_mask"] & keep_geo)[:, None].expand(j.shape)
    return j, alpha, bad


def cell_values(fluid):
    """make_simulation_coeff_fns' cell_fn from ``fluid_sample``'s
    output: (B, NUM_CELL_VALUES), NaN where a cut holds or the reference
    would NaN the sample."""
    samples, state, keep_geo, keep_val, _ = fluid
    keep = (keep_geo & keep_val & ~samples["nan_mask"])[:, None]
    return torch.where(keep, synchrotron.cell_values(state), math.nan)


def transfer_update(acc: dict, momentum_factors, frequencies,
                    sp: SimKernelParams, grid: SimulationGrid, spin: float,
                    mass_msun: float, camera_x):
    """The on_sample of ``geodesic.trace_steps`` for the kernel's plain
    versions: ``sample_coefficients`` and the light step of
    ``transfer/unpolarized.integrate_unpolarized`` (``light_update``) at
    one step of the bundle. It updates ``acc`` in place: "bad" (B, F)
    bool, the samples the reference would NaN; "intensity" (B, F), the
    unscaled transfer sum; "tau" (B, F), the optical depth."""
    x_unit = tu.x_unit(mass_msun)
    nu0 = float(frequencies[0])
    cam = [float(v) for v in camera_x]
    mom = momentum_factors

    def update(valid, ym, k, h):
        pos, kcov = tu.safe_sample(valid, ym, k, cam)
        j, alpha, bad = tu.sanitize(*sample_coefficients(
            pos, kcov, mom, frequencies, sp, grid, spin, cam, nu0))
        vcol = valid[:, None]
        acc["bad"] = acc["bad"] | (vcol & bad)
        _, dl_cgs = tu.path_cgs(valid, h, x_unit, frequencies, mom)
        acc["intensity"], acc["tau"] = tu.light_update(
            acc["intensity"], acc["tau"], j, alpha, dl_cgs, vcol)

    return update


def _finish(intensity, bad, flags, n_samples, frequencies, log_j_scale,
            fallback_nan):
    """The image of finished rays from their (B, F) transfer sums and bad
    samples: one multiply by image_scale, NaN where a sample was bad or,
    under fallback_nan, where the ray hit max_steps (the monolithic
    kernel's forms, csrc/simulation_kernel.cuh)."""
    poison = bad | (flags & fallback_nan)[:, None]
    i_nu = torch.where(poison, math.nan,
                       intensity * image_scale(frequencies, log_j_scale))
    return i_nu, flags, n_samples


def render_simulation_reference(positions, directions, momentum_factors,
                                frequencies, params: geo.GeodesicParams,
                                sp: SimKernelParams, grid: SimulationGrid,
                                mass_msun: float, camera_x,
                                log_j_scale: float, integrator: str = "rk4"):
    """The kernel's function in plain torch ops: the shared lock-step loop
    (``geodesic.trace_reference``) with ``transfer_update`` at every
    sample. Returns what ``render_simulation`` returns."""
    _check_rays(positions, directions, momentum_factors)
    _check_frequencies(frequencies, positions)
    b, nf = positions.shape[0], frequencies.shape[0]
    zero = torch.zeros((b, nf), dtype=positions.dtype,
                       device=positions.device)
    acc = {"bad": torch.zeros_like(zero, dtype=torch.bool),
           "intensity": zero, "tau": zero}
    update = transfer_update(acc, momentum_factors, frequencies, sp, grid,
                             params.bh_a, mass_msun, camera_x)
    flag, n_samp = geo.trace_reference(positions, directions, params,
                                       integrator, update)
    return _finish(acc["intensity"], acc["bad"], flag, n_samp, frequencies,
                   log_j_scale, sp.sampler.fallback_nan)


# ---------------------------------------------------------------------------
# Ray orderings of the kernel routes


def _bins(x, levels: int):
    """Each value's bin among ``levels`` equal bins between the least and
    the greatest value, int64; all 0 where the values span nothing (the
    JAX package's quant, in the values' dtype)."""
    lo = x.min()
    span = x.max() - lo
    scaled = ((x - lo) / span * levels).to(torch.int64).clamp(0, levels - 1)
    return torch.where(span > 0.0, scaled, 0)


def _tile_order(u, v, fine_u: int, fine_v: int, block: int):
    """The stable permutation that sorts rays by u's bin, then v's, among
    g = ceil(sqrt(B / block)) bins each, then u's among fine_u * g bins,
    then v's among fine_v * g: np.lexsort's order, by one argsort over a
    combined int64 key."""
    b = u.shape[0]
    g = max(1, math.ceil(math.sqrt(b / float(block))))
    key = torch.zeros(b, dtype=torch.int64, device=u.device)
    for x, levels in ((u, g), (v, g), (u, fine_u * g), (v, fine_v * g)):
        key = key * levels + _bins(x, levels)
    return torch.argsort(key, stable=True)


def spatial_order(positions, block: int = 1024):
    """Group rays into coherent ~sqrt(block) x sqrt(block) camera-plane
    tiles by their camera-plane coordinates, with a finer sub-key (8 x 4
    bins in each tile) so that runs of block / 32 rays are compact
    patches: ``blacklight_tpu/ops/pallas_simulation.py`` spatial_order
    :440, on the rays' device. The camera plane is the two principal axes
    of the positions' x^1..x^3; its 3 x 3 moment matrix is reduced on the
    device and solved on the host by numpy.linalg.eigh in float64, as the
    JAX package solves it, so that the axes' signs and the permutation
    are the JAX package's.

    Returns a permutation (B,) int64 on the positions' device.
    """
    q = positions[:, 1:4]
    q = q - q.mean(dim=0)
    _, vecs = np.linalg.eigh((q.T @ q).cpu().numpy())
    vecs = torch.from_numpy(vecs).to(q.device)
    u, v = q @ vecs[:, -1], q @ vecs[:, -2]
    return _tile_order(u, v, 8, 4, block)


def angular_order(positions, block: int = 1024):
    """Group mid-flight rays into (phi, theta)-compact runs:
    ``blacklight_tpu/ops/pallas_simulation.py`` angular_order :474, on the
    rays' device. Phased dispatch re-tiles its survivors with it: once
    rays have travelled, the camera plane no longer says which are near
    each other.

    Returns a permutation (B,) int64 on the positions' device.
    """
    x, y, z = positions[:, 1], positions[:, 2], positions[:, 3]
    r = torch.sqrt(x * x + y * y + z * z) + 1.0e-30
    phi = torch.atan2(y, x)
    cth = z / r
    return _tile_order(phi, cth, 8, 8, block)


# ---------------------------------------------------------------------------
# Phased dispatch (K2.3)

# Phase kernel launches so far; render_simulation_phase adds one per launch
# of the CUDA phase kernel and nowhere else.
PHASE_LAUNCHES = 0
# Of those, the launches of each kernel mode's phase kernel (SINGLE:
# simulation_phase_kernel; BLOCKS, INTERBLOCK, CKS_BLOCKS, CKS_INTERBLOCK:
# simulation_phase_mode_kernel; FMKS: simulation_phase_fmks_kernel), and
# of the mixture's (simulation_phase_mixture_kernel, any mode), also by mode,
# and of those the launches at the code_kappa temperature, by mode.
PHASE_MODE_LAUNCHES = [0] * KERNEL_MODES
PHASE_MIXTURE_LAUNCHES = 0
PHASE_MIXTURE_MODE_LAUNCHES = [0] * KERNEL_MODES
PHASE_CODE_KAPPA_MODE_LAUNCHES = [0] * KERNEL_MODES

# Steps a phase of render_simulation_phased by default: at 1024^2 with 2000
# steps, 1000 (2 launches) beat the JAX package's 512 (4 launches) in turns
# on an H100 (PERF.md).
PHASE_STEPS = 1000

# Bits of SimCarry.masks (csrc/simulation_kernel.cuh CARRY_*).
ALIVE, TRUNC, FLAG = 1, 2, 4


class SimCarry(NamedTuple):
    """The state phased dispatch carries from one phase to the next, for
    the whole bundle, each tensor on the rays' device and indexed by a
    ray's place in the bundle: y (7, B) in the rays' dtype, x^0..x^3 and
    p_1..p_3; r_mid_prev (B,); n_samp (B,) int32; masks (B,) int32, the
    bits ALIVE, TRUNC and FLAG; intensity and tau (F, B), the unscaled
    transfer sum and the optical depth (the port's accumulators: the TPU
    kernel carries the attenuation instead); bad (C, B) int32, C =
    ceil(F / MAX_FREQUENCIES): bit f of row c set where frequency
    c * MAX_FREQUENCIES + f met a sample the reference would NaN.

    The phase kernel updates it in place."""

    y: torch.Tensor
    r_mid_prev: torch.Tensor
    n_samp: torch.Tensor
    masks: torch.Tensor
    intensity: torch.Tensor
    tau: torch.Tensor
    bad: torch.Tensor


def initial_carry(positions, directions, params: geo.GeodesicParams,
                  nf: int) -> SimCarry:
    """The carried state of ``nf`` frequencies at the camera: every ray
    alive, no sample yet (``geodesic.initial_state``)."""
    state = geo.initial_state(positions, directions, params)
    b = positions.shape[0]
    zero = torch.zeros((nf, b), dtype=positions.dtype,
                       device=positions.device)
    return SimCarry(
        y=torch.stack(state.y), r_mid_prev=state.r_mid_prev,
        n_samp=state.n_samples, masks=_pack_masks(state),
        intensity=zero, tau=zero.clone(),
        bad=torch.zeros((-(-nf // MAX_FREQUENCIES), b), dtype=torch.int32,
                        device=positions.device))


def _pack_masks(state: geo.RayState):
    return (state.alive.to(torch.int32) * ALIVE
            | state.trunc.to(torch.int32) * TRUNC
            | state.flag.to(torch.int32) * FLAG)


def _bad_bits(bad, nf: int):
    """(n, nf) bool from the (C, n) bit rows of SimCarry.bad."""
    f = torch.arange(nf, device=bad.device)
    bits = bad[f // MAX_FREQUENCIES] >> (f % MAX_FREQUENCIES)[:, None]
    return (bits & 1).bool().T


def _check_phase(carry: SimCarry, index, n_base: int, phase_steps: int,
                 directions, momentum_factors, frequencies, integrator: str):
    if integrator not in ("rk4", "rk2"):
        raise ValueError("phased dispatch runs rk4 and rk2 only (dp would "
                         "also carry its step controller), not "
                         f"{integrator!r}")
    b = carry.y.shape[1]
    nf = frequencies.shape[0]
    if (carry.y.shape != (7, b) or carry.intensity.shape != (nf, b)
            or carry.tau.shape != (nf, b)
            or carry.bad.shape != (-(-nf // MAX_FREQUENCIES), b)
            or any(t.shape != (b,) for t in (carry.r_mid_prev, carry.n_samp,
                                              carry.masks))):
        raise ValueError("the carried state does not fit the frequencies "
                         "or its bundle")
    if directions.shape != (b, 4) or momentum_factors.shape != (b,):
        raise ValueError("directions and momentum_factors must be the "
                         "carried bundle's")
    if index.dtype != torch.int32 or index.dim() != 1:
        raise TypeError("index must be a 1-D int32 tensor")
    if n_base < 0 or phase_steps < 1:
        raise ValueError("n_base must be >= 0 and phase_steps >= 1")
    tensors = (*carry, index, directions, momentum_factors, frequencies)
    if any(t.device != carry.y.device for t in tensors):
        raise TypeError("the carried state, the index and the rays must "
                        "share one device")
    for t in (carry.y, carry.r_mid_prev, carry.intensity, carry.tau,
              directions, momentum_factors, frequencies):
        if t.dtype != carry.y.dtype:
            raise TypeError("the carried state, the rays and the "
                            "frequencies must share one dtype")
    for t in (carry.n_samp, carry.masks, carry.bad):
        if t.dtype != torch.int32:
            raise TypeError("n_samp, masks and bad must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the carried state, the index and the rays must be "
                         "contiguous")


def render_simulation_phase(carry: SimCarry, index, n_base: int,
                            phase_steps: int, directions, momentum_factors,
                            frequencies, params: geo.GeodesicParams,
                            sp: SimKernelParams, grid: SimulationGrid,
                            mass_msun: float, camera_x,
                            integrator: str = "rk4") -> None:
    """One phase of phased dispatch: advance the rays ``index`` (int32,
    places in the bundle) of ``carry`` by the steps [n_base, n_base +
    phase_steps) (ending at ray_max_steps), updating ``carry`` in place.
    ``directions`` and ``momentum_factors`` are the bundle's camera rays
    (p_0 and the momentum factor are constants of motion). rk4 and rk2
    only: ValueError for dp, as the JAX package raises.

    A CUDA device launches the phase kernel (csrc/simulation_kernel.cuh
    simulation_phase_kernel; one launch per MAX_FREQUENCIES frequencies)
    or raises; the CPU runs ``render_simulation_phase_reference``.
    """
    _check_phase(carry, index, n_base, phase_steps, directions,
                 momentum_factors, frequencies, integrator)
    run = _phase_runner(frequencies, params, sp, grid, mass_msun, camera_x,
                        integrator, carry.y.device)
    run(carry, index, n_base, phase_steps, directions, momentum_factors)


def _phase_runner(frequencies, params, sp, grid, mass_msun, camera_x,
                  integrator, device):
    """run(carry, index, n_base, phase_steps, directions,
    momentum_factors): one phase on ``device``, with what every phase of
    a render shares (the parameter vector, the tables) built once."""
    check_grid(grid, sp.sampler)
    if grid.prim.device != device:
        raise TypeError("the grid and the rays must share one device")
    if device.type == "cpu":
        def run(carry, index, n_base, phase_steps, directions,
                momentum_factors):
            render_simulation_phase_reference(
                carry, index, n_base, phase_steps, directions,
                momentum_factors, frequencies, params, sp, grid, mass_msun,
                camera_x, integrator)
        return run
    if device.type != "cuda":
        raise ValueError(f"no simulation kernel for device {device}")
    lib = _phase_library()
    nf, dtype = frequencies.shape[0], frequencies.dtype
    values = kernel_params(params, sp, float(frequencies[0]), mass_msun,
                           camera_x)
    kgrid = kernel_grid(grid, dtype, sp.sampler)
    nus = frequencies.cpu().numpy()
    code, integ = _DTYPE_CODES[dtype], INTEGRATORS.index(integrator)
    mixture = is_mixture(sp.plasma)
    mix = mixture_params(sp.plasma, False, sp.sampler.fallback_kappa) \
        if mixture else None
    launch = lib.blacklight_simulation_phase_mixture_launch if mixture \
        else lib.blacklight_simulation_phase_launch
    grid_args = kgrid.mixture_args() if mixture else kgrid.args()
    # the phase kernel writes no image: its scales are zero
    chunks = [(start, min(start + MAX_FREQUENCIES, nf), launch_consts(
        values, nus[start:start + MAX_FREQUENCIES],
        np.zeros_like(nus[start:start + MAX_FREQUENCIES]), dtype, mix,
        frequency_bucket(len(nus[start:start + MAX_FREQUENCIES]),
                         one=not mixture)))
        for start in range(0, nf, MAX_FREQUENCIES)]

    def run(carry, index, n_base, phase_steps, directions, momentum_factors):
        """One launch per MAX_FREQUENCIES frequencies; only the last
        writes the ray state back, so that every launch of the phase
        starts from the same state (they run in order on the stream)."""
        global PHASE_LAUNCHES, PHASE_MIXTURE_LAUNCHES
        b, n_live = carry.y.shape[1], index.shape[0]
        if not n_live:
            return
        for chunk, (start, stop, consts) in enumerate(chunks):
            with torch.cuda.device(device):
                stream = torch.cuda.current_stream(device).cuda_stream
                rc = launch(
                    code, integ, stop - start, index.data_ptr(), n_live,
                    n_base, phase_steps, int(chunk == len(chunks) - 1),
                    directions.data_ptr(), momentum_factors.data_ptr(),
                    consts.ctypes.data, consts.nbytes, *grid_args,
                    carry.y.data_ptr(), carry.r_mid_prev.data_ptr(),
                    carry.n_samp.data_ptr(), carry.masks.data_ptr(),
                    carry.intensity[start].data_ptr(),
                    carry.tau[start].data_ptr(), carry.bad[chunk].data_ptr(),
                    b, stream)
            if rc != 0:
                msg = lib.blacklight_cuda_error_string(rc).decode()
                raise RuntimeError(f"simulation phase kernel launch failed: "
                                   f"{msg} ({rc})")
            PHASE_LAUNCHES += 1
            if mixture:
                PHASE_MIXTURE_LAUNCHES += 1
                PHASE_MIXTURE_MODE_LAUNCHES[kgrid.mode] += 1
                if kgrid.kappa is not None:
                    PHASE_CODE_KAPPA_MODE_LAUNCHES[kgrid.mode] += 1
            else:
                PHASE_MODE_LAUNCHES[kgrid.mode] += 1
    return run


@functools.cache
def _phase_library() -> ctypes.CDLL:
    """The built library with the C interface of csrc/simulation_phase.cu
    declared as well."""
    lib = _library()
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, grid_args in (
            ("blacklight_simulation_phase_launch", GRID_ARGTYPES),
            ("blacklight_simulation_phase_mixture_launch",
             MIXTURE_GRID_ARGTYPES)):
        getattr(lib, name).argtypes = [
            i32, i32, i32, ptr, i64, i32, i32, i32, ptr, ptr, ptr, i64,
            *grid_args, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, ptr]
        getattr(lib, name).restype = i32
    return lib


def render_simulation_phase_reference(carry: SimCarry, index, n_base: int,
                                      phase_steps: int, directions,
                                      momentum_factors, frequencies,
                                      params: geo.GeodesicParams,
                                      sp: SimKernelParams,
                                      grid: SimulationGrid, mass_msun: float,
                                      camera_x, integrator: str = "rk4"):
    """The phase kernel's function in plain torch ops: the rays ``index``
    gathered from ``carry``, ``geodesic.trace_steps`` over the phase with
    ``transfer_update`` at every sample, and the result scattered back
    into ``carry`` in place."""
    _check_phase(carry, index, n_base, phase_steps, directions,
                 momentum_factors, frequencies, integrator)
    nf = frequencies.shape[0]
    idx = index.long()
    masks = carry.masks[idx]
    false = torch.zeros_like(masks, dtype=torch.bool)
    state = geo.RayState(
        y=tuple(carry.y[c, idx] for c in range(7)),
        h=torch.zeros_like(carry.r_mid_prev[idx]),
        alive=(masks & ALIVE) != 0, trunc=(masks & TRUNC) != 0,
        flag=(masks & FLAG) != 0, prev_fail=false,
        r_mid_prev=carry.r_mid_prev[idx], n_samples=carry.n_samp[idx],
        num_retry=torch.zeros_like(masks))
    acc = {"bad": _bad_bits(carry.bad[:, idx], nf),
           "intensity": carry.intensity[:, idx].T,
           "tau": carry.tau[:, idx].T}
    update = transfer_update(acc, momentum_factors[idx], frequencies, sp,
                             grid, params.bh_a, mass_msun, camera_x)
    state = geo.trace_steps(state, directions[idx, 0], params, integrator,
                            n_base, n_base + phase_steps, update)
    carry.y[:, idx] = torch.stack(state.y)
    carry.r_mid_prev[idx] = state.r_mid_prev
    carry.n_samp[idx] = state.n_samples
    carry.masks[idx] = _pack_masks(state)
    carry.intensity[:, idx] = acc["intensity"].T
    carry.tau[:, idx] = acc["tau"].T
    f = torch.arange(nf, device=idx.device)
    weights = (1 << (f % MAX_FREQUENCIES)).to(torch.int32)
    for chunk in range(carry.bad.shape[0]):
        cols = slice(chunk * MAX_FREQUENCIES, (chunk + 1) * MAX_FREQUENCIES)
        carry.bad[chunk, idx] = (acc["bad"][:, cols].to(torch.int32)
                                 * weights[cols]).sum(dim=1,
                                                      dtype=torch.int32)


def finish_rays(carry: SimCarry, index, frequencies, log_j_scale: float,
                fallback_nan: bool):
    """The outputs of the rays ``index`` as they leave the pool, in the
    monolithic kernel's forms (one multiply by image_scale, NaN where a
    sample was bad or, under fallback_nan, where the ray hit max_steps):
    (I_nu (n, F), flags (n,) bool, n_samples (n,) int32)."""
    idx = index.long()
    flags = (carry.masks[idx] & FLAG) != 0
    return _finish(carry.intensity[:, idx].T,
                   _bad_bits(carry.bad[:, idx], frequencies.shape[0]), flags,
                   carry.n_samp[idx], frequencies, log_j_scale, fallback_nan)


def render_simulation_phased(positions, directions, momentum_factors,
                             frequencies, params: geo.GeodesicParams,
                             sp: SimKernelParams, grid: SimulationGrid,
                             mass_msun: float, camera_x, log_j_scale: float,
                             integrator: str = "rk4",
                             phase_steps: int = PHASE_STEPS,
                             block: int = 1024, stats=None):
    """Phased-dispatch render (``blacklight_tpu/ops/pallas_simulation.py``
    render_simulation_phased :1588): the step budget is split into phases
    of ``phase_steps``; after each phase the rays that finished leave the
    pool with their outputs, and the survivors are re-tiled by
    ``angular_order`` (``block``) on their current positions. A kernel
    block then holds rays that are still running and near each other.

    Everything stays on the rays' device: the carried state in place in
    full-size buffers (``SimCarry``), the pool an int32 index list that
    is compacted and re-ordered between launches. The survivor count is
    the one host sync per phase. Unlike the JAX package, the pool is not
    padded to a fixed chunk (that let one XLA executable serve every
    launch; a CUDA launch takes any size), and no ray is re-rendered (the
    port's kernel has no overflow latch).

    stats: None, or a list that gets one dict per phase: its rays, its
    survivors, each ray's samples in the phase (in launch order), and the
    seconds of the kernel and of the compaction and ordering, each ended
    by a device synchronization.

    Returns what ``render_simulation`` returns, bit for bit on the card.
    """
    _check_rays(positions, directions, momentum_factors)
    _check_frequencies(frequencies, positions)
    device = positions.device
    b, nf = positions.shape[0], frequencies.shape[0]
    carry = initial_carry(positions, directions, params, nf)
    index = torch.arange(b, dtype=torch.int32, device=device)
    _check_phase(carry, index, 0, phase_steps, directions, momentum_factors,
                 frequencies, integrator)
    run = _phase_runner(frequencies, params, sp, grid, mass_msun, camera_x,
                        integrator, device)
    i_nu = torch.empty((b, nf), dtype=positions.dtype, device=device)
    flags = torch.empty(b, dtype=torch.bool, device=device)
    n_samples = torch.empty(b, dtype=torch.int32, device=device)
    n_phases = -(-params.ray_max_steps // phase_steps)
    for phase in range(n_phases):
        t0 = _clock(device, stats)
        before = carry.n_samp[index.long()] if stats is not None else None
        run(carry, index, phase * phase_steps, phase_steps, directions,
            momentum_factors)
        t1 = _clock(device, stats)
        # finished rays first, survivors after, each in pool order
        alive = (carry.masks[index.long()] & ALIVE) != 0
        if phase == n_phases - 1:
            alive = torch.zeros_like(alive)
        n_alive = int(alive.sum())
        pool = index[torch.argsort(alive.to(torch.int8), stable=True)]
        done, survivors = pool[:pool.shape[0] - n_alive], \
            pool[pool.shape[0] - n_alive:]
        out = finish_rays(carry, done, frequencies, log_j_scale,
                          sp.sampler.fallback_nan)
        for dest, value in zip((i_nu, flags, n_samples), out):
            dest[done.long()] = value
        if n_alive:
            order = angular_order(carry.y[:4, survivors.long()].T, block)
            survivors = survivors[order]
        if stats is not None:
            t2 = _clock(device, stats)
            stats.append({
                "phase": phase, "rays": index.shape[0], "survivors": n_alive,
                "samples": (carry.n_samp[index.long()] - before).cpu().numpy(),
                "kernel_s": t1 - t0, "compact_s": t2 - t1})
        index = survivors
        if not n_alive:
            break
    return i_nu, flags, n_samples


def _clock(device, stats) -> float:
    """perf_counter after the device's work so far, when stats are kept."""
    if stats is None:
        return 0.0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()
