"""AthenaK binary snapshot loader.

Port of ``blacklight_tpu/grid/athenak.py`` (:33-181), the reference's
AthenaK branch: a text header with the version, time, sizes, variable
names and the offset of the cell data
(src/simulation_reader/simulation_reader.cpp:915-1014,
ReadAthenaKHeader), the <section> key = value inputs after it
(:1027-1139, ReadAthenaKInputs), then one record a mesh block

  [24 B index range][12 B logical location][4 B level]
  [6 * location_size face coordinates][n_vars * cells * variable_size]

(:433-588), with the variables dens, velx, vely, velz, eint, bcc1-3
(:1226-1294) and eint converted to pgas (:581-587). The cell data are
in Cartesian Kerr-Schild (CKS) coordinates, the grid's too: no
coordinate conversion applies, and the grid is marked ``coords = "cks"``.
The refinement metadata (``levels``, ``locations``) go with it, for
exact interblock sampling (grid/amr.py, without a periodic axis).
"""

from __future__ import annotations

import numpy as np
import torch

from blacklight_tpu_torch.grid.athena import SimulationGrid, simulation_grid
from blacklight_tpu_torch.utils.errors import (
    BlacklightError,
    blacklight_warning,
)

VERSION_LINE = b"Athena binary output version=1.1"
# The file's variables for the sampler's names (VerifyVariablesAthenaK)
VARIABLE_NAMES = {"rho": "dens", "uu1": "velx", "uu2": "vely",
                  "uu3": "velz", "pgas": "eint", "bb1": "bcc1",
                  "bb2": "bcc2", "bb3": "bcc3"}
# The grid's primitive order (simulation_reader.cpp:538-541, 575-579)
PRIMITIVE_ORDER = ("rho", "uu1", "uu2", "uu3", "pgas", "bb1", "bb2", "bb3")
# (section, key) of the parameters held against the user's inputs, with
# the name of each in the warning and in ``expected``
CHECKED_PARAMETERS = ((("coord", "a"), "spin"),
                      (("units", "bhmass_msun"), "mass"),
                      (("units", "density_cgs"), "density scale"),
                      (("units", "mu"), "molecular weight"))
# Bytes of a block record before its face coordinates: the index range
# (6 int32), the logical location (3 int32) and the level (int32)
RECORD_HEAD = 40


def _header_value(line: bytes, prefix: str) -> str:
    text = line.decode(errors="replace")
    if not text.startswith(prefix):
        raise BlacklightError("Invalid AthenaK file header.")
    return text[len(prefix):].strip()


def _lines(data: bytes):
    """The header's lines, each without its newline, with the offset just
    past it (b"" at the end of the data, as a file's readline gives)."""
    pos = 0
    while True:
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end
        line, pos = data[pos:end], min(end + 1, len(data))
        yield line, pos


def _parameters(text: bytes) -> dict:
    """The parameter section: {(section, key): value string}."""
    params = {}
    section = ""
    for raw in text.split(b"\n"):
        line = raw.decode(errors="replace").strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("<") and line.endswith(">"):
            section = line[1:-1]
            continue
        if "=" in line:
            key, _, value = line.partition("=")
            params[(section, key.strip())] = value.split("#")[0].strip()
    return params


def expand(lo, hi, n: int):
    """Uniform faces (n_b, n + 1) and centres (n_b, n) of blocks from
    their bounds lo, hi (n_b,) (simulation_reader.cpp:496-529): the
    endpoints exact, the faces in between lo + (hi - lo) * (i / n)."""
    frac = np.arange(n + 1, dtype=np.float64) / n
    xf = lo[:, None] + (hi - lo)[:, None] * frac[None, :]
    xf[:, 0] = lo
    xf[:, -1] = hi
    return xf, 0.5 * (xf[:, :-1] + xf[:, 1:])


def load_athenak(path: str, kappa_name=None, *, device,
                 dtype=torch.float64, plasma_gamma=None,
                 expected=None) -> SimulationGrid:
    """Load an AthenaK binary dump onto ``device``.

    kappa_name: the file's variable of the kappa slot, if any.
    plasma_gamma: the user's adiabatic index (None: the file's).
    expected: optional dict of user inputs held against the file's
    parameter section, a, bhmass_msun, density_cgs and mu: a mismatch
    warns (simulation_reader.cpp:1057-1124).
    """
    with open(path, "rb") as f:
        data = f.read()
    lines = _lines(data)
    if next(lines)[0] != VERSION_LINE:
        raise BlacklightError("Unknown AthenaK file format.")
    next(lines)  # the preamble's size, unchecked (:932-934)
    time = float(_header_value(next(lines)[0], "  time="))
    next(lines)  # the cycle, unchecked (:943-945)
    loc_size = int(_header_value(next(lines)[0], "  size of location="))
    var_size = int(_header_value(next(lines)[0], "  size of variable="))
    if loc_size not in (4, 8):
        raise BlacklightError("Unsupported size of location.")
    if var_size not in (4, 8):
        raise BlacklightError("Unsupported size of variables.")
    n_vars = int(_header_value(next(lines)[0], "  number of variables="))
    names = next(lines)[0].decode(errors="replace")
    if not names.startswith("  variables:"):
        raise BlacklightError("Invalid AthenaK file header.")
    variable_names = names[len("  variables:"):].split()
    if len(variable_names) != n_vars:
        raise BlacklightError("Invalid AthenaK file header.")
    offset_line, param_start = next(lines)
    header_offset = int(_header_value(offset_line, "  header offset="))
    data_offset = param_start + header_offset

    params = _parameters(data[param_start:data_offset])
    gamma = plasma_gamma
    if ("mhd", "gamma") in params:
        file_gamma = float(params[("mhd", "gamma")])
        if gamma is None:
            gamma = file_gamma
        elif gamma != file_gamma:
            blacklight_warning(
                f"Given total adiabatic index of {gamma} does not match file "
                f"value of {file_gamma}; ignoring the latter.")
    if gamma is None:
        raise BlacklightError("Missing adiabatic index.")
    for (sec, key), label in CHECKED_PARAMETERS:
        if expected and key in expected and (sec, key) in params:
            file_val = float(params[(sec, key)])
            if file_val != expected[key]:
                blacklight_warning(
                    f"Given {label} of {expected[key]} does not match file "
                    f"value of {file_val}; ignoring the latter.")

    wanted = dict(VARIABLE_NAMES)
    order = list(PRIMITIVE_ORDER)
    if kappa_name is not None:
        wanted["kappa"] = kappa_name
        order.append("kappa")
    file_ind = {}
    for key, var in wanted.items():
        if var not in variable_names:
            raise BlacklightError(
                f'Unable to locate "{var}" values in data file.')
        file_ind[key] = variable_names.index(var)

    # the block shape from the first block's index range (:433-448)
    idx = np.frombuffer(data, dtype=np.int32, count=6, offset=data_offset)
    nx = int(idx[1] - idx[0] + 1)
    ny = int(idx[3] - idx[2] + 1)
    nz = int(idx[5] - idx[4] + 1)
    cells = nx * ny * nz
    block_bytes = RECORD_HEAD + 6 * loc_size + n_vars * cells * var_size
    n_blocks = (len(data) - data_offset) // block_bytes
    if n_blocks < 1 or (len(data) - data_offset) % block_bytes != 0:
        raise BlacklightError("Unknown AthenaK file format.")

    # the records as strided views of the file's bytes
    def field(offset, dt, shape, strides):
        return np.ndarray(shape, dtype=dt, buffer=data,
                          offset=data_offset + offset,
                          strides=(block_bytes, *strides))

    locations = field(24, np.int32, (n_blocks, 3), (4,)).astype(np.int64)
    levels = field(36, np.int32, (n_blocks,), ()).copy()
    loc_dtype = np.dtype(np.float32 if loc_size == 4 else np.float64)
    faces = field(RECORD_HEAD, loc_dtype, (n_blocks, 6),
                  (loc_size,)).astype(np.float64)
    var_dtype = np.dtype(np.float32 if var_size == 4 else np.float64)
    cell_data = field(RECORD_HEAD + 6 * loc_size, var_dtype,
                      (n_blocks, n_vars, nz, ny, nx),
                      (cells * var_size, ny * nx * var_size, nx * var_size,
                       var_size))

    x1f, x1v = expand(faces[:, 0], faces[:, 1], nx)
    x2f, x2v = expand(faces[:, 2], faces[:, 3], ny)
    x3f, x3v = expand(faces[:, 4], faces[:, 5], nz)

    # repacked into the grid's order, each value rounded to float32 as the
    # JAX package's cell data are; eint -> pgas in float32
    prim = np.empty((len(order), n_blocks, nz, ny, nx), dtype=np.float32)
    for slot, name in enumerate(order):
        prim[slot] = cell_data[:, file_ind[name]]
    ind = {name: slot for slot, name in enumerate(order)}
    prim[ind["pgas"]] *= np.float32(gamma - 1.0)

    return simulation_grid(prim, x1f, x1v, x2f, x2v, x3f, x3v, ind, time,
                           device=device, dtype=dtype, levels=levels,
                           locations=locations, coords="cks")
