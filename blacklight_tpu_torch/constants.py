"""Mathematical/physical constants and enumerations.

Mirrors the constant and enum surface of the reference
(src/blacklight.hpp:10-47) so configs and outputs are interchangeable.
All values are CGS.
"""

import enum
import math


class Math:
    pi = math.pi
    sqrt2 = math.sqrt(2.0)


class Physics:
    """CGS physical constants (reference src/blacklight.hpp:17-27)."""

    c = 2.99792458e10            # speed of light [cm/s]
    h = 6.62607015e-27           # Planck constant [erg s]
    k_b = 1.380649e-16           # Boltzmann constant [erg/K]
    m_p = 1.67262192369e-24      # proton mass [g]
    m_e = 9.1093837015e-28       # electron mass [g]
    e = 4.80320425e-10           # elementary charge [esu]
    gg_msun = 1.32712440018e26   # G * M_sun [cm^3/s^2]


class CellValues(enum.IntEnum):
    """Diagnostic cell quantities (reference src/blacklight.hpp:30-33)."""

    rho = 0
    n_e = 1
    p_gas = 2
    theta_e = 3
    bb = 4
    sigma = 5
    beta_inv = 6


NUM_CELL_VALUES = 7

# Names used in output files for cell values (reference output_writer.hpp:110-111)
CELL_VALUE_NAMES = ("rho", "n_e", "p_gas", "Theta_e", "B", "sigma", "beta_inverse")


class ModelType(enum.Enum):
    simulation = "simulation"
    formula = "formula"


class OutputFormat(enum.Enum):
    npz = "npz"
    npy = "npy"
    raw = "raw"


class SimulationFormat(enum.Enum):
    athena = "athena"
    athenak = "athenak"
    iharm3d = "iharm3d"
    harm3d = "harm3d"


class Coordinates(enum.Enum):
    cks = "cks"
    sks = "sks"
    fmks = "fmks"


class CameraType(enum.Enum):
    plane = "plane"
    pinhole = "pinhole"


class RayTerminate(enum.Enum):
    photon = "photon"
    multiplicative = "multiplicative"
    additive = "additive"


class RayIntegrator(enum.Enum):
    dp = "dp"
    rk4 = "rk4"
    rk2 = "rk2"


class FrequencySpacing(enum.Enum):
    lin_freq = "lin_freq"
    lin_wave = "lin_wave"
    log = "log"


class FrequencyNormalization(enum.Enum):
    camera = "camera"
    infinity = "infinity"


class RenderType(enum.Enum):
    fill = "fill"
    thresh = "thresh"
    rise = "rise"
    fall = "fall"


class PlasmaModel(enum.Enum):
    ti_te_beta = "ti_te_beta"
    code_kappa = "code_kappa"
