"""PyTorch port: geometric cuts, the fluid state, value cuts, the pitch
angle and the thermal synchrotron coefficients against the JAX package.

Each function gets the same inputs on both sides, made with a seeded
numpy generator (for the later stages, the JAX package's float64 state,
rounded to the working type). float64 is held at rtol 1e-12; float32 at
the tolerance each test states.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blacklight_tpu.constants import PlasmaModel
from blacklight_tpu.models import cuts as jcuts
from blacklight_tpu.models import synchrotron as jsyn
from blacklight_tpu_torch import interop
from blacklight_tpu_torch.models import cuts, synchrotron

torch.set_num_threads(2)

SPIN = 0.7
RHO_UNIT = 1.0e-16
CAMERA_X = (0.0, 30.0, -5.0, 35.0)
SAMPLE_KEYS = ("rho", "pgas", "uu1", "uu2", "uu3", "bb1", "bb2", "bb3")
STATE_KEYS = ("rho_cgs", "pgas_cgs", "n_e_cgs", "bb_cgs", "sigma",
              "beta_inv", "theta_e", "kb_tt_e_cgs", "b_sq")


def _inputs(n=2000, seed=5):
    """CKS positions at r in [2, 50] and sampled primitives spanning a
    GRMHD snapshot's range, with zero-field cells and cells holding an
    exact-zero fallback density and pressure."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(2.0, 50.0, n)
    th = np.arccos(rng.uniform(-0.98, 0.98, n))
    ph = rng.uniform(0.0, 2.0 * np.pi, n)
    x = np.sin(th) * (r * np.cos(ph) - SPIN * np.sin(ph))
    y = np.sin(th) * (r * np.sin(ph) + SPIN * np.cos(ph))
    pos = np.stack([np.zeros(n), x, y, r * np.cos(th)], axis=-1)
    samples = {
        "rho": 10.0 ** rng.uniform(-8, 0, n),
        "pgas": 10.0 ** rng.uniform(-10, -1, n),
        "uu1": rng.normal(0.0, 0.3, n), "uu2": rng.normal(0.0, 0.02, n),
        "uu3": rng.normal(0.0, 0.05, n),
        "bb1": rng.normal(0.0, 0.1, n), "bb2": rng.normal(0.0, 0.005, n),
        "bb3": rng.normal(0.0, 0.02, n),
    }
    zero_field = rng.random(n) < 0.05
    fallback = rng.random(n) < 0.05
    for key in ("bb1", "bb2", "bb3"):
        samples[key][zero_field] = 0.0
    for key in ("rho", "pgas"):
        samples[key][fallback] = 0.0
    kcov = np.stack([-np.ones(n), *rng.normal(0.0, 1.0, (3, n))], axis=-1)
    return pos, samples, kcov


def _plasma(use_p):
    kwargs = {} if use_p else dict(gamma=13.0 / 9.0, gamma_i=5.0 / 3.0,
                                   gamma_e=4.0 / 3.0)
    return jsyn.PlasmaParams(mu=0.5, ne_ni=1.0, model=PlasmaModel.ti_te_beta,
                             use_p=use_p, rat_low=1.0, rat_high=10.0,
                             **kwargs)


def _close(a, b, rtol, err_msg=""):
    """rtol with an absolute floor of rtol times the largest finite |b|,
    non-finite entries in the same places."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin), err_msg
    assert np.array_equal(a[~fin], b[~fin]) or np.all(np.isnan(a[~fin])), \
        err_msg
    scale = float(np.max(np.abs(b[fin]), initial=0.0))
    np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=rtol * scale,
                               err_msg=err_msg)


def _torch(a, precision):
    return torch.from_numpy(np.asarray(a, np.float64).astype(precision))


def _jax_state(pos, samples, plasma, precision):
    jdtype = jnp.float64 if precision == "float64" else jnp.float32
    return jsyn.fluid_state(
        jnp.asarray(pos, jdtype),
        {k: jnp.asarray(v, jdtype) for k, v in samples.items()}, SPIN,
        plasma, RHO_UNIT)


def _torch_state(jstate, precision):
    """The port's state dict from the JAX package's (same values)."""
    state = {k: _torch(jstate[k], precision) for k in STATE_KEYS}
    for key in ("ucon", "bcon"):
        v = np.asarray(jstate[key], np.float64)
        state[key] = tuple(_torch(v[:, c], precision) for c in range(4))
    return state


CUT_CASES = {
    "none": {},
    "near": {"omit_near": True},
    "far": {"omit_far": True},
    "in_out": {"omit_in": 6.0, "omit_out": 30.0},
    "mid_theta": {"midplane_theta": 0.3},
    "mid_theta_neg": {"midplane_theta": -0.2},
    "mid_z": {"midplane_z": 4.0},
    "mid_z_neg": {"midplane_z": -2.5},
    "plane": {"plane": True, "plane_origin": (1.0, -2.0, 0.5),
              "plane_normal": (0.3, 0.4, -0.8)},
}


@pytest.mark.parametrize("case", sorted(CUT_CASES))
def test_geometric_keep(case):
    pos, _, _ = _inputs()
    jc = jcuts.GeometricCuts(camera_r=40.0, **CUT_CASES[case])
    ours = cuts.geometric_keep(torch.from_numpy(pos), SPIN, CAMERA_X,
                               interop.geometric_cuts_from_jax(jc))
    ref = jcuts.geometric_keep(jnp.asarray(pos), SPIN, CAMERA_X, jc)
    assert np.array_equal(ours.numpy(), np.asarray(ref))
    assert 0 < int(ours.sum()) < pos.shape[0]


def test_cut_param_values_block():
    """The geometric-cut block of the kernels' parameter vectors: flags and
    signs decided from the float64 values."""
    values = cuts.cut_param_values(cuts.GeometricCuts(
        camera_r=50.0, omit_in=-1.0, omit_out=20.0, midplane_theta=-0.2,
        midplane_z=3.0, plane=True))
    assert set(values) == set(cuts.CUT_PARAM_NAMES)
    assert values["CUT_IN_ON"] is False and values["CUT_OUT_ON"] is True
    assert values["CUT_MID_THETA_SIGN"] == -1.0
    assert values["CUT_MID_THETA"] == 0.2
    assert values["CUT_MID_Z_SIGN"] == 1.0


@pytest.mark.parametrize("precision,use_p", [
    ("float64", True), ("float64", False), ("float32", True),
    ("float32", False)])
def test_fluid_state(precision, use_p):
    """float32: 2e-5 relative. b_sq = b_mu b^mu sums terms that cancel,
    and XLA rounds the metric's products in another order than torch;
    b_cgs, sigma, 1/beta and theta_e inherit that (measured 1.2e-5)."""
    pos, samples, _ = _inputs()
    plasma = _plasma(use_p)
    p = pos.astype(precision)
    s = {k: v.astype(precision) for k, v in samples.items()}
    ours = synchrotron.fluid_state(
        torch.from_numpy(p), {k: torch.from_numpy(v) for k, v in s.items()},
        SPIN, interop.plasma_params_from_jax(plasma), RHO_UNIT)
    ref = _jax_state(p, s, plasma, precision)
    f64 = precision == "float64"
    for key in STATE_KEYS:
        assert ours[key].dtype == (torch.float64 if f64 else torch.float32)
        _close(ours[key].numpy(), np.asarray(ref[key]),
               1e-12 if f64 else 2e-5, err_msg=key)
    for key in ("ucon", "bcon"):
        for c in range(4):
            _close(ours[key][c].numpy(), np.asarray(ref[key])[:, c],
                   1e-12 if f64 else 2e-5, err_msg=f"{key}[{c}]")


def test_value_cuts():
    pos, samples, _ = _inputs()
    state = _jax_state(pos, samples, _plasma(True), "float64")
    values = {k: np.asarray(state[k]) for k in STATE_KEYS}
    cut_kwargs = {
        "rho_min": float(np.quantile(values["rho_cgs"], 0.1)),
        "n_e_max": float(np.quantile(values["n_e_cgs"], 0.95)),
        "p_gas_min": float(np.quantile(values["pgas_cgs"], 0.05)),
        "theta_e_max": float(np.quantile(values["theta_e"], 0.9)),
        "b_min": 0.0,
        "sigma_max": 1.0,
        "beta_inverse_min": float(np.quantile(values["beta_inv"], 0.02)),
    }
    jc = jsyn.CutParams(**cut_kwargs)
    ours = synchrotron.value_cuts(_torch_state(state, "float64"),
                                  interop.cut_params_from_jax(jc))
    ref = jsyn.value_cuts(state, jc)
    assert np.array_equal(ours.numpy(), np.asarray(ref))
    assert 0 < int(ours.sum()) < pos.shape[0]
    off = synchrotron.value_cuts(_torch_state(state, "float64"),
                                 synchrotron.CutParams())
    assert bool(off.all())


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_pitch_angle(precision):
    """float32: 1e-5 relative to the largest value (sin theta_B =
    sqrt(1 - cos^2) loses digits where the wavevector nearly follows the
    field)."""
    pos, samples, kcov = _inputs()
    state = _jax_state(pos, samples, _plasma(True), "float64")
    ours = synchrotron.pitch_angle(
        tuple(_torch(kcov[:, c], precision) for c in range(4)),
        _torch_state(state, precision))
    jstate = {k: jnp.asarray(np.asarray(state[k]).astype(precision))
              for k in (*STATE_KEYS, "ucon", "bcon")}
    ref = jsyn.pitch_angle(jnp.asarray(pos.astype(precision)),
                           jnp.asarray(kcov.astype(precision)), jstate, SPIN)
    for name, a, b in zip(("sin", "cos", "sin2", "u_dot_k"), ours, ref):
        _close(a.numpy(), np.asarray(b),
               1e-12 if precision == "float64" else 1e-5, err_msg=name)


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_thermal_coefficients(precision):
    """Three frequencies, with the float32 floors and caps on that side.
    float32: 1e-5 relative to the largest value; exp(-x^(1/3)) turns a
    relative error e of x into e x^(1/3) / 3."""
    pos, samples, kcov = _inputs()
    plasma = _plasma(True)
    state = _jax_state(pos, samples, plasma, "float64")
    sin_b, cos_b, sin2_b, u_dot_k = jsyn.pitch_angle(
        jnp.asarray(pos), jnp.asarray(kcov), state, SPIN)
    freqs = np.array([1.0e11, 2.3e11, 6.0e11])
    nu_cgs = -np.asarray(u_dot_k)[:, None] * freqs[None, :] * 1.1
    nu0 = float(freqs[1])
    j, alpha = synchrotron.thermal_coefficients(
        _torch(nu_cgs, precision), nu0, _torch_state(state, precision),
        _torch(sin_b, precision), interop.plasma_params_from_jax(plasma))
    jd = jnp.float64 if precision == "float64" else jnp.float32
    jstate = {k: jnp.asarray(np.asarray(state[k]), jd) for k in STATE_KEYS}
    ref = jsyn.thermal_coefficients(
        jnp.asarray(nu_cgs, jd), nu0, jstate, jnp.asarray(sin_b, jd),
        jnp.asarray(cos_b, jd), jnp.asarray(sin2_b, jd), plasma,
        polarized=False)
    rtol = 1e-12 if precision == "float64" else 1e-5
    _close(j.numpy(), np.asarray(ref["j_i"]), rtol, err_msg="j_i")
    _close(alpha.numpy(), np.asarray(ref["alpha_i"]), rtol,
           err_msg="alpha_i")
    assert float(torch.nan_to_num(j).max()) > 0.0


def test_log_scales():
    nu0 = 2.3e11
    assert synchrotron.log_j_scale(nu0) == jsyn.log_j_scale(nu0)


def test_plasma_params_copy():
    plasma = dataclasses.replace(_plasma(False), kappa=3.5)
    ours = dataclasses.asdict(interop.plasma_params_from_jax(plasma))
    ref = dataclasses.asdict(plasma)
    # the enum member becomes this package's own member of the same name
    assert ours.pop("model") is synchrotron.PlasmaModel[ref.pop("model").name]
    assert ours == ref
