"""PyTorch port: the auxiliary image planes (ROADMAP A.5), formula model.

The batched formula forms (``cpp_pow``, ``formula_coefficients``),
``gcov_gcon`` and the cell values against the JAX package on seeded
numpy inputs; the scan route (``transfer/unpolarized.integrate_unpolarized``
through ``pipeline.make_formula_renderer``) against the JAX package's
formula renderer, which always takes that route, on the JAX package's
own camera rays: rk4 and rk2 in float64 exact (flags, n_samples, NaN
sets, rtol 1e-8, crossings equal), dp float64 and rk4 float32 at the
statistical gate of bench.py:181-186; which route a configuration takes;
the simulation kernel's plain version bit for bit with the transfer step
it had before the scan route shared it; and the refusal of the
cell-value planes on the formula model.
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from blacklight_tpu import pipeline as jax_pipeline
from blacklight_tpu import pipeline_simulation as jax_sim
from blacklight_tpu.camera import make_camera as jax_make_camera
from blacklight_tpu.models import formula as jax_formula
from blacklight_tpu.ops import geometry as jax_geometry
from blacklight_tpu.utils.config import parse_config as jax_parse_config
from blacklight_tpu_torch import interop, parse_config, pipeline
from blacklight_tpu_torch import pipeline_simulation
from blacklight_tpu_torch.models import formula
from blacklight_tpu_torch.ops import formula_kernel as fk
from blacklight_tpu_torch.ops import geometry
from blacklight_tpu_torch.ops import simulation_kernel as sk
from blacklight_tpu_torch.transfer import unpolarized as tu

from test_adaptive import CONFIG

torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
TORCH_DTYPE = {"float32": torch.float32, "float64": torch.float64}
ALL_PLANES = {f"image_{k}": "true" for k in (
    "time", "length", "lambda", "emission", "tau", "lambda_ave",
    "emission_ave", "tau_int", "crossings")}
FORMULA_PLANES = {f"image_{k}": "true" for k in (
    "time", "length", "lambda", "emission", "tau", "crossings")}
PLANE_KEYS = ("I_nu", "time", "length", "lambda", "emission", "tau",
              "lambda_ave", "emission_ave", "tau_int", "crossings")


def _formula_text(out, res=16, **overrides):
    """test_adaptive.CONFIG (the formula model, rk4, float64) at
    ``res``^2 with absorption on (formula_a = 1e5) and 400 steps of 0.03,
    and ``overrides``."""
    text = CONFIG.format(out=str(out), res=res, max_level=0, num_regions=0,
                         regions="")
    settings = {"formula_a": 1e5, "ray_step": 0.03, "ray_max_steps": 400,
                **overrides}
    for key, value in settings.items():
        line = f"{key} = {value}"
        text, n = re.subn(rf"^{key}\s*=.*$", line, text, flags=re.M)
        if n == 0:
            text += line + "\n"
    return text


def _numpy(value):
    return value.numpy() if isinstance(value, torch.Tensor) \
        else np.asarray(value)


def statistical_gate(a, b):
    """bench.py:181-186 on one plane column: identical NaN sets, fewer
    than 0.5 % of pixels past 1e-3 relative, total within 1e-3."""
    assert np.array_equal(np.isnan(a), np.isnan(b))
    peak = np.nanmax(np.abs(b)) if np.isfinite(b).any() else 0.0
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.abs(a - b) / (np.abs(b) + peak * 1e-6)
    assert np.mean(np.nan_to_num(rel) > 1e-3) < 5e-3
    assert abs(np.nansum(a) - np.nansum(b)) <= 1e-3 * abs(np.nansum(b))


def assert_planes(ours: dict, ref: dict, gate: str, truth=None):
    """Every plane of ``ref`` (the JAX package's) in ``ours``: "exact"
    equal flags, n_samples and NaN sets, rtol 1e-8 and crossings equal;
    "statistical" the statistical gate per frequency and cell value and
    crossings equal on 99 % of the rays; "float32" the light image at the
    statistical gate, crossings on 99 % of the rays, and every other plane
    against ``truth``, the JAX package's float64 render of the same rays
    (FLOAT32_TRUTH)."""
    keys = [k for k in PLANE_KEYS if k in ref]
    assert set(k for k in ours if not k.startswith("_")) == set(keys)
    if gate == "exact":
        assert np.array_equal(_numpy(ours["_flags"]), np.asarray(ref["_flags"]))
        assert np.array_equal(_numpy(ours["_n_samples"]),
                              np.asarray(ref["_n_samples"]))
    for key in keys:
        a, b = _numpy(ours[key]), np.asarray(ref[key])
        assert a.shape == b.shape, key
        assert a.dtype == b.dtype, key
        if key == "crossings":
            share = np.mean(a != b)
            assert share == 0.0 if gate == "exact" else share <= 0.01, key
        elif gate == "exact":
            assert np.array_equal(np.isnan(a), np.isnan(b)), key
            atol = 1e-14 * np.nanmax(np.abs(b)) if np.isfinite(b).any() \
                else 0.0
            np.testing.assert_allclose(a, b, rtol=1e-8, atol=atol,
                                       err_msg=key)
        elif gate == "statistical" or key == "I_nu":
            cols = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
            for c in range(cols[0].shape[1]):
                statistical_gate(cols[0][:, c], cols[1][:, c])
        elif key == "emission":
            # its unit is subnormal in float32 (FLOAT32_TRUTH): the NaN
            # sets only
            assert np.array_equal(np.isnan(a), np.isnan(truth[key]))
        else:
            float32_truth_gate(a, np.asarray(truth[key]), key)


# The float32 planes' gate against the float64 truth: equal NaN sets, mean
# relative error (the statistical gate's normalization) and total. The
# JAX package's own float32 planes miss the statistical gate against its
# float64 ones (16^2 formula rk4: length 3.1 %, tau 3.5 % of the pixels
# past 1e-3; the proper length and the optical depth of rays that end at
# the horizon are ill-conditioned in float32); the port's mean errors
# there are length 7.6e-4 and tau 2.6e-4 (the JAX package's 2.9e-4 and
# 2.0e-4). The float32 emission plane is held to neither: its unit
# exp(log_j_scale) is subnormal in float32 for the formula model (~1.4e-41,
# which XLA's CPU backend flushes to zero and torch keeps with the few bits
# left) and 0 for the simulation model (~1.5e-52), so neither package has
# the float64 value there.
FLOAT32_TRUTH = {"mean": 2e-3, "total": 1e-2}


def float32_truth_gate(a, truth, key):
    a = a.astype(np.float64).reshape(a.shape[0], -1)
    truth = truth.reshape(truth.shape[0], -1)
    assert np.array_equal(np.isnan(a), np.isnan(truth)), key
    for c in range(a.shape[1]):
        x, t = a[:, c], truth[:, c]
        peak = np.nanmax(np.abs(t)) if np.isfinite(t).any() else 0.0
        with np.errstate(invalid="ignore", divide="ignore"):
            rel = np.nan_to_num(np.abs(x - t) / (np.abs(t) + peak * 1e-6))
        assert rel.mean() < FLOAT32_TRUTH["mean"], (key, c, rel.mean())
        assert abs(np.nansum(x) - np.nansum(t)) \
            <= FLOAT32_TRUTH["total"] * abs(np.nansum(t)), (key, c)


# ---- the batched forms ---------------------------------------------------

# exponents: odd and even integers, negative and positive non-integers, 0
EXPONENTS = (-5.0, -4.0, -2.5, -0.5, 0.0, 0.5, 1.0, 3.0)


# The port's cpp_pow is held to Python's math.pow per element at rtol
# 1e-13: math.pow is the C library's scalar pow, which does not dispatch on
# the CPU's vector units, so it cannot move from one worker or machine to
# another. In the 6-worker suite numpy's vector pow (at e = 0.5: 906 of
# 2,130 entries up to 3.07e-11 from the port's) and in another run the JAX
# package's (3.1e-11 on 22 % of the entries) have each been seen off the
# others, while alone all three agree to an ulp; the JAX package is held to
# the port at CPP_POW_JAX_RTOL. A failure names which library left
# math.pow, by how much, and on which CPU.
CPP_POW_JAX_RTOL = 1e-10


def _pow_inputs():
    rng = np.random.default_rng(7)
    x = rng.normal(0.0, 2.0, 4000)
    x[::17] = 0.0
    x[1::23] = -0.0
    x[2::29] = rng.uniform(-1e-3, 1e-3, x[2::29].shape)
    return x


def _math_pow(x, e):
    """C++'s std::pow as Python's scalar math.pow, element by element
    (NaN where it has no real value or is infinite)."""
    def one(v):
        try:
            return math.pow(v, e)
        except (ValueError, OverflowError, ZeroDivisionError):
            return math.nan
    return np.array([one(float(v)) for v in x])


def _cpu() -> str:
    model = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            model = next((line.split(":", 1)[1].strip() for line in f
                          if line.startswith("model name")), model)
    except OSError:
        pass
    return (f"CPU {model!r}, torch capability "
            f"{torch.backends.cpu.get_cpu_capability()}")


def _float_state() -> str:
    """This process's floating-point environment (the C library's rounding
    mode and, on x86-64, the SSE control word: rounding, flush-to-zero and
    denormals-are-zero), torch's thread count and JAX's x64 flag."""
    import ctypes
    import jax
    state = {"torch threads": torch.get_num_threads(),
             "jax x64": bool(jax.config.jax_enable_x64)}
    try:
        libm = ctypes.CDLL("libm.so.6")
        env = ctypes.create_string_buffer(32)
        libm.fegetenv(env)
        state["fegetround"] = libm.fegetround()
        state["mxcsr"] = hex(int.from_bytes(env.raw[28:32], "little"))
    except OSError:
        pass
    return ", ".join(f"{k} {v}" for k, v in state.items())


def _earlier_files(request) -> list:
    """The test files of which some test already ran in this process (in
    an xdist worker: on this worker), this one aside: pytest clears an
    item's funcargs to None once it has run."""
    here = request.node.path
    files = []
    for item in request.session.items:
        if getattr(item, "funcargs", {}) is None and item.path != here \
                and item.path.name not in files:
            files.append(item.path.name)
    return files


def _pow_report(x, e, values: dict) -> str:
    """Each library's largest relative distance from math.pow on the
    finite entries, and the CPU."""
    exact = _math_pow(x, e)
    ok = np.isfinite(exact) & (exact != 0.0)
    parts = []
    for name, v in values.items():
        v = np.asarray(v, dtype=np.float64)
        rel = np.abs(v[ok] - exact[ok]) / np.abs(exact[ok])
        rel = rel[np.isfinite(rel)]
        worst = float(rel.max()) if rel.size else 0.0
        parts.append(f"{name} {worst:.3g} ({int((rel > 1e-13).sum())} "
                     f"entries past 1e-13)")
    return (f"pow(x, {e}) off math.pow: " + ", ".join(parts)
            + f"; {_cpu()}")


def _library_pows(x, e) -> dict:
    """numpy's, torch's and XLA's float64 pow of |x| on the same inputs."""
    import jax.numpy as jnp
    a = np.abs(x)
    with np.errstate(invalid="ignore", divide="ignore"):
        return {"numpy": np.power(a, e),
                "torch": torch.pow(torch.tensor(a), e).numpy(),
                "jax": np.asarray(jnp.power(jnp.asarray(a), e))}


@pytest.mark.parametrize("e", EXPONENTS)
def test_cpp_pow_matches_jax(e, request):
    x = _pow_inputs()
    value, bad = formula.cpp_pow(torch.tensor(x), e)
    ref_value, ref_bad = jax_formula._cpp_pow(x, e)
    np.testing.assert_array_equal(bad.numpy(), np.asarray(ref_bad))
    assert np.isfinite(value.numpy()).all()
    port, jax_value = value.numpy(), np.asarray(ref_value)

    def report(assertion):
        with np.errstate(invalid="ignore", divide="ignore"):
            rel = np.abs(port - jax_value) / np.abs(jax_value)
        return (f"{assertion} failed; port from the JAX package "
                f"{float(np.nanmax(rel)):.3g}; "
                + _pow_report(np.abs(x), e, {
                    "port": np.abs(port), "jax package": np.abs(jax_value),
                    **_library_pows(x, e)})
                + f"; {_float_state()}; earlier files in this process: "
                f"{_earlier_files(request)}")

    assert np.allclose(port, jax_value, rtol=CPP_POW_JAX_RTOL, atol=0.0), \
        report(f"port against the JAX package at rtol {CPP_POW_JAX_RTOL}")
    # C++'s std::pow where it is finite: math.pow per element
    ok = ~bad.numpy() & ~((x == 0.0) & (e < 0.0))
    exact = _math_pow(x[ok], e)
    assert np.allclose(port[ok], exact, rtol=1e-13, atol=0.0), \
        report("port against math.pow at rtol 1e-13")
    if e < 0.0:  # pow(0, e < 0) is flagged, where the kernel forms give 0
        assert bad.numpy()[x == 0.0].all()


# (formula_alpha, formula_beta, formula_h, cuts): integer and non-integer
# exponents of j and alpha, the density profile's height, and cuts
FORMULA_PARAMS = {
    "int_j_nonint_alpha": (-3.0, 2.5, 0.0, {}),
    "nonint_j_int_alpha": (-2.5, 4.5, 0.4, {"cut_omit_near": "true"}),
    "neg_int_j_cuts": (1.0, -1.0, 0.2, {
        "cut_omit_in": 2.5, "cut_omit_out": 60.0, "cut_midplane_theta": 0.6,
        "cut_midplane_z": 8.0, "cut_plane": "true",
        "cut_plane_normal_z": 1.0}),
}


@pytest.mark.parametrize("case", sorted(FORMULA_PARAMS))
def test_formula_coefficients_matches_jax(tmp_path, case):
    """On seeded samples from near the horizon out to the camera, with
    zero and negative fluid-frame frequencies: the bad masks equal, the
    coefficients at CPP_POW_JAX_RTOL (their powers are XLA's pow)."""
    alpha, beta, h, cuts = FORMULA_PARAMS[case]
    text = _formula_text(tmp_path / "f.npz", formula_alpha=alpha,
                         formula_beta=beta, formula_h=h, **cuts)
    jfp = jax_formula.formula_params_from_config(jax_parse_config(text))
    fp = formula.formula_params_from_config(parse_config(text))
    assert fp == interop.formula_params_from_jax(jfp)
    rng = np.random.default_rng(11)
    n = 3000
    r = rng.uniform(1.2, 120.0, n)
    th = rng.uniform(0.0, math.pi, n)
    ph = rng.uniform(-math.pi, math.pi, n)
    pos = np.stack([rng.normal(0.0, 10.0, n), r * np.sin(th) * np.cos(ph),
                    r * np.sin(th) * np.sin(ph), r * np.cos(th)], axis=-1)
    kcov = rng.normal(0.0, 1.0, (n, 4))
    kcov[::13] = 0.0  # zero fluid-frame frequency
    mom = rng.uniform(0.5, 2.0, n)
    freqs = np.array([1.1e11, 2.3e11, 4.6e11])
    camera_x = (0.0, 50.0, 0.0, 86.6)
    ours = formula.formula_coefficients(
        torch.tensor(pos), torch.tensor(kcov), torch.tensor(mom),
        torch.tensor(freqs), fp, camera_x)
    ref = jax_formula.formula_coefficients(pos, kcov, mom, freqs, jfp,
                                           np.asarray(camera_x))
    names = ("j", "alpha", "keep", "bad")
    for name, a, b in zip(names, ours, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert np.isfinite(a).all(), name
            if not np.allclose(a, b, rtol=CPP_POW_JAX_RTOL, atol=1e-300):
                x = np.abs(_pow_inputs())
                probes = "; ".join(
                    _pow_report(x, e, _library_pows(x, e))
                    for e in sorted({0.5, float(alpha), float(beta)}))
                np.testing.assert_allclose(
                    a, b, rtol=CPP_POW_JAX_RTOL, atol=1e-300,
                    err_msg=f"{name}; {probes}")
    assert ours[2].any() and (~ours[2]).any()
    if not float(alpha).is_integer():  # pow(negative, non-integer)
        assert ours[3].any()


@pytest.mark.parametrize("flat", (False, True))
def test_gcov_gcon_matches_jax(flat):
    rng = np.random.default_rng(3)
    x = rng.normal(0.0, 6.0, (500, 3))
    g_cov, g_con = geometry.gcov_gcon(torch.tensor(x), 0.9, 1.0, flat=flat)
    ref_cov, ref_con = jax_geometry.gcov_gcon(x, 0.9, 1.0, flat=flat)
    np.testing.assert_allclose(g_cov.numpy(), np.asarray(ref_cov),
                               rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(g_con.numpy(), np.asarray(ref_con),
                               rtol=1e-13, atol=1e-15)
    # the two agree with the separate forms and invert each other
    assert torch.equal(g_cov, geometry.gcov(torch.tensor(x), 0.9, flat=flat))
    assert torch.equal(g_con, geometry.gcon(torch.tensor(x), 0.9, flat=flat))


def _sim_text(out, name="golden_sim_rk4_32.input", **overrides):
    """``name`` on mock_small.athdf at 16^2, and ``overrides``."""
    text = (FIXTURES / name).read_text()
    settings = {"simulation_file": FIXTURES / "mock_small.athdf",
                "output_file": out, "camera_resolution": 16, **overrides}
    for key, value in settings.items():
        line = f"{key} = {value}"
        text, n = re.subn(rf"^{key}\s*=.*$", line, text, flags=re.M)
        if n == 0:
            text += line + "\n"
    return text


@pytest.mark.parametrize("polarized", (False, True))
def test_cell_values_match_jax(tmp_path, polarized):
    """make_simulation_coeff_fns' cell_fn on seeded samples in and off the
    grid, some cut by value and some geometrically: NaN sets equal, the
    values at rtol 1e-10 (XLA's hypot and acos differ from torch's by an
    ulp, test_torch_sks_sampling.py)."""
    text = _sim_text(tmp_path / "c.npz", cut_omit_near="true",
                     cut_theta_e_max=20.0, cut_rho_min=1e-22)
    jcfg, cfg = jax_parse_config(text), parse_config(text)
    jgrid, _ = jax_sim.load_grid(jcfg)
    jgeom, _, jfreqs = jax_make_camera(jcfg, bh_m=1.0, bh_a=jcfg.simulation_a)
    rng = np.random.default_rng(5)
    n = 2000
    r = rng.uniform(1.5, 60.0, n)
    th = rng.uniform(0.05, math.pi - 0.05, n)
    ph = rng.uniform(-math.pi, math.pi, n)
    pos = np.stack([np.zeros(n), r * np.sin(th) * np.cos(ph),
                    r * np.sin(th) * np.sin(ph), r * np.cos(th)], axis=-1)
    kcov = np.stack([-np.ones(n), *rng.normal(0.0, 1.0, (3, n))], axis=-1)
    mom = np.ones(n)
    _, jcell_fn, _ = jax_sim.make_simulation_coeff_fns(
        jcfg, jgrid, jgeom, jfreqs, mom, polarized=polarized)
    ref = np.asarray(jcell_fn(pos, kcov))

    render_fn, geom, _, freqs, _ = \
        pipeline_simulation.make_simulation_renderer(cfg, device="cpu")
    _, params, sp, grid, _, camera_x, _ = render_fn.kernel_args
    coeff_fn, cell_fn = pipeline_simulation.make_simulation_coeff_fns(
        sp, grid, freqs, torch.tensor(mom), params.bh_a, camera_x,
        polarized=polarized)
    tpos, tk = torch.tensor(pos), tuple(torch.tensor(kcov).unbind(-1))
    if polarized:
        tpos = tuple(tpos.unbind(-1))
    coeff_fn(tpos, tk)  # cell_fn reuses this sample's fluid state
    ours = cell_fn(tpos, tk).numpy()
    assert ours.shape == ref.shape == (n, 7)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    assert 0.2 < np.isnan(ref[:, 0]).mean() < 0.8
    np.testing.assert_allclose(ours, ref, rtol=1e-10, atol=0.0)
    fresh = pipeline_simulation.make_simulation_coeff_fns(
        sp, grid, freqs, torch.tensor(mom), params.bh_a, camera_x,
        polarized=polarized)[1](tpos, tk).numpy()
    np.testing.assert_array_equal(fresh, ours)


# ---- the formula model's scan route --------------------------------------

# name -> (input overrides, gate)
FORMULA_CASES = {
    "rk4": (FORMULA_PLANES, "exact"),
    "rk2_cuts_no_fallback_nan": (
        dict(FORMULA_PLANES, ray_integrator="rk2", fallback_nan="false",
             cut_omit_far="true", formula_alpha=-2.5), "exact"),
    "rk4_three_frequencies": (
        dict(FORMULA_PLANES, image_num_frequencies=3,
             image_frequency_start=1e11, image_frequency_end=6e11,
             image_frequency_spacing="log", fallback_nan="true"), "exact"),
    "no_light": ({"image_light": "false", "image_tau": "true",
                  "image_crossings": "true"}, "exact"),
    "dp": (dict(FORMULA_PLANES, ray_integrator="dp", ray_tol_abs=1e-8,
                ray_tol_rel=1e-8, ray_max_retries=20), "statistical"),
    "rk4_float32": (dict(FORMULA_PLANES, precision="float32"), "float32"),
}


@pytest.fixture(scope="module", params=sorted(FORMULA_CASES))
def formula_renders(request, tmp_path_factory):
    """(gate, ours, ref, truth, route) of a case: the port's formula
    renderer and the JAX package's on the JAX package's camera rays, and
    for float32 the JAX package's float64 render of those rays."""
    overrides, gate = FORMULA_CASES[request.param]
    out = tmp_path_factory.mktemp("f") / "o.npz"
    text = _formula_text(out, **overrides)
    jrender, _, rays, _, _ = jax_pipeline.make_formula_renderer(
        jax_parse_config(text))
    ref = jrender(rays.positions, rays.directions, rays.momentum_factors)
    truth = None
    if gate == "float32":
        jrender64, *_ = jax_pipeline.make_formula_renderer(jax_parse_config(
            _formula_text(out, **dict(overrides, precision="float64"))))
        truth = jrender64(*(np.asarray(a, np.float64) for a in (
            rays.positions, rays.directions, rays.momentum_factors)))
    cfg = parse_config(text)
    render_fn, *_ = pipeline.make_formula_renderer(cfg, device="cpu")
    t = interop.camera_rays_from_numpy(
        rays.positions, rays.directions, rays.momentum_factors,
        device="cpu", dtype=TORCH_DTYPE[cfg.precision or "float64"])
    calls = fk.PLAIN_CALLS
    ours = render_fn(t.positions, t.directions, t.momentum_factors)
    assert fk.PLAIN_CALLS == calls  # not the kernel's plain version
    return gate, ours, ref, truth, render_fn.route


def test_formula_scan_route_matches_jax(formula_renders):
    gate, ours, ref, truth, route = formula_renders
    assert route == "scan"
    assert_planes(ours, ref, gate, truth)
    for key in ("I_nu", "tau", "emission"):
        if key in ref and gate != "float32":
            assert np.nanmax(np.abs(np.asarray(ref[key]))) > 0.0, key
    if "I_nu" in ref:
        assert np.isfinite(np.asarray(ref["I_nu"])).mean() > 0.5


def test_formula_run_matches_jax_run(tmp_path):
    """pipeline.run's npz arrays, written and returned, against the JAX
    run with every formula plane (float64 rk4)."""
    text = _formula_text(tmp_path / "jax.npz", output_camera="true",
                         **FORMULA_PLANES)
    ref = jax_pipeline.run(jax_parse_config(text), quiet=True)
    cfg = parse_config(text.replace(str(tmp_path / "jax.npz"),
                                    str(tmp_path / "torch.npz")))
    ours = pipeline.run(cfg, quiet=True, device="cpu")
    for arrays in (ours, np.load(tmp_path / "torch.npz")):
        assert set(arrays.keys()) == set(ref.keys())
        for key in ref.keys():
            a, b = np.asarray(arrays[key]), np.asarray(ref[key])
            assert a.shape == b.shape and a.dtype == b.dtype, key
            assert np.array_equal(np.isnan(a), np.isnan(b)), key
            np.testing.assert_allclose(
                a, b, rtol=1e-8, atol=1e-14 * np.nanmax(np.abs(b)),
                err_msg=key)
    assert {"time", "length", "lambda", "emission", "tau",
            "crossings"} <= set(ours)


def test_npy_without_light_matches_jax(tmp_path):
    """image_light = false in npy: no light image to pack, so both
    packages write the same empty array."""
    text = _formula_text(tmp_path / "jax.npy", res=4, image_light="false",
                         output_format="npy")
    jax_pipeline.run(jax_parse_config(text), quiet=True)
    cfg = parse_config(text.replace(str(tmp_path / "jax.npy"),
                                    str(tmp_path / "torch.npy")))
    arrays = pipeline.run(cfg, quiet=True, device="cpu")
    assert "I_nu" not in arrays
    ours = np.load(tmp_path / "torch.npy", allow_pickle=True)
    ref = np.load(tmp_path / "jax.npy", allow_pickle=True)
    assert ours.shape == ref.shape == () and ours.dtype == ref.dtype
    assert ours.item() is None and ref.item() is None


@pytest.mark.parametrize("plane", ("lambda_ave", "emission_ave", "tau_int"))
def test_formula_cell_planes_refused(tmp_path, plane):
    """The formula model has no cell values: the JAX package's error."""
    text = _formula_text(tmp_path / "x.npz", res=4, **{f"image_{plane}":
                                                       "true"})
    with pytest.raises(ValueError, match=re.escape(
            "cell_fn required for lambda_ave/emission_ave/tau_int")):
        jax_pipeline.run(jax_parse_config(text), quiet=True)
    with pytest.raises(ValueError, match=re.escape(
            "cell_fn required for lambda_ave/emission_ave/tau_int")):
        pipeline.run(parse_config(text), quiet=True, device="cpu")
    assert not (tmp_path / "x.npz").exists()


def test_image_options_from_config_match_jax(tmp_path):
    from blacklight_tpu.transfer.unpolarized import ImageOptions
    text = _formula_text(tmp_path / "o.npz", image_light="false",
                         image_tau="true", image_lambda_ave="true",
                         image_crossings="true", fallback_nan="false")
    ours = tu.ImageOptions.from_config(parse_config(text))
    ref = ImageOptions.from_config(jax_parse_config(text))
    assert ours.__dict__ == ref.__dict__
    assert ours.aux and ours.cells
    assert not tu.ImageOptions().aux and not tu.ImageOptions().cells


def test_sample_times_match_jax(tmp_path):
    """integrate_unpolarized with track_sample_times (the slow-light
    planes ROADMAP B.6 will read) against the JAX package's, on its
    formula camera rays at 8^2, rk4 float64."""
    import jax.numpy as jnp
    from blacklight_tpu.transfer import unpolarized as jax_tu
    text = _formula_text(tmp_path / "t.npz", res=8)
    jcfg, cfg = jax_parse_config(text), parse_config(text)
    _, bh_a, mass_msun = jax_pipeline.bh_mass_spin(jcfg)
    jgeom, rays, jfreqs = jax_make_camera(jcfg, bh_m=1.0, bh_a=bh_a)
    jparams = jax_pipeline.geodesic_params_from_config(jcfg, 1.0, bh_a)
    jfp = jax_formula.formula_params_from_config(jcfg)

    def jcoeff(pos, kcov):
        j, alpha, _, bad = jax_formula.formula_coefficients(
            pos, kcov, jnp.asarray(rays.momentum_factors), jfreqs, jfp,
            jgeom.cam_x)
        return j, alpha, bad

    jopts = jax_tu.ImageOptions(light=True, time=True,
                                track_sample_times=True)
    ref = jax_tu.integrate_unpolarized(
        rays.positions, rays.directions, rays.momentum_factors, jfreqs,
        jparams, jcoeff, jopts, mass_msun, jgeom.cam_x, early_exit=True,
        log_j_scale=jax_formula.formula_log_j_scale(jfp))

    t = interop.camera_rays_from_numpy(
        rays.positions, rays.directions, rays.momentum_factors,
        device="cpu", dtype=torch.float64)
    fp = formula.formula_params_from_config(cfg)
    camera_x = np.asarray(jgeom.cam_x).tolist()
    freqs = torch.tensor(np.asarray(jfreqs))

    def coeff(pos, kcov, momentum_factors):
        j, alpha, _, bad = formula.formula_coefficients(
            pos, torch.stack(kcov, dim=-1), momentum_factors, freqs, fp,
            camera_x)
        return j, alpha, bad

    ours = tu.integrate_unpolarized(
        t.positions, t.directions, t.momentum_factors, freqs,
        params=interop.geodesic_params_from_jax(jparams), integrator="rk4",
        coeff_fn=coeff, opts=tu.ImageOptions(light=True, time=True,
                                            track_sample_times=True),
        mass_msun=mass_msun, camera_x=camera_x,
        log_j_scale=formula.formula_log_j_scale(fp))
    assert set(ours) == set(ref)
    for key in ("_t_min", "_t_max", "time", "I_nu"):
        a, b = ours[key].numpy(), np.asarray(ref[key])
        assert np.array_equal(np.isnan(a), np.isnan(b)), key
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12, err_msg=key)
    assert np.isfinite(ours["_t_min"].numpy()).all()
    assert (ours["_t_min"] < ours["_t_max"]).all()


# ---- routing --------------------------------------------------------------

# name -> (input file, overrides, route)
ROUTES = {
    "formula_light": ("formula", {}, "kernel"),
    "formula_tau": ("formula", {"image_tau": "true"}, "scan"),
    "formula_no_light": ("formula", {"image_light": "false"}, "scan"),
    "simulation_light": ("golden_sim_rk4_32.input", {}, "kernel"),
    "simulation_crossings": ("golden_sim_rk4_32.input",
                             {"image_crossings": "true"}, "scan"),
    "polarized_light": ("golden_polarized_rk4_32.input", {}, "kernel"),
    "polarized_tau_int": ("golden_polarized_rk4_32.input",
                          {"image_tau_int": "true"}, "scan"),
    "polarized_no_light": ("golden_polarized_rk4_32.input",
                           {"image_light": "false", "image_time": "true"},
                           "scan"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_is_chosen_from_the_config(tmp_path, case):
    """A light-only configuration keeps its kernel (on the CPU, its plain
    version); any auxiliary plane or image_light = false takes the scan
    route, and the polarized kernel only with the light image."""
    name, overrides, route = ROUTES[case]
    if name == "formula":
        cfg = parse_config(_formula_text(tmp_path / "r.npz", res=4,
                                         ray_max_steps=30, **overrides))
        render_fn, _, rays, _, _ = pipeline.make_formula_renderer(
            cfg, device="cpu")
        counter = (fk, "PLAIN_CALLS")
    else:
        cfg = parse_config(_sim_text(tmp_path / "r.npz", name,
                                     camera_resolution=4, ray_max_steps=30,
                                     **overrides))
        render_fn, _, rays, _, _ = \
            pipeline_simulation.make_simulation_renderer(cfg, device="cpu")
        counter = None
    assert render_fn.route == route
    before = getattr(*counter) if counter else None
    out = render_fn(rays.positions, rays.directions, rays.momentum_factors)
    if counter:
        assert getattr(*counter) - before == (route == "kernel")
    else:
        assert (render_fn.kernel is None) == (route == "scan")
    polarized = name.startswith("golden_polarized") \
        and cfg.require("image_light")
    assert ("Q_nu" in out) == polarized
    assert ("I_nu" in out) == bool(cfg.require("image_light"))


# ---- one copy of the light recurrence --------------------------------------

def _transfer_update_before(acc, momentum_factors, frequencies, sp, grid,
                            spin, mass_msun, camera_x):
    """simulation_kernel.transfer_update as it was before it called
    transfer/unpolarized's light step, verbatim."""
    from blacklight_tpu_torch.constants import Physics
    x_unit = Physics.gg_msun * mass_msun / (Physics.c * Physics.c)
    nu0 = float(frequencies[0])
    cam = [float(v) for v in camera_x]
    mom = momentum_factors

    def update(valid, ym, k, h):
        pos = torch.stack([torch.where(valid, ym[c], cam[c])
                           for c in range(4)], dim=-1)
        kcov = (torch.where(valid, k[0], -1.0), torch.where(valid, k[1], 1.0),
                torch.where(valid, k[2], 0.0), torch.where(valid, k[3], 0.0))
        j, alpha, cbad = sk.sample_coefficients(
            pos, kcov, mom, frequencies, sp, grid, spin, cam, nu0)
        vcol = valid[:, None]
        bad = cbad | ~(torch.isfinite(j) & torch.isfinite(alpha))
        j = torch.where(bad, 0.0, j)
        alpha = torch.where(bad, 0.0, alpha)
        acc["bad"] = acc["bad"] | (vcol & bad)

        delta_lambda = -torch.where(valid, h, 0.0)
        dl_cgs = delta_lambda[:, None] * x_unit \
            / (frequencies[None, :] * mom[:, None])
        pos_alpha = alpha > 0.0
        ss = j / torch.where(pos_alpha, alpha, 1.0)
        delta_tau = alpha * dl_cgs
        atten = torch.exp(-acc["tau"])
        thin = delta_tau <= tu.DELTA_TAU_MAX
        contrib = torch.where(pos_alpha,
                              torch.where(thin, ss * -torch.expm1(-delta_tau),
                                          ss),
                              j * dl_cgs)
        acc["intensity"] = acc["intensity"] + torch.where(
            vcol, contrib * atten, 0.0)
        dtau_eff = torch.where(pos_alpha,
                               torch.where(thin, delta_tau, math.inf), 0.0)
        acc["tau"] = acc["tau"] + torch.where(vcol, dtau_eff, 0.0)

    return update


@pytest.mark.parametrize("integrator,precision,nf", (
    ("rk4", "float64", 1), ("rk2", "float32", 3), ("dp", "float64", 1)))
def test_transfer_update_bits_unchanged(tmp_path, monkeypatch, integrator,
                                        precision, nf):
    """The simulation kernel's plain version gives the same bits with the
    shared light step as with its own copy."""
    text = _sim_text(tmp_path / "b.npz", camera_resolution=8,
                     ray_integrator=integrator, precision=precision,
                     ray_step=0.03, ray_max_steps=300,
                     image_num_frequencies=nf, image_frequency_start=1e11,
                     image_frequency_end=6e11, image_frequency_spacing="log")
    render_fn, _, rays, _, _ = pipeline_simulation.make_simulation_renderer(
        parse_config(text), device="cpu")
    args = (rays.positions, rays.directions, rays.momentum_factors,
            *render_fn.kernel_args)
    after = sk.render_simulation_reference(*args, **render_fn.kernel_kwargs)
    monkeypatch.setattr(sk, "transfer_update", _transfer_update_before)
    before = sk.render_simulation_reference(*args, **render_fn.kernel_kwargs)
    assert np.nanmax(after[0].numpy()) > 0.0
    for a, b in zip(after, before):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
