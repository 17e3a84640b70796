"""PyTorch port: forward tangents of the formula kernel (K1.4) and the
differentiable renderers built on them.

The plain version's tangents are held against the JAX package's tangent
kernel (Pallas, interpret mode) and against torch.autograd's reverse mode
through the plain forward itself; the fit and vjp renderers (a
torch.autograd.Function) against JAX's custom_vjp renderers under
jax.grad and against finite differences through themselves. Every input
is made once and carried to both packages with ``interop``. The CUDA
kernel's tangents are held against the plain version on the card by
``test_torch_formula_kernel_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blacklight_tpu.constants import FrequencySpacing
from blacklight_tpu.ops import pallas_formula as jpallas
from blacklight_tpu_torch.constants import Physics
from blacklight_tpu_torch.models.formula import (
    formula_geom_c,
    formula_jalpha_c,
)
from blacklight_tpu_torch.ops import formula_fit
from blacklight_tpu_torch.ops import formula_kernel as fk
from blacklight_tpu_torch.ops import geodesic as geo

from test_torch_formula_kernel import _port_args, _setup

torch.set_num_threads(2)

FIT_PARAMS = ("cn0", "r0", "h")
# Three frequencies (tests/test_pallas_kernel.py:78-82), h = 0.4 (h = 0
# zeroes the h tangent, tests/test_gradients.py:133) and absorption on:
# formula_a = 1e5 gives optical depths of order one on these rays, so
# every branch of the tangent update runs.
CASE = dict(ray_max_steps=600, formula_h=0.4, formula_a=1e5,
            image_num_frequencies=3, image_frequency_start=1.0e11,
            image_frequency_end=4.0e11,
            image_frequency_spacing=FrequencySpacing.log)


def _values(s):
    fp = s["fparams"]
    return {p: float(getattr(fp, p)) for p in FIT_PARAMS}


def test_tangents_match_pallas_interpret(tmp_path):
    """Plain float32 tangents for cn0, r0 and h at three frequencies
    against the JAX tangent kernel (interpret mode): identical NaN sets,
    flags and n_samples; I and each dI/dp within atol 1e-4 x its own peak
    per frequency; dI/dp is 0 exactly where I is NaN and finite
    elsewhere."""
    s = _setup(tmp_path, "rk4", 8, "float32", **CASE)
    rays = s["rays"]
    i_ref, flags_ref, nsamp_ref, d_ref = jpallas.render_formula(
        rays.positions, rays.directions, rays.momentum_factors,
        np.asarray(s["freqs"]), s["params"], s["fparams"], s["mass_msun"],
        s["camera_x"], s["log_j_scale"], fallback_nan=True,
        integrator="rk4", interpret=True, diff_values=_values(s))
    i_port, flags, nsamp, d_port = fk.render_formula(
        *_port_args(s), fallback_nan=True, integrator="rk4",
        diff_values=_values(s))
    i_ref, i_port = np.asarray(i_ref), i_port.numpy()

    nan = np.isnan(i_ref)
    assert nan.any() and not nan.all()
    assert np.array_equal(np.isnan(i_port), nan)
    assert np.array_equal(flags.numpy(), np.asarray(flags_ref))
    assert np.array_equal(nsamp.numpy(), np.asarray(nsamp_ref))
    pairs = [(i_port, i_ref)] + [(d.numpy(), np.asarray(r))
                                 for d, r in zip(d_port, d_ref)]
    for k, (ours, ref) in enumerate(pairs):
        assert ours.shape == ref.shape == (64, 3)
        if k:
            assert np.isfinite(ours).all() and not ours[nan].any()
        for f in range(3):
            scale = np.nanmax(np.abs(ref[:, f]))
            assert scale > 0.0
            np.testing.assert_allclose(np.nan_to_num(ours[:, f]),
                                       np.nan_to_num(ref[:, f]),
                                       atol=1e-4 * scale)


def _max_delta_tau(args, fp, integrator):
    """The largest optical depth of one sample on these rays, from a
    second sweep of the plain step loop with the coefficients alone."""
    positions, directions, mom, nus, params = args[:5]
    mass_msun, camera_x = args[6:8]
    x_unit = Physics.gg_msun * mass_msun / (Physics.c * Physics.c)
    cam = tuple(float(v) for v in camera_x)
    worst = []

    def observe(valid, ym, k, h):
        keep, gbad, n_n0, u_dot_k, _, _ = formula_geom_c(
            *(torch.where(valid, ym[c], cam[c]) for c in range(4)), *k, fp,
            cam)
        for nu in nus:
            _, alpha, _ = formula_jalpha_c(keep, gbad, n_n0, u_dot_k, mom,
                                           nu, fp)
            delta_tau = alpha * (-h) * (x_unit / nu) / mom
            worst.append(float(torch.where(valid, delta_tau, 0.0)
                               .nan_to_num(0.0).max()))

    geo.trace_reference(positions, directions, params, integrator, observe)
    return max(worst)


def test_tangents_are_reverse_mode_derivatives(tmp_path):
    """The plain float64 rk4 tangents equal torch.autograd's reverse mode
    through the plain forward (theta as tensors requiring grad), to rtol
    1e-8, contracted with positive random weights per pixel and
    frequency, on rays where no sample reaches the optically thick trap
    (delta tau > 100, whose branch autograd and the tangents both treat
    as constant)."""
    s = _setup(tmp_path, "rk4", 4, "float64", **CASE)
    args = _port_args(s)
    max_dt = _max_delta_tau(args, args[5], "rk4")
    assert 1e-3 < max_dt < fk.DELTA_TAU_MAX
    theta = {p: torch.tensor(v, dtype=torch.float64, requires_grad=True)
             for p, v in _values(s).items()}
    i_nu, _, _, d_i = fk.render_formula_reference(
        *args, fallback_nan=False, integrator="rk4", diff_values=theta)
    assert torch.isfinite(i_nu).all()
    rng = np.random.default_rng(7)
    for _ in range(2):
        w = torch.tensor(rng.uniform(0.5, 1.5, size=tuple(i_nu.shape)))
        grads = torch.autograd.grad((w * i_nu).sum(), list(theta.values()),
                                    retain_graph=True)
        for p, g, d in zip(FIT_PARAMS, grads, d_i):
            tangent = float((w * d.detach()).sum())
            assert tangent != 0.0, p
            np.testing.assert_allclose(float(g), tangent, rtol=1e-8,
                                       err_msg=p)


def _fit_case(tmp_path, **overrides):
    """16 rays at three frequencies, float32, rk4 with 600 steps, no NaN
    poisoning (the JAX fit tests' setting, tests/test_gradients.py:48-63),
    h = 0.4 and absorption on unless ``overrides`` say otherwise."""
    s = _setup(tmp_path, "rk4", 4, "float32", fallback_nan=False,
               **dict(CASE, **overrides))
    rays = s["rays"]
    jax_args = (np.asarray(s["freqs"]), s["params"], s["fparams"],
                s["mass_msun"], s["camera_x"], s["log_j_scale"])
    args = _port_args(s)
    port_args = (args[3], *args[4:])
    return s, rays, jax_args, args[:3], port_args


@pytest.fixture(scope="module")
def fit_case(tmp_path_factory):
    return _fit_case(tmp_path_factory.mktemp("fit"))


def _port_value_and_grad(render, rays, values, vjp):
    """The total flux and its gradient through a port renderer: a vjp
    renderer takes cn0 itself, a fit renderer the dict."""
    theta = {p: torch.tensor(v, dtype=torch.float32, requires_grad=True)
             for p, v in values.items()}
    i_img = render(theta["cn0"] if vjp else theta, *rays)[0]
    loss = i_img.sum()
    loss.backward()
    return loss.item(), {p: t.grad.item() for p, t in theta.items()}


def test_fit_renderers_match_jax(fit_case):
    """value_and_grad through the port's fit renderer (cn0, r0, h) and vjp
    renderer (cn0) against JAX's make_formula_fit_renderer /
    make_formula_vjp_renderer (interpret mode) under jax.value_and_grad,
    on the same rays: value and every gradient within rtol 1e-4."""
    s, jrays, jax_args, rays, port_args = fit_case
    values = _values(s)
    jrays = (jrays.positions, jrays.directions, jrays.momentum_factors)
    cases = {
        "fit": (jpallas.make_formula_fit_renderer(
            *jax_args, fallback_nan=False, integrator="rk4", interpret=True,
            fit_params=FIT_PARAMS),
                formula_fit.make_formula_fit_renderer(
            *port_args, fallback_nan=False, integrator="rk4",
            fit_params=FIT_PARAMS), values),
        "vjp": (jpallas.make_formula_vjp_renderer(
            *jax_args, fallback_nan=False, integrator="rk4", interpret=True),
                formula_fit.make_formula_vjp_renderer(
            *port_args, fallback_nan=False, integrator="rk4"),
            {"cn0": values["cn0"]}),
    }
    for name, (jrender, render, vals) in cases.items():
        if name == "fit":
            def jloss(theta):
                return jnp.sum(jrender(theta, *jrays)[0])
            jval, jgrad = jax.value_and_grad(jloss)(
                {p: jnp.float32(v) for p, v in vals.items()})
        else:
            def jloss(cn0):
                return jnp.sum(jrender(cn0, *jrays)[0])
            jval, g = jax.value_and_grad(jloss)(jnp.float32(vals["cn0"]))
            jgrad = {"cn0": g}
        val, grad = _port_value_and_grad(render, rays, vals,
                                         vjp=name == "vjp")
        np.testing.assert_allclose(val, float(jval), rtol=1e-4, err_msg=name)
        for p in vals:
            assert grad[p] != 0.0, (name, p)
            np.testing.assert_allclose(grad[p], float(jgrad[p]), rtol=1e-4,
                                       err_msg=f"{name} {p}")


def test_ray_gradients_are_none(fit_case):
    """The rays enter the renderer detached (JAX's stop_gradient): a
    gradient with respect to them comes back None, and the fitted
    parameters' gradients are unaffected."""
    s, _, _, rays, port_args = fit_case
    render = formula_fit.make_formula_fit_renderer(
        *port_args, fallback_nan=False, integrator="rk4",
        fit_params=("r0",))
    positions = rays[0].clone().requires_grad_(True)
    r0 = torch.tensor(s["fparams"].r0, requires_grad=True)
    loss = render({"r0": r0}, positions, *rays[1:])[0].sum()
    g_pos, g_r0 = torch.autograd.grad(loss, [positions, r0],
                                      allow_unused=True)
    assert g_pos is None
    assert g_r0 is not None and float(g_r0) != 0.0
    with pytest.raises(ValueError):
        render({"r0": r0, "h": 0.4}, *rays)
