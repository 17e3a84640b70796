"""Differentiable formula-model renderers for inverse problems.

Port of ``make_formula_fit_renderer`` and ``make_formula_vjp_renderer``
(``blacklight_tpu/ops/pallas_formula.py`` :700-794): a
``torch.autograd.Function`` in place of ``jax.custom_vjp``. The forward
pass is one call of ``formula_kernel.render_formula`` with tangents (the
CUDA kernel on the card, its plain version on the CPU), which gives the
per-ray dI/dp of every fitted parameter; backward contracts them with the
incoming gradient. The trajectory does not depend on cn0, r0 or h, so no
reverse sweep over the integration is needed.

The rays are constants: they enter detached, as the JAX renderer wraps
them in ``stop_gradient``, so a gradient with respect to them is None.
Camera-pose gradients need reverse mode through the step loop (ROADMAP
A.7), which the port does not have yet.
"""

from __future__ import annotations

import torch

from blacklight_tpu_torch.models.formula import FormulaParams
from blacklight_tpu_torch.ops import geodesic as geo
from blacklight_tpu_torch.ops.formula_kernel import (
    DIFFABLE_PARAMS,
    frequency_list,
    render_formula,
)


class _TangentRender(torch.autograd.Function):
    """(theta (nd,), rays) -> (I_nu (B, F), flags, n_samples), with
    d I / d theta from the forward pass's tangents."""

    @staticmethod
    def forward(ctx, theta, positions, directions, momentum_factors,
                forward_fn):
        i_img, flags, n_samples, d_i = forward_fn(
            theta, positions, directions, momentum_factors)
        ctx.save_for_backward(d_i)
        ctx.mark_non_differentiable(flags, n_samples)
        return i_img, flags, n_samples

    @staticmethod
    def backward(ctx, grad_i, _grad_flags, _grad_n_samples):
        (d_i,) = ctx.saved_tensors
        grad_theta = torch.stack([torch.sum(grad_i * d) for d in d_i])
        return grad_theta, None, None, None, None


def make_formula_fit_renderer(frequencies, params: geo.GeodesicParams,
                              fp: FormulaParams, mass_msun: float, camera_x,
                              log_j_scale: float, fallback_nan: bool = True,
                              integrator: str = "dp",
                              fit_params: tuple = ("cn0",)):
    """Differentiable renderer over a subset of ("cn0", "r0", "h").

    Returns render(theta, positions, directions, momentum_factors) ->
    (I_nu (B, F), flags, n_samples), theta a dict over fit_params of 0-dim
    tensors (or floats). Autograd reaches every entry of theta: they are
    stacked into one (nd,) tensor in the rays' dtype and on their device.

    cn0 enters the image twice: linearly through the emission amplitude
    (in log_j_scale, fixed inside the kernel, so applied here as the exact
    factor cn0 / cn0_ref with cn0_ref = fp.cn0 > 0) and through the
    absorption alpha = cn0 alpha_unit (the kernel's tangent). So
    dI/dcn0 = (cn0 / cn0_ref) dI_raw + I_raw / cn0_ref, and 0 where I_raw
    is NaN. log_j_scale must be formula_log_j_scale(fp). r0 and h enter
    only through the Gaussian density profile.
    """
    fit_params = tuple(p for p in DIFFABLE_PARAMS if p in fit_params)
    if not fit_params:
        raise ValueError(f"fit_params takes a non-empty subset of "
                         f"{DIFFABLE_PARAMS}")
    has_cn0 = "cn0" in fit_params
    cn0_ref = float(fp.cn0)
    nus = frequency_list(frequencies)

    def forward_fn(theta, positions, directions, momentum_factors):
        values = dict(zip(fit_params, theta.unbind()))
        i_raw, flags, n_samples, d_raw = render_formula(
            positions, directions, momentum_factors, nus, params, fp,
            mass_msun, camera_x, log_j_scale, fallback_nan=fallback_nan,
            integrator=integrator, diff_values=values)
        scale = values["cn0"] / cn0_ref if has_cn0 else 1.0
        # product rule for cn0; a poisoned pixel holds a constant NaN
        # whose derivative is zero
        nan = torch.isnan(i_raw)
        d_i = []
        for p, d in zip(fit_params, d_raw):
            d = scale * d
            if p == "cn0":
                d = d + i_raw / cn0_ref
            d_i.append(torch.where(nan, 0.0, d))
        return i_raw * scale, flags, n_samples, torch.stack(d_i)

    def render(theta, positions, directions, momentum_factors):
        if set(theta) != set(fit_params):
            raise ValueError(f"theta must hold exactly {fit_params}, not "
                             f"{sorted(theta)}")
        vec = torch.stack([
            torch.as_tensor(theta[p], dtype=positions.dtype,
                            device=positions.device).reshape(())
            for p in fit_params])
        return _TangentRender.apply(vec, positions.detach(),
                                    directions.detach(),
                                    momentum_factors.detach(), forward_fn)

    return render


def make_formula_vjp_renderer(frequencies, params: geo.GeodesicParams,
                              fp: FormulaParams, mass_msun: float, camera_x,
                              log_j_scale: float, fallback_nan: bool = True,
                              integrator: str = "dp"):
    """cn0-only form of make_formula_fit_renderer:
    render(cn0, positions, directions, momentum_factors)."""
    fit = make_formula_fit_renderer(
        frequencies, params, fp, mass_msun, camera_x, log_j_scale,
        fallback_nan=fallback_nan, integrator=integrator,
        fit_params=("cn0",))

    def render(cn0, positions, directions, momentum_factors):
        return fit({"cn0": cn0}, positions, directions, momentum_factors)

    return render
