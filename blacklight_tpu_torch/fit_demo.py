"""Inverse rendering demo: recover emission-model parameters from an image.

    python -m blacklight_tpu_torch.fit_demo [--device cuda|cpu]
        [--resolution N] [--iterations N]

A synthetic "observation" of the analytic disk is rendered with hidden
parameters, and log(cn0) (emission amplitude) and formula_r0 (disk
radius) are fit to it by Adam on an L2 image loss, through the
differentiable kernel renderer (``ops/formula_fit.make_formula_fit_renderer``:
in-kernel forward tangents behind a ``torch.autograd.Function``). The
port's counterpart of ``scripts/fit_demo.py --kernel``: the same
configuration, hidden truth, loss and Adam settings, rendered in float32
with the configuration's rk4 integrator (the JAX script's kernel path
passes none and takes its renderer's default, dp). It prints FIT OK and
exits 0 when both parameters come within 2e-2 (in log) of the truth. The
default device is the card, where it fails rather than run on the CPU.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import torch

from blacklight_tpu_torch.camera import make_camera
from blacklight_tpu_torch.models import formula as formula_model
from blacklight_tpu_torch.ops.formula_fit import make_formula_fit_renderer
from blacklight_tpu_torch.pipeline import (
    bh_mass_spin,
    geodesic_params_from_config,
    resolve_device,
)
from blacklight_tpu_torch.utils.config import parse_config

CONFIG = """
model_type = formula
formula_mass  = 6.0e11
formula_spin  = 0.9
formula_r0    = 10.0
formula_h     = 0.0
formula_l0    = 0.0
formula_q     = 0.5
formula_nup   = 2.3e11
formula_cn0   = 3.0e-18
formula_alpha = -3.0
formula_a     = 0.0
formula_beta  = 2.5
camera_type       = plane
camera_r          = 100.0
camera_th         = 60.0
camera_ph         = 0.0
camera_urn        = 0.0
camera_uthn       = 0.0
camera_uphn       = 0.0
camera_k_r        = 1.0
camera_k_th       = 0.0
camera_k_ph       = 0.0
camera_rotation   = 0.0
camera_width      = 25.0
camera_resolution = 32
ray_flat        = false
ray_terminate   = additive
ray_factor      = 5.0e-4
ray_integrator  = rk4
ray_step        = 0.01
ray_max_steps   = 2600
image_light           = true
image_num_frequencies = 1
image_frequency       = 2.3e11
image_normalization   = camera
render_num_images = 0
adaptive_max_level = 0
cut_omit_near = false
cut_omit_far  = false
cut_omit_in   = -1.0
cut_omit_out  = -1.0
cut_midplane_theta = 0.0
cut_midplane_z = 0.0
cut_plane = false
fallback_nan = false
precision = float64
"""

# Hidden truth: the amplitude times 2.5 and a disk radius of 13
TRUTH_CN0_FACTOR = 2.5
TRUTH_R0 = 13.0
# Adam (scripts/fit_demo.py:152-162) and the success test
LR, BETAS, EPS = 0.05, (0.9, 0.999), 1e-8
TOLERANCE = 2e-2


def make_problem(resolution: int, device):
    """render(log_cn0, log_r0) -> (B,) image on ``device`` in float32
    through the fit renderer, and the starting log parameters."""
    cfg = parse_config(CONFIG)
    cfg.camera_resolution = resolution
    bh_m, bh_a, mass_msun = bh_mass_spin(cfg)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a, device=device,
                                    dtype=torch.float32)
    params = geodesic_params_from_config(cfg, bh_m, bh_a)
    fp = formula_model.formula_params_from_config(cfg)
    fit = make_formula_fit_renderer(
        freqs, params, fp, mass_msun, geom.cam_x.tolist(),
        formula_model.formula_log_j_scale(fp), fallback_nan=False,
        integrator=params.integrator.value, fit_params=("cn0", "r0"))

    def render(log_cn0, log_r0):
        i_img, _, _ = fit({"cn0": torch.exp(log_cn0), "r0": torch.exp(log_r0)},
                          rays.positions, rays.directions,
                          rays.momentum_factors)
        return i_img[:, 0]

    return render, math.log(fp.cn0), math.log(fp.r0)


def fit(resolution: int = 32, iterations: int = 200, device="cuda",
        log=print) -> dict:
    """Fit (log cn0, log r0) to the hidden truth's image; returns the truth,
    the fitted values, the loss and the wall time of each iteration."""
    device = resolve_device(device)
    render, log_cn0, log_r0 = make_problem(resolution, device)
    truth = torch.tensor([log_cn0 + math.log(TRUTH_CN0_FACTOR),
                          math.log(TRUTH_R0)], dtype=torch.float64,
                         device=device)
    with torch.no_grad():
        target = render(truth[0], truth[1])
    # The JAX script's loss is the nanmean of the squared scaled residual.
    # A pixel whose ray samples the ergosphere (the disk velocity is not
    # timelike there) is NaN whatever the parameters, and nanmean's
    # backward through the square would give it a NaN gradient: it is
    # masked before the square instead, which leaves the value unchanged.
    finite = ~torch.isnan(target)
    scale = target[finite].max()

    theta = torch.tensor([log_cn0, log_r0], dtype=torch.float64,
                         device=device, requires_grad=True)
    opt = torch.optim.Adam([theta], lr=LR, betas=BETAS, eps=EPS)
    log(f"truth:  log_cn0 = {float(truth[0]):.4f}, "
        f"log_r0 = {float(truth[1]):.4f}")
    losses, seconds = [], []
    for i in range(1, iterations + 1):
        t0 = time.perf_counter()
        opt.zero_grad()
        residual = torch.where(finite, render(theta[0], theta[1]) - target,
                               0.0)
        loss = torch.sum((residual / scale) ** 2) / finite.sum()
        loss.backward()
        opt.step()
        losses.append(loss.item())  # waits for the device
        seconds.append(time.perf_counter() - t0)
        if i % 25 == 0 or i in (1, iterations):
            log_cn0, log_r0 = theta.detach().tolist()
            log(f"step {i:3d}: loss = {losses[-1]:.3e}  "
                f"log_cn0 = {log_cn0:.4f}  log_r0 = {log_r0:.4f}")
    errors = (theta.detach() - truth).abs().tolist()
    return {"truth": truth.tolist(), "theta": theta.detach().tolist(),
            "errors": errors, "losses": losses, "seconds": seconds,
            "ok": all(e < TOLERANCE for e in errors)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Fit log(cn0) and formula_r0 of the analytic disk to a "
                    "target image by Adam through the differentiable kernel "
                    "renderer.")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; fails without a GPU) or cpu")
    parser.add_argument("--resolution", type=int, default=32)
    parser.add_argument("--iterations", type=int, default=200)
    opts = parser.parse_args(argv)
    result = fit(opts.resolution, opts.iterations, opts.device)
    err_cn0, err_r0 = result["errors"]
    print(f"final errors: |dlog_cn0| = {err_cn0:.2e}, "
          f"|dlog_r0| = {err_r0:.2e}")
    print("FIT OK" if result["ok"] else "FIT DID NOT CONVERGE")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
