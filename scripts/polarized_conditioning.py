"""How far rounding moves the polarized route's float64 image: the plain
version's own change under a one-ulp change of theta_e at every sample and
under a 1e-15 relative change of the camera's positions, and on a GPU the
kernel route against the plain version, for the thermal (ti_te_beta) and
code_kappa temperatures, with one block's trilinear sample and with the
nearest cell.

The cell is tests/test_torch_code_kappa_cuda.py's polarized one:
golden_polarized_rk4_32.input at 8^2, rk4, 400 steps of 0.04, float64, on
mock_small.athdf with the entropy of scripts/mock_athenak.py with_kappa.
Each reading is that test's: per channel the largest |a - b| / (|b| +
floor), the floor the channel's peak x 1e-4 (at least I's peak x 1e-8).
One JSON line per case.

    python scripts/polarized_conditioning.py            # CPU only
    python scripts/polarized_conditioning.py --device cuda
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from blacklight_tpu_torch import RayIntegrator, pipeline_simulation  # noqa
from blacklight_tpu_torch import read_config  # noqa: E402
from blacklight_tpu_torch.constants import PlasmaModel  # noqa: E402
from blacklight_tpu_torch.grid.athena import load_athdf  # noqa: E402
from blacklight_tpu_torch.models import synchrotron  # noqa: E402
from blacklight_tpu_torch.ops import polarized_kernel as pk  # noqa: E402

import generate_mock_simulation as gen  # noqa: E402
import mock_athenak  # noqa: E402

FIXTURES = ROOT / "tests" / "fixtures"
STOKES = ("I_nu", "Q_nu", "U_nu", "V_nu")
LAYOUTS = {"single": {}, "nearest": {"simulation_interp": False}}


def renderer(device, layout, model):
    cfg = read_config(str(FIXTURES / "golden_polarized_rk4_32.input"))
    settings = dict(camera_resolution=8, ray_step=0.04, ray_max_steps=400,
                    precision="float64",
                    ray_integrator=RayIntegrator("rk4"), plasma_model=model,
                    simulation_kappa_name="kappa",
                    image_rotation_split=False, **LAYOUTS[layout])
    for key, value in settings.items():
        setattr(cfg, key, value)
    grid = mock_athenak.with_kappa(
        load_athdf(str(FIXTURES / "mock_small.athdf"), device=device,
                   dtype=torch.float64), gen.DEFAULTS["gamma_adi"])
    render_fn, geom, rays, _, _ = \
        pipeline_simulation.make_simulation_renderer(cfg, device=device,
                                                     grid=grid)
    args = (rays.positions, rays.directions, rays.momentum_factors,
            *render_fn.kernel_args)
    return args, render_fn.kernel_kwargs, geom


def stokes(fn, args, kwargs, geom):
    nn_re, nn_im, flags, _, bad = fn(*args, **kwargs)
    image = pk.poisoned_stokes(nn_re, nn_im, flags, bad, args[0], args[1],
                               args[3], args[4], geom, args[-1], True)
    return {k: v.cpu().numpy() for k, v in image.items()}


def reading(ours, ref) -> dict:
    i_scale = np.nanmax(np.abs(ref["I_nu"]))
    out = {}
    for name in STOKES:
        a, b = ours[name], ref[name]
        floor = max(np.nanmax(np.abs(b)) * 1e-4, i_scale * 1e-8)
        out[name] = float(np.nanmax(np.abs(a - b) / (np.abs(b) + floor)))
    return out


def one_ulp_theta_e(*args, **kwargs):
    """synchrotron.fluid_state with theta_e one ulp higher."""
    state = dict(ONE_ULP_BASE(*args, **kwargs))
    theta = state["theta_e"]
    state["theta_e"] = torch.nextafter(theta, torch.full_like(theta, np.inf))
    return state


ONE_ULP_BASE = synchrotron.fluid_state


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    opts = parser.parse_args(argv)
    torch.set_num_threads(4)
    device = torch.device(opts.device)
    for layout in LAYOUTS:
        for model in (PlasmaModel.ti_te_beta, PlasmaModel.code_kappa):
            args, kwargs, geom = renderer(device, layout, model)
            ref = stokes(pk.render_polarized_reference, args, kwargs, geom)
            case = {"layout": layout, "plasma_model": model.name}
            if device.type == "cuda":
                ours = stokes(pk.render_polarized, args, kwargs, geom)
                print(json.dumps({**case, "kernel_vs_plain":
                                  reading(ours, ref)}), flush=True)
                continue
            synchrotron.fluid_state = one_ulp_theta_e
            try:
                moved = stokes(pk.render_polarized_reference, args, kwargs,
                               geom)
            finally:
                synchrotron.fluid_state = ONE_ULP_BASE
            shifted = (args[0] * (1.0 + 1e-15), *args[1:])
            print(json.dumps({
                **case, "theta_e_one_ulp": reading(moved, ref),
                "positions_1e-15": reading(stokes(
                    pk.render_polarized_reference, shifted, kwargs, geom),
                    ref)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
