"""PyTorch port: the scan route of the auxiliary image planes on the card.

The route is torch ops on the rays' device: on CUDA tensors it runs on
the card (no kernel of the port is launched) and gives the CPU's values.
A light-only configuration still launches its kernel.

This file imports neither jax nor the JAX package, so it runs on a GPU
machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_aux_planes_cuda.py``. Without a GPU every test skips.
The route is held against the JAX package in test_torch_aux_planes.py
and test_torch_aux_planes_simulation.py.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from blacklight_tpu_torch import parse_config, pipeline
from blacklight_tpu_torch import pipeline_simulation
from blacklight_tpu_torch.ops import formula_kernel as fk
from blacklight_tpu_torch.ops import polarized_kernel as pk
from blacklight_tpu_torch.ops import simulation_kernel as sk

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
ALL_PLANES = {f"image_{k}": "true" for k in (
    "time", "length", "lambda", "emission", "tau", "lambda_ave",
    "emission_ave", "tau_int", "crossings")}
FORMULA_PLANES = {f"image_{k}": "true" for k in (
    "time", "length", "lambda", "emission", "tau", "crossings")}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return torch.device("cuda")


def _config(name, res=16, **overrides):
    """``name`` on mock_small.athdf (simulation inputs) at ``res``^2,
    rk4 float64, 300 steps of 0.03, and ``overrides``."""
    text = (FIXTURES / name).read_text()
    settings = {"simulation_file": FIXTURES / "mock_small.athdf",
                "output_file": "unused.npz", "camera_resolution": res,
                "ray_integrator": "rk4", "precision": "float64",
                "ray_step": 0.03, "ray_max_steps": 300, **overrides}
    for key, value in settings.items():
        line = f"{key} = {value}"
        text, n = re.subn(rf"^{key}\s*=.*$", line, text, flags=re.M)
        if n == 0:
            text += line + "\n"
    return parse_config(text)


def _renderer(cfg, device):
    if cfg.require("model_type").value == "formula":
        return pipeline.make_formula_renderer(cfg, device=device)
    return pipeline_simulation.make_simulation_renderer(cfg, device=device)


def _counts():
    return (fk.LAUNCHES, sk.LAUNCHES, sk.PHASE_LAUNCHES, pk.LAUNCHES)


# name -> (input file, overrides)
CASES = {
    "simulation": ("golden_sim_rk4_32.input", ALL_PLANES),
    "simulation_no_light": ("golden_sim_rk4_32.input",
                            {"image_light": "false", "image_tau": "true",
                             "image_tau_int": "true"}),
    "formula": ("golden_formula_32.input", FORMULA_PLANES),
    "polarized": ("golden_polarized_rk4_32.input", ALL_PLANES),
}


# Polarized Stokes: rtol over the floor of tests/test_polarized_e2e.py:40
# (the channel's peak x 1e-4, at least I's peak x 1e-8); V at the card's V
# gate (chip_smoke.V_EXACT_RTOL): the Faraday rotation amplifies an ulp of
# the camera rays to 1e-8 of V (ROADMAP §3).
STOKES_RTOL = {"I_nu": 1e-9, "Q_nu": 1e-9, "U_nu": 1e-9, "V_nu": 5e-5}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_route_on_the_card_equals_the_cpu(cuda_device, case):
    """The same rays through the route on CUDA tensors and on CPU
    tensors: every output on the card, no kernel launched, flags,
    n_samples, NaN sets and crossings equal, the rest at rtol 1e-9 (the
    polarized Stokes with STOKES_RTOL)."""
    name, overrides = CASES[case]
    res = 8 if case == "polarized" else 16
    cfg = _config(name, res=res, **overrides)
    cpu_fn, _, rays, _, _ = _renderer(cfg, "cpu")
    card_fn, *_ = _renderer(cfg, cuda_device)
    assert cpu_fn.route == card_fn.route == "scan"
    ref = cpu_fn(rays.positions, rays.directions, rays.momentum_factors)
    before = _counts()
    ours = card_fn(*(t.to(cuda_device) for t in (
        rays.positions, rays.directions, rays.momentum_factors)))
    torch.cuda.synchronize()
    assert _counts() == before
    assert set(ours) == set(ref)
    for key, value in ours.items():
        assert value.device.type == "cuda", key
        a, b = value.cpu().numpy(), ref[key].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if a.dtype.kind != "f" or key == "crossings":
            np.testing.assert_array_equal(a, b, err_msg=key)
            continue
        assert np.array_equal(np.isnan(a), np.isnan(b)), key
        peak = np.nanmax(np.abs(b)) if np.isfinite(b).any() else 0.0
        if "Q_nu" in ref and key in STOKES_RTOL:
            floor = max(peak * 1e-4, np.nanmax(np.abs(ref["I_nu"].numpy()))
                        * 1e-8)
            rel = np.abs(a - b) / (np.abs(b) + floor)
            assert np.nanmax(rel) < STOKES_RTOL[key], (key, np.nanmax(rel))
            continue
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-14 * peak,
                                   err_msg=key)


@pytest.mark.parametrize("name,counter", (
    ("golden_sim_rk4_32.input", 1), ("golden_formula_32.input", 0),
    ("golden_polarized_rk4_32.input", 3)))
def test_light_only_still_launches_its_kernel(cuda_device, name, counter):
    cfg = _config(name, res=8)
    render_fn, _, rays, _, _ = _renderer(cfg, cuda_device)
    assert render_fn.route == "kernel"
    before = _counts()
    out = render_fn(rays.positions, rays.directions, rays.momentum_factors)
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_counts(), before)]
    assert launched[counter] > 0
    assert sum(launched) == launched[counter]
    assert out["I_nu"].device.type == "cuda"
