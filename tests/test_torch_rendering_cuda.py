"""PyTorch port: false-color rendering (ROADMAP D.1) on the card, and
the scan route's CUDA graphs (ROADMAP R5).

The scan route is torch ops on the rays' device: on CUDA tensors it runs
on the card (no kernel of the port is launched), its loop
(``ops/geodesic.trace_compacted``) replaying each bundle's step from a
CUDA graph. Here the route with renderings on the card against the same
route on the CPU at 32^2, the route with graphs against the same route
stepped eagerly on the card (bit for bit), and the reference-binary
goldens golden_render_rk4_32 and golden_render_32 through
``pipeline.run(device="cuda")`` at tests/test_render_truecolor.py's
gates.

This file imports neither jax nor the JAX package, so it runs on a GPU
machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_rendering_cuda.py``. Without a GPU every test skips.
The route is held against the JAX package in test_torch_rendering.py.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from blacklight_tpu_torch import parse_config, pipeline
from blacklight_tpu_torch import pipeline_simulation
from blacklight_tpu_torch.ops import formula_kernel as fk
from blacklight_tpu_torch.ops import geodesic
from blacklight_tpu_torch.ops import polarized_kernel as pk
from blacklight_tpu_torch.ops import simulation_kernel as sk

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
ALL_PLANES = {f"image_{k}": "true" for k in (
    "light", "time", "length", "lambda", "emission", "tau", "lambda_ave",
    "emission_ave", "tau_int", "crossings")}
# the polarized Stokes: I and V as tests/test_torch_aux_planes_cuda.py
# holds them; Q and U at the card tests' gate for an ill-conditioned
# configuration (the nearest cell's, ROADMAP §3): in this flat-spacetime
# one the card's Q parts from the CPU's by 3.7e-9
STOKES_RTOL = {"I_nu": 1e-9, "Q_nu": 1e-7, "U_nu": 1e-7, "V_nu": 5e-5}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the scan route on CUDA tensors)")
    return torch.device("cuda")


def _text(name="golden_render_rk4_32.input", res=32, **overrides):
    """``name`` on mock_small.athdf at ``res``^2, 400 steps of 0.02, and
    ``overrides``."""
    text = (FIXTURES / name).read_text()
    settings = {"simulation_file": FIXTURES / "mock_small.athdf",
                "output_file": "unused.npz", "camera_resolution": res,
                "ray_step": 0.02, "ray_max_steps": 400, **overrides}
    for key, value in settings.items():
        line = f"{key} = {value}"
        text, n = re.subn(rf"^{key}\s*=.*$", line, text, flags=re.M)
        if n == 0:
            text += line + "\n"
    return text


def _counts():
    return (fk.LAUNCHES, sk.LAUNCHES, sk.PHASE_LAUNCHES, pk.LAUNCHES)


def _assert_close(ours: dict, ref: dict):
    assert set(ours) == set(ref)
    for key, value in ours.items():
        a, b = value.cpu().numpy(), ref[key].cpu().numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if a.dtype.kind != "f" or key == "crossings":
            np.testing.assert_array_equal(a, b, err_msg=key)
            continue
        assert np.array_equal(np.isnan(a), np.isnan(b)), key
        peak = np.nanmax(np.abs(b)) if np.isfinite(b).any() else 0.0
        if "Q_nu" in ref and key in STOKES_RTOL:
            floor = max(peak * 1e-4, np.nanmax(np.abs(
                ref["I_nu"].cpu().numpy())) * 1e-8)
            rel = np.abs(a - b) / (np.abs(b) + floor)
            assert np.nanmax(rel) < STOKES_RTOL[key], (key, np.nanmax(rel))
            continue
        floor = 1e-10 if key == "rendering" else 1e-14
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=floor * peak,
                                   err_msg=key)


# name -> overrides of golden_render_rk4_32.input (float64)
CASES = {
    "rk4_every_plane": ALL_PLANES,
    "rk2_rendering_alone": {"ray_integrator": "rk2"},
    "polarized": {"image_light": "true", "image_polarization": "true",
                  "image_rotation_split": "false", "camera_resolution": 8,
                  "ray_step": 0.04},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rendering_on_the_card_equals_the_cpu(cuda_device, case):
    """The same rays through the renderer on CUDA tensors and on CPU
    tensors: every output on the card, no kernel launched, flags,
    n_samples, NaN sets and crossings equal, the rest at rtol 1e-9 (the
    rendering over 1e-10 of its peak, the polarized Stokes at
    STOKES_RTOL)."""
    cfg = parse_config(_text(**CASES[case]))
    cpu_fn, _, rays, _, _ = pipeline_simulation.make_simulation_renderer(
        cfg, device="cpu")
    card_fn, *_ = pipeline_simulation.make_simulation_renderer(
        cfg, device=cuda_device)
    assert cpu_fn.route == card_fn.route == "scan"
    ref = cpu_fn(rays.positions, rays.directions, rays.momentum_factors)
    before = _counts()
    ours = card_fn(*(t.to(cuda_device) for t in (
        rays.positions, rays.directions, rays.momentum_factors)))
    torch.cuda.synchronize()
    assert _counts() == before
    assert all(v.device.type == "cuda" for v in ours.values())
    assert "rendering" in ours
    _assert_close(ours, ref)


@pytest.mark.parametrize("integrator", ("dp", "rk4", "rk2"))
def test_step_graphs_replay_the_eager_steps(cuda_device, monkeypatch,
                                            integrator):
    """The scan route with every plane and the renderings on the card,
    its steps replayed from CUDA graphs, against the same route stepped
    eagerly on the card: every output equal bit for bit, the length plane
    and the renderings (whose proper length is a batched contraction the
    card may round by batch size) at rtol 1e-12."""
    cfg = parse_config(_text(res=24, ray_integrator=integrator,
                             **ALL_PLANES))
    render_fn, _, rays, _, _ = pipeline_simulation.make_simulation_renderer(
        cfg, device=cuda_device)
    graphs = []
    graph = geodesic._StepGraph

    class Counted(graph):
        def __init__(self, *args, **kwargs):
            graphs.append(args[0].alive.shape[0])
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(geodesic, "_StepGraph", Counted)
    ours = render_fn(rays.positions, rays.directions, rays.momentum_factors)
    assert len(graphs) > 1, graphs
    monkeypatch.setattr(geodesic, "STEP_GRAPHS", False)
    ref = render_fn(rays.positions, rays.directions, rays.momentum_factors)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        a, b = ours[key].cpu(), value.cpu()
        assert torch.equal(a.isnan(), b.isnan()), key
        if key in ("length", "rendering"):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       err_msg=key)
        else:
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), key


def test_formula_scan_route_on_the_card_equals_the_cpu(cuda_device):
    """The formula model's scan route (dp, two planes, 2000 of the
    golden's steps, so with fallback_nan off) through the graphed loop on
    the card against the CPU: NaN sets equal, the rest at the dp
    quadrature gate of tests/test_formula_e2e.py (the controller
    amplifies an ulp)."""
    text = _text("golden_formula_32.input", res=16, ray_max_steps=2000,
                 fallback_nan="false", image_time="true", image_lambda="true")
    cfg = parse_config(text)
    cpu_fn, _, rays, _, _ = pipeline.make_formula_renderer(cfg,
                                                           device="cpu")
    card_fn, *_ = pipeline.make_formula_renderer(cfg, device=cuda_device)
    assert card_fn.route == "scan"
    ref = cpu_fn(rays.positions, rays.directions, rays.momentum_factors)
    ours = card_fn(*(t.to(cuda_device) for t in (
        rays.positions, rays.directions, rays.momentum_factors)))
    for key in ("I_nu", "time", "lambda"):
        a, b = ours[key].cpu().numpy(), ref[key].numpy()
        assert np.array_equal(np.isnan(a), np.isnan(b)), key
        rel = np.abs(a - b) / (np.abs(b) + np.nanmax(np.abs(b)) * 1e-8)
        assert np.nanmax(rel) < 5e-3 and np.nanmean(rel) < 1e-3, key


@pytest.mark.parametrize("name", ("golden_render_rk4_32", "golden_render_32"))
def test_render_goldens_on_the_card(cuda_device, tmp_path, name):
    """The reference binary's renderings through pipeline.run on the card:
    rk4 float64 at rtol 1e-8 over 1e-10 of the peak, dp with mean error
    < 5e-3 and max < 2e-1 of the peak (tests/test_render_truecolor.py:
    16-34)."""
    cfg = parse_config((FIXTURES / f"{name}.input").read_text())
    cfg.simulation_file = str(FIXTURES / "mock_small.athdf")
    cfg.output_file = str(tmp_path / "r.npz")
    before = _counts()
    arrays = pipeline.run(cfg, quiet=True, device="cuda")
    assert _counts() == before
    gold = np.load(FIXTURES / f"{name}.npz")["rendering"]
    ours = arrays["rendering"].reshape(gold.shape)
    peak = np.abs(gold).max()
    if name == "golden_render_rk4_32":
        np.testing.assert_allclose(ours, gold, rtol=1e-8, atol=peak * 1e-10)
    else:
        err = np.abs(ours - gold) / peak
        assert np.nanmean(err) < 5e-3
        assert np.nanmax(err) < 2e-1
