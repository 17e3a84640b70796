"""PyTorch port: the CKS instantiations of the simulation kernel, its
phase kernel and the polarized route's derive kernel (csrc/sim_sample.cuh
SAMPLE_CKS_BLOCKS, SAMPLE_CKS_INTERBLOCK) on the card, against their
plain versions on the same rays.

This file imports neither jax nor the JAX package, so it runs on a GPU
machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_athenak_cuda.py``. Without a GPU every test skips. The
plain versions are held against the JAX package in
``test_torch_athenak.py``.

The snapshots are AthenaK files of scripts/generate_mock_simulation.py's
torus written by scripts/mock_athenak.write_blocks: one block of 32^3
cells (write_athenak's file), and a root grid of 2^3 blocks of 12^3 cells
with two root blocks refined once (21 blocks, two levels). The cameras and
plasmas are golden_sim_rk4_32.input's and golden_plasma_mix_rk4_32.input's
with 400 steps of 0.04, and off-grid samples take fallback values
(fallback_nan off: the cube is smaller than the camera's distance). Gates:
rk4 in float64 exact (flags, sample counts and NaN sets equal, rtol
1e-9), dp in float64 at rtol 1e-7; float32 at the statistical gate of
bench.py:181-186 (32^2); phased bit for bit the monolithic image; the
polarized route in float64 at rtol 1e-9 over a floor of 1e-4 of each
channel's peak (V at 5e-5), in float32 each channel's |delta| within 1e-3
of I's peak at the 99.5th percentile and 1e-2 at the most (16^2).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from blacklight_tpu_torch import RayIntegrator, read_config
from blacklight_tpu_torch import pipeline_simulation
from blacklight_tpu_torch.constants import Coordinates, SimulationFormat
from blacklight_tpu_torch.grid.athenak import load_athenak
from blacklight_tpu_torch.ops import polarized_kernel as pk
from blacklight_tpu_torch.ops import simulation_kernel as sk

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

ROOT = pathlib.Path(__file__).parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
sys.path.insert(0, str(ROOT / "scripts"))
import generate_mock_simulation as gen  # noqa: E402
import mock_athenak  # noqa: E402

THERMAL = "golden_sim_rk4_32.input"
MIXTURE = "golden_plasma_mix_rk4_32.input"
STOKES = ("I_nu", "Q_nu", "U_nu", "V_nu")
# snapshot -> write_blocks' layout
SNAPSHOTS = {"one": dict(root=1, cells=32),
             "amr": dict(root=2, cells=12, refine=[(1, 1, 1), (0, 1, 1)])}
# case -> (snapshot, overrides, the kernel mode it takes)
LAYOUTS = {
    "one": ("one", {}, sk.CKS_BLOCKS),
    "one_nearest": ("one", {"simulation_interp": False}, sk.CKS_BLOCKS),
    "amr_interblock": ("amr", {"simulation_block_interp": True},
                       sk.CKS_INTERBLOCK),
    "amr_blocks": ("amr", {}, sk.CKS_BLOCKS),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("athenak_cuda")
    p = dict(gen.DEFAULTS)
    out = {}
    for name, layout in SNAPSHOTS.items():
        out[name] = d / f"{name}.bin"
        mock_athenak.write_blocks(str(out[name]), p, **layout)
    return out


_GRIDS = {}


def _config(name, path, res, **overrides):
    cfg = read_config(str(FIXTURES / name))
    cfg.simulation_format = SimulationFormat.athenak
    cfg.simulation_coord = Coordinates.cks
    cfg.simulation_file = str(path)
    cfg.camera_resolution = res
    cfg.ray_step = 0.04
    cfg.ray_max_steps = 400
    cfg.fallback_nan = False
    cfg.fallback_rho = 1.0e-8
    cfg.fallback_pgas = 1.0e-10
    for key, value in overrides.items():
        setattr(cfg, key, value)
    return cfg


def _renderer(files, name, layout, res=16, **overrides):
    snapshot, layout_overrides, mode = LAYOUTS[layout]
    cfg = _config(name, files[snapshot], res,
                  **{**layout_overrides, **overrides})
    dtype = torch.float32 if cfg.precision == "float32" else torch.float64
    if (snapshot, dtype) not in _GRIDS:
        _GRIDS[snapshot, dtype] = load_athenak(str(files[snapshot]),
                                               device="cuda", dtype=dtype)
    render_fn, geom, rays, _, _ = \
        pipeline_simulation.make_simulation_renderer(
            cfg, device="cuda", grid=_GRIDS[snapshot, dtype])
    grid = render_fn.kernel_args[3]
    assert grid.coords == "cks"
    assert sk.kernel_mode(grid, render_fn.kernel_args[2].sampler) == mode
    return render_fn, geom, rays, mode


def _args(render_fn, rays):
    return (rays.positions, rays.directions, rays.momentum_factors,
            *render_fn.kernel_args)


def _exact(ours, ref, rtol):
    assert torch.equal(ours[1], ref[1]) and torch.equal(ours[2], ref[2])
    a, b = ours[0].cpu().numpy(), ref[0].cpu().numpy()
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.nanmax(b) > 0.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0.0)


def _statistical_gate(a, b):
    """bench.py:181-186: identical NaN sets, fewer than 0.5% of pixels past
    1e-3 relative, total flux within 1e-3."""
    rel = np.abs(a - b) / (np.abs(b) + np.nanmax(np.abs(b)) * 1e-6)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.mean(np.nan_to_num(rel) > 1e-3) < 5e-3
    assert abs(np.nansum(a) - np.nansum(b)) < 1e-3 * abs(np.nansum(b))


KERNEL_CASES = (
    [("thermal", layout, integrator, precision) for layout in LAYOUTS
     for integrator, precision in (("rk4", "float64"), ("dp", "float64"),
                                   ("rk4", "float32"), ("dp", "float32"))]
    + [("mixture", layout, integrator, precision) for layout in LAYOUTS
       for integrator, precision in (("rk4", "float64"),
                                     ("dp", "float32"))])


@pytest.mark.parametrize("population,layout,integrator,precision",
                         KERNEL_CASES)
def test_cks_kernel_matches_plain(cuda_device, files, population, layout,
                                  integrator, precision):
    """dp keeps the golden inputs' 2000 steps of 0.01 (a float32 dp ray
    whose step count nears a budget of 400 can end flagged in one version
    and not the other)."""
    steps = {} if integrator != "dp" else {"ray_step": 0.01,
                                           "ray_max_steps": 2000}
    render_fn, _, rays, mode = _renderer(
        files, THERMAL if population == "thermal" else MIXTURE, layout,
        res=16 if precision == "float64" else 32,
        ray_integrator=RayIntegrator(integrator), precision=precision,
        **steps)
    assert render_fn.route == "kernel"
    args = _args(render_fn, rays)
    counts = sk.MODE_LAUNCHES if population == "thermal" \
        else sk.MIXTURE_MODE_LAUNCHES
    before = (sk.LAUNCHES, list(counts))
    ours = sk.render_simulation(*args, integrator=integrator)
    assert sk.LAUNCHES == before[0] + 1
    assert counts[mode] == before[1][mode] + 1
    ref = sk.render_simulation_reference(*args, integrator=integrator)
    torch.cuda.synchronize()
    if precision == "float64":
        _exact(ours, ref, 1e-9 if integrator == "rk4" else 1e-7)
    else:
        _statistical_gate(ours[0].cpu().numpy()[:, 0],
                          ref[0].cpu().numpy()[:, 0])


@pytest.mark.parametrize("population", ["thermal", "mixture"])
@pytest.mark.parametrize("integrator,precision,layout", [
    ("rk4", "float64", "amr_interblock"), ("rk2", "float32", "amr_blocks"),
    ("rk4", "float32", "one_nearest")])
def test_cks_phased_matches_monolithic(cuda_device, files, integrator,
                                       precision, layout, population):
    """The CKS phase kernel (phases of 100 steps) gives the CKS kernel's
    image bit for bit."""
    render_fn, _, rays, mode = _renderer(
        files, THERMAL if population == "thermal" else MIXTURE, layout,
        res=32, ray_integrator=RayIntegrator(integrator),
        precision=precision)
    args = _args(render_fn, rays)
    mono = sk.render_simulation(*args, integrator=integrator)
    counts = sk.PHASE_MODE_LAUNCHES if population == "thermal" \
        else sk.PHASE_MIXTURE_MODE_LAUNCHES
    before = counts[mode]
    phased = sk.render_simulation_phased(*args, integrator=integrator,
                                         phase_steps=100, block=256)
    assert counts[mode] > before
    for a, b in zip(phased, mono):
        assert torch.equal(torch.nan_to_num(a, nan=-1.0),
                           torch.nan_to_num(b, nan=-1.0))


def test_cks_phase_kernel_matches_plain(cuda_device, files):
    """One phase of the CKS phase kernel from the same carried state as
    its plain version: rk4 float64, rtol 1e-9, exact interblock
    sampling."""
    render_fn, _, rays, _ = _renderer(files, THERMAL, "amr_interblock")
    positions, directions, mom, freqs, params, sp, grid, mass, cam, log_js = \
        _args(render_fn, rays)
    outs = []
    for run in (sk.render_simulation_phase,
                sk.render_simulation_phase_reference):
        carry = sk.initial_carry(positions, directions, params,
                                 freqs.shape[0])
        index = torch.arange(positions.shape[0], dtype=torch.int32,
                             device=positions.device)
        run(carry, index, 0, 200, directions, mom, freqs, params, sp, grid,
            mass, cam, "rk4")
        outs.append(sk.finish_rays(carry, index, freqs, log_js, False))
    _exact(outs[0], outs[1], 1e-9)


def _stokes(render_fn, geom, rays, kernel):
    fn = pk.render_polarized if kernel else pk.render_polarized_reference
    nn_re, nn_im, flags, _, bad = fn(*_args(render_fn, rays),
                                     **render_fn.kernel_kwargs)
    return {k: v.double().cpu().numpy() for k, v in pk.poisoned_stokes(
        nn_re, nn_im, flags, bad, rays.positions, rays.directions,
        render_fn.kernel_args[0], render_fn.kernel_args[1], geom,
        render_fn.kernel_args[6], False).items()}


@pytest.mark.parametrize("population", ["thermal", "mixture"])
@pytest.mark.parametrize("precision,layout", [
    ("float64", "amr_interblock"), ("float32", "amr_interblock"),
    ("float64", "one_nearest")])
def test_cks_polarized_matches_plain(cuda_device, files, precision, layout,
                                     population):
    name = "golden_polarized_rk4_32.input" if population == "thermal" \
        else "golden_plasma_mix_pol_rk4_32.input"
    render_fn, geom, rays, mode = _renderer(files, name, layout,
                                            precision=precision)
    counts = pk.DERIVE_MODE_LAUNCHES if population == "thermal" \
        else pk.DERIVE_MIXTURE_MODE_LAUNCHES
    before = (list(pk.DERIVE_MODE_LAUNCHES),
              list(pk.DERIVE_MIXTURE_MODE_LAUNCHES))
    ours = _stokes(render_fn, geom, rays, True)
    assert counts[mode] > (before[0] if population == "thermal"
                           else before[1])[mode]
    # no other derive instantiation
    other = pk.DERIVE_MIXTURE_MODE_LAUNCHES if population == "thermal" \
        else pk.DERIVE_MODE_LAUNCHES
    assert other == (before[1] if population == "thermal" else before[0])
    ref = _stokes(render_fn, geom, rays, False)
    i_scale = np.nanmax(np.abs(ref["I_nu"]))
    assert i_scale > 0.0
    for key in STOKES:
        a, b = ours[key], ref[key]
        assert np.array_equal(np.isnan(a), np.isnan(b)), key
        if precision == "float64":
            floor = np.nanmax(np.abs(b)) * 1e-4
            rtol = 5e-5 if key == "V_nu" else 1e-9
            assert np.nanmax(np.abs(a - b) / (np.abs(b) + floor)) < rtol, key
        else:
            frac = np.abs(a - b) / i_scale
            assert np.nanpercentile(frac, 99.5) < 1e-3, key
            assert np.nanmax(frac) < 1e-2, key
