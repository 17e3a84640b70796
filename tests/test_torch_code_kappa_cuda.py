"""PyTorch port: plasma_model = code_kappa (ROADMAP B.2) on the card: the
mixture's instantiations of the simulation kernel, its phase kernel and
the polarized route's derive kernel at the code_kappa temperature
(csrc/sim_sample.cuh code_kappa_state, the electron entropy read from
its own table), in every sampling mode, against their plain versions on
the same rays.

This file imports neither jax nor the JAX package, so it runs on a GPU
machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_code_kappa_cuda.py``. Without a GPU every test skips.
The plain versions are held against the JAX package in
``test_torch_code_kappa.py``.

The snapshots (built in memory: the card's Python has no h5py) take a
ninth primitive, kappa = KAPPA_SCALE * pgas / rho^gamma_adi of their own
rho and pgas (scripts/mock_athenak.py with_kappa): mock_small.athdf (one
block; trilinear, and the nearest cell), mock_amr.athdf (two refinement
levels; clamped to the block, and exact interblock sampling), the FMKS
torus of scripts/mock_iharm3d_datasets.py on mock_small.athdf's grid, and
an AthenaK file of scripts/mock_athenak.write_blocks with its own kappa
column read through load_athenak's kappa slot (21 blocks on two levels;
clamped to the block, and interblock). Cameras: golden_sim_rk4_32.input
(golden_polarized_rk4_32.input, golden_plasma_mix_rk4_32.input) with 400
steps of 0.04 at 16^2 (polarized 8^2). Gates, chip_smoke.py's: rk4 in
float64 exact (flags, sample counts and NaN sets equal, rtol 1e-9); dp
and float32 the statistical gate of bench.py:181-186; the phase kernel's
second phase exact in float64; the phased route bit for bit the
monolithic image; the polarized route in float64: I, Q and U within
1e-9 relative over a floor of 1e-4 of each channel's peak (at least 1e-8
of I's), as the FMKS, AthenaK and mixture tests hold theirs, and at the
nearest cell within 1e-7, the gate of the thermal route's test of that
mode (test_torch_polarized_kernel_cuda.py _compare); V within 5e-5 and
|delta V| within 1e-9 of I's peak. The nearest cell's Q and U sit at the
route's own conditioning there: one ulp more theta_e at every sample
moves the plain version's own Q by 7.1e-9 and U by 1.1e-8 in that
reading, in both temperature models (scripts/polarized_conditioning.py),
and the card read 6.4e-9 for Q.
"""

import copy
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from blacklight_tpu_torch import RayIntegrator, read_config
from blacklight_tpu_torch import pipeline_simulation
from blacklight_tpu_torch.constants import (
    Coordinates,
    PlasmaModel,
    SimulationFormat,
)
from blacklight_tpu_torch.grid.amr import with_amr_table
from blacklight_tpu_torch.grid.athena import load_athdf
from blacklight_tpu_torch.grid.athenak import load_athenak
from blacklight_tpu_torch.grid.iharm3d import iharm3d_grid
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
POLARIZED = "golden_polarized_rk4_32.input"
MIXTURE = "golden_plasma_mix_rk4_32.input"
STOKES = ("I_nu", "Q_nu", "U_nu", "V_nu")
FMKS_GRID = dict(n_r=64, n_th=32, n_ph=32, r_min=1.916, r_max=52.2)
ATHENAK_LAYOUT = dict(root=2, cells=12, refine=[(1, 1, 1), (0, 1, 1)],
                      kappa_scale=mock_athenak.KAPPA_SCALE)
# case -> (snapshot, overrides, the kernel mode it takes)
LAYOUTS = {
    "single": ("athena", {}, 0),
    "nearest": ("athena", {"simulation_interp": False}, 1),
    "blocks": ("amr", {}, 1),
    "interblock": ("amr", {"simulation_block_interp": True}, 2),
    "fmks": ("fmks", {}, 3),
    "cks_blocks": ("athenak", {}, sk.CKS_BLOCKS),
    "cks_interblock": ("athenak", {"simulation_block_interp": True},
                       sk.CKS_INTERBLOCK),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return torch.device("cuda")


def with_kappa(grid):
    return mock_athenak.with_kappa(grid, gen.DEFAULTS["gamma_adi"])


_GRIDS = {}


def _grid(snapshot, dtype, cfg, tmp):
    key = (snapshot, dtype)
    if key in _GRIDS:
        return _GRIDS[key]
    device = torch.device("cuda")
    if snapshot == "athena":
        grid = with_kappa(load_athdf(str(FIXTURES / "mock_small.athdf"),
                                     device=device, dtype=dtype))
    elif snapshot == "amr":
        grid = with_kappa(with_amr_table(load_athdf(
            str(FIXTURES / "mock_amr.athdf"), device=device, dtype=dtype)))
    elif snapshot == "fmks":
        from mock_iharm3d_datasets import record_datasets
        p = dict(gen.DEFAULTS, **FMKS_GRID)
        datasets = record_datasets(gen.write_iharm3d_fmks,
                                   gen.make_fields(p), p)
        # the recorded datasets have no kappa slot: built as a thermal
        # snapshot, the slot added in memory
        thermal = copy.copy(cfg)
        thermal.plasma_model = PlasmaModel.ti_te_beta
        grid = with_kappa(iharm3d_grid(datasets, thermal, device=device,
                                       dtype=dtype))
    else:
        path = tmp / "athenak.bin"
        if not path.exists():
            mock_athenak.write_blocks(str(path), dict(gen.DEFAULTS),
                                      **ATHENAK_LAYOUT)
        grid = with_amr_table(load_athenak(str(path), "kappa", device=device,
                                           dtype=dtype))
    _GRIDS[key] = grid
    return grid


def _renderer(tmp, layout, name=THERMAL, res=16, precision="float64",
              integrator="rk4", **overrides):
    snapshot, layout_overrides, mode = LAYOUTS[layout]
    cfg = read_config(str(FIXTURES / name))
    settings = dict(camera_resolution=res, ray_step=0.04, ray_max_steps=400,
                    precision=precision,
                    ray_integrator=RayIntegrator(integrator),
                    plasma_model=PlasmaModel.code_kappa,
                    simulation_kappa_name="kappa")
    settings.update(**layout_overrides, **overrides)
    if snapshot == "fmks":
        settings.update(simulation_format=SimulationFormat.iharm3d,
                        simulation_coord=Coordinates.fmks)
    elif snapshot == "athenak":
        settings.update(simulation_format=SimulationFormat.athenak,
                        simulation_coord=Coordinates.cks, fallback_nan=False,
                        fallback_rho=1.0e-8, fallback_pgas=1.0e-10)
    for key, value in settings.items():
        setattr(cfg, key, value)
    dtype = torch.float32 if precision == "float32" else torch.float64
    grid = _grid(snapshot, dtype, cfg, tmp)
    render_fn, geom, rays, _, _ = \
        pipeline_simulation.make_simulation_renderer(cfg, device="cuda",
                                                     grid=grid)
    sp = render_fn.kernel_args[2]
    assert sp.sampler.has_kappa and sk.is_mixture(sp.plasma)
    assert sk.kernel_mode(render_fn.kernel_args[3], sp.sampler) == mode
    args = (rays.positions, rays.directions, rays.momentum_factors,
            *render_fn.kernel_args)
    return args, render_fn.kernel_kwargs, geom, mode


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("code_kappa_cuda")


def statistical_gate(a, b):
    """bench.py:181-186: identical NaN sets, fewer than 0.5 % of pixels
    past 1e-3 relative (with a floor of 1e-6 of the peak), flux within
    1e-3."""
    rel = np.abs(a - b) / (np.abs(b) + np.nanmax(np.abs(b)) * 1e-6)
    return (np.array_equal(np.isnan(a), np.isnan(b))
            and np.mean(np.nan_to_num(rel) > 1e-3) < 5e-3
            and abs(np.nansum(a) - np.nansum(b)) < 1e-3 * abs(np.nansum(b)))


def _assert_exact(out_k, out_p, rtol=1e-9):
    (ik, fk, nk), (ip, fp, np_) = out_k, out_p
    a, b = ik.cpu().numpy(), ip.cpu().numpy()
    assert torch.equal(fk.cpu(), fp.cpu())
    assert torch.equal(nk.cpu(), np_.cpu())
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.nanmax(b) > 0.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0.0, equal_nan=True)


def _launched(counts, mode, fn, launches=1):
    """fn's result; it must launch the code_kappa kernel of ``mode``
    ``launches`` times and no other mode's."""
    before = list(counts)
    out = fn()
    assert [c - b for c, b in zip(counts, before)] == [
        launches if m == mode else 0 for m in range(len(counts))]
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_simulation_kernel_rk4_float64_exact(cuda_device, tmp, layout):
    args, kwargs, _, mode = _renderer(tmp, layout)
    out_k = _launched(sk.CODE_KAPPA_MODE_LAUNCHES, mode,
                      lambda: sk.render_simulation(*args, **kwargs))
    _assert_exact(out_k, sk.render_simulation_reference(*args, **kwargs))


@pytest.mark.parametrize("layout,integrator", [("single", "dp"),
                                               ("interblock", "rk4"),
                                               ("cks_interblock", "rk2")])
def test_simulation_kernel_float32_statistical(cuda_device, tmp, layout,
                                               integrator):
    args, kwargs, _, mode = _renderer(tmp, layout, precision="float32",
                                      integrator=integrator)
    out_k = _launched(sk.CODE_KAPPA_MODE_LAUNCHES, mode,
                      lambda: sk.render_simulation(*args, **kwargs))
    out_p = sk.render_simulation_reference(*args, **kwargs)
    a, b = out_k[0].cpu().numpy(), out_p[0].cpu().numpy()
    assert np.nanmax(b) > 0.0 and statistical_gate(a, b)


def test_mixture_at_the_code_kappa_temperature(cuda_device, tmp):
    """Thermal, power-law and kappa electrons with the code_kappa
    temperature: rk4 float64 exact."""
    args, kwargs, _, mode = _renderer(tmp, "single", name=MIXTURE)
    assert args[5].plasma.power_frac and args[5].plasma.kappa_frac
    out_k = _launched(sk.CODE_KAPPA_MODE_LAUNCHES, mode,
                      lambda: sk.render_simulation(*args, **kwargs))
    _assert_exact(out_k, sk.render_simulation_reference(*args, **kwargs))


@pytest.mark.parametrize("layout", ["single", "interblock", "fmks",
                                    "cks_interblock"])
def test_phase_kernel_second_phase_exact(cuda_device, tmp, layout):
    """The phase kernel's second phase of 200 steps from the kernel's
    carried state after the first, against its plain version."""
    args, _, _, mode = _renderer(tmp, layout)
    positions, directions, mom, freqs, params, sp, grid, mass, cam, log_js \
        = args
    carry = sk.initial_carry(positions, directions, params, freqs.shape[0])
    index = torch.arange(positions.shape[0], dtype=torch.int32,
                         device=positions.device)
    phase = (directions, mom, freqs, params, sp, grid, mass, cam, "rk4")
    sk.render_simulation_phase(carry, index, 0, 200, *phase)
    index = index[(carry.masks[index.long()] & sk.ALIVE) != 0]
    assert index.numel()
    plain = sk.SimCarry(*(t.clone() for t in carry))
    _launched(sk.PHASE_CODE_KAPPA_MODE_LAUNCHES, mode,
              lambda: sk.render_simulation_phase(carry, index, 200, 200,
                                                 *phase))
    sk.render_simulation_phase_reference(plain, index, 200, 200, *phase)
    _assert_exact(sk.finish_rays(carry, index, freqs, log_js, True),
                  sk.finish_rays(plain, index, freqs, log_js, True))


def test_phased_route_is_the_monolithic_image(cuda_device, tmp):
    args, kwargs, _, _ = _renderer(tmp, "single", precision="float32",
                                   res=32, ray_max_steps=600)
    mono = sk.render_simulation(*args, **kwargs)
    phased = _launched(
        sk.PHASE_CODE_KAPPA_MODE_LAUNCHES, 0,
        lambda: sk.render_simulation_phased(*args, **kwargs,
                                            phase_steps=300), launches=2)
    for a, b in zip(mono, phased):
        assert torch.equal(a, b) or (a.dtype.is_floating_point and bool(
            ((a == b) | (torch.isnan(a) & torch.isnan(b))).all()))


def _stokes(out, args, geom):
    nn_re, nn_im, flags, _, bad = out
    image = pk.poisoned_stokes(nn_re, nn_im, flags, bad, args[0], args[1],
                               args[3], args[4], geom, args[-1], True)
    return {k: v.cpu().numpy() for k, v in image.items()}


# I, Q and U's gate of the polarized route in float64, by layout
IQU_RTOL = {"single": 1e-9, "nearest": 1e-7, "cks_interblock": 1e-9}


@pytest.mark.parametrize("layout", sorted(IQU_RTOL))
def test_polarized_route_float64(cuda_device, tmp, layout):
    args, kwargs, geom, mode = _renderer(tmp, layout, name=POLARIZED, res=8,
                                         image_rotation_split=False)
    before = list(pk.DERIVE_CODE_KAPPA_MODE_LAUNCHES)
    ours = _stokes(pk.render_polarized(*args, **kwargs), args, geom)
    assert pk.DERIVE_CODE_KAPPA_MODE_LAUNCHES[mode] > before[mode]
    ref = _stokes(pk.render_polarized_reference(*args, **kwargs), args,
                  geom)
    i_scale = np.nanmax(np.abs(ref["I_nu"]))
    assert i_scale > 0.0
    for name in STOKES:
        a, b = ours[name], ref[name]
        assert np.array_equal(np.isnan(a), np.isnan(b)), name
        floor = max(np.nanmax(np.abs(b)) * 1e-4, i_scale * 1e-8)
        rel = np.abs(a - b) / (np.abs(b) + floor)
        assert np.nanmax(rel) <= (5e-5 if name == "V_nu" else IQU_RTOL[
            layout]), (name, np.nanmax(rel))
    assert np.nanmax(np.abs(ours["V_nu"] - ref["V_nu"])) <= 1e-9 * i_scale
