"""PyTorch port: the CUDA simulation kernel against its plain PyTorch
version, on the card.

This file imports neither jax nor the JAX package, so it runs on a GPU
machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_simulation_kernel_cuda.py``. Without a GPU every test
skips. The plain version itself is held against the JAX package in
``test_torch_simulation_pipeline.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

from blacklight_tpu_torch.constants import FrequencySpacing
from blacklight_tpu_torch import RayIntegrator, pipeline, read_config
from blacklight_tpu_torch import pipeline_simulation
from blacklight_tpu_torch.grid.athena import simulation_grid
from blacklight_tpu_torch.pipeline_simulation import make_simulation_renderer
from blacklight_tpu_torch.ops import simulation_kernel as sk

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
INPUT = FIXTURES / "golden_sim_rk4_32.input"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return torch.device("cuda")


def _config(res=16, **overrides):
    cfg = read_config(str(INPUT))
    cfg.simulation_file = str(FIXTURES / "mock_small.athdf")
    cfg.camera_resolution = res
    for key, value in overrides.items():
        setattr(cfg, key, value)
    return cfg


def _args(integrator, precision, **overrides):
    """Rays and arguments for render_simulation on the card: the rk4
    simulation golden input at 16^2 with its full step budget. Off-grid
    samples poison pixels (fallback_nan) only where the comparison is
    exact; a dp or float32 ray may step off the grid where its plain
    twin does not."""
    exact = integrator != "dp" and precision == "float64"
    cfg = _config(ray_integrator=RayIntegrator(integrator),
                  precision=precision, fallback_nan=exact, **overrides)
    render_fn, geom, rays, freqs, _ = make_simulation_renderer(
        cfg, device="cuda")
    args = (rays.positions, rays.directions, rays.momentum_factors,
            *render_fn.kernel_args)
    return args, {"integrator": integrator}, exact


def _statistical_gate(a, b):
    """bench.py:181-186: identical NaN sets, fewer than 0.5% of pixels past
    1e-3 relative, total flux within 1e-3."""
    rel = np.abs(a - b) / (np.abs(b) + np.nanmax(np.abs(b)) * 1e-6)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.mean(np.nan_to_num(rel) > 1e-3) < 5e-3
    assert abs(np.nansum(a) - np.nansum(b)) < 1e-3 * abs(np.nansum(b))


def _compare(args, kwargs, exact, launches):
    before = sk.LAUNCHES
    i_k, f_k, n_k = sk.render_simulation(*args, **kwargs)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == before + launches
    i_p, f_p, n_p = sk.render_simulation_reference(*args, **kwargs)
    assert sk.LAUNCHES == before + launches
    assert i_k.dtype == args[0].dtype and i_k.shape == i_p.shape
    a, b = i_k.cpu().numpy(), i_p.cpu().numpy()
    assert np.nanmax(b) > 0.0
    if exact:
        assert torch.equal(f_k, f_p) and torch.equal(n_k, n_p)
        assert np.array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=0.0)
    else:
        for f in range(a.shape[1]):
            _statistical_gate(a[:, f], b[:, f])


@pytest.mark.parametrize("precision", ["float32", "float64"])
@pytest.mark.parametrize("integrator", ["dp", "rk4", "rk2"])
def test_kernel_matches_plain(cuda_device, integrator, precision):
    """rk4 and rk2 in float64 round alike on both sides (no multiply-add
    contraction): flags, n_samples and NaN sets agree exactly, I_nu to
    rtol 1e-7 (the card's pow and transcendentals are not torch's). dp and
    float32 are held to the statistical gate of bench.py."""
    args, kwargs, exact = _args(integrator, precision)
    _compare(args, kwargs, exact, launches=1)


def test_kernel_many_frequencies(cuda_device):
    """20 frequencies: two launches of at most 16, one image."""
    args, kwargs, exact = _args(
        "rk4", "float64", image_num_frequencies=20,
        image_frequency_start=5e10, image_frequency_end=1e12,
        image_frequency_spacing=FrequencySpacing.log)
    assert args[3].shape == (20,)
    _compare(args, kwargs, exact, launches=2)


def test_kernel_rejects_mixed_inputs(cuda_device):
    args, kwargs, _ = _args("rk4", "float64")
    pos, dirs, mom = args[:3]
    with pytest.raises(TypeError):
        sk.render_simulation(pos, dirs.cpu(), mom, *args[3:], **kwargs)
    with pytest.raises(TypeError):
        sk.render_simulation(pos, dirs.float(), mom, *args[3:], **kwargs)
    empty = [t[:0] for t in (pos, dirs, mom)]
    before = sk.LAUNCHES
    i_nu, flags, n_samples = sk.render_simulation(*empty, *args[3:],
                                                  **kwargs)
    assert i_nu.shape == (0, 1) and sk.LAUNCHES == before


def test_pipeline_run_on_cuda(cuda_device, tmp_path):
    cfg = _config(res=8, output_file=str(tmp_path / "out.npz"))
    before = sk.LAUNCHES
    arrays = pipeline.run(cfg, quiet=True, device="cuda")
    assert sk.LAUNCHES == before + 1
    assert arrays["I_nu"].shape == (8, 8)
    assert np.isfinite(np.nanmax(arrays["I_nu"]))
    assert (tmp_path / "out.npz").exists()


def _bits(t):
    """The tensor's bytes, so that NaNs compare equal to NaNs."""
    return t.cpu().contiguous().numpy().tobytes()


@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_bundles_match_the_full_launch(cuda_device, precision):
    """Bundles of 1, 31, 129 and twice the threads the card holds at once,
    and that bundle permuted: each ray's outputs are, bit for bit, those
    it has in the largest launch, whatever its place in the launch (a
    ray's cell search starts from its own previous sample)."""
    args, kwargs, _ = _args("rk4", precision)
    props = torch.cuda.get_device_properties(cuda_device)
    big = 2 * props.multi_processor_count \
        * props.max_threads_per_multi_processor
    reps = -(-big // args[0].shape[0])
    rays = [torch.cat([t] * reps)[:big].contiguous() for t in args[:3]]
    ref = sk.render_simulation(*rays, *args[3:], **kwargs)
    for n in (1, 31, 129):
        out = sk.render_simulation(*(t[:n].contiguous() for t in rays),
                                   *args[3:], **kwargs)
        assert all(_bits(a) == _bits(b[:n]) for a, b in zip(out, ref)), n
    perm = torch.randperm(big, generator=torch.Generator().manual_seed(0))
    perm = perm.to(rays[0].device)
    out = sk.render_simulation(*(t[perm].contiguous() for t in rays),
                               *args[3:], **kwargs)
    assert all(_bits(a) == _bits(b[perm]) for a, b in zip(out, ref))


def test_launch_consts_size_on_both_sides(cuda_device):
    """sizeof(SimLaunchConsts) per type and frequency bucket, from the
    library, is what launch_consts packs."""
    assert sk.consts_sizes(sk._library()) == sk.host_consts_sizes()


def phi_blocks(grid, n):
    """``grid`` (one block) split into ``n`` mesh blocks along phi, with
    the logical locations and levels Athena++ gives them (as
    write_athena(..., phi_blocks=n) lays a file out)."""
    nvar, _, n_k, n_j, n_i = grid.prim.shape
    m = n_k // n
    prim = grid.prim[:, 0].reshape(nvar, n, m, n_j, n_i)
    x3f = torch.stack([grid.x3f[0, b * m:(b + 1) * m + 1] for b in range(n)])
    x3v = grid.x3v[0].reshape(n, m)
    rows = [grid.x1f[0], grid.x1v[0], grid.x2f[0], grid.x2v[0]]
    rows = [r.expand(n, -1).cpu() for r in rows]
    locations = np.zeros((n, 3), np.int64)
    locations[:, 2] = np.arange(n)
    return simulation_grid(
        prim.cpu(), rows[0], rows[1], rows[2], rows[3], x3f.cpu(),
        x3v.cpu(), grid.ind, grid.time, device=grid.prim.device,
        dtype=grid.x1f.dtype, levels=np.zeros(n, np.int32),
        locations=locations, n3_root=n_k)


# mode -> (snapshot, overrides, split into 4 phi blocks)
MODES = {
    "amr_interblock": ("mock_amr.athdf",
                       {"simulation_block_interp": True}, False),
    "amr_blocks": ("mock_amr.athdf", {}, False),
    "four_blocks_nearest": ("mock_small.athdf",
                            {"simulation_interp": False}, True),
    "nearest": ("mock_small.athdf", {"simulation_interp": False}, False),
}


def mode_args(mode, integrator, precision, res=16, **overrides):
    """render_simulation's arguments on the card for a sampling mode of
    MODES; fallback_nan where the comparison is exact, as _args."""
    snapshot, mode_overrides, split = MODES[mode]
    exact = integrator != "dp" and precision == "float64"
    cfg = _config(res=res, ray_integrator=RayIntegrator(integrator),
                  precision=precision, fallback_nan=exact,
                  simulation_file=str(FIXTURES / snapshot),
                  **mode_overrides, **overrides)
    grid = None
    if split:
        grid = phi_blocks(pipeline_simulation.load_grid(
            cfg, device="cuda", dtype=torch.float64 if precision == "float64"
            else torch.float32), 4)
    render_fn, geom, rays, freqs, _ = make_simulation_renderer(
        cfg, device="cuda", grid=grid)
    args = (rays.positions, rays.directions, rays.momentum_factors,
            *render_fn.kernel_args)
    return args, {"integrator": integrator}, exact


@pytest.mark.parametrize("integrator,precision", [
    ("rk4", "float64"), ("rk2", "float64"), ("rk4", "float32"),
    ("dp", "float32")])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_kernel_matches_plain(cuda_device, mode, integrator,
                                   precision):
    """The kernels of many blocks, exact interblock sampling and the
    nearest cell against the plain version: rk4 and rk2 in float64 exact
    in flags, n_samples and NaN sets and I_nu to rtol 1e-7; float32 and
    dp the statistical gate."""
    args, kwargs, exact = mode_args(mode, integrator, precision)
    kgrid = sk.kernel_grid(args[6], args[0].dtype, args[5].sampler)
    assert kgrid.mode != sk.SINGLE
    _compare(args, kwargs, exact, launches=1)


def test_mode_kernel_many_frequencies(cuda_device):
    """20 frequencies on mock_amr with interblock sampling: two launches."""
    args, kwargs, exact = mode_args(
        "amr_interblock", "rk4", "float64", image_num_frequencies=20,
        image_frequency_start=5e10, image_frequency_end=1e12,
        image_frequency_spacing=FrequencySpacing.log)
    _compare(args, kwargs, exact, launches=2)


def test_pipeline_run_mesh_blocks_on_cuda(cuda_device, tmp_path):
    """pipeline.run on the card reads mock_amr.athdf and renders it with
    interblock sampling through the kernel."""
    cfg = _config(res=8, output_file=str(tmp_path / "out.npz"),
                  simulation_file=str(FIXTURES / "mock_amr.athdf"),
                  simulation_block_interp=True)
    before = sk.LAUNCHES
    arrays = pipeline.run(cfg, quiet=True, device="cuda")
    assert sk.LAUNCHES == before + 1
    assert np.isfinite(np.nanmax(arrays["I_nu"]))
