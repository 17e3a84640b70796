"""PyTorch port: the CUDA formula kernel against its plain PyTorch version,
on the card.

This file imports neither jax nor the JAX package, so it runs on a GPU
machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_formula_kernel_cuda.py``. Without a GPU every test skips.
The plain version itself is held against the JAX package in
``test_torch_formula_kernel.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

from blacklight_tpu_torch import RayIntegrator, pipeline, read_config
from blacklight_tpu_torch.models import formula as formula_model
from blacklight_tpu_torch.ops import formula_kernel as fk

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

INPUT = pathlib.Path(__file__).parent / "fixtures" / "golden_formula_32.input"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return torch.device("cuda")


def _args(integrator, precision):
    """Rays and arguments for render_formula on the card: the golden
    formula input at 16^2 with its full step budget. 256 rays let the
    statistical gate's 0.5 % admit one pixel; a dp ray cut short by a step
    limit ends wherever its own step sequence reached, which that gate
    cannot compare."""
    cfg = read_config(str(INPUT))
    cfg.camera_resolution = 16
    cfg.ray_integrator = RayIntegrator(integrator)
    cfg.precision = precision
    cfg.fallback_nan = False
    render_fn, geom, rays, freqs, mass_msun = pipeline.make_formula_renderer(
        cfg, device="cuda")
    fp = formula_model.formula_params_from_config(cfg)
    args = (rays.positions, rays.directions, rays.momentum_factors,
            float(freqs[0]), render_fn.geodesic_params, fp, mass_msun,
            geom.cam_x.tolist(), formula_model.formula_log_j_scale(fp))
    return args, dict(fallback_nan=False, integrator=integrator)


def _statistical_gate(a, b):
    """bench.py:181-186: identical NaN sets, fewer than 0.5% of pixels past
    1e-3 relative, total flux within 1e-3."""
    rel = np.abs(a - b) / (np.abs(b) + np.nanmax(np.abs(b)) * 1e-6)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.mean(np.nan_to_num(rel) > 1e-3) < 5e-3
    assert abs(np.nansum(a) - np.nansum(b)) < 1e-3 * abs(np.nansum(b))


@pytest.mark.parametrize("precision", ["float32", "float64"])
@pytest.mark.parametrize("integrator", ["dp", "rk4", "rk2"])
def test_kernel_matches_plain(cuda_device, integrator, precision):
    """rk4 and rk2 in float64 round alike on both sides: flags, n_samples
    and NaN sets agree exactly, I_nu to rtol 1e-9. dp and every float32
    case are held to the statistical gate of bench.py, since chaotic
    photon-ring rays and dp accept/reject decisions amplify one-ulp
    differences."""
    args, kwargs = _args(integrator, precision)
    before = fk.LAUNCHES
    i_k, f_k, n_k = fk.render_formula(*args, **kwargs)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == before + 1
    i_p, f_p, n_p = fk.render_formula_reference(*args, **kwargs)
    assert fk.LAUNCHES == before + 1
    assert i_k.dtype == args[0].dtype and i_k.shape == (256, 1)
    a, b = i_k[:, 0].cpu().numpy(), i_p[:, 0].cpu().numpy()
    assert np.nanmax(b) > 0.0
    if integrator != "dp" and precision == "float64":
        assert torch.equal(f_k, f_p) and torch.equal(n_k, n_p)
        assert np.array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=0.0)
    else:
        _statistical_gate(a, b)


def test_kernel_rejects_mixed_inputs(cuda_device):
    args, kwargs = _args("rk4", "float64")
    pos, dirs, mom = args[:3]
    with pytest.raises(TypeError):
        fk.render_formula(pos, dirs.cpu(), mom, *args[3:], **kwargs)
    with pytest.raises(TypeError):
        fk.render_formula(pos, dirs.float(), mom, *args[3:], **kwargs)
    empty = [t[:0] for t in (pos, dirs, mom)]
    before = fk.LAUNCHES
    i_nu, flags, n_samples = fk.render_formula(*empty, *args[3:], **kwargs)
    assert i_nu.shape == (0, 1) and fk.LAUNCHES == before


def test_pipeline_run_on_cuda(cuda_device, tmp_path):
    cfg = read_config(str(INPUT))
    cfg.camera_resolution = 8
    cfg.ray_integrator = RayIntegrator.rk4
    cfg.output_file = str(tmp_path / "out.npz")
    before = fk.LAUNCHES
    arrays = pipeline.run(cfg, quiet=True, device="cuda")
    assert fk.LAUNCHES == before + 1
    assert arrays["I_nu"].shape == (8, 8)
    assert np.isfinite(np.nanmax(arrays["I_nu"]))
    assert (tmp_path / "out.npz").exists()
