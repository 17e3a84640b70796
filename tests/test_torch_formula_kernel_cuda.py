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
from blacklight_tpu_torch.ops import formula_fit
from blacklight_tpu_torch.ops import formula_kernel as fk
from blacklight_tpu_torch.ops.simulation_kernel import spatial_order

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

INPUT = pathlib.Path(__file__).parent / "fixtures" / "golden_formula_32.input"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return torch.device("cuda")


# K1.3/K1.4 cases: three frequencies log-spaced over 100-400 GHz (the
# ones tests/test_pallas_kernel.py:78-82 uses), tangents for every
# parameter, h = 0.4 (h = 0 zeroes the h tangent) and absorption on
# (formula_a = 1e5 gives optical depths of order one on these rays), so
# that every branch of the tangent update runs.
FREQUENCIES = dict(image_num_frequencies=3, image_frequency_start=1e11,
                   image_frequency_end=4e11, image_frequency_spacing="log")
TANGENT_PARAMS = dict(formula_h=0.4, formula_a=1e5)


def _args(integrator, precision, **overrides):
    """Rays and arguments for render_formula on the card: the golden
    formula input at 16^2 with its full step budget. 256 rays let the
    statistical gate's 0.5 % admit one pixel; a dp ray cut short by a step
    limit ends wherever its own step sequence reached, which that gate
    cannot compare."""
    from blacklight_tpu_torch.constants import FrequencySpacing
    cfg = read_config(str(INPUT))
    cfg.camera_resolution = 16
    cfg.ray_integrator = RayIntegrator(integrator)
    cfg.precision = precision
    cfg.fallback_nan = False
    for key, value in overrides.items():
        if key == "image_frequency_spacing":
            value = FrequencySpacing(value)
        setattr(cfg, key, value)
    render_fn, geom, rays, freqs, mass_msun = pipeline.make_formula_renderer(
        cfg, device="cuda")
    fp = formula_model.formula_params_from_config(cfg)
    args = (rays.positions, rays.directions, rays.momentum_factors,
            freqs.tolist(), render_fn.geodesic_params, fp, mass_msun,
            geom.cam_x.tolist(), formula_model.formula_log_j_scale(fp))
    return args, dict(fallback_nan=False, integrator=integrator)


def _outputs(out):
    """I_nu, flags, n_samples and every dI/dp of a render_formula output."""
    return [out[0], out[1], out[2], *(out[3] if len(out) == 4 else [])]


def _same_bits(a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = torch.int32 if a.element_size() == 4 else torch.int64
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


def _resident_threads(args, kwargs):
    """Threads of the card's resident blocks of the instantiation a launch
    with these arguments takes."""
    device = args[0].device
    mask = sum(1 << fk.DIFFABLE_PARAMS.index(p)
               for p in kwargs.get("diff_values") or {})
    with torch.cuda.device(device):
        blocks = fk._resident_blocks(
            device.index, 0 if args[0].dtype == torch.float32 else 1,
            fk.INTEGRATORS.index(kwargs["integrator"]),
            min(len(args[3]), fk.MAX_FREQUENCIES), mask)
    return blocks * fk.THREADS


def _check_bundles(args, kwargs, out):
    """The persistent lanes change no ray's outputs: the first 1, 31 and
    129 of the rays on their own, and the rays repeated past twice the
    card's resident threads (more rays than lanes, so that lanes fetch),
    give the 256-ray launch's outputs bit for bit; a second launch of the
    large bundle gives the first's bit for bit, and the bundle in another
    order (spatial_order's) gives them in that order."""
    rays, rest = args[:3], args[3:]
    ref = _outputs(out)
    for b in (1, 31, 129):
        sub = fk.render_formula(*(t[:b].contiguous() for t in rays), *rest,
                                **kwargs)
        assert all(_same_bits(x, y[:b]) for x, y in zip(_outputs(sub), ref))
    reps = _resident_threads(args, kwargs) * 2 // rays[0].shape[0] + 1
    big = [t.repeat(reps, *([1] * (t.dim() - 1))) for t in rays]
    first = fk.render_formula(*big, *rest, **kwargs)
    for x, y in zip(_outputs(first), ref):
        assert _same_bits(x, y.repeat(reps, *([1] * (y.dim() - 1))))
    again = fk.render_formula(*big, *rest, **kwargs)
    assert all(_same_bits(x, y) for x, y in zip(_outputs(again),
                                                _outputs(first)))
    order = spatial_order(big[0], block=256)
    moved = fk.render_formula(*(t[order] for t in big), *rest, **kwargs)
    assert all(_same_bits(x, y[order]) for x, y in zip(_outputs(moved),
                                                       _outputs(first)))


def _statistical_gate(a, b):
    """bench.py:181-186: identical NaN sets, fewer than 0.5% of pixels past
    1e-3 relative, total flux within 1e-3; for a signed tangent the flux
    is held to 1e-3 of the sum of |b| (the same for a positive image)."""
    rel = np.abs(a - b) / (np.abs(b) + np.nanmax(np.abs(b)) * 1e-6)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.mean(np.nan_to_num(rel) > 1e-3) < 5e-3
    assert abs(np.nansum(a) - np.nansum(b)) <= 1e-3 * np.nansum(np.abs(b))


@pytest.mark.parametrize("precision", ["float32", "float64"])
@pytest.mark.parametrize("integrator", ["dp", "rk4", "rk2"])
def test_kernel_matches_plain(cuda_device, integrator, precision):
    """rk4 and rk2 in float64 round alike on both sides: flags, n_samples
    and NaN sets agree exactly, I_nu to rtol 1e-9. dp and every float32
    case are held to the statistical gate of bench.py, since chaotic
    photon-ring rays and dp accept/reject decisions amplify one-ulp
    differences. Every bundle size gives the same rays' outputs bit for
    bit (_check_bundles)."""
    args, kwargs = _args(integrator, precision)
    before = fk.LAUNCHES
    out = fk.render_formula(*args, **kwargs)
    i_k, f_k, n_k = out
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
    _check_bundles(args, kwargs, out)


ALL_INTEGRATORS_PRECISIONS = [(i, p) for i in ("dp", "rk4", "rk2")
                              for p in ("float32", "float64")]


@pytest.mark.parametrize("integrator,precision", ALL_INTEGRATORS_PRECISIONS)
def test_frequencies_and_tangents_match_plain(cuda_device, integrator,
                                              precision):
    """K1.3 and K1.4: three frequencies with tangents for cn0, r0 and h, at
    chip_smoke.py phase 3's gates: rk4/rk2 float64 identical flags,
    n_samples and NaN sets, I and every dI/dp within rtol 1e-9; otherwise
    the statistical gate per frequency on I and on each dI/dp. Every
    bundle size gives the same rays' outputs bit for bit."""
    _check_variant(integrator, precision, 3, ("cn0", "r0", "h"))


@pytest.mark.parametrize("integrator,precision", ALL_INTEGRATORS_PRECISIONS)
@pytest.mark.parametrize("nf,tangents", [(3, ()), (1, ("cn0", "r0", "h"))])
def test_bucket_variants_match_plain(cuda_device, integrator, precision, nf,
                                     tangents):
    """The two instantiations the tests above leave out, in every type and
    integrator: the larger frequency bucket without tangents, and tangents
    at one frequency; gates as above."""
    _check_variant(integrator, precision, nf, tangents)


def _check_variant(integrator, precision, nf, tangents):
    overrides = dict(TANGENT_PARAMS)
    if nf > 1:
        overrides.update(FREQUENCIES)
    args, kwargs = _args(integrator, precision, **overrides)
    fp = args[5]
    if tangents:
        kwargs["diff_values"] = {p: getattr(fp, p) for p in tangents}
    before = fk.LAUNCHES
    out_k = fk.render_formula(*args, **kwargs)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == before + 1
    out_p = fk.render_formula_reference(*args, **kwargs)
    assert out_k[0].shape == (256, nf)
    assert len(out_k) == (4 if tangents else 3)
    if tangents:
        assert len(out_k[3]) == len(tangents)
    exact = integrator != "dp" and precision == "float64"
    if exact:
        assert torch.equal(out_k[1], out_p[1])
        assert torch.equal(out_k[2], out_p[2])
    planes_k = [out_k[0], *(out_k[3] if tangents else [])]
    planes_p = [out_p[0], *(out_p[3] if tangents else [])]
    for a, b in zip(planes_k, planes_p):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert np.nanmax(np.abs(b)) > 0.0
        for f in range(nf):
            if exact:
                assert np.array_equal(np.isnan(a[:, f]), np.isnan(b[:, f]))
                np.testing.assert_allclose(a[:, f], b[:, f], rtol=1e-9,
                                           atol=0.0)
            else:
                _statistical_gate(a[:, f], b[:, f])
    _check_bundles(args, kwargs, out_k)


def test_launch_consts_size_matches_host_packing(cuda_device):
    """sizeof(FormulaLaunchConsts) on the C side equals the bytes
    launch_consts packs, for each type and frequency bucket."""
    sizes = fk.consts_sizes(fk._library())
    assert sizes == fk.host_consts_sizes()
    assert sizes[torch.float32, 1] == 4 * (len(fk.PARAM_NAMES)
                                           + len(fk.FREQUENCY_PARAM_NAMES))


def test_more_frequencies_than_a_launch(cuda_device):
    """Six frequencies take two launches, each filling its columns; the
    result equals one launch per frequency (float64 rk4)."""
    args, kwargs = _args("rk4", "float64", **TANGENT_PARAMS)
    nus = list(np.geomspace(1e11, 4e11, 6))
    args = (*args[:3], nus, *args[4:])
    kwargs["diff_values"] = {"r0": args[5].r0}
    before = fk.LAUNCHES
    i_all, _, _, (d_all,) = fk.render_formula(*args, **kwargs)
    assert fk.LAUNCHES == before + 2
    for f, nu in enumerate(nus):
        i_one, _, _, (d_one,) = fk.render_formula(
            *args[:3], nu, *args[4:], **kwargs)
        assert torch.equal(i_all[:, f], i_one[:, 0])
        assert torch.equal(d_all[:, f], d_one[:, 0])


def test_fit_renderer_grad_matches_plain(cuda_device, monkeypatch):
    """value_and_grad through the fit renderer (cn0, r0, h; rk4 float64)
    launches the tangent kernel once and agrees with the same renderer
    built on the plain version, on the same rays on the card."""
    args, kwargs = _args("rk4", "float64", **TANGENT_PARAMS)
    positions, directions, mom, nus, params, fp = args[:6]

    def value_and_grad():
        render = formula_fit.make_formula_fit_renderer(
            nus, params, fp, *args[6:], fallback_nan=False,
            integrator="rk4", fit_params=("cn0", "r0", "h"))
        theta = {p: torch.tensor(getattr(fp, p), dtype=torch.float64,
                                 device="cuda", requires_grad=True)
                 for p in ("cn0", "r0", "h")}
        loss = render(theta, positions, directions, mom)[0].sum()
        loss.backward()
        return loss.item(), [theta[p].grad.item() for p in theta]

    before, plain_before = fk.LAUNCHES, fk.PLAIN_CALLS
    val_k, grad_k = value_and_grad()
    assert fk.LAUNCHES == before + 1 and fk.PLAIN_CALLS == plain_before
    monkeypatch.setattr(formula_fit, "render_formula",
                        fk.render_formula_reference)
    val_p, grad_p = value_and_grad()
    assert fk.LAUNCHES == before + 1
    np.testing.assert_allclose(val_k, val_p, rtol=1e-9)
    np.testing.assert_allclose(grad_k, grad_p, rtol=1e-9)
    assert all(g != 0.0 for g in grad_k)


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
    with pytest.raises(ValueError):
        fk.render_formula(pos, dirs, mom, *args[3:], **kwargs,
                          diff_values={"a_param": 1.0})


@pytest.mark.parametrize("num_frequencies", [1, 3])
def test_pipeline_run_on_cuda(cuda_device, tmp_path, num_frequencies):
    from blacklight_tpu_torch.constants import FrequencySpacing
    cfg = read_config(str(INPUT))
    cfg.camera_resolution = 8
    cfg.ray_integrator = RayIntegrator.rk4
    cfg.output_file = str(tmp_path / "out.npz")
    if num_frequencies > 1:
        for key, value in FREQUENCIES.items():
            setattr(cfg, key, value)
        cfg.image_frequency_spacing = FrequencySpacing.log
    before = fk.LAUNCHES
    arrays = pipeline.run(cfg, quiet=True, device="cuda")
    assert fk.LAUNCHES == before + 1
    shape = (8, 8) if num_frequencies == 1 else (num_frequencies, 8, 8)
    assert arrays["I_nu"].shape == shape
    assert np.isfinite(np.nanmax(arrays["I_nu"]))
    assert (tmp_path / "out.npz").exists()
