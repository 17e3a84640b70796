"""PyTorch port: the CUDA polarized route (three kernels) against its
plain PyTorch version, on the card.

This file imports neither jax nor the JAX package, so it runs on a GPU
machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_polarized_kernel_cuda.py``. Without a GPU every test
skips. The plain version itself is held against the JAX package in
``test_torch_polarized_pipeline.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

from blacklight_tpu_torch import RayIntegrator, pipeline, read_config
from blacklight_tpu_torch.constants import FrequencySpacing
from blacklight_tpu_torch.ops import polarized_kernel as pk
from blacklight_tpu_torch.pipeline_simulation import make_simulation_renderer

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
INPUT = FIXTURES / "golden_polarized_rk4_32.input"
STOKES = ("I_nu", "Q_nu", "U_nu", "V_nu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return torch.device("cuda")


def _config(res=16, **overrides):
    """The rk4 polarized golden input at res^2 with 400 steps of 0.04."""
    cfg = read_config(str(INPUT))
    cfg.simulation_file = str(FIXTURES / "mock_small.athdf")
    cfg.camera_resolution = res
    cfg.ray_step = 0.04
    cfg.ray_max_steps = 400
    for key, value in overrides.items():
        setattr(cfg, key, value)
    return cfg


def _args(integrator, precision, **overrides):
    cfg = _config(ray_integrator=RayIntegrator(integrator),
                  precision=precision, **overrides)
    render_fn, geom, rays, _, _ = make_simulation_renderer(cfg, device="cuda")
    args = (rays.positions, rays.directions, rays.momentum_factors,
            *render_fn.kernel_args)
    return args, dict(render_fn.kernel_kwargs), geom


def _stokes(out, args, geom):
    nn_re, nn_im, flags, _, bad = out
    image = pk.poisoned_stokes(nn_re, nn_im, flags, bad, args[0], args[1],
                               args[3], args[4], geom, args[-1], True)
    return {k: v.cpu().numpy() for k, v in image.items()}


def _compare(args, kwargs, geom, exact, launches):
    """``launches``: the route's kernel launches for the bundle (trace,
    then derive and chain per frequency group of MAX_FREQUENCIES)."""
    before = pk.LAUNCHES
    out_k = pk.render_polarized(*args, **kwargs)
    torch.cuda.synchronize()
    assert pk.LAUNCHES == before + launches
    out_p = pk.render_polarized_reference(*args, **kwargs)
    assert pk.LAUNCHES == before + launches
    for k_, p_ in zip(out_k, out_p):
        assert k_.shape == p_.shape and k_.dtype == p_.dtype
    ours, ref = _stokes(out_k, args, geom), _stokes(out_p, args, geom)
    i_scale = np.nanmax(np.abs(ref["I_nu"]))
    assert i_scale > 0.0
    for k in STOKES:
        assert np.array_equal(np.isnan(ours[k]), np.isnan(ref[k])), k
    if exact:
        assert torch.equal(out_k[2], out_p[2]) and torch.equal(out_k[3],
                                                               out_p[3])
        # V: the Faraday rotation amplifies the card's rounding of its
        # transcendentals (chip_smoke.py polarized_gate)
        for k, tol in (("I_nu", 1e-7), ("Q_nu", 1e-7), ("U_nu", 1e-7),
                       ("V_nu", 5e-5)):
            floor = max(np.nanmax(np.abs(ref[k])) * 1e-4, i_scale * 1e-8)
            rel = np.abs(ours[k] - ref[k]) / (np.abs(ref[k]) + floor)
            assert np.nanmax(rel) < tol, (k, np.nanmax(rel))
    else:
        for k in STOKES:
            frac = np.abs(ours[k] - ref[k]) / i_scale
            assert np.nanpercentile(frac, 99.5) < 1e-3, k
            assert np.nanmax(frac) < 1e-2, k


@pytest.mark.parametrize("precision", ["float32", "float64"])
@pytest.mark.parametrize("integrator", ["dp", "rk4", "rk2"])
def test_kernel_matches_plain(cuda_device, integrator, precision):
    """rk4 and rk2 in float64: flags, n_samples and NaN sets agree exactly,
    I, Q, U to rtol 1e-7 with the per-channel floor. dp and float32:
    identical NaN sets, every channel within 1e-2 of I's peak (1e-3 at the
    99.5th percentile)."""
    args, kwargs, geom = _args(integrator, precision)
    exact = integrator != "dp" and precision == "float64"
    _compare(args, kwargs, geom, exact, launches=3)


@pytest.mark.parametrize("rotation_split", [False, True])
def test_kernel_frequencies_and_split(cuda_device, rotation_split):
    """Six frequencies: two groups of at most MAX_FREQUENCIES (one trace,
    two derive and two chain launches), one image; both rotation_split
    regimes."""
    args, kwargs, geom = _args(
        "rk4", "float64", image_num_frequencies=6,
        image_frequency_start=1e11, image_frequency_end=6e11,
        image_frequency_spacing=FrequencySpacing.log,
        image_rotation_split=rotation_split)
    assert args[3].shape == (6,) and kwargs["rotation_split"] is rotation_split
    _compare(args, kwargs, geom, True, launches=5)


def _same_bits(a, b) -> bool:
    if a.is_floating_point():
        view = torch.int32 if a.element_size() == 4 else torch.int64
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


def test_kernel_window_chunks(cuda_device):
    """Byte caps small enough for several trace chunks and record pieces
    give the one-chunk image bit for bit, in float64 and float32."""
    for precision in ("float64", "float32"):
        args, kwargs, _ = _args("rk4", precision)
        one = pk.render_polarized(*args, **kwargs)
        item = args[0].element_size()
        before = dict(pk.STAGE_LAUNCHES)
        several = pk._render_cuda(
            *args, kwargs["integrator"], kwargs["rotation_split"],
            trace_bytes=3 * 32 * 400 * 7 * item,
            record_bytes=pk.record_bytes_per_slot(args[0].dtype, 1) * 600)
        torch.cuda.synchronize()
        traces = pk.STAGE_LAUNCHES["trace"] - before["trace"]
        chains = pk.STAGE_LAUNCHES["chain"] - before["chain"]
        assert traces == 3  # 256 rays, 96 a chunk
        assert chains > traces
        for a, b in zip(several, one):
            assert _same_bits(a, b)


def test_derive_matches_plain(cuda_device):
    """The derive kernel against derive_records_reference on the trace
    kernel's samples: every record value of every stored sample, and the
    bad bits; float64 to rounding, float32 at the rounding of its
    transcendentals."""
    for precision, rtol in (("float64", 1e-9), ("float32", 2e-3)):
        args, kwargs, _ = _args("rk4", precision, image_num_frequencies=2,
                                image_frequency_start=1.5e11,
                                image_frequency_end=4.6e11,
                                image_frequency_spacing=FrequencySpacing.log)
        positions, directions, mom, freqs, params, sp, grid, mass, cam, _ = \
            args
        stages = pk._CudaStages(positions, directions, mom, freqs, params,
                                sp, grid, mass, cam, "rk4", False, None,
                                1 << 30, 1 << 30)
        b = positions.shape[0]
        flags = torch.empty(b, dtype=torch.int32, device="cuda")
        n_samples = torch.empty(b, dtype=torch.int32, device="cuda")
        samples = stages.trace(0, b, flags, n_samples)
        lengths = pk.warp_lengths(n_samples)
        piece = pk.Piece(0, b, samples, n_samples, lengths,
                         pk.record_offsets(lengths), int(lengths.sum()))
        geometry, coefficients, bits = stages.derive(piece, 0, 2, None)
        torch.cuda.synchronize()
        ref = pk.derive_records_reference(
            samples, n_samples, lengths, piece.offsets, directions, mom,
            freqs, 0, 2, params, sp, grid, mass, cam)
        w, t, lane, _ = pk._stored(samples, n_samples, lengths)
        slot = piece.offsets[w] + t
        for ours, plain in ((geometry, ref[0]), (coefficients, ref[1])):
            a, p = ours[slot, :, lane], plain[slot, :, lane]
            scale = p.abs().amax(dim=0).clamp_min(1e-300)
            err = ((a - p).abs() / scale).amax(dim=0)
            assert torch.isfinite(a).all()
            assert float(err.max()) < rtol, (precision, err)
        assert torch.equal(bits, ref[2])


def test_piece_without_samples(cuda_device):
    """A piece whose rays have no stored sample launches no derive kernel
    and is not counted as one; the chain kernel still writes its rays,
    as its plain version does."""
    args, kwargs, _ = _args("rk4", "float32")
    stages = pk._CudaStages(*args[:9], "rk4", False, None, 1 << 30, 1 << 30)
    b = 40
    samples = torch.zeros((pk.n_warps(b), 400, pk.SAMPLE_VALUES, pk.WARP),
                          dtype=torch.float32, device="cuda")
    n_samples = torch.zeros(b, dtype=torch.int32, device="cuda")
    lengths = pk.warp_lengths(n_samples)
    piece = pk.Piece(0, b, samples, n_samples, lengths,
                     pk.record_offsets(lengths), 0)
    before, stage_before = pk.LAUNCHES, dict(pk.STAGE_LAUNCHES)
    geometry, coefficients, bits = stages.derive(piece, 0, 1, None)
    out = stages.chain(piece, geometry, coefficients, 1)
    torch.cuda.synchronize()
    assert pk.LAUNCHES == before + 1
    assert pk.STAGE_LAUNCHES["derive"] == stage_before["derive"]
    assert pk.STAGE_LAUNCHES["chain"] == stage_before["chain"] + 1
    assert geometry.shape[0] == 0 and not bits.any()
    plain = pk.chain_records_reference(samples, n_samples, lengths,
                                       piece.offsets, geometry, coefficients,
                                       1, False)
    assert _same_bits(out, plain)


def test_pipeline_run_on_cuda(cuda_device, tmp_path):
    cfg = _config(res=8, output_file=str(tmp_path / "out.npz"))
    before = pk.LAUNCHES
    arrays = pipeline.run(cfg, quiet=True, device="cuda")
    assert pk.LAUNCHES == before + 3
    for k in STOKES:
        assert arrays[k].shape == (8, 8)
    assert np.isfinite(np.nanmax(arrays["I_nu"]))
    assert (tmp_path / "out.npz").exists()


# sampling modes of many blocks and the nearest cell
MESH_BLOCKS = {
    "amr_interblock": {"simulation_file": str(FIXTURES / "mock_amr.athdf"),
                       "simulation_block_interp": True},
    "amr_nearest": {"simulation_file": str(FIXTURES / "mock_amr.athdf"),
                    "simulation_interp": False},
    "nearest": {"simulation_interp": False},
}


@pytest.mark.parametrize("integrator,precision", [("rk4", "float64"),
                                                  ("rk2", "float32")])
@pytest.mark.parametrize("mode", sorted(MESH_BLOCKS))
def test_mesh_blocks_kernel_matches_plain(cuda_device, mode, integrator,
                                          precision):
    """The route with the derive kernel of many blocks or the nearest
    cell, against the plain version, with the gates of
    test_kernel_matches_plain."""
    args, kwargs, geom = _args(integrator, precision, **MESH_BLOCKS[mode])
    _compare(args, kwargs, geom, precision == "float64", launches=3)


def test_mesh_blocks_pipeline_run_on_cuda(cuda_device, tmp_path):
    cfg = _config(res=8, output_file=str(tmp_path / "out.npz"),
                  simulation_file=str(FIXTURES / "mock_amr.athdf"),
                  simulation_block_interp=True)
    before = pk.LAUNCHES
    arrays = pipeline.run(cfg, quiet=True, device="cuda")
    assert pk.LAUNCHES == before + 3
    assert np.isfinite(np.nanmax(arrays["I_nu"]))
