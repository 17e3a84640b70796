"""PyTorch port: what the formula kernel's wrapper hands a launch, checked
on the CPU: the launch constants the host packs (the kernel reads them
from its parameter, in the constant bank), the order the renderer
launches rays in and the size of the persistent grid; and the formula
path against the JAX package at 16^2. The kernel itself is held to its plain
version on the card by test_torch_formula_kernel_cuda.py."""

import numpy as np
import pytest
import torch

from blacklight_tpu import pipeline as jax_pipeline
from blacklight_tpu import read_config as jax_read_config
from blacklight_tpu_torch import pipeline, read_config
from blacklight_tpu_torch.models import formula as formula_model
from blacklight_tpu_torch.ops import formula_kernel as fk

from test_torch_pipeline import _assert_same_npz, _input

torch.set_num_threads(2)

NUMPY = {torch.float32: np.float32, torch.float64: np.float64}
THREE = dict(image_num_frequencies=3, image_frequency_start=1.0e11,
             image_frequency_end=4.0e11, image_frequency_spacing="log")


def _values(tmp_path, nus):
    """kernel_params of a 16^2 formula input (h = 0.4, absorption on, a
    midplane cut) at frequencies ``nus``, and the config."""
    inp = _input(tmp_path / "f.input", tmp_path / "f.npz",
                 cut_midplane_z=2.0)
    cfg = read_config(str(inp))
    cfg.formula_h = 0.4
    cfg.formula_a = 1e5
    render_fn, geom, _, _, mass_msun = pipeline.make_formula_renderer(
        cfg, device="cpu")
    fp = formula_model.formula_params_from_config(cfg)
    values = fk.kernel_params(render_fn.geodesic_params, fp, nus, mass_msun,
                              geom.cam_x.tolist(),
                              formula_model.formula_log_j_scale(fp), True)
    return values, cfg


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nf", [1, 3, 4])
def test_launch_consts_hold_every_field_in_order(tmp_path, dtype, nf):
    """The packed constants are PARAM_NAMES, then FREQUENCY_PARAM_NAMES for
    each frequency of the launch, each the float64 value rounded once to
    the rays' type (bit for bit np.float32(value) or np.float64(value)),
    and zero in the bucket's unused frequency blocks."""
    nus = list(np.geomspace(1e11, 4e11, nf))
    values, cfg = _values(tmp_path, nus)
    packed = fk.launch_consts(values, dtype)
    n_fixed, n_freq = len(fk.PARAM_NAMES), len(fk.FREQUENCY_PARAM_NAMES)
    bucket = 1 if nf == 1 else fk.MAX_FREQUENCIES
    assert packed.dtype == NUMPY[dtype]
    assert packed.shape == (n_fixed + bucket * n_freq,)
    assert len(values) == n_fixed + nf * n_freq
    expected = np.array([NUMPY[dtype](v) for v in values], dtype=NUMPY[dtype])
    bits = np.uint32 if dtype == torch.float32 else np.uint64
    assert np.array_equal(packed[:len(values)].view(bits), expected.view(bits))
    assert not packed[len(values):].any()
    at = dict(zip(fk.PARAM_NAMES, packed))
    assert at["MAX_STEPS"] == cfg.ray_max_steps
    assert at["F_H_SQ"] == NUMPY[dtype](0.4 * 0.4)
    assert at["FALLBACK_NAN"] == 1 and at["CUT_MID_Z_SIGN"] == 1
    for f, nu in enumerate(nus):
        block = dict(zip(fk.FREQUENCY_PARAM_NAMES,
                         packed[n_fixed + f * n_freq:][:n_freq]))
        assert block["NU"] == NUMPY[dtype](nu)
        assert block["I_SCALE"] == NUMPY[dtype](fk.image_scale(
            nu, formula_model.formula_log_j_scale(
                formula_model.formula_params_from_config(cfg))))


def test_launch_consts_sizes_and_buckets():
    """Each type and bucket packs (PARAM_NAMES + bucket blocks) values of
    the type; a launch takes 1..MAX_FREQUENCIES frequencies."""
    sizes = fk.host_consts_sizes()
    for (dtype, bucket), size in sizes.items():
        n = len(fk.PARAM_NAMES) + bucket * len(fk.FREQUENCY_PARAM_NAMES)
        assert size == n * torch.empty((), dtype=dtype).element_size()
    assert [fk.frequency_bucket(n) for n in (1, 2, 3, 4)] == [1, 4, 4, 4]
    for nf in (0, fk.MAX_FREQUENCIES + 1):
        with pytest.raises(ValueError):
            fk.frequency_bucket(nf)
    with pytest.raises(ValueError):
        fk.launch_consts([0.0] * (len(fk.PARAM_NAMES) + 1), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [0, 1, 31, 129, 256, 1000])
def test_launch_order_is_a_permutation(dtype, b):
    """The order the formula renderer launches a bundle in is None (as
    given) for float32 and for fewer than two rays, else a permutation of
    range(B) in int64 on the rays' device, for ragged bundles too."""
    gen = np.random.default_rng(b)
    positions = torch.from_numpy(gen.normal(size=(b, 4))).to(dtype)
    order = pipeline.formula_launch_order(positions)
    if dtype == torch.float32 or b < 2:
        assert order is None
        return
    assert order.dtype == torch.int64 and order.shape == (b,)
    assert order.device == positions.device
    assert torch.equal(torch.sort(order).values, torch.arange(b))


@pytest.mark.parametrize("integrator", ["rk4", "rk2"])
def test_renderer_returns_the_callers_order(tmp_path, integrator):
    """A float64 bundle launched in spatial_order comes back in the
    caller's order: the renderer's outputs equal render_formula's on the
    rays as given, bit for bit (each ray's arithmetic is its own)."""
    inp = _input(tmp_path / "f.input", tmp_path / "f.npz",
                 ray_integrator=integrator)
    cfg = read_config(str(inp))
    render_fn, geom, rays, freqs, mass_msun = pipeline.make_formula_renderer(
        cfg, device="cpu")
    assert rays.positions.dtype == torch.float64
    order = pipeline.formula_launch_order(rays.positions)
    assert not torch.equal(order, torch.arange(order.numel()))
    out = render_fn(rays.positions, rays.directions, rays.momentum_factors)
    fp = formula_model.formula_params_from_config(cfg)
    ref = fk.render_formula(
        rays.positions, rays.directions, rays.momentum_factors,
        freqs.tolist(), render_fn.geodesic_params, fp, mass_msun,
        geom.cam_x.tolist(), formula_model.formula_log_j_scale(fp),
        fallback_nan=cfg.require("fallback_nan"), integrator=integrator)
    for got, want in zip((out["I_nu"], out["_flags"], out["_n_samples"]),
                         ref):
        assert got.dtype == want.dtype
        assert np.array_equal(got.numpy(), want.numpy(), equal_nan=True)


@pytest.mark.parametrize("b", [0, 1, 31, 129, 128 * 528 + 1, 1024 * 1024])
@pytest.mark.parametrize("resident", [1, 4, 528])
def test_persistent_grid_never_exceeds_what_the_bundle_needs(b, resident):
    """The grid is the resident blocks, or the blocks the rays fill if
    fewer: never a block without a ray of its own, none for no rays."""
    grid = fk.persistent_grid(b, resident)
    needed = -(-b // fk.THREADS)
    assert grid == min(resident, needed)
    assert grid <= needed and grid <= resident
    assert (grid >= 1) == (b > 0)
    if b:
        assert (grid - 1) * fk.THREADS < b


@pytest.mark.parametrize("integrator,frequencies", [("rk4", 1), ("rk2", 3)])
def test_formula_path_matches_jax_at_16(tmp_path, integrator, frequencies):
    """pipeline.run on the CPU (float64 bundles in spatial_order) writes
    the JAX run's npz at 16^2, float64, rtol 1e-8: one frequency in rk4,
    three in rk2."""
    lines = dict(ray_integrator=integrator)
    if frequencies > 1:
        lines.update(THREE)
    inp = _input(tmp_path / "ref.input", tmp_path / "jax.npz", **lines)
    ref = jax_pipeline.run(jax_read_config(str(inp)), quiet=True)
    cfg = read_config(str(inp))
    cfg.output_file = str(tmp_path / "torch.npz")
    before = fk.PLAIN_CALLS
    arrays = pipeline.run(cfg, quiet=True, device="cpu")
    assert fk.PLAIN_CALLS == before + 1
    assert np.all(np.nanmax(arrays["I_nu"].reshape(frequencies, -1),
                            axis=1) > 0.0)
    _assert_same_npz(arrays, ref)
