"""PyTorch port: adaptive image-plane refinement (ROADMAP A.9) of the
simulation model against the JAX package.

``pipeline.run(cfg, device="cpu")`` with adaptive_max_level = 2 against
the JAX package's ``run``, array by array, on write_athena's mock torus
(rk4, float64): the kernel route, the scan route with auxiliary planes,
and a block size whose bundles are a multiple of no warp, each level of
the last also against a straight render of the finer camera; phased
dispatch of the larger levels beside a monolithic root; and a numbered
run of two snapshots through the CLI.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from blacklight_tpu_torch import cli, parse_config, pipeline, pipeline_simulation
from blacklight_tpu_torch.ops import simulation_kernel as sk

from test_torch_adaptive import (_assert_refines, _assert_same_arrays,
                                 _run_both, _sim_text, level_pixels)

torch.set_num_threads(2)

sys.path.insert(0, str(pathlib.Path(__file__).parents[1] / "scripts"))

import generate_mock_simulation as gen  # noqa: E402


@pytest.fixture(scope="module")
def mock(tmp_path_factory):
    """write_athena's mock torus at the generator's defaults (the mock of
    tests/test_reference_goldens.py)."""
    path = tmp_path_factory.mktemp("mock") / "mock.athdf"
    p = dict(gen.DEFAULTS)
    gen.write_athena(str(path), gen.make_fields(p), p)
    return path


def test_simulation_run_matches_jax(tmp_path, mock):
    text = _sim_text(tmp_path / "torch.npz", simulation_file=mock)
    ours, ref, ref_file = _run_both(tmp_path, text)
    _assert_refines(ours)
    _assert_same_arrays(ours, ref)
    _assert_same_arrays(np.load(tmp_path / "torch.npz"), ref_file)


def test_scan_route_run_matches_jax(tmp_path, mock):
    """Auxiliary planes take the scan route at every level: each level's
    planes are held too."""
    text = _sim_text(tmp_path / "torch.npz", simulation_file=mock,
                     image_time="true", image_tau="true",
                     image_crossings="true", output_camera="true")
    render_fn, *_ = pipeline_simulation.make_simulation_renderer(
        parse_config(text), device="cpu")
    assert render_fn.route == "scan"
    ours, ref, _ = _run_both(tmp_path, text)
    _assert_refines(ours)
    for plane in ("time", "tau", "crossings", "positions"):
        assert f"adaptive_{plane}_2" in ours, plane
    _assert_same_arrays(ours, ref)


def test_ragged_bundles(tmp_path, mock):
    """Blocks of 5 on a 20^2 root: bundles of 100 rays a refined parent,
    a multiple of no warp, through spatial_order's tiles of
    KERNEL_ORDER_BLOCK. The run matches the JAX package's (which pads each
    bundle to a power of two of blocks), and each level's pixels are a
    straight render's of the finer camera, bit for bit."""
    text = _sim_text(tmp_path / "torch.npz", simulation_file=mock,
                     camera_resolution=20, adaptive_block_size=5)
    ours, ref, _ = _run_both(tmp_path, text)
    _assert_refines(ours)
    counts = ours["adaptive_num_blocks"]
    assert all(n * 25 % 32 for n in counts[1:]), counts
    _assert_same_arrays(ours, ref)
    for level in (1, 2):
        cfg = parse_config(_sim_text(tmp_path / f"s{level}.npz",
                                     simulation_file=mock,
                                     camera_resolution=20 << level,
                                     adaptive_max_level=0))
        render_fn, _, rays, _, _ = \
            pipeline_simulation.make_simulation_renderer(cfg, device="cpu")
        pick = torch.from_numpy(level_pixels(
            ours[f"adaptive_block_locs_{level}"], 5, 20 << level))
        image = render_fn(rays.positions[pick], rays.directions[pick],
                          rays.momentum_factors[pick])["I_nu"][:, 0]
        np.testing.assert_array_equal(
            ours[f"adaptive_I_nu_{level}"], image.numpy().reshape(-1, 5, 5))


def test_phased_levels_with_monolithic_root(tmp_path, mock, monkeypatch):
    """With phased dispatch on for bundles of 512 rays or more, use_phased
    sends the 256-ray root to the monolithic kernel and the larger levels
    to the phased route: the arrays are the monolithic run's (the root
    bit for bit, the levels within the plain phased route's 1e-12)."""
    text = _sim_text(tmp_path / "torch.npz", simulation_file=mock)
    mono = pipeline.run(parse_config(text), quiet=True, device="cpu")
    levels = [n * 16 for n in mono["adaptive_num_blocks"][1:]]
    assert len(levels) == 2 and min(levels) >= 512
    calls = []
    phased = sk.render_simulation_phased

    def spy(*args, **kwargs):
        calls.append(args[0].shape[0])
        return phased(*args, **kwargs)

    monkeypatch.setattr(pipeline_simulation, "KERNEL_PHASED", True)
    monkeypatch.setattr(pipeline_simulation, "KERNEL_PHASE_STEPS", 64)
    monkeypatch.setattr(pipeline_simulation, "KERNEL_PHASE_CHUNK", 512)
    monkeypatch.setattr(sk, "render_simulation_phased", spy)
    ours = pipeline.run(parse_config(text), quiet=True, device="cpu")
    assert calls == levels
    assert set(ours) == set(mono)
    for key in ours:
        if key.startswith("adaptive_I_nu"):
            assert np.array_equal(np.isnan(ours[key]), np.isnan(mono[key]))
            np.testing.assert_allclose(ours[key], mono[key], rtol=1e-12)
        else:
            np.testing.assert_array_equal(ours[key], mono[key], err_msg=key)


def test_numbered_cli_run_refines_each_snapshot(tmp_path):
    """simulation_multiple through the CLI: each numbered snapshot is
    refined and written with its own levels, the single run's arrays."""
    for n, amp in enumerate((1.0, 3.0)):
        p = dict(gen.DEFAULTS, rho_amp=amp)
        gen.write_athena(str(tmp_path / f"snap.{n:02d}.athdf"),
                         gen.make_fields(p), p)
    text = _sim_text(tmp_path / "out.{02d}.npz",
                     simulation_file=tmp_path / "snap.{02d}.athdf",
                     camera_resolution=8, simulation_multiple="true",
                     simulation_start=0, simulation_end=1)
    (tmp_path / "run.input").write_text(text)
    assert cli.main(["--device", "cpu", str(tmp_path / "run.input")]) == 0
    for n in (0, 1):
        single = _sim_text(tmp_path / f"single{n}.npz", camera_resolution=8,
                           simulation_file=tmp_path / f"snap.{n:02d}.athdf")
        ref = pipeline.run(parse_config(single), quiet=True, device="cpu")
        written = np.load(tmp_path / f"out.{n:02d}.npz")
        assert written["adaptive_num_levels"][0] >= 1
        assert set(written.keys()) == set(ref)
        for key in ref:
            np.testing.assert_array_equal(written[key], ref[key],
                                          err_msg=key)
