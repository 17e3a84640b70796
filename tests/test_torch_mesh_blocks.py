"""PyTorch port: multi-block and AMR Athena++ grids (the loader's
refinement metadata, the neighbour table, the sampler's block search,
nearest cell and exact interblock modes, the kernels' tables) against the
JAX package on the same inputs.

Grids: mock_amr.athdf (two levels and a sentinel block), 4-block phi
splits written by write_athena(..., phi_blocks=4) of fields without and
with phi structure (pert_amp 0 and 0.1), and the single-block mock. Sample points come from a seeded numpy generator, placed as in
tests/test_torch_sks_sampling.py: block faces and centres, points near
them, random points inside and points off the grid. Both samplers take
the same SKS coordinates (the JAX grid declared "cks", for which its
sampler takes the coordinates as they are), so float64 holds at rtol
1e-12.
"""

import dataclasses
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blacklight_tpu.grid import amr as jamr
from blacklight_tpu.grid import sampling as jsampling
from blacklight_tpu.grid.athena import load_athdf as jax_load_athdf
from blacklight_tpu_torch.grid import amr, sampling
from blacklight_tpu_torch.grid.athena import load_athdf, simulation_grid
from blacklight_tpu_torch.ops import simulation_kernel as sk
from blacklight_tpu_torch.utils.errors import BlacklightError

torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
sys.path.insert(0, str(pathlib.Path(__file__).parents[1] / "scripts"))
import generate_mock_simulation as gen  # noqa: E402

MODES = {"trilinear": dict(interp=True, block_interp=False),
         "nearest": dict(interp=False, block_interp=False),
         "interblock": dict(interp=True, block_interp=True)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_blocks")
    p = dict(gen.DEFAULTS)
    gen.write_athena(str(tmp / "four.athdf"), gen.make_fields(p), p,
                     phi_blocks=4)
    gen.write_athena_amr(str(tmp / "amr_b.athdf"), p, block_size=(8, 4, 4),
                         refine=((1, 0, 1), (2, 3, 0)), pad_block=False)
    # fields that vary in phi, in 4 phi blocks and in one
    p = dict(p, pert_amp=0.1)
    fields = gen.make_fields(p)
    gen.write_athena(str(tmp / "four_pert.athdf"), fields, p, phi_blocks=4)
    gen.write_athena(str(tmp / "one_pert.athdf"), fields, p)
    return {"amr": str(FIXTURES / "mock_amr.athdf"),
            "four": str(tmp / "four.athdf"),
            "four_pert": str(tmp / "four_pert.athdf"),
            "one_pert": str(tmp / "one_pert.athdf"),
            "single": str(FIXTURES / "mock_small.athdf"),
            "amr_b": str(tmp / "amr_b.athdf")}


def _grids(path, dtype=torch.float64):
    ours = amr.with_amr_table(load_athdf(path, device="cpu", dtype=dtype))
    ref = jamr.with_amr_table(jax_load_athdf(
        path, dtype=jnp.float64 if dtype == torch.float64 else jnp.float32))
    return ours, ref


def _points(grid, rng, n=1500):
    """(r, th, ph) float64: faces and centres of random blocks, points
    within 1e-9 of them, random points in the grid's box, ~10 % off it in
    r, and the poles and the phi seam."""
    n_b = grid.n_blocks
    coords = []
    for faces, centres in ((grid.x1f, grid.x1v), (grid.x2f, grid.x2v),
                           (grid.x3f, grid.x3v)):
        faces, centres = faces.double().numpy(), centres.double().numpy()
        b = rng.integers(0, n_b, n)
        pick = rng.integers(0, 4, n)
        special = np.where(
            pick == 0, faces[b, rng.integers(0, faces.shape[1], n)],
            centres[b, rng.integers(0, centres.shape[1], n)])
        near = special * (1.0 + rng.choice([-1e-9, 1e-9], n))
        inside = rng.uniform(faces[:, 0].min(), faces[:, -1].max(), n)
        coords.append(np.select([pick == 0, pick == 1, pick == 2],
                                [special, special, near], inside))
    r, th, ph = coords
    lo, hi = grid.x1f[:, 0].min().item(), grid.x1f[:, -1].max().item()
    off = rng.random(n) < 0.1
    r = np.where(off, np.where(rng.random(n) < 0.5, 0.5 * lo, 2.0 * hi), r)
    th[:2], ph[2:4] = (0.0, np.pi), (0.0, 2.0 * np.pi - 1e-12)
    return r, th, ph


def _jax_sample(ref, r, th, ph, opts):
    """The JAX sampler at SKS (r, th, ph): its grid declared "cks", whose
    coordinates it takes as they are."""
    pos = np.stack([np.zeros_like(r), r, th, ph], axis=-1)
    return jsampling.sample_grid(dataclasses.replace(ref, coords="cks"),
                                 jnp.asarray(pos), 0.0, opts)


@pytest.mark.parametrize("name", ["amr", "four", "single"])
def test_loader_metadata_matches_jax(files, name):
    ours, ref = _grids(files[name])
    assert np.array_equal(ours.levels, np.asarray(ref.levels))
    assert ours.levels.dtype == np.int32
    assert np.array_equal(ours.locations, np.asarray(ref.locations))
    assert ours.locations.dtype == np.int64
    assert ours.n3_root == ref.n3_root > 0
    assert [f.shape for f in ours.host_faces] == [
        tuple(getattr(ours, a).shape) for a in ("x1f", "x2f", "x3f")]
    assert np.array_equal(ours.prim.numpy(), np.asarray(ref.prim))


@pytest.mark.parametrize("name", ["amr", "four", "amr_b"])
def test_neighbor_table_matches_jax(files, name):
    """The port's table (a dictionary of the blocks' locations) equals the
    JAX package's (a scan of the block list) entry for entry."""
    ours, ref = _grids(files[name])
    assert ours.amr_table.dtype == ours.loc_parity.dtype == torch.int32
    assert np.array_equal(ours.amr_table.numpy(), np.asarray(ref.amr_table))
    assert np.array_equal(ours.loc_parity.numpy(),
                          np.asarray(ref.loc_parity))
    assert ours.amr_table.shape == (ours.n_blocks, 27, 8, amr.TABLE_FIELDS)


def test_with_amr_table_leaves_single_blocks(files):
    grid = load_athdf(files["single"], device="cpu")
    assert amr.with_amr_table(grid) is grid
    tabled = amr.with_amr_table(load_athdf(files["four"], device="cpu"))
    assert amr.with_amr_table(tabled) is tabled


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["amr", "four", "four_pert", "single"])
def test_sample_matches_jax(files, name, mode):
    """Every sampled primitive and the off-grid and NaN masks at rtol
    1e-12 in float64, in each grid and mode."""
    ours, ref = _grids(files[name])
    seed = 10 * list(MODES).index(mode) + len(name)
    r, th, ph = _points(ours, np.random.default_rng(seed))
    opts = dict(fallback_nan=True, fallback_rho=1e-3, fallback_pgas=2e-5,
                **MODES[mode])
    out = sampling.sample_sks(ours, *map(torch.from_numpy, (r, th, ph)),
                              sampling.SamplerOptions(**opts))
    jout = _jax_sample(ref, r, th, ph, jsampling.SamplerOptions(**opts))
    for mask in ("off_grid", "nan_mask"):
        assert np.array_equal(out[mask].numpy(), np.asarray(jout[mask]))
    off = out["off_grid"].numpy()
    assert 0 < off.sum() < off.size
    for key in sampling.SAMPLE_NAMES:
        a, b = out[key].numpy(), np.asarray(jout[key])
        assert a.dtype == np.float64, key
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0.0, err_msg=key)


def test_phi_split_differs_from_one_block_only_at_the_seam(files):
    """Fields that vary in phi, in 4 phi blocks with interblock sampling
    and in one block with trilinear sampling: the same values wherever
    phi lies between the first and the last cell centre, since each
    interior phi face's ghost is the next block's first centre; within
    half a cell of the phi = 0 seam the blocks wrap through the
    neighbour table while the one block extrapolates from its edge
    cells, so the values differ there. The port and the JAX package
    alike."""
    four, four_ref = _grids(files["four_pert"])
    one, one_ref = _grids(files["one_pert"])
    rng = np.random.default_rng(11)
    n = 4000
    faces = one.x1f[0].numpy()
    r = np.exp(rng.uniform(np.log(faces[0]), np.log(faces[-1]), n))
    th = rng.uniform(0.1, np.pi - 0.1, n)
    ph = rng.uniform(0.0, 2.0 * np.pi, n)
    centres = one.x3v[0].numpy()
    seam = (ph < centres[0]) | (ph > centres[-1])
    assert 0 < seam.sum() < n
    pts = tuple(map(torch.from_numpy, (r, th, ph)))
    ours = (sampling.sample_sks(four, *pts, sampling.SamplerOptions(
                **MODES["interblock"])),
            sampling.sample_sks(one, *pts, sampling.SamplerOptions()))
    theirs = (_jax_sample(four_ref, r, th, ph, jsampling.SamplerOptions(
                  **MODES["interblock"])),
              _jax_sample(one_ref, r, th, ph, jsampling.SamplerOptions()))
    for split, whole in (ours, theirs):
        for key in ("rho", "pgas"):
            a, b = np.asarray(split[key]), np.asarray(whole[key])
            np.testing.assert_allclose(a[~seam], b[~seam], rtol=1e-12,
                                       atol=0.0, err_msg=key)
            assert np.abs(a[seam] - b[seam]).max() > 1e-3 * np.abs(b).max()


def test_interblock_matches_host_transcription(files):
    """The exact interblock sampler against the per-sample transcription
    of the reference (tests/helpers_amr_host.py) on mock_amr."""
    from helpers_amr_host import sample_point

    grid, _ = _grids(files["amr"])
    grid_np = dict(
        **{a: getattr(grid, a).numpy() for a in
           ("x1f", "x2f", "x3f", "x1v", "x2v", "x3v")},
        prim=grid.prim.numpy(), levels=[int(v) for v in grid.levels],
        locs=[tuple(int(v) for v in row) for row in grid.locations])
    rng = np.random.default_rng(3)
    n = 1500
    r = np.exp(rng.uniform(np.log(2.0), np.log(50.0), n))
    th = rng.uniform(0.05, np.pi - 0.05, n)
    ph = rng.uniform(0.0, 2 * np.pi, n)
    out = sampling.sample_sks(grid, *map(torch.from_numpy, (r, th, ph)),
                              sampling.SamplerOptions(**MODES["interblock"]))
    checked = 0
    for s in range(n):
        res = sample_point(grid_np, r[s], th[s], ph[s], True, grid.n3_root)
        if res is None:
            assert out["off_grid"][s]
            continue
        vals, info = res
        checked += 1
        host = np.float64(np.float32(vals[grid.ind["rho"]]))
        assert np.isclose(host, out["rho"][s].item(), rtol=1e-6,
                          atol=1e-30), (s, info)
    assert checked > n // 2


@pytest.mark.parametrize("mode", ["trilinear", "interblock"])
def test_sample_float32_matches_jax(files, mode):
    """float32 coordinates: the block search and the cell walk on the
    rounded faces give JAX's cells; values at rtol 1e-6 (the fractions'
    float32 rounding)."""
    ours, ref = _grids(files["amr"], torch.float32)
    r, th, ph = (c.astype(np.float32)
                 for c in _points(ours, np.random.default_rng(5)))
    opts = dict(fallback_nan=True, **MODES[mode])
    out = sampling.sample_sks(ours, *map(torch.from_numpy, (r, th, ph)),
                              sampling.SamplerOptions(**opts))
    jout = _jax_sample(ref, r, th, ph, jsampling.SamplerOptions(**opts))
    assert np.array_equal(out["off_grid"].numpy(),
                          np.asarray(jout["off_grid"]))
    for key in sampling.SAMPLE_NAMES:
        a, b = out[key].numpy(), np.asarray(jout[key])
        scale = np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * scale,
                                   err_msg=key)


def test_block_interp_without_metadata_raises(files):
    """A multi-block grid without Levels/LogicalLocations (built in
    memory) has no exact neighbour table: block_interp is refused, naming
    ROADMAP B.5b; the other modes sample it."""
    g = load_athdf(files["four"], device="cpu")
    bare = simulation_grid(g.prim, g.x1f, g.x1v, g.x2f, g.x2v, g.x3f, g.x3v,
                           g.ind, g.time, device="cpu", dtype=torch.float64)
    assert bare.levels is None and amr.with_amr_table(bare) is bare
    pts = [torch.tensor([5.0]), torch.tensor([1.0]), torch.tensor([1.0])]
    with pytest.raises(BlacklightError, match="B.5b"):
        sampling.sample_sks(bare, *pts,
                            sampling.SamplerOptions(**MODES["interblock"]))
    with pytest.raises(BlacklightError, match="B.5b"):
        sk.kernel_grid(bare, torch.float64,
                       sampling.SamplerOptions(**MODES["interblock"]))
    for mode in ("trilinear", "nearest"):
        out = sampling.sample_sks(bare, *pts,
                                  sampling.SamplerOptions(**MODES[mode]))
        assert not out["off_grid"].any()


@pytest.mark.parametrize("name,mode,expected", [
    ("single", "trilinear", sampling.SINGLE),
    ("single", "interblock", sampling.SINGLE),
    ("single", "nearest", sampling.BLOCKS),
    ("four", "trilinear", sampling.BLOCKS),
    ("four", "nearest", sampling.BLOCKS),
    ("amr", "nearest", sampling.BLOCKS),
    ("amr", "interblock", sampling.INTERBLOCK)])
def test_kernel_grid_layout(files, name, mode, expected):
    """The kernels' tables: the (n_b, n_k, n_j, n_i, 8) cells, each
    axis' (n_b, n + 1) faces and (n_b, n) centres back to back, the
    (n_b, 6) block bounds, the neighbour table under INTERBLOCK, the
    sampling mode and the nearest flag."""
    grid, _ = _grids(files[name])
    opts = sampling.SamplerOptions(**MODES[mode])
    sk.check_grid(grid)
    kg = sk.kernel_grid(grid, torch.float64, opts)
    assert (kg.mode, kg.nearest) == (expected, not opts.interp)
    nvar, n_b, n_k, n_j, n_i = grid.prim.shape
    assert kg.table.shape == (n_b, n_k, n_j, n_i, 8)
    for q, key in enumerate(sampling.SAMPLE_NAMES):
        assert torch.equal(kg.table[..., q], grid.prim[grid.ind[key]])
    at = 0
    for name_f, name_v in (("x1f", "x1v"), ("x2f", "x2v"), ("x3f", "x3v")):
        for key in (name_f, name_v):
            flat = getattr(grid, key).reshape(-1)
            assert torch.equal(kg.coords[at:at + flat.numel()], flat)
            at += flat.numel()
    assert at == kg.coords.numel()
    bounds = torch.stack([grid.x1f[:, 0], grid.x1f[:, -1], grid.x2f[:, 0],
                          grid.x2f[:, -1], grid.x3f[:, 0], grid.x3f[:, -1]],
                         dim=1)
    assert torch.equal(kg.bounds, bounds)
    assert (kg.amr is None) == (expected != sampling.INTERBLOCK)
    if kg.amr is not None:
        assert torch.equal(kg.amr, grid.amr_table)
        assert torch.equal(kg.parity, grid.loc_parity)


def test_check_grid_blocks(files):
    """check_grid takes many blocks (the sentinel block of mock_amr
    included) and refuses blocks that overlap in volume or have no
    extent on an axis."""
    sk.check_grid(_grids(files["amr"])[0])
    grid = load_athdf(files["four"], device="cpu")
    sk.check_grid(grid)           # blocks that share phi faces
    x3f = grid.host_faces[2].copy()
    x3f[1] = x3f[0]               # block 1 onto block 0
    with pytest.raises(ValueError, match="overlap"):
        sk.check_grid(dataclasses.replace(
            grid, host_faces=(*grid.host_faces[:2], x3f)))
    x1f = grid.host_faces[0].copy()
    x1f[2] = x1f[2, 0]            # block 2 with no radial extent
    with pytest.raises(ValueError, match="extent"):
        sk.check_grid(dataclasses.replace(
            grid, host_faces=(x1f, *grid.host_faces[1:])))


def test_simulation_units_do_not_contract():
    """The units of many blocks, of FMKS, of CKS grids and of the mixture
    of populations build, as the single-block units, without multiply-add contraction:
    their kernels round as the plain version does, and a phased render on
    many blocks stays the monolithic kernel's bit for bit."""
    from blacklight_tpu_torch.ops import _build
    units = {p.name for p in _build.sources()
             if p.name.startswith("simulation")}
    assert units == {"simulation_kernel.cu", "simulation_kernel_dp.cu",
                     "simulation_phase.cu", "simulation_blocks.cu",
                     "simulation_blocks_dp.cu", "simulation_phase_blocks.cu",
                     "simulation_mixture.cu", "simulation_mixture_dp.cu",
                     "simulation_mixture_blocks.cu",
                     "simulation_mixture_blocks_dp.cu",
                     "simulation_phase_mixture.cu",
                     "simulation_phase_mixture_blocks.cu",
                     "simulation_fmks.cu", "simulation_fmks_dp.cu",
                     "simulation_mixture_fmks.cu",
                     "simulation_phase_fmks.cu",
                     "simulation_phase_mixture_fmks.cu",
                     "simulation_cks.cu", "simulation_cks_dp.cu",
                     "simulation_mixture_cks.cu",
                     "simulation_phase_cks.cu",
                     "simulation_phase_mixture_cks.cu"}
    assert all(_build.CONTRACT[u] is False for u in units)
