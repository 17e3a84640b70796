"""PyTorch port: SKS helpers, the Athena++ loader and the grid sampler
against the JAX package on the same inputs.

Inputs come from a seeded numpy generator and go to both packages as
numpy arrays. float64 is held at rtol 1e-12; float32 at the tolerance
each test states.
"""

import pathlib

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blacklight_tpu.grid import sampling as jsampling
from blacklight_tpu.grid.athena import load_athdf as jax_load_athdf
from blacklight_tpu.grid.athena import with_packed_corners
from blacklight_tpu.ops import sks as jsks
from blacklight_tpu_torch import interop
from blacklight_tpu_torch.grid import hdf5, sampling
from blacklight_tpu_torch.grid.athena import load_athdf
from blacklight_tpu_torch.ops import sks

torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
MOCK = FIXTURES / "mock_small.athdf"
TORCH_DTYPE = {"float32": torch.float32, "float64": torch.float64}
JAX_DTYPE = {"float32": jnp.float32, "float64": jnp.float64}
SPIN = 0.6


def _sks_to_cks(r, th, ph, spin):
    """Kerr-Schild (r, theta, phi) -> CKS (x, y, z), float64 numpy."""
    x = np.sin(th) * (r * np.cos(ph) - spin * np.sin(ph))
    y = np.sin(th) * (r * np.sin(ph) + spin * np.cos(ph))
    return x, y, r * np.cos(th)


def _positions(rng, n=1500):
    """(n, 4) CKS positions around mock_small's grid: cell faces and
    centres (up to rounding through CKS), points near them, random points
    inside, and points off the grid in r on both sides."""
    with h5py.File(MOCK, "r") as f:
        axes = [(np.asarray(f[face][0], np.float64),
                 np.asarray(f[centre][0], np.float64))
                for face, centre in (("x1f", "x1v"), ("x2f", "x2v"),
                                     ("x3f", "x3v"))]
    coords = []
    for faces, centres in axes:
        pick = rng.integers(0, 4, n)
        special = np.where(pick == 0, rng.choice(faces, n),
                           rng.choice(centres, n))
        near = special * (1.0 + rng.choice([-1e-9, 1e-9], n))
        inside = rng.uniform(faces[0], faces[-1], n)
        coords.append(np.select([pick == 0, pick == 1, pick == 2],
                                [special, special, near], inside))
    r, th, ph = coords
    r_faces = axes[0][0]
    off = rng.random(n) < 0.1
    r = np.where(off, np.where(rng.random(n) < 0.5, 0.5 * r_faces[0],
                               2.0 * r_faces[-1]), r)
    # a polar point and the phi = 0 seam
    th[:2], ph[2:4] = (0.0, np.pi), (0.0, 2.0 * np.pi - 1e-12)
    x, y, z = _sks_to_cks(r, th, ph, SPIN)
    return np.stack([rng.uniform(-10, 10, n), x, y, z], axis=-1)


@pytest.fixture(scope="module")
def positions():
    return _positions(np.random.default_rng(7))


def _polar(pos, precision):
    """Samples within ~1e-4 rad (float64) or ~1e-2 rad (float32) of the
    polar axis. There theta = acos(z / r) has a condition number of order
    1 / sin(theta): one ulp of r (torch's hypot rounds correctly, XLA's is
    a few ulp off) moves theta by ~sqrt(ulp), and the sampled values
    with it."""
    x, y, z = pos[:, 1], pos[:, 2], pos[:, 3]
    cos_th = np.abs(z) / np.sqrt(x * x + y * y + z * z)
    return cos_th > 1.0 - (1e-8 if precision == "float64" else 1e-4)


def _assert_close(a, b, rtol, polar, polar_atol, err_msg=""):
    """rtol with an absolute floor of rtol times the largest |b| (entries
    that cancel to ~0), and ``polar_atol`` times it on ``polar``."""
    scale = float(np.nanmax(np.abs(b)))
    atol = np.where(polar, polar_atol * scale, rtol * scale)
    bad = ~(np.abs(a - b) <= atol + rtol * np.abs(b))
    assert not bad.any(), (f"{err_msg}: {bad.sum()} of {bad.size} differ, "
                           f"worst |a - b| {np.nanmax(np.abs(a - b))}")


# float32 theta: each package is held to the float64 theta of the same
# float32 inputs within THETA_ULPS ulps of z / r carried through acos, plus
# as many ulps of theta itself. theta = acos(z / r) turns one float32 ulp
# of z / r into ulp / sin(theta) (3.3e-6 at theta = 0.018), and into
# sqrt(2 ulp) on the axis; on the suite's 1,500 points torch's error
# reaches 2.8 and XLA's 1.6 of these one-ulp units, so 4 leaves a margin.
THETA_ULPS = 4


def _theta_truth(p32):
    """(theta, z / r) in float64 from the float32 points ``p32`` (n, 4)."""
    x, y, z = (torch.from_numpy(p32[:, c].astype(np.float64))
               for c in (1, 2, 3))
    r, th, _ = sks.cks_to_sks(x, y, z, SPIN)
    return th.numpy(), (z / r).numpy()


def _theta_bound(theta, cos_th, ulps):
    """How far ``ulps`` float32 ulps of z / r and of theta move theta:
    |acos(z / r +- ulps ulp) - theta| + ulps ulp(theta)."""
    du = ulps * np.spacing(np.abs(cos_th).astype(np.float32)).astype(
        np.float64)
    moved = np.maximum(np.abs(np.arccos(np.clip(cos_th - du, -1.0, 1.0))
                              - theta),
                       np.abs(np.arccos(np.clip(cos_th + du, -1.0, 1.0))
                              - theta))
    return moved + ulps * np.spacing(theta.astype(np.float32)).astype(
        np.float64)


def _theta_outside(theta_pkg, theta, cos_th):
    """Entries where a package's float32 theta is past _theta_bound."""
    err = np.abs(np.asarray(theta_pkg, dtype=np.float64) - theta)
    return ~(err <= _theta_bound(theta, cos_th, THETA_ULPS))


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_cks_to_sks(positions, precision):
    """float32: atan2/acos round differently in XLA and in torch, 2e-6
    relative; r and phi are held to each other at that, theta wherever
    the conditioning of acos (THETA_ULPS ulps of z / r) stays inside it,
    and each package's theta to the float64 theta everywhere. Near the
    axis phi is ill-conditioned too (see _polar)."""
    p = positions.astype(precision)
    ours = sks.cks_to_sks(*(torch.from_numpy(p[:, c]) for c in (1, 2, 3)),
                          SPIN)
    ref = jsks.cks_to_sks(*(jnp.asarray(p[:, c]) for c in (1, 2, 3)), SPIN)
    rtol = 1e-12 if precision == "float64" else 2e-6
    polar = _polar(positions, precision)
    for a, b in zip(ours, ref):
        assert a.dtype == TORCH_DTYPE[precision]
    if precision == "float64":
        for a, b in zip(ours, ref):
            _assert_close(a.numpy(), np.asarray(b), rtol, polar, 1e-8)
    else:
        for c in (0, 2):  # r, phi
            _assert_close(ours[c].numpy(), np.asarray(ref[c]), rtol, polar,
                          1e-3)
        theta, cos_th = _theta_truth(p)
        for name, th in (("torch", ours[1].numpy()),
                         ("xla", np.asarray(ref[1]))):
            out = _theta_outside(th, theta, cos_th)
            assert not out.any(), (
                f"{name} theta past {THETA_ULPS} ulps at {np.flatnonzero(out)}")
        scale = float(np.nanmax(np.abs(theta)))
        well = _theta_bound(theta, cos_th, THETA_ULPS) <= rtol * scale
        _assert_close(ours[1].numpy()[well], np.asarray(ref[1])[well], rtol,
                      polar[well], 1e-3, err_msg="theta")
    assert float(ours[2].min()) >= 0.0 and float(ours[2].max()) < 2 * np.pi


def test_theta_bound_catches_ten_ulps(positions):
    """The float32 theta gate of test_cks_to_sks lets torch's theta
    through at a point 0.018 rad off the axis (cos theta = 0.99984, where
    torch's theta is 1.7 ulps of z / r off the float64 one and outside
    the 2e-6 cross-library floor) and refuses a theta that is wrong by 10
    of the one-ulp units at every point."""
    p = positions.astype(np.float32)
    theta, cos_th = _theta_truth(p)
    torch_theta = sks.cks_to_sks(
        *(torch.from_numpy(p[:, c]) for c in (1, 2, 3)), SPIN)[1].numpy()
    near_axis = (np.abs(theta - 0.018037) < 1e-5) & (cos_th > 0.9998)
    assert near_axis.any()
    assert not _theta_outside(torch_theta, theta, cos_th)[near_axis].any()
    unit = _theta_bound(theta, cos_th, 1)
    for sign in (1.0, -1.0):
        wrong = theta + sign * 10.0 * unit
        assert _theta_outside(wrong, theta, cos_th).all()


def test_sks_metric_velocity_and_jacobian(positions):
    rng = np.random.default_rng(3)
    x, y, z = (positions[:, c] for c in (1, 2, 3))
    uu = rng.normal(0.0, 0.3, (3, x.size))
    vec = rng.normal(0.0, 1.0, (3, x.size))
    tx, ty, tz = (torch.from_numpy(v) for v in (x, y, z))
    m = sks.sks_metric(tx, ty, tz, SPIN)
    jm = jsks.sks_metric(x, y, z, SPIN)
    polar = _polar(positions, "float64")
    for name in ("g_tt", "g_tr", "g_tph", "g_rr", "g_rph", "g_thth",
                 "g_phph", "gi_tt", "gi_tr", "gi_rr", "gi_rph", "gi_thth"):
        _assert_close(getattr(m, name).numpy(), np.asarray(getattr(jm, name)),
                      1e-12, polar, 1e-8, err_msg=name)
    u = sks.normal_frame_velocity(m, *(torch.from_numpy(v) for v in uu))
    ju = jsks.normal_frame_velocity(jm, *uu)
    low = sks.lower_sks(m, *u)
    jlow = jsks.lower_sks(jm, *ju)
    v = sks.sks_to_cks_vector(*(torch.from_numpy(c) for c in vec), tx, ty,
                              tz, SPIN)
    jv = jsks.sks_to_cks_vector(*vec, x, y, z, SPIN)
    for a, b in zip((*u, *low, *v), (*ju, *jlow, *jv)):
        _assert_close(a.numpy(), np.asarray(b), 1e-12, polar, 1e-8)


@pytest.mark.parametrize("path", ["mock_small.athdf", "mock_amr.athdf",
                                  "slowlight/small.00000.athdf"])
def test_hdf5_reader_matches_h5py(path):
    """Every dataset and attribute, with its dtype, as h5py reads it."""
    ours = hdf5.read_file(str(FIXTURES / path))
    with h5py.File(FIXTURES / path, "r") as ref:
        assert sorted(ours.children) == sorted(ref.keys())
        for name in ref.keys():
            a, b = ours[name].read(), ref[name][()]
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert np.array_equal(a, b), name
        assert sorted(ours.attrs) == sorted(ref.attrs)
        for name, value in ref.attrs.items():
            a, b = np.asarray(ours.attrs[name]), np.asarray(value)
            assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_hdf5_reader_refuses_other_files(tmp_path):
    bad = tmp_path / "x.athdf"
    bad.write_bytes(b"not an hdf5 file at all")
    with pytest.raises(hdf5.HDF5Error):
        hdf5.read_file(str(bad))


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_load_athdf_matches_jax(precision):
    ours = load_athdf(str(MOCK), device="cpu", dtype=TORCH_DTYPE[precision])
    ref = jax_load_athdf(str(MOCK), dtype=JAX_DTYPE[precision])
    assert ours.ind == ref.ind and ours.time == ref.time
    assert ours.prim.dtype == torch.float32
    assert np.array_equal(ours.prim.numpy(), np.asarray(ref.prim))
    for name in ("x1f", "x1v", "x2f", "x2v", "x3f", "x3v"):
        a = getattr(ours, name)
        assert a.dtype == TORCH_DTYPE[precision]
        assert np.array_equal(a.numpy(), np.asarray(getattr(ref, name)))
    copied = interop.simulation_grid_from_jax(ref, device="cpu",
                                              dtype=TORCH_DTYPE[precision])
    assert torch.equal(copied.prim, ours.prim)
    assert torch.equal(copied.x2f, ours.x2f)


def test_locate_at_faces_and_centres():
    """The comparison count and the anchor back-off at exact face and
    centre coordinates, outside the axis and between."""
    with h5py.File(MOCK, "r") as f:
        faces = np.asarray(f["x1f"][0], np.float64)
        centres = np.asarray(f["x1v"][0], np.float64)
    rng = np.random.default_rng(11)
    x = np.concatenate([faces, centres, np.nextafter(centres, 0.0),
                        np.nextafter(centres, np.inf),
                        [faces[0] - 1.0, faces[-1] + 1.0],
                        rng.uniform(faces[0], faces[-1], 200)])
    ours = sampling.locate(torch.from_numpy(faces), torch.from_numpy(centres),
                           torch.from_numpy(x))
    ref = jsampling._locate(jnp.asarray(faces), jnp.asarray(centres),
                            jnp.asarray(x))
    assert np.array_equal(ours[0].numpy(), np.asarray(ref[0]))
    assert np.array_equal(ours[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(ref[2]),
                               rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("precision,fallback_nan", [
    ("float64", True), ("float64", False), ("float32", True)])
def test_sample_grid_matches_jax(positions, precision, fallback_nan):
    """Every sampled primitive and the off-grid and NaN masks, through the
    JAX package's packed-corner sampler (the path its renderer takes) and
    its plain one. Both round every sample through float32, and one ulp
    of r (XLA's hypot is a few ulp off) can move a value to the
    neighbouring float32: float64 holds to one float32 ulp, 2^-23
    relative. float32: cks_to_sks rounds differently (see
    test_cks_to_sks), and the trilinear weights carry that: 2e-5 relative
    to each primitive's largest magnitude. Near the axis see _polar."""
    dtype = TORCH_DTYPE[precision]
    opts = dict(fallback_nan=fallback_nan, fallback_rho=1e-3,
                fallback_pgas=2e-5)
    grid = load_athdf(str(MOCK), device="cpu", dtype=dtype)
    jgrid = jax_load_athdf(str(MOCK), dtype=JAX_DTYPE[precision])
    pos = positions.astype(precision)
    polar = _polar(positions, precision)
    ours = sampling.sample_grid(grid, torch.from_numpy(pos), SPIN,
                                sampling.SamplerOptions(**opts))
    # float32 samples within rounding of the grid's outer radial faces may
    # fall on either side of them
    r = sks.cks_to_sks(*(torch.from_numpy(positions[:, c])
                         for c in (1, 2, 3)), SPIN)[0].numpy()
    faces = grid.x1f[0, [0, -1]].double().numpy()
    edge = np.zeros_like(r, dtype=bool) if precision == "float64" else \
        (np.abs(r[:, None] / faces - 1.0) < 1e-4).any(axis=-1)
    for ref_grid in (jgrid, with_packed_corners(jgrid)):
        ref = jsampling.sample_grid(ref_grid, jnp.asarray(pos), SPIN,
                                    jsampling.SamplerOptions(interp=True,
                                                             **opts))
        for mask in ("off_grid", "nan_mask"):
            assert np.array_equal(ours[mask].numpy()[~edge],
                                  np.asarray(ref[mask])[~edge])
        for name in sampling.SAMPLE_NAMES:
            a, b = ours[name].numpy()[~edge], np.asarray(ref[name])[~edge]
            assert a.dtype == b.dtype == np.dtype(precision), name
            if precision == "float64":
                _assert_close(a, b, 2.0 ** -23, polar[~edge], 1e-6,
                              err_msg=name)
            else:
                _assert_close(a, b, 2e-5, polar[~edge], 1e-3, err_msg=name)
    off = ours["off_grid"].numpy()
    assert 0 < off.sum() < off.size
    assert np.all(ours["rho"].numpy()[off] == np.asarray(1e-3, precision))
    assert np.all(ours["bb1"].numpy()[off] == 0.0)
    assert np.all(ours["rho"].numpy() > 0.0)
