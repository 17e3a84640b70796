"""PyTorch port: what the simulation kernels' wrapper hands a launch,
checked on the CPU: the launch constants the host packs (the kernels read
them from their parameter, in the constant bank), the guides that start
the cell search near its answer, with a Python transcription of the
card's walk held to a binary search and to the JAX package's comparison
count, and the launch-bound variant the design's bounds were timed on. The
kernels themselves are held to their plain version on the card by
test_torch_simulation_kernel_cuda.py and
test_torch_simulation_phased_cuda.py.
"""

import pathlib
import re
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blacklight_tpu.grid.sampling import _locate as jax_locate
from blacklight_tpu_torch import parse_config, pipeline_simulation
from blacklight_tpu_torch.ops import simulation_kernel as sk

torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
CSRC = pathlib.Path(sk.__file__).resolve().parent.parent / "csrc"
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "scripts"))
import generate_mock_simulation as mock  # noqa: E402

NUMPY = {torch.float32: np.float32, torch.float64: np.float64}
# chip_smoke.py's full-width snapshot grid (r, theta, phi cells and the
# radial range): faces as scripts/generate_mock_simulation.make_fields
# builds them.
FULL = dict(n_r=288, n_th=128, n_ph=128, r_min=1.916, r_max=52.2)


def _config(tmp_path, **overrides):
    text = (FIXTURES / "golden_sim_rk4_32.input").read_text()
    settings = {"simulation_file": FIXTURES / "mock_small.athdf",
                "output_file": tmp_path / "out.npz", "camera_resolution": 4,
                "ray_max_steps": 300, **overrides}
    for key, value in settings.items():
        line = f"{key} = {value}"
        text, n = re.subn(rf"^{key}\s*=.*$", line, text, flags=re.M)
        if n == 0:
            text += line + "\n"
    return parse_config(text)


def _header_counts():
    """S_COUNT from csrc/simulation_params.cuh, and the fields of
    SimLaunchConsts in csrc/simulation_kernel.cuh: [(name, length)] with
    the length "S_COUNT" or "NF"."""
    enum = re.search(r"enum SimulationParam : int \{(.*?)\};",
                     (CSRC / "simulation_params.cuh").read_text(),
                     re.S).group(1)
    names = [n.strip() for n in re.sub(r"//[^\n]*", "", enum).split(",")
             if n.strip()]
    assert names[-1] == "S_COUNT"
    body = re.search(r"struct SimLaunchConsts \{(.*?)\};",
                     (CSRC / "simulation_kernel.cuh").read_text(),
                     re.S).group(1)
    fields = re.findall(r"T (\w+)\[(\w+)\];", body)
    return len(names) - 1, fields


def _kernel_values(tmp_path, **overrides):
    cfg = _config(tmp_path, **overrides)
    render_fn, geom, rays, freqs, mass_msun = \
        pipeline_simulation.make_simulation_renderer(cfg, device="cpu")
    _, params, sp, grid, mass, camera_x, log_js = render_fn.kernel_args
    values = sk.kernel_params(params, sp, float(freqs[0]), mass, camera_x)
    return values, freqs, log_js, grid


def test_launch_consts_layout_matches_header():
    """SimLaunchConsts is the SimulationParam block, then NF frequencies,
    then NF image scales; launch_consts packs that many values of the
    rays' type, per frequency bucket."""
    count, fields = _header_counts()
    assert count == len(sk.PARAM_NAMES)
    assert fields == [("v", "S_COUNT"), ("nu", "NF"), ("scale", "NF")]
    sizes = sk.host_consts_sizes()
    for dtype, item in ((torch.float32, 4), (torch.float64, 8)):
        for bucket in (1, sk.MAX_FREQUENCIES):
            assert sizes[dtype, bucket] == (count + 2 * bucket) * item
    header = (CSRC / "simulation_kernel.cuh").read_text()
    assert f"MAX_FREQUENCIES = {sk.MAX_FREQUENCIES};" in header


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launch_consts_round_once_in_header_order(tmp_path, dtype):
    """Every parameter at its header index, rounded once from float64 to
    the rays' type (numpy's nearest rounding, the card's); the value cuts
    that are off (negative) as -inf for a minimum and +inf for a maximum,
    those that are on as their rounded value; then the frequencies and
    scales, zero beyond the launch's own in the larger bucket."""
    values, freqs, log_js, _ = _kernel_values(
        tmp_path, cut_sigma_max=1.0, cut_b_min=-1.0, cut_rho_min=0.0,
        cut_theta_e_max=1e300)
    named = dict(zip(sk.PARAM_NAMES, values))
    np_t = NUMPY[dtype]
    nus = np.asarray([1.0e11, 2.3e11, 4.5e11], dtype=np_t)
    scales = sk.image_scale(torch.from_numpy(nus), log_js).numpy()
    for n in (1, 3):
        out = sk.launch_consts(values, nus[:n], scales[:n], dtype)
        bucket = sk.frequency_bucket(n)
        assert out.dtype == np_t
        assert out.shape == (len(sk.PARAM_NAMES) + 2 * bucket,)
        for i, name in enumerate(sk.PARAM_NAMES):
            end = name.rsplit("_", 1)[-1]
            if name.rsplit("_", 1)[0] in sk.VALUE_CUT_NAMES and \
                    not named[name] >= 0.0:
                assert out[i] == (-np.inf if end == "MIN" else np.inf), name
            else:
                assert out[i] == np_t(named[name]), name
        base = len(sk.PARAM_NAMES)
        assert np.array_equal(out[base:base + n], nus[:n])
        assert np.array_equal(out[base + bucket:base + bucket + n],
                              scales[:n])
        assert not out[base + n:base + bucket].any()
        assert not out[base + bucket + n:].any()
    # the switches as the config gives them: on at 0.0 and at 1.0, off at
    # -1.0; an on cut past the type's range rounds to its infinity
    assert named["SIGMA_MAX"] == 1.0 and named["B_MIN"] == -1.0
    at = {name: i for i, name in enumerate(sk.PARAM_NAMES)}
    out = sk.launch_consts(values, nus[:1], scales[:1], dtype)
    assert out[at["RHO_MIN"]] == 0.0 and out[at["SIGMA_MAX"]] == 1.0
    assert out[at["B_MIN"]] == -np.inf
    assert out[at["THETA_E_MAX"]] == np_t(1e300)


def test_launch_consts_reject_wrong_shapes():
    values = [0.0] * len(sk.PARAM_NAMES)
    with pytest.raises(ValueError):
        sk.launch_consts(values[:-1], [1.0], [1.0], torch.float32)
    with pytest.raises(ValueError):
        sk.launch_consts(values, [1.0, 2.0], [1.0], torch.float32)
    with pytest.raises(ValueError):
        sk.launch_consts(values, [1.0] * (sk.MAX_FREQUENCIES + 1),
                         [1.0] * (sk.MAX_FREQUENCIES + 1), torch.float32)


def _walk(faces, guide, lo, scale, bins, x, hint=-1):
    """csrc/sim_sample.cuh faces_below, transcribed: from ``hint`` (the
    count at the ray's previous sample), or with none (-1) from the
    guide's count at x's bin (taken in the faces' type), walked up or
    down face by face to the count of faces below x."""
    n = faces.size - 1
    q = hint
    if q < 0:
        t_type = faces.dtype.type
        t = (t_type(x) - t_type(lo)) * t_type(scale)
        if t > 0:
            b = int(t) if t < t_type(bins - 1) else bins - 1
        else:
            b = 0
        q = int(guide[b])
    if q <= n and faces[q] < x:
        q += 1
        while q <= n and faces[q] < x:
            q += 1
    else:
        while q > 0 and not faces[q - 1] < x:
            q -= 1
    return q


def _guide(faces):
    """axis_bins and axis_guide of numpy ``faces`` (the kernel's type):
    (guide as numpy int32, lo, hi, scale, bins)."""
    lo, hi, scale, bins = sk.axis_bins(faces)
    guide = sk.axis_guide(torch.from_numpy(faces), lo, scale, bins)
    return guide.numpy(), lo, hi, scale, bins


def _binary_search(faces, x):
    """The count of faces below x as the kernel's binary search takes it:
    torch.searchsorted on the left side, 0 for NaN."""
    if np.isnan(x):
        return 0
    return int(torch.searchsorted(torch.from_numpy(faces),
                                  torch.tensor([x], dtype=torch.from_numpy(
                                      faces).dtype), side="left")[0])


def _points(faces, rng):
    """Faces, centres, both ends and beyond, random points, infinities and
    NaN, in the faces' type."""
    t_type = faces.dtype.type
    lo, hi = float(faces[0]), float(faces[-1])
    span = (hi - lo) or 1.0
    mids = 0.5 * (faces[:-1] + faces[1:])
    pts = [faces, mids, np.nextafter(faces, -np.inf),
           np.nextafter(faces, np.inf),
           rng.uniform(lo - 0.1 * span, hi + 0.1 * span, 300),
           [lo - span, hi + span, np.inf, -np.inf, np.nan]]
    return np.concatenate([np.asarray(p, dtype=np.float64)
                           for p in pts]).astype(t_type)


def _grids():
    """Faces of the mock grids: chip_smoke.py's full-width grid (log-r,
    uniform theta and phi) and mock_small.athdf's, random non-decreasing
    faces with repeated values, and a flat axis."""
    rng = np.random.default_rng(8)
    lrf = np.linspace(np.log(FULL["r_min"]), np.log(FULL["r_max"]),
                      FULL["n_r"] + 1)
    out = {"full_r": np.exp(lrf),
           "full_theta": np.linspace(0.0, np.pi, FULL["n_th"] + 1),
           "full_phi": np.linspace(0.0, 2.0 * np.pi, FULL["n_ph"] + 1)}
    p = dict(mock.DEFAULTS)
    small = mock.make_fields(dict(p, n_r=12, n_th=8, n_ph=6))
    out.update(small_r=small["rf"], small_theta=small["thf"],
               small_phi=small["phf"])
    out["repeats"] = np.sort(rng.choice(np.round(rng.uniform(-3, 5, 9), 1),
                                        40))
    out["clustered"] = np.sort(np.concatenate([
        rng.uniform(0.0, 1e-3, 30), rng.uniform(0.0, 100.0, 10)]))
    out["flat"] = np.full(5, 2.5)
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(_grids()))
def test_guide_walk_gives_the_binary_search_count(name, dtype):
    faces = _grids()[name].astype(dtype)
    guide, lo, hi, scale, bins = _guide(faces)
    assert guide.dtype == np.int32 and guide.shape == (bins,)
    assert 1 <= bins <= sk.GUIDE_MAX_BINS
    assert lo == float(faces[0]) and hi == float(faces[-1])
    assert np.all(np.diff(guide) >= 0)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    points = _points(faces, rng)
    hint = -1
    for x in points:
        want = _binary_search(faces, x)
        assert _walk(faces, guide, lo, scale, bins, x) == want, (name, x)
        # from the previous point's count, as a ray's next sample starts,
        # and from any count
        assert _walk(faces, guide, lo, scale, bins, x, hint) == want
        anywhere = int(rng.integers(0, faces.size + 1))
        assert _walk(faces, guide, lo, scale, bins, x, anywhere) == want
        hint = want


def test_guide_walk_matches_the_jax_comparison_count():
    """The JAX package's _locate takes the cell as the comparison count
    less one, clamped: the walk gives the same cell on the mock grids."""
    rng = np.random.default_rng(3)
    for name, faces in _grids().items():
        if name in ("repeats", "flat"):
            continue
        faces = faces.astype(np.float64)
        guide, lo, hi, scale, bins = _guide(faces)
        n = faces.size - 1
        x = _points(faces, rng)
        x = x[np.isfinite(x)]
        centres = 0.5 * (faces[:-1] + faces[1:])
        i_jax = np.asarray(jax_locate(jnp.asarray(faces),
                                      jnp.asarray(centres),
                                      jnp.asarray(x))[0])
        ours = [min(max(_walk(faces, guide, lo, scale, bins, v) - 1, 0),
                    n - 1) for v in x]
        assert np.array_equal(i_jax, ours), name


def test_guide_bins_fit_the_smallest_cell():
    """On chip_smoke.py's full-width grid each bin holds at most one face
    (the walk takes one face or two), and the bins stay within
    GUIDE_MAX_BINS where the smallest gap would ask for more."""
    grids = _grids()
    for name in ("full_r", "full_theta", "full_phi"):
        faces = grids[name].astype(np.float32)
        guide, lo, hi, scale, bins = _guide(faces)
        assert np.max(np.diff(guide)) <= 1, name
        assert bins >= faces.size - 1
    guide, *_, bins = _guide(grids["clustered"])
    assert bins == sk.GUIDE_MAX_BINS
    guide, lo, hi, scale, bins = _guide(grids["flat"])
    assert bins == 1 and scale == 0.0 and guide.tolist() == [0]


def test_guide_tables_and_kernel_grid(tmp_path):
    """kernel_grid concatenates the r, theta and phi guides of the
    coordinates kernel_tables lays out, with their lo, hi, scale and bins
    taken on the host from the grid's host copy of its faces, which
    rounds to each dtype as the device coordinates did; the guides lie
    beside the tables on the grid's device."""
    for dtype in (torch.float32, torch.float64):
        grid = pipeline_simulation.load_grid(_config(tmp_path),
                                             device="cpu", dtype=dtype)
        for host, dev in zip(grid.host_faces, (grid.x1f, grid.x2f,
                                               grid.x3f)):
            assert host.dtype == np.float64
            assert np.array_equal(host.astype(NUMPY[dtype]), dev.numpy())
        kg = sk.kernel_grid(grid, dtype)
        table, coords = sk.kernel_tables(grid, dtype)
        assert torch.equal(kg.table, table) and torch.equal(kg.coords,
                                                            coords)
        n_k, n_j, n_i = table.shape[1:4]
        c = coords.numpy()
        at, guides = 0, []
        for a, n in enumerate((n_i, n_j, n_k)):
            guide, *values = _guide(c[at:at + n + 1])
            guides.append(guide)
            axis = kg.axes[a * sk.GUIDE_AXIS_VALUES:
                           (a + 1) * sk.GUIDE_AXIS_VALUES]
            assert axis.tolist() == [float(v) for v in values]
            at += 2 * n + 1
        assert torch.equal(kg.guides,
                           torch.from_numpy(np.concatenate(guides)))
        assert kg.guides.dtype == torch.int32
        assert kg.guides.device == grid.prim.device
        assert kg.axes.dtype == np.float64
        assert kg.args()[4:7] == (n_i, n_j, n_k)
    header = (CSRC / "sim_sample.cuh").read_text()
    assert f"GUIDE_AXIS_VALUES = {sk.GUIDE_AXIS_VALUES};" in header


@pytest.mark.parametrize("variant", ["blocks=5", "blocks=8"])
def test_simulation_variants_apply(variant):
    """scripts/simulation_variants.py, which makes the trees the launch
    bounds were timed on, finds the one SimBlocks definition of this
    checkout's simulation_kernel.cuh and sets it, and takes no other
    variant."""
    import importlib.util
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "simulation_variants", root / "scripts" / "simulation_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    blocks = int(variant.partition("=")[2])
    text = (root / mod.KERNEL_CUH).read_text()
    out = mod.with_blocks(text, blocks)
    assert f"SimBlocks = sizeof(T) == 4 ? {blocks} : 1;" in out
    assert len(out.splitlines()) == len(text.splitlines())
    with pytest.raises(ValueError):
        mod.make(root, root / "unused", "grid=fetch")
