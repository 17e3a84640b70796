"""PyTorch port: the polarized route's three stages in plain torch ops
(trace_samples_reference, derive_records_reference,
chain_records_reference, with transfer/polarized.sample_record and
apply_record) through the CUDA route's glue, against the JAX package.

The staged plain route renders the JAX package's own camera rays and is
held to the JAX XLA path (transfer/polarized.integrate_polarized) at the
gates of test_torch_polarized_pipeline.py: golden_polarized_rk4_32.input
on mock_small.athdf at 16^2 with 400 steps of 0.04. Then the glue's index
tensors (per-warp padding, record offsets, trace chunks, record pieces)
against Python loops on ragged sample counts, and the route's chunking
with caps small enough to force several chunks and pieces.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from blacklight_tpu import pipeline_simulation as jax_sim
from blacklight_tpu.utils.config import parse_config as jax_parse_config
from blacklight_tpu_torch import interop, parse_config, pipeline_simulation
from blacklight_tpu_torch.ops import polarized_kernel as pk
from blacklight_tpu_torch.transfer import polarized as tp
from blacklight_tpu_torch.transfer import unpolarized as tu

torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
TORCH_DTYPE = {"float32": torch.float32, "float64": torch.float64}
STOKES = ("I_nu", "Q_nu", "U_nu", "V_nu")
# test_torch_polarized_pipeline.py's per-channel rtol of the exact gate
EXACT_RTOL = {"I_nu": 1e-8, "Q_nu": 1e-8, "U_nu": 1e-8, "V_nu": 1e-5}
TWO_FREQUENCIES = {"image_num_frequencies": 2,
                   "image_frequency_start": 1.5e11,
                   "image_frequency_end": 4.6e11,
                   "image_frequency_spacing": "log"}


def _config_text(out, res=16, **overrides):
    """golden_polarized_rk4_32.input on mock_small.athdf at ``res``^2 with
    400 steps of 0.04, and ``overrides`` (key = value)."""
    text = (FIXTURES / "golden_polarized_rk4_32.input").read_text()
    settings = {"simulation_file": FIXTURES / "mock_small.athdf",
                "output_file": out, "camera_resolution": res,
                "ray_step": 0.04, "ray_max_steps": 400, **overrides}
    for key, value in settings.items():
        line = f"{key} = {value}"
        text, n = re.subn(rf"^{key}\s*=.*$", line, text, flags=re.M)
        if n == 0:
            text += line + "\n"
    return text


# name -> (input overrides, gate, byte caps of the staged route: a trace
# chunk of 64 rays and pieces of a few warps in the first case)
CASES = {
    "rk4_float64_chunked": ({}, "exact",
                            dict(trace_bytes=64 * 400 * 7 * 8,
                                 record_bytes=3 * 150 * 58 * 32 * 8)),
    "rk4_float64_two_frequencies_split": (
        {**TWO_FREQUENCIES, "image_rotation_split": "true"}, "exact", {}),
    "dp_float32": ({"ray_integrator": "dp", "precision": "float32"},
                   "quadrature", {}),
    "rk2_float32": ({"ray_integrator": "rk2", "precision": "float32"},
                    "truth", {}),
}

# The float32 gate (chip_smoke.py truth_gate, tests/test_pallas_polarized.py
# :99-119): against the JAX XLA path in float64 on the same rays, the
# staged route's error (|x - truth| over the frequency's peak of I, on the
# pixels finite in all three) stays within TRUTH_FACTOR times the JAX
# float32 path's, plus about one float32 ulp of I's peak. Pixel by pixel
# two float32 renders part where the Faraday rotation is deep or dp's
# step sequence forks, so their difference is not the measure; their
# distance to float64 is.
TRUTH_FACTOR = 3.0
TRUTH_SLACK = 1e-7
# dp in float32 ("quadrature"): with x64 on, the JAX package's dp steps
# run in float64 (its float32 image equals its float64 one here), and the
# port's float32 error controller picks another step sequence (249 of
# 256 rays differ in their sample count, measured), so samples sit
# elsewhere along each ray. It is held to the dp quadrature gate of
# tests/test_polarized_e2e.py:44-60 (each channel's mean and max over
# I's peak below QUAD_MEAN and QUAD_MAX, I's flux within 1e-3); fallback
# NaNs differ where float32 dp exhausts its retries on a ray that the
# float64 steps pass: at most QUAD_NAN_PIXELS of the pixels (8 of 256
# measured).
QUAD_MEAN = 5e-3
QUAD_MAX = 1e-1
QUAD_NAN_PIXELS = 0.05


def _jax_render(text, rays, dtype=None):
    """The JAX XLA path's image of ``text`` on ``rays`` (numpy arrays,
    cast to ``dtype`` if given)."""
    jrender, *_ = jax_sim.make_simulation_renderer(jax_parse_config(text))
    if dtype is not None:
        rays = [np.asarray(r).astype(dtype) for r in rays]
    return jrender(*rays)


@pytest.fixture(scope="module", params=sorted(CASES))
def renders(request, tmp_path_factory):
    """(gate, ours, ref, truth): the staged plain route and the JAX XLA
    path on the JAX package's camera rays, as numpy dicts with STOKES
    (B, F), _flags and _n_samples; truth is the JAX XLA path in float64
    on the same rays for the float32 gate (else None)."""
    overrides, gate, caps = CASES[request.param]
    out = tmp_path_factory.mktemp("rec") / "out.npz"
    text = _config_text(out, **overrides)
    _, _, rays, _, _ = jax_sim.make_simulation_renderer(
        jax_parse_config(text))
    jrays = (rays.positions, rays.directions, rays.momentum_factors)
    ref = _jax_render(text, jrays)
    truth = None
    if gate == "truth":
        truth = _jax_render(_config_text(out, **dict(overrides,
                                                     precision="float64")),
                            jrays, np.float64)
    cfg = parse_config(text)
    dtype = TORCH_DTYPE[cfg.precision or "float64"]
    render_fn, geom, *_ = pipeline_simulation.make_simulation_renderer(
        cfg, device="cpu")
    t = interop.camera_rays_from_numpy(*jrays, device="cpu", dtype=dtype)
    freqs, params, *_, log_scale = render_fn.kernel_args
    before = pk.LAUNCHES
    nn_re, nn_im, flags, n_samples, bad = pk.render_polarized_staged_reference(
        t.positions, t.directions, t.momentum_factors,
        *render_fn.kernel_args, **render_fn.kernel_kwargs, **caps)
    assert pk.LAUNCHES == before  # plain versions only
    assert nn_re.dtype == dtype
    image = pk.poisoned_stokes(nn_re, nn_im, flags, bad, t.positions,
                               t.directions, freqs, params, geom, log_scale,
                               cfg.require("fallback_nan"))
    ours = {k: v.numpy() for k, v in image.items()}
    ours.update(_flags=flags.numpy(), _n_samples=n_samples.numpy())
    n = t.positions.shape[0]

    def flat(img):
        return None if img is None else {
            k: np.asarray(v).reshape(n, -1) if k in STOKES else np.asarray(v)
            for k, v in img.items()}
    return gate, ours, flat(ref), flat(truth)


def test_staged_plain_matches_jax_xla_path(renders):
    gate, ours, ref, truth = renders
    i_scale = np.nanmax(np.abs(ref["I_nu"]))
    assert i_scale > 0.0 and np.isfinite(ref["I_nu"]).mean() > 0.5
    for k in STOKES:
        assert ours[k].shape == ref[k].shape, k
    if gate == "exact":
        for k in STOKES:
            assert np.array_equal(np.isnan(ours[k]), np.isnan(ref[k])), k
        assert np.array_equal(ours["_flags"], ref["_flags"])
        assert np.array_equal(ours["_n_samples"], ref["_n_samples"])
        for k in STOKES:
            floor = max(np.nanmax(np.abs(ref[k])) * 1e-4, i_scale * 1e-8)
            rel = np.abs(ours[k] - ref[k]) / (np.abs(ref[k]) + floor)
            assert np.nanmax(rel) < EXACT_RTOL[k], (k, np.nanmax(rel))
        return
    if gate == "quadrature":
        finite = np.all([np.isfinite(x[k]) for x in (ours, ref)
                         for k in STOKES], axis=0)
        for k in STOKES:
            nan_differs = np.isnan(ours[k]) != np.isnan(ref[k])
            assert nan_differs.mean() <= QUAD_NAN_PIXELS, (k, nan_differs)
            frac = np.abs(ours[k] - ref[k])[finite] / i_scale
            assert frac.mean() < QUAD_MEAN and frac.max() < QUAD_MAX, k
        a, b = ours["I_nu"][finite], ref["I_nu"][finite]
        assert abs(a.sum() - b.sum()) < 1e-3 * abs(b.sum())
        return
    for k in STOKES:
        assert np.array_equal(np.isnan(ours[k]), np.isnan(ref[k])), k
    for f in range(truth["I_nu"].shape[1]):
        scale = np.nanmax(np.abs(truth["I_nu"][:, f]))
        finite = np.all([np.isfinite(x[k][:, f]) for x in (ours, ref, truth)
                         for k in STOKES], axis=0)
        assert finite.mean() > 0.5
        for k in STOKES:
            e_ours = np.abs(ours[k][finite, f] - truth[k][finite, f]) / scale
            e_ref = np.abs(ref[k][finite, f] - truth[k][finite, f]) / scale
            for stat in (np.max, np.mean):
                assert stat(e_ours) <= TRUTH_FACTOR * stat(e_ref) \
                    + TRUTH_SLACK, (k, f, stat.__name__, stat(e_ours),
                                    stat(e_ref))


# ragged per-ray sample counts: rays with 0 and 1 samples, full warps,
# an empty warp and a partial last warp
RAGGED = np.concatenate([
    np.array([0, 1, 5, 0, 1, 3, 2, 7] * 4),      # warp 0: longest 7
    np.zeros(32, dtype=np.int64),                # warp 1: no sample
    np.array([1] * 31 + [0]),                    # warp 2: longest 1
    np.arange(32) % 9,                           # warp 3: longest 8
    np.array([4, 0, 6]),                         # warp 4: 3 rays, 6
]).astype(np.int32)


def test_warp_lengths_offsets_and_order():
    counts = torch.from_numpy(RAGGED)
    lengths = pk.warp_lengths(counts)
    want = [max(RAGGED[w * 32:(w + 1) * 32], default=0)
            for w in range(-(-len(RAGGED) // 32))]
    assert lengths.tolist() == want == [7, 0, 1, 8, 6]
    offsets = pk.record_offsets(lengths)
    total, first = 0, []
    for n in want:
        first.append(total)
        total += n
    assert offsets.tolist() == first + [total]
    order = pk.chain_order(lengths)
    assert order.dtype == torch.int32
    assert order.tolist() == sorted(range(len(want)),
                                    key=lambda w: (-want[w], w))


@pytest.mark.parametrize("cap,want", [
    (10 ** 9, [(0, 5)]),
    (7 * 100, [(0, 2), (2, 3), (3, 4), (4, 5)]),
    (8 * 100, [(0, 3), (3, 4), (4, 5)]),
    (1, [(0, 2), (2, 3), (3, 4), (4, 5)]),
])
def test_record_pieces(cap, want):
    """Greedy runs of warps under the cap; a warp past it starts a run of
    its own, and a warp of no record joins the run before it."""
    lengths = [7, 0, 1, 8, 6]
    pieces = pk.record_pieces(lengths, 100, cap)
    assert pieces == want
    assert [w for a, b in pieces for w in range(a, b)] == list(range(5))
    for a, b in pieces:
        assert sum(lengths[a:b]) * 100 <= cap or sum(lengths[a + 1:b]) == 0
    assert pk.record_pieces([], 100, cap) == []


def test_byte_sizing():
    """A ray's stored samples take ray_max_steps slots of 7 values; a
    record slot is 50 values and 8 per frequency, for 32 lanes; a trace
    chunk is whole warps under the cap, between one warp and the
    bundle."""
    assert pk.sample_bytes_per_ray(torch.float32, 2000) == 2000 * 7 * 4
    assert pk.sample_bytes_per_ray(torch.float64, 400) == 400 * 7 * 8
    assert pk.record_bytes_per_slot(torch.float32, 1) == 58 * 32 * 4
    assert pk.record_bytes_per_slot(torch.float64, 4) == 82 * 32 * 8
    per_warp = 32 * 400 * 7 * 8
    assert pk.trace_chunk_rays(1000, torch.float64, 400, 3 * per_warp) == 96
    assert pk.trace_chunk_rays(1000, torch.float64, 400, 1) == 32
    assert pk.trace_chunk_rays(70, torch.float64, 400, 10 ** 12) == 96
    # the main path (1024^2, 2000 steps, float32) on an 80 GB card with
    # 78 GiB free: 4 trace chunks
    trace_bytes, _ = pk.byte_caps(78 << 30)
    rays = pk.trace_chunk_rays(1024 ** 2, torch.float32, 2000, trace_bytes)
    assert rays % 32 == 0 and -(-1024 ** 2 // rays) == 4


@pytest.mark.parametrize("free", [0, 1 << 20, 2 << 30, 78 << 30])
def test_byte_caps(free):
    """The caps take MEMORY_SHARE of the free memory, SAMPLE_SHARE of it
    for the samples (14:52), so a card with less free memory takes
    smaller chunks and pieces."""
    trace_bytes, record_bytes = pk.byte_caps(free)
    assert trace_bytes >= 0 and record_bytes >= 0
    assert trace_bytes + record_bytes == int(free * pk.MEMORY_SHARE)
    assert abs(trace_bytes * 52 - record_bytes * 14) <= 66
    smaller = pk.byte_caps(free // 2)
    assert smaller[0] <= trace_bytes and smaller[1] <= record_bytes


class _Recorder:
    """Stages for pk._route that record what the glue hands them and
    return values that name each ray and frequency."""

    def __init__(self, counts, dtype=torch.float64):
        self.counts, self.dtype, self.calls = counts, dtype, []

    def trace(self, r0, r1, flags, n_samples):
        self.calls.append(("trace", r0, r1))
        flags.copy_(torch.arange(r0, r1) % 2)
        n_samples.copy_(self.counts[r0:r1])
        return torch.zeros((pk.n_warps(r1 - r0), 1, 7, 32))

    def derive(self, piece, f0, f1, geometry):
        self.calls.append(("derive", piece.r0, piece.r1, f0, f1,
                           geometry is None))
        assert piece.n_slots == int(piece.offsets[-1])
        assert piece.samples.shape[0] == piece.lengths.shape[0]
        assert torch.equal(piece.n_samples, self.counts[piece.r0:piece.r1])
        bits = torch.full((piece.r1 - piece.r0,), f0 // 4 + 2,
                          dtype=torch.int32)
        return "geometry", None, bits

    def chain(self, piece, geometry, coefficients, nf):
        self.calls.append(("chain", piece.r0, piece.r1, nf))
        assert geometry == "geometry"
        rays = torch.arange(piece.r0, piece.r1, dtype=self.dtype)
        out = rays[:, None, None] + torch.zeros((1, nf, 16))
        return out + 1000.0 * torch.arange(nf)[None, :, None]


@pytest.mark.parametrize("nf", [1, 6])
def test_route_chunks_pieces_and_groups(nf):
    """Every ray is traced once; each piece of a chunk is derived with its
    geometry once and then once per further frequency group, and chained
    once per group; outputs land at their rays and frequencies."""
    counts = torch.from_numpy(RAGGED)
    b = counts.shape[0]
    params = type("P", (), {"ray_max_steps": 400})()
    positions = torch.zeros((b, 4), dtype=torch.float64)
    freqs = torch.arange(1.0, nf + 1.0, dtype=torch.float64)
    stages = _Recorder(counts)
    per_warp = 32 * 400 * 7 * 8
    nn_re, nn_im, flags, n_samples, bad = pk._route(
        positions, positions, positions[:, 0], freqs, params, stages,
        trace_bytes=2 * per_warp,
        record_bytes=8 * pk.record_bytes_per_slot(torch.float64,
                                                  min(nf, 4)))
    traces = [c[1:] for c in stages.calls if c[0] == "trace"]
    assert traces == [(0, 64), (64, 128), (128, 131)]
    chains = [c for c in stages.calls if c[0] == "chain"]
    derives = [c for c in stages.calls if c[0] == "derive"]
    groups = [(0, min(nf, 4))] + ([(4, nf)] if nf > 4 else [])
    # warps 0-1 (7 + 0 slots) fit 8; warps 2-3 (1 + 8) do not; warp 4 alone
    pieces = [(0, 64), (64, 96), (96, 128), (128, 131)]
    assert [(c[1], c[2]) for c in chains] == [p for p in pieces
                                              for _ in groups]
    assert [(c[1], c[2], c[3], c[4], c[5]) for c in derives] == [
        (*p, f0, f1, f0 == 0) for p in pieces for f0, f1 in groups]
    assert len(stages.calls) == len(traces) + 2 * len(pieces) * len(groups)
    assert torch.equal(n_samples, counts)
    assert torch.equal(flags, torch.arange(b) % 2 == 1)
    nn = torch.cat((nn_re, nn_im), -1)
    want = torch.arange(b, dtype=torch.float64)[:, None, None] \
        + 1000.0 * (torch.arange(nf) % 4)[None, :, None]
    assert torch.equal(nn, want.expand(b, nf, 16))
    # the group's bits are f0 // 4 + 2: frequency f0 + 1 of the first,
    # f0 and f0 + 1 of the second
    want_bad = torch.tensor([(f // 4 + 2) >> (f % 4) & 1 == 1
                             for f in range(nf)])
    assert torch.equal(bad, want_bad[None, :].expand(b, nf))


@pytest.fixture(scope="module")
def traced():
    """A 16^2 rk4 float64 bundle's plain route pieces: rays, model
    arguments and the trace stage's samples."""
    cfg = parse_config(_config_text("unused.npz", res=8,
                                    **TWO_FREQUENCIES))
    render_fn, _, rays, *_ = pipeline_simulation.make_simulation_renderer(
        cfg, device="cpu")
    freqs, params, sp, grid, mass_msun, cam, _ = render_fn.kernel_args
    samples, flags, n_samples = pk.trace_samples_reference(
        rays.positions, rays.directions, params, "rk4")
    return rays, (freqs, params, sp, grid, mass_msun, cam), samples, \
        n_samples


def test_derive_and_chain_match_per_ray_loop(traced):
    """derive_records_reference and chain_records_reference on ragged
    sample counts (rays cut to 0, 1, 2 or all of their samples) against a
    loop over each ray's samples, far end first: each record against
    sample_record, and the chain against apply_record on those
    records."""
    rays, model, samples, n_full = traced
    freqs, params, sp, grid, mass_msun, cam = model
    b = n_full.shape[0]
    cut = torch.tensor([0, 1, 2, 10 ** 6])[torch.arange(b) % 4]
    counts = torch.minimum(n_full, cut).to(torch.int32)
    lengths = pk.warp_lengths(counts)
    offsets = pk.record_offsets(lengths)
    geometry, coefficients, bits = pk.derive_records_reference(
        samples, counts, lengths, offsets, rays.directions,
        rays.momentum_factors, freqs, 0, 2, params, sp, grid, mass_msun, cam)
    nn = pk.chain_records_reference(samples, counts, lengths, offsets,
                                    geometry, coefficients, 2, False)
    assert nn.shape == (b, 2, 16)
    x_unit = tu.x_unit(mass_msun)
    zero = torch.zeros(1, dtype=torch.float64)
    for ray in range(0, b, 7):
        n = int(counts[ray])
        w, lane = divmod(ray, 32)
        re, im = (torch.zeros((1, 2), dtype=torch.float64),) * 10, \
            (torch.zeros((1, 2), dtype=torch.float64),) * 6
        a_prev = tuple((zero,) * 4 for _ in range(4))
        prev = ((zero,) * 4, (zero,) * 4, zero)
        coeff_fn = pk._coeff_fn(rays.momentum_factors[ray:ray + 1], freqs,
                                params, sp, grid, cam, float(freqs[0]))
        any_bad = torch.zeros(2, dtype=torch.bool)
        for t in range(n - 1, -1, -1):
            v = samples[w, t, :, lane][:, None]
            pos = (zero, v[0], v[1], v[2])
            kcov = (rays.directions[ray:ray + 1, 0], v[3], v[4], v[5])
            rec = tp.sample_record(
                pos, kcov, v[6], torch.tensor([t == n - 1]), prev, coeff_fn,
                nus=freqs[None, :], mom=rays.momentum_factors[ray:ray + 1,
                                                              None],
                x_unit=x_unit, spin=params.bh_a, mass=params.bh_m,
                flat=params.ray_flat)
            slot = int(offsets[w]) + t
            got = pk.unpack_record(geometry[slot, :, lane][None],
                                   coefficients[slot, :, lane][None], 2)
            for key in ("a_cur", "a_half"):
                for m in range(4):
                    for c in range(4):
                        torch.testing.assert_close(got[key][m][c],
                                                   rec[key][m][c],
                                                   rtol=1e-12, atol=0.0)
            for key in ("dl_sec", "dl_local"):
                torch.testing.assert_close(got[key], rec[key], rtol=1e-12,
                                           atol=0.0)
            for key in ("e1", "e2", "t1", "t2", "coef"):
                for g, r in zip(got[key], rec[key]):
                    torch.testing.assert_close(g, r, rtol=1e-12,
                                               atol=1e-300)
            any_bad |= rec["bad"][0]
            # the chain on the derived record: sample_record's values
            # agree to rounding, which the Faraday rotation amplifies
            re, im = tp.apply_record(re, im, a_prev, got, False)
            a_prev = got["a_cur"]
            prev = (pos, rec["kcon"], -v[6])
        want_re, want_im = tp.finish_transport(re, im, a_prev, prev[2])
        torch.testing.assert_close(nn[ray:ray + 1, :, :10], want_re,
                                   rtol=1e-12, atol=1e-300)
        torch.testing.assert_close(nn[ray:ray + 1, :, 10:], want_im,
                                   rtol=1e-12, atol=1e-300)
        assert int(bits[ray]) == sum(int(v) << f for f, v in
                                     enumerate(any_bad.tolist()))
        if n == 0:
            assert not nn[ray].any()


def test_polarized_units_do_not_contract():
    """Every unit of the route is built without multiply-add contraction:
    a unit missing from CONTRACT would contract, and its kernels would
    round unlike the plain version."""
    from blacklight_tpu_torch.ops import _build
    units = {p.name for p in _build.sources() if p.name.startswith("polar")}
    assert units == {"polarized_trace.cu", "polarized_derive.cu",
                     "polarized_derive_f64.cu", "polarized_derive_blocks.cu",
                     "polarized_chain.cu", "polarized_derive_mixture.cu",
                     "polarized_derive_mixture_f64.cu",
                     "polarized_derive_mixture_blocks.cu",
                     "polarized_derive_fmks.cu",
                     "polarized_derive_fmks_f64.cu",
                     "polarized_derive_cks.cu",
                     "polarized_derive_cks_f64.cu"}
    assert all(_build.CONTRACT[u] is False for u in units)
