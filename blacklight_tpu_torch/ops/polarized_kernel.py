"""Polarized simulation-model route: geodesics + GRMHD grid sampling +
thermal polarized synchrotron coefficients + full-Stokes transfer, in
three CUDA kernels.

Port of ``blacklight_tpu/ops/pallas_polarized.py`` (``_make_kernel``
:286, launched by ``render_polarized`` :727; K3.1) for a single-block SKS
grid and thermal ti_te_beta electrons, with dp, rk4 and rk2 in float32
and float64; the derive kernel also samples many blocks, FMKS and CKS
grids and the mixture of populations (``simulation_kernel.kernel_mode``). Its values follow the JAX package's exact (XLA) path,
``transfer/polarized.integrate_polarized`` with
``pipeline_simulation.make_simulation_coeff_fns(polarized=True)``, in each
dtype's forms; like the TPU kernel it leaves the camera-frame Stokes
extraction (``transfer/polarized.camera_stokes``) to the caller, and
marks the samples the reference would NaN, zeroing their coefficients.

``render_polarized`` dispatches on the device of the rays it is given: on
a CUDA device it launches the hand-written kernels
(``csrc/polarized_kernel.cuh``) or raises; on the CPU it runs
``render_polarized_reference``. There is no fallback from one to the
other.

The CUDA route (``_route``) takes the rays in trace chunks. For each, the
trace kernel stores every valid sample of each ray in step order, laid
out per warp of 32 rays, slot-major ([warp][slot][value][lane],
ray_max_steps slots a warp); then, from the chunk's sample counts,
each warp's longest ray sets its record slots (``warp_lengths``,
``record_offsets``), and pieces of warps whose records fit the byte cap
(``record_pieces``) go through the derive kernel (one thread per sample:
the record of everything that does not depend on the coherency tensor)
and the chain kernel (one thread per ray: the records applied far end
first). Frequencies beyond MAX_FREQUENCIES add derive and chain launches
of coefficients only. ``render_polarized_staged_reference`` runs the same
glue with the stages' plain versions (``trace_samples_reference``,
``derive_records_reference``, ``chain_records_reference``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from blacklight_tpu_torch.constants import Physics
from blacklight_tpu_torch.grid.athena import SimulationGrid
from blacklight_tpu_torch.models import synchrotron
from blacklight_tpu_torch.ops import _build
from blacklight_tpu_torch.ops import geodesic as geo
from blacklight_tpu_torch.ops import simulation_kernel as sk
from blacklight_tpu_torch.ops.formula_kernel import (
    INTEGRATORS,
    _DTYPE_CODES,
    _check_rays,
)
from blacklight_tpu_torch.transfer import polarized as tp
from blacklight_tpu_torch.transfer import unpolarized as tu

# Frequencies one derive and chain launch take (csrc/polarized_kernel.cuh
# POL_MAX_FREQUENCIES): the chain keeps one frequency's 16 coherency
# components in registers, more in a local array.
MAX_FREQUENCIES = 4

# The layout of samples and records (csrc/polarized_kernel.cuh): rays in
# warps of WARP; a sample is SAMPLE_VALUES values (x, y, z, k1, k2, k3,
# h); a record GEOMETRY_VALUES values (A(x, k), the first half's matrix,
# two step lengths, four tetrad rows) and COEFFICIENT_VALUES per
# frequency.
WARP = 32
SAMPLE_VALUES = 7
GEOMETRY_VALUES = 50
COEFFICIENT_VALUES = 8

# Device memory for the route's buffers, worked out at its entry from
# what the card has free (free_device_bytes): MEMORY_SHARE of it goes to
# one trace chunk's stored samples (ray_max_steps slots a ray, so a chunk
# is a fixed number of rays) and the records of one piece of it (sized
# from the chunk's sample counts), split SAMPLE_SHARE to the samples; the
# rest is for the route's smaller tensors and the kernel tables. Larger
# chunks are faster, each launch ending in a partly idle tail
# (chip_smoke.py --chunk-sweep, PERF.md); 14:52 is the split that ran
# fastest on an 80 GB H100 at 1024^2, 2000 steps of rk4 in float32 (721
# samples a ray): 4 trace chunks of one derive and one chain launch. A
# card with less free memory takes smaller chunks.
MEMORY_SHARE = 0.85
SAMPLE_SHARE = 14 / 66

# Kernel launches so far: render_polarized adds one per launch of any of
# the three kernels and nowhere else, and STAGE_LAUNCHES one per launch
# of each.
LAUNCHES = 0
STAGE_LAUNCHES = {"trace": 0, "derive": 0, "chain": 0}
# Of the derive launches, those of each kernel mode's kernel
# (simulation_kernel.kernel_mode; SINGLE: polarized_derive_kernel; BLOCKS,
# INTERBLOCK, CKS_BLOCKS, CKS_INTERBLOCK: polarized_derive_mode_kernel;
# FMKS: polarized_derive_fmks_kernel), and those of the mixture's
# (polarized_derive_mixture_kernel, any mode), also by mode.
DERIVE_MODE_LAUNCHES = [0] * sk.KERNEL_MODES
DERIVE_MIXTURE_LAUNCHES = 0
DERIVE_MIXTURE_MODE_LAUNCHES = [0] * sk.KERNEL_MODES
# Of the mixture's derive launches, those at the code_kappa temperature,
# by mode.
DERIVE_CODE_KAPPA_MODE_LAUNCHES = [0] * sk.KERNEL_MODES

# Index order of the kernel's float64 parameter vector: the simulation
# kernel's (simulation_kernel.PARAM_NAMES), then the enum in
# csrc/polarized_params.cuh with its "P_" prefix dropped.
PARAM_NAMES = sk.PARAM_NAMES + ("ROTATION_SPLIT", "FALLBACK_RHO",
                                "FALLBACK_PGAS", "E_SQUARED", "ME_C")


def kernel_params(params: geo.GeodesicParams, sp: sk.SimKernelParams,
                  nu0: float, mass_msun: float, camera_x,
                  rotation_split: bool) -> list:
    """The kernel's parameter vector in PARAM_NAMES order; for a mixture
    of populations (simulation_kernel.is_mixture) followed by its
    constants in simulation_kernel.MIX_PARAM_NAMES order, polarized."""
    values = dict(zip(sk.PARAM_NAMES, sk.kernel_params(
        params, sp, nu0, mass_msun, camera_x)))
    values.update({
        "ROTATION_SPLIT": rotation_split,
        "FALLBACK_RHO": sp.sampler.fallback_rho,
        "FALLBACK_PGAS": sp.sampler.fallback_pgas,
        "E_SQUARED": Physics.e ** 2, "ME_C": Physics.m_e * Physics.c})
    mix = sk.mixture_params(sp.plasma, True, sp.sampler.fallback_kappa) \
        if sk.is_mixture(sp.plasma) else []
    return geo.pack_params(PARAM_NAMES, values) + mix


# ---- the glue of the route (the same for the kernels and their plain
# versions) ------------------------------------------------------------------

def n_warps(n_rays: int) -> int:
    return -(-n_rays // WARP)


def sample_bytes_per_ray(dtype, max_steps: int) -> int:
    """Bytes of stored samples a ray takes: max_steps slots."""
    return max_steps * SAMPLE_VALUES * (torch.finfo(dtype).bits // 8)


def record_bytes_per_slot(dtype, frequencies: int) -> int:
    """Bytes of one record slot of a warp (32 rays' records at one
    sample), for a launch of ``frequencies`` frequencies."""
    values = GEOMETRY_VALUES + COEFFICIENT_VALUES * frequencies
    return values * WARP * (torch.finfo(dtype).bits // 8)


def trace_chunk_rays(n_rays: int, dtype, max_steps: int,
                     byte_cap: int) -> int:
    """Rays per trace chunk: whole warps whose stored samples fit
    ``byte_cap``, at least one warp and at most the bundle."""
    per_warp = WARP * sample_bytes_per_ray(dtype, max_steps)
    return WARP * max(1, min(byte_cap // per_warp, n_warps(n_rays)))


def byte_caps(free_bytes: int) -> tuple:
    """(trace_bytes, record_bytes): the caps on one trace chunk's samples
    and one piece's records for ``free_bytes`` of free device memory."""
    budget = int(free_bytes * MEMORY_SHARE)
    trace = int(budget * SAMPLE_SHARE)
    return trace, budget - trace


def free_device_bytes(device) -> int:
    """Device memory that allocations on ``device`` can take: the card's
    free memory and what PyTorch's caching allocator holds unused (an
    earlier call's workspace, which this call's takes again)."""
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def warp_lengths(n_samples):
    """Each warp's longest ray (W,) int64: the record slots the warp
    takes. The bundle's last warp is padded with rays of no sample."""
    padded = torch.zeros(n_warps(n_samples.shape[0]) * WARP,
                         dtype=torch.int64, device=n_samples.device)
    padded[:n_samples.shape[0]] = n_samples
    return padded.view(-1, WARP).amax(dim=1)


def record_offsets(lengths):
    """(W + 1,) int64: the first record slot of each warp, then the
    total."""
    offsets = torch.zeros(lengths.shape[0] + 1, dtype=torch.int64,
                          device=lengths.device)
    torch.cumsum(lengths, 0, out=offsets[1:])
    return offsets


def record_pieces(lengths: list, slot_bytes: int, byte_cap: int) -> list:
    """Split warps with ``lengths`` record slots of ``slot_bytes`` each
    into runs (w0, w1) whose records fit ``byte_cap``; a warp that alone
    exceeds it starts a run of its own, and a warp with no record joins
    the run before it."""
    pieces, w0, used = [], 0, 0
    for w, n in enumerate(lengths):
        size = n * slot_bytes
        if w > w0 and size and used + size > byte_cap:
            pieces.append((w0, w))
            w0, used = w, 0
        used += size
    if lengths:
        pieces.append((w0, len(lengths)))
    return pieces


def chain_order(lengths):
    """The warps longest first (int32): the chain kernel's order, so that
    the long rays start first and the last wave is of short ones."""
    return torch.argsort(lengths, descending=True,
                         stable=True).to(torch.int32)


class Piece(NamedTuple):
    """Warps [w0, w1) of a trace chunk and their rays [r0, r1) of the
    bundle: their stored samples (W, cap, SAMPLE_VALUES, WARP), sample
    counts (r1 - r0,), record slots per warp, the record offsets and the
    total of slots."""

    r0: int
    r1: int
    samples: torch.Tensor
    n_samples: torch.Tensor
    lengths: torch.Tensor
    offsets: torch.Tensor
    n_slots: int


def _route(positions, directions, momentum_factors, frequencies, params,
           stages, trace_bytes: int, record_bytes: int):
    """The three stages over the bundle: trace chunks, pieces under the
    record cap, frequency groups of MAX_FREQUENCIES. ``stages`` provides
    trace(r0, r1, flags, n_samples) -> samples, derive(piece, f0, f1,
    geometry) -> (geometry, coefficients, bits) and chain(piece, geometry,
    coefficients, nf) -> (rays, nf, 16)."""
    device, dtype = positions.device, positions.dtype
    b, nf = positions.shape[0], frequencies.shape[0]
    nn = torch.empty((b, nf, 16), dtype=dtype, device=device)
    flags = torch.empty(b, dtype=torch.int32, device=device)
    n_samples = torch.empty(b, dtype=torch.int32, device=device)
    bad = torch.zeros((b, nf), dtype=torch.bool, device=device)
    groups = [(f0, min(f0 + MAX_FREQUENCIES, nf))
              for f0 in range(0, nf, MAX_FREQUENCIES)]
    slot_bytes = record_bytes_per_slot(dtype, min(nf, MAX_FREQUENCIES))
    chunk = trace_chunk_rays(b, dtype, params.ray_max_steps, trace_bytes)
    for c0 in range(0, b, chunk):
        c1 = min(b, c0 + chunk)
        samples = stages.trace(c0, c1, flags[c0:c1], n_samples[c0:c1])
        lengths = warp_lengths(n_samples[c0:c1])
        host = lengths.tolist()  # one host sync per chunk
        for w0, w1 in record_pieces(host, slot_bytes, record_bytes):
            r0, r1 = c0 + w0 * WARP, min(c1, c0 + w1 * WARP)
            piece = Piece(r0, r1, samples[w0:w1], n_samples[r0:r1],
                          lengths[w0:w1], record_offsets(lengths[w0:w1]),
                          sum(host[w0:w1]))
            geometry = None
            for f0, f1 in groups:
                geometry, coefficients, bits = stages.derive(
                    piece, f0, f1, geometry)
                nn[r0:r1, f0:f1] = stages.chain(piece, geometry,
                                                coefficients, f1 - f0)
                del coefficients  # before the next group's or piece's
                shifts = torch.arange(f1 - f0, dtype=torch.int32,
                                      device=device)
                bad[r0:r1, f0:f1] = ((bits[:, None] >> shifts) & 1).bool()
            del geometry
    return nn[..., :10], nn[..., 10:], flags.bool(), n_samples, bad


def render_polarized(positions, directions, momentum_factors, frequencies,
                     params: geo.GeodesicParams, sp: sk.SimKernelParams,
                     grid: SimulationGrid, mass_msun: float, camera_x,
                     log_j_scale: float, integrator: str = "rk4",
                     rotation_split: bool = False):
    """Polarized render of a ray bundle through a GRMHD snapshot.

    Arguments as ``simulation_kernel.render_simulation`` takes them, plus
    ``rotation_split`` (image_rotation_split). ``log_j_scale`` is not
    used here: ``camera_stokes`` applies the scale.

    Returns (nn_re (B, F, 10), nn_im (B, F, 6), flags (B,) bool,
    n_samples (B,) int32, bad (B, F) bool): the final coherency
    components in ``transfer/polarized`` _SYM/_ANT order, on the rays'
    device and in their dtype. ``bad`` marks the pixels that met a sample
    the reference would NaN. A CUDA device runs the three CUDA kernels;
    the CPU runs ``render_polarized_reference``.
    """
    _check_rays(positions, directions, momentum_factors)
    sk._check_frequencies(frequencies, positions)
    if integrator not in INTEGRATORS:
        raise ValueError(f"integrator must be one of {INTEGRATORS}")
    sk.check_grid(grid, sp.sampler)
    if grid.prim.device != positions.device:
        raise TypeError("the grid and the rays must share one device")
    device = positions.device
    args = (positions, directions, momentum_factors, frequencies, params, sp,
            grid, mass_msun, camera_x, log_j_scale, integrator,
            rotation_split)
    if device.type == "cuda":
        return _render_cuda(*args)
    if device.type == "cpu":
        return render_polarized_reference(*args)
    raise ValueError(f"no polarized kernel for device {device}")


def _render_cuda(positions, directions, momentum_factors, frequencies,
                 params, sp, grid, mass_msun, camera_x, log_j_scale,
                 integrator, rotation_split, *, trace_bytes=None,
                 record_bytes=None, events=None):
    """The CUDA route (_route with _CudaStages). The byte caps default to
    byte_caps of free_device_bytes. ``events``: a list that receives
    (stage, start, end) CUDA events around each launch."""
    del log_j_scale
    device = positions.device

    def stages(free_bytes):
        caps = byte_caps(free_bytes)
        return _CudaStages(
            positions, directions, momentum_factors, frequencies, params,
            sp, grid, mass_msun, camera_x, integrator, rotation_split,
            events, caps[0] if trace_bytes is None else trace_bytes,
            caps[1] if record_bytes is None else record_bytes)
    try:
        cuda = stages(free_device_bytes(device))
    except torch.OutOfMemoryError:
        # cached memory counted as free lies in a block that a tensor made
        # since has split: give the cache back and size from the card's
        # free memory alone
        with torch.cuda.device(device):
            torch.cuda.empty_cache()
        cuda = stages(torch.cuda.mem_get_info(device)[0])
    return _route(positions, directions, momentum_factors, frequencies,
                  params, cuda, cuda.trace_bytes, cuda.record_bytes)


class _CudaStages:
    """The three kernels' launches for _route under the byte caps
    ``trace_bytes`` and ``record_bytes``; each returns after its launch,
    on the current stream.

    The samples of a trace chunk and the records of a piece are views of
    one workspace, allocated first and once a call at the most the caps
    let _route ask for: within the call no block of either is freed and
    asked for again at another size, which a smaller tensor could have
    split in between; the next call takes the cached workspace whole."""

    def __init__(self, positions, directions, momentum_factors, frequencies,
                 params, sp, grid, mass_msun, camera_x, integrator,
                 rotation_split, events, trace_bytes: int,
                 record_bytes: int):
        self.device, self.dtype = positions.device, positions.dtype
        self.item = positions.element_size()
        self.cap = params.ray_max_steps
        self.trace_bytes, self.record_bytes = trace_bytes, record_bytes
        warps = n_warps(trace_chunk_rays(positions.shape[0], self.dtype,
                                         self.cap, trace_bytes))
        slot_bytes = record_bytes_per_slot(
            self.dtype, min(frequencies.shape[0], MAX_FREQUENCIES))
        # a piece's records fit record_bytes or are one warp's
        # (record_pieces); a chunk has at most cap slots a warp
        slots = min(warps * self.cap,
                    max(self.cap, record_bytes // slot_bytes))
        self.n_sample_values = warps * self.cap * SAMPLE_VALUES * WARP
        self.workspace = torch.empty(
            self.n_sample_values + slots * slot_bytes // self.item,
            dtype=self.dtype, device=self.device)
        self.lib = _library()
        self.rays = (positions, directions, momentum_factors)
        self.frequencies = frequencies
        self.dtype_code = _DTYPE_CODES[self.dtype]
        self.integrator = INTEGRATORS.index(integrator)
        self.prm = torch.tensor(kernel_params(
            params, sp, float(frequencies[0]), mass_msun, camera_x,
            rotation_split), dtype=torch.float64, device=self.device)
        self.mixture = sk.is_mixture(sp.plasma)
        self.grid = sk.kernel_grid(grid, self.dtype, sp.sampler)
        self.events = events

    def _launch(self, stage, fn, *args):
        global LAUNCHES, DERIVE_MIXTURE_LAUNCHES
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device)
            if self.events is not None:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            rc = fn(*args, stream.cuda_stream)
            if self.events is not None:
                end.record(stream)
                self.events.append((stage, start, end))
        if rc != 0:
            msg = self.lib.blacklight_cuda_error_string(rc).decode()
            raise RuntimeError(f"polarized {stage} kernel launch failed: "
                               f"{msg} ({rc})")
        LAUNCHES += 1
        STAGE_LAUNCHES[stage] += 1
        if stage == "derive" and self.mixture:
            DERIVE_MIXTURE_LAUNCHES += 1
            DERIVE_MIXTURE_MODE_LAUNCHES[self.grid.mode] += 1
            if self.grid.kappa is not None:
                DERIVE_CODE_KAPPA_MODE_LAUNCHES[self.grid.mode] += 1
        elif stage == "derive":
            DERIVE_MODE_LAUNCHES[self.grid.mode] += 1

    def _ray_ptr(self, k, r0, values):
        return self.rays[k].data_ptr() + values * r0 * self.item

    def trace(self, r0, r1, flags, n_samples):
        samples = self.workspace[:self.n_sample_values].view(
            -1, self.cap, SAMPLE_VALUES, WARP)[:n_warps(r1 - r0)]
        self._launch("trace", self.lib.blacklight_polarized_trace,
                     self.dtype_code, self.integrator,
                     self._ray_ptr(0, r0, 4), self._ray_ptr(1, r0, 4),
                     self.prm.data_ptr(), samples.data_ptr(), self.cap,
                     flags.data_ptr(), n_samples.data_ptr(), r1 - r0)
        return samples

    def _set(self, piece):
        return (piece.samples.data_ptr(), self.cap,
                piece.n_samples.data_ptr(), piece.offsets.data_ptr(),
                piece.lengths.shape[0])

    def derive(self, piece, f0, f1, geometry):
        nf = f1 - f0
        first = geometry is None
        records = self.workspace[self.n_sample_values:]
        size = piece.n_slots * GEOMETRY_VALUES * WARP
        if first:
            geometry = records[:size].view(-1, GEOMETRY_VALUES, WARP)
        coefficients = records[
            size:size + piece.n_slots * COEFFICIENT_VALUES * nf * WARP].view(
                -1, COEFFICIENT_VALUES * nf, WARP)
        bits = torch.zeros(piece.r1 - piece.r0, dtype=torch.int32,
                           device=self.device)
        if not piece.n_slots:  # no stored sample: nothing to launch
            return geometry, coefficients, bits
        freqs = self.frequencies[f0:f1].contiguous()
        derive = self.lib.blacklight_polarized_derive_mixture \
            if self.mixture else self.lib.blacklight_polarized_derive
        grid_args = self.grid.mixture_args() if self.mixture \
            else self.grid.args()
        self._launch("derive", derive,
                     self.dtype_code, int(first), *self._set(piece),
                     piece.n_slots, piece.r1 - piece.r0,
                     self._ray_ptr(1, piece.r0, 4),
                     self._ray_ptr(2, piece.r0, 1), freqs.data_ptr(), nf,
                     self.prm.data_ptr(), *grid_args,
                     geometry.data_ptr(), coefficients.data_ptr(),
                     bits.data_ptr())
        return geometry, coefficients, bits

    def chain(self, piece, geometry, coefficients, nf):
        out = torch.empty((piece.r1 - piece.r0, nf, 16), dtype=self.dtype,
                          device=self.device)
        order = chain_order(piece.lengths)
        self._launch("chain", self.lib.blacklight_polarized_chain,
                     self.dtype_code, *self._set(piece), piece.r1 - piece.r0,
                     order.data_ptr(), geometry.data_ptr(),
                     coefficients.data_ptr(), nf, self.prm.data_ptr(),
                     out.data_ptr())
        return out


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library with the C interface of csrc/polarized_chain.cu
    declared: every pointer and the stream as c_void_p."""
    lib = _build.load_library()
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sample_set = [ptr, i32, ptr, ptr, i32]  # samples, cap, n_samples,
    #                                         offsets, n_warps
    signatures = {
        "trace": [i32, i32, ptr, ptr, ptr, ptr, i32, ptr, ptr, i64, ptr],
        "derive": [i32, i32, *sample_set, i64, i64, ptr, ptr, ptr, i32, ptr,
                   *sk.GRID_ARGTYPES, ptr, ptr, ptr, ptr],
        "chain": [i32, *sample_set, i64, ptr, ptr, ptr, i32, ptr, ptr, ptr],
    }
    signatures["derive_mixture"] = [
        i32, i32, *sample_set, i64, i64, ptr, ptr, ptr, i32, ptr,
        *sk.MIXTURE_GRID_ARGTYPES, ptr, ptr, ptr, ptr]
    for name, argtypes in signatures.items():
        fn = getattr(lib, f"blacklight_polarized_{name}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    expected = {"param_count": len(PARAM_NAMES),
                "mixture_param_count": len(PARAM_NAMES)
                + len(sk.MIX_PARAM_NAMES),
                "max_frequencies": MAX_FREQUENCIES,
                "sample_values": SAMPLE_VALUES,
                "geometry_values": GEOMETRY_VALUES,
                "coefficient_values": COEFFICIENT_VALUES}
    for name, value in expected.items():
        fn = getattr(lib, f"blacklight_polarized_{name}")
        fn.argtypes = []
        fn.restype = ctypes.c_int
        if fn() != value:
            raise RuntimeError(f"csrc/polarized_kernel.cuh and "
                               f"ops/polarized_kernel.py disagree on {name}")
    lib.blacklight_cuda_error_string.argtypes = [ctypes.c_int]
    lib.blacklight_cuda_error_string.restype = ctypes.c_char_p
    return lib


def polarized_coefficients(pos, kcov, momentum_factors, frequencies,
                           sp: sk.SimKernelParams, grid: SimulationGrid,
                           spin, camera_x, nu0: float, fluid=None):
    """The polarized coeff_fn of ``transfer/polarized.integrate_polarized``
    at CKS positions ``pos`` with covariant momenta ``kcov`` (4-tuples of
    (B,) components): make_simulation_coeff_fns(polarized=True) for the
    slice. The sampled primitives are zeroed at geometrically cut samples
    before the fluid state (the reference's sampler leaves zeros there,
    which the tetrad consumes); the coefficients are zero where a cut
    holds or the field vanishes, and zero with ``bad`` set where the
    reference would NaN (an uncut off-grid sample under fallback_nan, or
    a coefficient that is not finite). ``fluid``:
    ``simulation_kernel.fluid_sample`` at ``pos`` with zero_cut, where
    already formed."""
    samples, state, keep_geo, keep_val, b_zero = \
        sk.fluid_sample(torch.stack(pos, dim=-1), sp, grid, spin, camera_x,
                        zero_cut=True) if fluid is None else fluid
    sin_b, cos_b, sin2_b, u_dot_k = synchrotron.pitch_angle(kcov, state)
    nu_cgs = -u_dot_k[:, None] * frequencies[None, :] \
        * momentum_factors[:, None]
    coeffs = synchrotron.all_coefficients(
        nu_cgs, nu0, state, sin_b, sp.plasma, cos_theta_b=cos_b,
        sin2_theta_b=sin2_b, polarized=True)
    keep = (keep_geo & keep_val & ~b_zero)[:, None]
    coeffs = {k: torch.where(keep, v, 0.0) for k, v in coeffs.items()}
    bad = (samples["nan_mask"] & keep_geo)[:, None].expand(nu_cgs.shape)
    for v in coeffs.values():
        bad = bad | ~torch.isfinite(v)
    out = {k: torch.where(bad, 0.0, v) for k, v in coeffs.items()}
    out.update(bad=bad, ucon=state["ucon"], bcon=state["bcon"],
               b_zero=b_zero)
    return out


def _coeff_fn(momentum_factors, frequencies, params, sp, grid, camera_x,
              nu0):
    cam = [float(v) for v in camera_x]

    def coeff_fn(pos, kcov):
        return polarized_coefficients(pos, kcov, momentum_factors,
                                      frequencies, sp, grid, params.bh_a,
                                      cam, nu0)
    return coeff_fn


def render_polarized_reference(positions, directions, momentum_factors,
                               frequencies, params: geo.GeodesicParams,
                               sp: sk.SimKernelParams, grid: SimulationGrid,
                               mass_msun: float, camera_x,
                               log_j_scale: float = 0.0,
                               integrator: str = "rk4",
                               rotation_split: bool = False):
    """The route's function in plain torch ops:
    ``transfer/polarized.integrate_polarized`` (the windowed sweep and
    its reverse replay, sample_record and apply_record at every sample)
    with ``polarized_coefficients``. Returns what ``render_polarized``
    returns."""
    del log_j_scale
    _check_rays(positions, directions, momentum_factors)
    sk._check_frequencies(frequencies, positions)
    coeff_fn = _coeff_fn(momentum_factors, frequencies, params, sp, grid,
                         camera_x, float(frequencies[0]))
    return tp.integrate_polarized(
        positions, directions, momentum_factors, frequencies, params=params,
        integrator=integrator, coeff_fn=coeff_fn, mass_msun=mass_msun,
        rotation_split=rotation_split)[:5]


# ---- the stages' plain versions ---------------------------------------------

def trace_samples_reference(positions, directions, params: geo.GeodesicParams,
                            integrator: str):
    """The trace kernel's plain version: the rays' valid samples in step
    order, laid out (W, ray_max_steps, SAMPLE_VALUES, WARP) as the kernel
    lays them out (zeros where a ray has no sample), with flags (B,) bool
    and n_samples (B,) int32 (ops/geodesic.trace_reference)."""
    b = positions.shape[0]
    samples = torch.zeros((n_warps(b), params.ray_max_steps, SAMPLE_VALUES,
                           WARP), dtype=positions.dtype,
                          device=positions.device)
    count = torch.zeros(b, dtype=torch.int64, device=positions.device)
    rays = torch.arange(b, device=positions.device)

    def on_sample(valid, x, k, h):
        idx = rays[valid]
        values = torch.stack((x[1], x[2], x[3], k[1], k[2], k[3], h), -1)
        samples[idx // WARP, count[idx], :, idx % WARP] = values[valid]
        count.add_(valid.to(torch.int64))

    flags, n_samples = geo.trace_reference(positions, directions, params,
                                           integrator, on_sample)
    return samples, flags, n_samples


def _stored(samples, n_samples, lengths):
    """Every stored sample of a piece: (w, t, lane) index tensors in
    record order."""
    ns = torch.zeros(lengths.shape[0] * WARP, dtype=torch.int64,
                     device=n_samples.device)
    ns[:n_samples.shape[0]] = n_samples
    ns = ns.view(-1, WARP)
    slots = int(lengths.max()) if lengths.numel() else 0
    t = torch.arange(slots, device=n_samples.device)
    w, t, lane = torch.nonzero(t[None, :, None] < ns[:, None, :],
                               as_tuple=True)
    return w, t, lane, ns[w, lane]


def derive_records_reference(samples, n_samples, lengths, offsets,
                             directions, momentum_factors, frequencies, f0,
                             f1, params: geo.GeodesicParams,
                             sp: sk.SimKernelParams, grid: SimulationGrid,
                             mass_msun: float, camera_x):
    """The derive kernel's plain version on a piece's stored samples
    (Piece fields; directions and momentum_factors of its rays): every
    sample's ``transfer/polarized.sample_record`` against the
    next-farther sample, in the kernel's record layout.

    Returns (geometry (n_slots, GEOMETRY_VALUES, WARP), coefficients
    (n_slots, COEFFICIENT_VALUES * (f1 - f0), WARP), bits (rays,) int32
    with bit f set where frequency f0 + f met a bad sample); slots of no
    sample hold zeros.
    """
    dtype, device = samples.dtype, samples.device
    n_slots = int(offsets[-1])
    nf = f1 - f0
    geometry = torch.zeros((n_slots, GEOMETRY_VALUES, WARP), dtype=dtype,
                           device=device)
    coefficients = torch.zeros((n_slots, COEFFICIENT_VALUES * nf, WARP),
                               dtype=dtype, device=device)
    bits = torch.zeros(n_samples.shape[0], dtype=torch.int32, device=device)
    w, t, lane, n = _stored(samples, n_samples, lengths)
    if not w.numel():
        return geometry, coefficients, bits
    ray = w * WARP + lane
    first = t == n - 1
    here = samples[w, t, :, lane]
    there = samples[w, torch.clamp(t + 1, max=samples.shape[1] - 1), :,
                    lane]
    zero = torch.zeros_like(here[:, 0])
    p0 = directions[ray, 0]
    pos = (zero, here[:, 0], here[:, 1], here[:, 2])
    kcov = (p0, here[:, 3], here[:, 4], here[:, 5])
    pos_pv = (zero, there[:, 0], there[:, 1], there[:, 2])
    kcov_pv = (p0, there[:, 3], there[:, 4], there[:, 5])
    spin, mass, flat = params.bh_a, params.bh_m, params.ray_flat
    kcon_pv = tp._kcon_scalar(pos_pv, kcov_pv, spin, mass, flat)
    dl_pv = torch.where(first, 0.0, -there[:, 6])
    mom = momentum_factors[ray]
    freqs = frequencies[f0:f1]
    coeff_fn = _coeff_fn(mom, freqs, params, sp, grid, camera_x,
                         float(frequencies[0]))
    rec = tp.sample_record(pos, kcov, here[:, 6], first,
                           (pos_pv, kcon_pv, dl_pv), coeff_fn,
                           nus=freqs[None, :], mom=mom[:, None],
                           x_unit=tu.x_unit(mass_msun), spin=spin, mass=mass,
                           flat=flat)
    slot = offsets[w] + t
    geometry[slot, :, lane] = pack_geometry(rec)
    coefficients[slot, :, lane] = torch.stack(rec["coef"], -1).reshape(
        -1, COEFFICIENT_VALUES * nf)
    for f in range(nf):
        hits = torch.zeros_like(bits).index_add_(
            0, ray, rec["bad"][:, f].to(torch.int32))
        bits |= (hits > 0).to(torch.int32) << f
    return geometry, coefficients, bits


def pack_geometry(rec):
    """A record's geometry values (S, GEOMETRY_VALUES) in the kernel's
    order (csrc/polarized_kernel.cuh RecordValue)."""
    values = [v for row in rec["a_cur"] for v in row]
    values += [v for row in rec["a_half"] for v in row]
    values += [rec["dl_sec"], rec["dl_local"], *rec["e1"], *rec["e2"],
               *rec["t1"], *rec["t2"]]
    return torch.stack(values, -1)


def unpack_record(geometry, coefficients, nf):
    """sample_record's dict from geometry (S, GEOMETRY_VALUES) and
    coefficient (S, COEFFICIENT_VALUES * nf) values."""
    g = geometry.unbind(-1)
    c = coefficients.reshape(-1, nf, COEFFICIENT_VALUES).unbind(-1)
    return {"a_cur": tuple(tuple(g[4 * m:4 * m + 4]) for m in range(4)),
            "a_half": tuple(tuple(g[16 + 4 * m:20 + 4 * m])
                            for m in range(4)),
            "dl_sec": g[32], "dl_local": g[33], "e1": g[34:38],
            "e2": g[38:42], "t1": g[42:46], "t2": g[46:50], "coef": c}


def chain_records_reference(samples, n_samples, lengths, offsets, geometry,
                            coefficients, nf: int, rotation_split: bool):
    """The chain kernel's plain version on a piece: each ray's records far
    end first through ``transfer/polarized.apply_record``, then the
    camera end's half step. Returns (rays, nf, 16)."""
    dtype, device = samples.dtype, samples.device
    b = n_samples.shape[0]
    ray = torch.arange(b, device=device)
    w, lane = ray // WARP, ray % WARP
    n = n_samples.to(torch.int64)
    zero = torch.zeros((b, nf), dtype=dtype, device=device)
    re, im = (zero,) * 10, (zero,) * 6
    zero_b = torch.zeros(b, dtype=dtype, device=device)
    a_prev = tuple((zero_b,) * 4 for _ in range(4))
    slots = int(lengths.max()) if lengths.numel() else 0
    for t in range(slots - 1, -1, -1):
        active = t < n
        if not bool(active.any()):
            continue
        slot = torch.where(active, offsets[w] + t, 0)
        rec = unpack_record(geometry[slot, :, lane],
                            coefficients[slot, :, lane], nf)
        new_re, new_im = tp.apply_record(re, im, a_prev, rec, rotation_split)
        act = active[:, None]
        re = tuple(torch.where(act, x, y) for x, y in zip(new_re, re))
        im = tuple(torch.where(act, x, y) for x, y in zip(new_im, im))
        a_prev = tuple(tuple(torch.where(active, x, y)
                             for x, y in zip(rx, ry))
                       for rx, ry in zip(rec["a_cur"], a_prev))
    h0 = samples[w, 0, SAMPLE_VALUES - 1, lane]
    dl_pv = torch.where(n > 0, -h0, 0.0)
    nn_re, nn_im = tp.finish_transport(re, im, a_prev, dl_pv)
    return torch.cat((nn_re, nn_im), -1)


class _PlainStages:
    """The stages' plain versions for _route (the CPU twin of
    _CudaStages)."""

    def __init__(self, positions, directions, momentum_factors, frequencies,
                 params, sp, grid, mass_msun, camera_x, integrator,
                 rotation_split):
        self.rays = (positions, directions, momentum_factors)
        self.frequencies = frequencies
        self.model = (params, sp, grid, mass_msun, camera_x)
        self.integrator = integrator
        self.rotation_split = rotation_split

    def trace(self, r0, r1, flags, n_samples):
        samples, f, ns = trace_samples_reference(
            self.rays[0][r0:r1], self.rays[1][r0:r1], self.model[0],
            self.integrator)
        flags.copy_(f)
        n_samples.copy_(ns)
        return samples

    def derive(self, piece, f0, f1, geometry):
        g, coefficients, bits = derive_records_reference(
            piece.samples, piece.n_samples, piece.lengths, piece.offsets,
            self.rays[1][piece.r0:piece.r1], self.rays[2][piece.r0:piece.r1],
            self.frequencies, f0, f1, *self.model)
        return (g if geometry is None else geometry), coefficients, bits

    def chain(self, piece, geometry, coefficients, nf):
        return chain_records_reference(
            piece.samples, piece.n_samples, piece.lengths, piece.offsets,
            geometry, coefficients, nf, self.rotation_split)


def render_polarized_staged_reference(
        positions, directions, momentum_factors, frequencies,
        params: geo.GeodesicParams, sp: sk.SimKernelParams,
        grid: SimulationGrid, mass_msun: float, camera_x,
        log_j_scale: float = 0.0, integrator: str = "rk4",
        rotation_split: bool = False, *, trace_bytes=math.inf,
        record_bytes=math.inf):
    """The CUDA route's glue (_route: trace chunks, record pieces,
    frequency groups) with the stages' plain versions; without byte caps,
    one chunk of one piece. Returns what ``render_polarized`` returns."""
    del log_j_scale
    _check_rays(positions, directions, momentum_factors)
    sk._check_frequencies(frequencies, positions)
    stages = _PlainStages(positions, directions, momentum_factors,
                          frequencies, params, sp, grid, mass_msun, camera_x,
                          integrator, rotation_split)
    return _route(positions, directions, momentum_factors, frequencies,
                  params, stages, trace_bytes, record_bytes)


def poisoned_stokes(nn_re, nn_im, flags, bad, positions, directions,
                    frequencies, params: geo.GeodesicParams, geom,
                    log_j_scale: float, fallback_nan: bool) -> dict:
    """Camera-frame I, Q, U, V (B, F) from ``render_polarized``'s output,
    NaN where ``(flags & fallback_nan) | bad`` (pipeline_simulation.py
    :492-510)."""
    stokes = tp.camera_stokes(nn_re, nn_im, positions, directions, params.bh_a,
                           params.bh_m, params.ray_flat, frequencies,
                           geom.u_con, geom.u_cov, geom.vert_con_c,
                           log_j_scale)
    poison = (flags & fallback_nan)[:, None] | bad
    return {k: torch.where(poison, math.nan, v)
            for k, v in zip(("I_nu", "Q_nu", "U_nu", "V_nu"), stokes)}
