"""Geodesic integration parameters, the Dormand-Prince tableau and the
lock-step ray loop of the fused kernels' plain versions.

Port of the parameter half of ``blacklight_tpu/ops/geodesic.py:44-98``
and of its windowed sweep (``masked_step``, ``segment_carries``,
``replay_window``, :462-521). The step loop itself runs inside the fused
kernels (``csrc/trace.cuh`` on the card); ``step`` is one of its steps in
plain torch ops, from which ``trace_steps`` (one phase of the loop),
``trace_reference`` (the loop of
``ops/formula_kernel.render_formula_reference`` and
``ops/simulation_kernel.render_simulation_reference``), ``trace_compacted``
(the scan route's loop, which drops finished rays and replays steps from
CUDA graphs) and the windowed sweep of
``ops/polarized_kernel.render_polarized_reference`` are built.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from blacklight_tpu_torch.constants import RayIntegrator, RayTerminate
from blacklight_tpu_torch.ops.geometry import (
    geodesic_rhs_c,
    radius_c,
    renormalize_factor_c,
)

# Dormand-Prince RK5(4)7M coefficients (1980 JCoAM 6 19), as in the
# reference geodesics.cpp:42-72. csrc/kerr.cuh holds the same table; the
# tests check the two against each other.
DP_A = (
    (),
    (1.0 / 5.0,),
    (3.0 / 40.0, 9.0 / 40.0),
    (44.0 / 45.0, -56.0 / 15.0, 32.0 / 9.0),
    (19372.0 / 6561.0, -25360.0 / 2187.0, 64448.0 / 6561.0, -212.0 / 729.0),
    (9017.0 / 3168.0, -355.0 / 33.0, 46732.0 / 5247.0, 49.0 / 176.0,
     -5103.0 / 18656.0),
    (35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0,
     11.0 / 84.0),
)
DP_B5 = (35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0,
         -2187.0 / 6784.0, 11.0 / 84.0, 0.0)
DP_B4 = (5179.0 / 57600.0, 0.0, 7571.0 / 16695.0, 393.0 / 640.0,
         -92097.0 / 339200.0, 187.0 / 2100.0, 1.0 / 40.0)
DP_B4M = (6025192743.0 / 30085553152.0, 0.0, 51252292925.0 / 65400821598.0,
          -2691868925.0 / 45128329728.0, 187940372067.0 / 1594534317056.0,
          -1776094331.0 / 19743644256.0, 11237099.0 / 235043384.0)
DP_ERR_POWER = 0.2
DP_ERR_FACTOR = 0.9
DP_MIN_FACTOR = 0.2
DP_MAX_FACTOR = 10.0


@dataclasses.dataclass(frozen=True)
class GeodesicParams:
    """Static integration parameters (subset of Config, all Python scalars)."""

    integrator: RayIntegrator
    bh_m: float
    bh_a: float
    ray_flat: bool
    ray_step: float
    ray_max_steps: int
    r_terminate: float
    camera_r: float
    r_horizon: float
    ray_tol_abs: float = 1.0e-8
    ray_tol_rel: float = 1.0e-8
    ray_max_retries: int = 20


def horizon_radius(bh_m: float, bh_a: float) -> float:
    """r_+ = M + sqrt(M^2 - a^2) (geodesic_integrator.cpp:117)."""
    return bh_m + math.sqrt(bh_m * bh_m - bh_a * bh_a)


def terminate_radius(ray_terminate, ray_factor: float, bh_m: float,
                     bh_a: float) -> float:
    """Inner termination radius (geodesic_integrator.cpp:118-123)."""
    r_h = horizon_radius(bh_m, bh_a)
    if ray_terminate == RayTerminate.photon:
        return 2.0 * bh_m * (1.0 + math.cos(
            2.0 / 3.0 * math.acos(-abs(bh_a) / bh_m)))
    if ray_terminate == RayTerminate.multiplicative:
        return r_h * ray_factor
    return r_h + ray_factor


# Index order of the geodesic block that opens every fused kernel's float64
# parameter vector: the enum GeodesicParam in csrc/trace.cuh with its "G_"
# prefix dropped.
GEODESIC_PARAM_NAMES = (
    "SPIN", "A2", "TWO_SPIN", "TWO_A2", "THREE_A2", "TWO_MASS",
    "FLAT", "RAY_STEP", "CAMERA_R", "R_TERMINATE", "R_HORIZON", "TOL_ABS",
    "TOL_REL", "MAX_STEPS", "MAX_RETRIES", "FALLBACK_NAN",
)


def geodesic_param_values(params: GeodesicParams, fallback_nan: bool) -> dict:
    """The geodesic block by name, every derived constant folded in
    float64 (the kernel rounds each once to its working type, as JAX
    rounds a Python scalar)."""
    spin, mass = params.bh_a, params.bh_m
    return {
        "SPIN": spin, "A2": spin * spin, "TWO_SPIN": 2.0 * spin,
        "TWO_A2": 2.0 * (spin * spin), "THREE_A2": 3.0 * (spin * spin),
        "TWO_MASS": 2.0 * mass, "FLAT": params.ray_flat,
        "RAY_STEP": params.ray_step, "CAMERA_R": params.camera_r,
        "R_TERMINATE": params.r_terminate, "R_HORIZON": params.r_horizon,
        "TOL_ABS": params.ray_tol_abs, "TOL_REL": params.ray_tol_rel,
        "MAX_STEPS": params.ray_max_steps,
        "MAX_RETRIES": params.ray_max_retries,
        "FALLBACK_NAN": fallback_nan,
    }


def pack_params(names, values: dict) -> list:
    """``values`` as a list in ``names`` order; the two must hold the same
    names."""
    if set(values) != set(names):
        raise AssertionError(sorted(set(values) ^ set(names)))
    return [float(values[name]) for name in names]


class RayState(NamedTuple):
    """The integrator state of a ray bundle between two steps, each field
    (B,): the seven dynamical components y (x^0..x^3, p_1..p_3; p_0 is
    conserved), the dp controller (h, num_retry, prev_fail) and the
    bookkeeping of stored samples. A window's replay starts from one of
    these (``segment_carries``)."""

    y: tuple
    h: torch.Tensor
    alive: torch.Tensor
    trunc: torch.Tensor
    flag: torch.Tensor
    prev_fail: torch.Tensor
    r_mid_prev: torch.Tensor
    n_samples: torch.Tensor
    num_retry: torch.Tensor


class Sample(NamedTuple):
    """One step's stored sample, each field over the bundle: ``valid``
    (B,) marks the rays whose sample counts, ``x`` the position
    (x^0..x^3), ``k`` the null-renormalized covariant momentum
    (p_0..p_3) and ``h`` the signed affine step."""

    valid: torch.Tensor
    x: tuple
    k: tuple
    h: torch.Tensor


def initial_state(positions, directions, params: GeodesicParams) -> RayState:
    x0, x1, x2, x3 = positions.unbind(-1)
    _, p1, p2, p3 = directions.unbind(-1)
    false = torch.zeros_like(x0, dtype=torch.bool)
    izero = torch.zeros_like(x0, dtype=torch.int32)
    return RayState(
        y=(x0, x1, x2, x3, p1, p2, p3),
        h=-params.ray_step * radius_c(x1, x2, x3, params.bh_a),
        alive=~false, trunc=false, flag=false, prev_fail=false,
        r_mid_prev=torch.zeros_like(x0), n_samples=izero, num_retry=izero)


def _add_stage(base, weights, k, h):
    out = []
    for ci in range(7):
        acc = None
        for q, w in enumerate(weights):
            if w == 0.0:
                continue
            term = (w * h) * k[q][ci]
            acc = term if acc is None else acc + term
        out.append(base[ci] if acc is None else base[ci] + acc)
    return out


def step(state: RayState, p0, n: int, params: GeodesicParams,
         integrator: str):
    """Advance every ray of the bundle by step index ``n`` (< max_steps)
    in lock step; returns (new state, the step's Sample).

    The JAX kernel's forms are kept, where-guards included: masks select
    the state updates and dead rays park at a benign state. ``p0`` is the
    rays' conserved p_0.
    """
    spin, mass, flat = params.bh_a, params.bh_m, params.ray_flat
    max_steps = params.ray_max_steps
    y, alive = list(state.y), state.alive
    false = torch.zeros_like(alive)

    def rhs(v, with_distance=False):
        return geodesic_rhs_c(v[1], v[2], v[3], p0, v[4], v[5], v[6], spin,
                              mass, flat=flat, with_distance=with_distance)

    def renorm(v):
        return renormalize_factor_c(v[1], v[2], v[3], p0, v[4], v[5], v[6],
                                    spin, mass, flat=flat)

    r = radius_c(y[1], y[2], y[3], spin)
    if integrator == "dp":
        k = [None] * 7
        k[0] = rhs(y, with_distance=True)
        ds_dlam = torch.abs(k[0][7]) + 1e-30
        h_cap = params.ray_step * r / ds_dlam
        h = -torch.minimum(torch.abs(state.h), h_cap)
        for i in range(1, 7):
            k[i] = rhs(_add_stage(y, DP_A[i], k, h))
        y_end = _add_stage(y, DP_B5, k, h)
        y4 = _add_stage(y, DP_B4, k, h)
        y_mid = _add_stage(y, DP_B4M, k, h)

        err = torch.zeros_like(r)
        for ci in range(7):
            ya = torch.maximum(torch.abs(y[ci]), torch.abs(y_end[ci]))
            sc = params.ray_tol_abs + params.ray_tol_rel * ya
            err = torch.maximum(err, torch.abs(y_end[ci] - y4[ci]) / sc)
        accept = err <= 1.0
        err_safe = torch.clamp(err, min=1e-30)
        fac_ideal = DP_ERR_FACTOR * err_safe ** (-DP_ERR_POWER)
        fac_rej = torch.clamp(
            torch.where(torch.isfinite(err), fac_ideal, DP_MIN_FACTOR),
            min=DP_MIN_FACTOR)
        fac_acc = torch.clamp(fac_ideal, DP_MIN_FACTOR, DP_MAX_FACTOR)
        fac_acc = torch.where(err == 0.0, DP_MAX_FACTOR, fac_acc)
        fac_acc = torch.where(state.prev_fail, torch.clamp(fac_acc, max=1.0),
                              fac_acc)
        h_next = h * torch.where(accept, fac_acc, fac_rej)
        retry = torch.where(accept, 0, state.num_retry + 1)
        retry_exceeded = retry > params.ray_max_retries
    else:
        h = torch.where(alive, -params.ray_step * (r - params.r_horizon), 0.0)
        k1 = rhs(y)
        if integrator == "rk4":
            k2 = rhs([y[c] + (0.5 * h) * k1[c] for c in range(7)])
            k3 = rhs([y[c] + (0.5 * h) * k2[c] for c in range(7)])
            k4 = rhs([y[c] + (1.0 * h) * k3[c] for c in range(7)])
            y_end = [y[c] + h * (k1[c] * (1.0 / 6.0) + k2[c] * (1.0 / 3.0)
                                 + k3[c] * (1.0 / 3.0) + k4[c] * (1.0 / 6.0))
                     for c in range(7)]
            y_mid = [0.5 * (y[c] + y_end[c]) for c in range(7)]
        else:  # rk2 (Heun); the sample is y + h/2 k1
            k2 = rhs([y[c] + (1.0 * h) * k1[c] for c in range(7)])
            y_end = [y[c] + 0.5 * h * (k1[c] + k2[c]) for c in range(7)]
            y_mid = [y[c] + (0.5 * h) * k1[c] for c in range(7)]
        accept = ~false
        retry_exceeded = false

    fac = renorm(y_end)
    r_new = radius_c(y_end[1], y_end[2], y_end[3], spin)
    facm = renorm(y_mid)
    r_mid = radius_c(y_mid[1], y_mid[2], y_mid[3], spin)

    trunc_now = (state.n_samples > 0) & (
        ((r_mid > params.camera_r) & (r_mid > state.r_mid_prev))
        | (r_mid < params.r_terminate))
    trunc = state.trunc | (accept & trunc_now)
    valid = alive & accept & ~trunc & ~retry_exceeded
    terminate = ((r_new > params.camera_r) & (r_new > r)) \
        | (r_new < params.r_terminate)
    flag = state.flag | (alive & retry_exceeded) \
        | (alive & accept & ~terminate & (n == max_steps - 1))
    alive_new = alive & ~(accept & terminate) & ~retry_exceeded

    sample = Sample(valid, tuple(y_mid[:4]),
                    (p0, y_mid[4] * facm, y_mid[5] * facm, y_mid[6] * facm),
                    h)

    stepped = (y_end[0], y_end[1], y_end[2], y_end[3],
               y_end[4] * fac, y_end[5] * fac, y_end[6] * fac)
    parked = (0.0, 1.0e3, 0.0, 0.0, 1.0, 0.0, 0.0)
    moved = alive & accept
    park = ~alive_new
    new = RayState(
        y=tuple(torch.where(park, parked[c],
                            torch.where(moved, stepped[c], y[c]))
                for c in range(7)),
        h=torch.where(alive, h_next, state.h) if integrator == "dp"
        else state.h,
        alive=alive_new, trunc=trunc, flag=flag,
        prev_fail=(alive & ~accept) | (~alive & state.prev_fail),
        r_mid_prev=torch.where(valid, r_mid, state.r_mid_prev),
        n_samples=state.n_samples + valid.to(torch.int32),
        num_retry=torch.where(alive, retry, state.num_retry)
        if integrator == "dp" else state.num_retry)
    return new, sample


def trace_steps(state: RayState, p0, params: GeodesicParams, integrator: str,
                n_begin: int, n_end: int, on_sample) -> RayState:
    """Run ``step`` for n in [n_begin, min(n_end, max_steps)) while any
    ray of the bundle is alive, handing every step's Sample to
    ``on_sample``; returns the state after the last step. One phase of
    phased dispatch, or with [0, max_steps) the whole trace.

    on_sample(valid, x, k, h) is called once per step with the fields of
    ``step``'s Sample; it sees every ray, valid or not.
    """
    n = n_begin
    while n < min(n_end, params.ray_max_steps) and bool(state.alive.any()):
        state, sample = step(state, p0, n, params, integrator)
        on_sample(*sample)
        n += 1
    return state


def trace_reference(positions, directions, params: GeodesicParams,
                    integrator: str, on_sample):
    """Integrate a ray bundle in lock step and hand every step's Sample to
    ``on_sample`` (``trace_steps`` over [0, max_steps)): the loop of the
    fused kernels, in plain torch ops over (B,) tensors.

    Returns (flag (B,) bool, n_samples (B,) int32).
    """
    state = trace_steps(initial_state(positions, directions, params),
                        directions[:, 0], params, integrator, 0,
                        params.ray_max_steps, on_sample)
    return state.flag, state.n_samples


# The scan route's loop (``trace_compacted``): the live-ray count is read
# (one host sync) every COMPACT_CHECK_STEPS steps, and the bundle drops its
# finished rays when its live rays are fewer than COMPACT_SHARE of its
# rows. A compacted bundle keeps COMPACT_ROWS-multiples of rows ahead of
# the original bundle's last (B mod COMPACT_ROWS) rays, which stay at its
# end: torch's CPU loops take the vector or the scalar form of an op by an
# element's distance from the end of its tensor (the last n mod 2w
# elements of n, w the vector width: 8 or 16 lanes), so every row keeps
# the form, and the bits, it had in the whole bundle. On a CUDA device
# every bundle's step after the first COMPACT_CHECK_STEPS steps is
# captured once in a CUDA graph and replayed (the same kernels on the same
# tensors: the eager route is bound by the host's ~1,860 launches a step).
COMPACT_CHECK_STEPS = 16
COMPACT_SHARE = 0.75
COMPACT_ROWS = 64
# Whether trace_compacted replays steps from CUDA graphs on a CUDA device
# (off: every step eager, as on the CPU).
STEP_GRAPHS = True
# Lock steps taken by trace_compacted (replayed ones included), for
# callers that time a step.
LOCK_STEPS = 0


def _gather_state(state: RayState, index) -> RayState:
    return RayState(*(tuple(c.index_select(0, index) for c in f)
                      if isinstance(f, tuple) else f.index_select(0, index)
                      for f in state))


def _final(state: RayState, carry: dict) -> tuple:
    """What trace_compacted returns of each ray, by name."""
    return (("flag", state.flag), ("n_samples", state.n_samples),
            *carry.items())


def _flat(state: RayState, p0, carry: dict) -> list:
    return [*state.y, *state[1:], p0, *carry.values()]


def _unflat(flat: list, keys) -> tuple:
    state = RayState(tuple(flat[:7]), *flat[7:15])
    return state, flat[15], dict(zip(keys, flat[16:]))


class _StepGraph:
    """A lock step of one bundle captured in a CUDA graph: each replay
    advances the bundle's state and carry, which live in the graph's own
    input tensors (``state``, ``p0``, ``carry``), by one step that is not
    the last (n < max_steps - 1, the only step whose index the step
    reads)."""

    def __init__(self, state, p0, carry, params, integrator, on_sample):
        keys = tuple(carry)
        static = [t.clone() for t in _flat(state, p0, carry)]
        self.state, self.p0, self.carry = _unflat(static, keys)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            new, sample = step(self.state, self.p0, -1, params, integrator)
            carry = dict(self.carry)
            on_sample(*sample, carry)
            for dst, src in zip(static, _flat(new, self.p0, carry)):
                if src is not dst:
                    dst.copy_(src)

    def replay(self) -> None:
        self.graph.replay()


def trace_compacted(positions, directions, params: GeodesicParams,
                    integrator: str, carry: dict, on_sample):
    """The loop of ``trace_reference`` for a caller that keeps per-ray
    tensors: each ray's steps and samples are bit for bit the lock-step
    loop's, but finished rays leave the bundle.

    carry: per-ray tensors (first dimension B), the caller's inputs and
    accumulators. on_sample(valid, x, k, h, carry) is called once per step
    with the fields of ``step``'s Sample over the rays the bundle still
    holds, and with ``carry`` holding those rays' rows; it replaces the
    accumulators in ``carry`` and makes no host sync (on a CUDA device
    it is captured in a graph). A finished ray's sample is invalid and
    must leave its accumulators as they are, as the loop's are left: the
    loop may step a bundle whose rays have all finished (up to
    COMPACT_CHECK_STEPS - 1 steps) and keeps some finished rays in it.

    Returns (flag (B,) bool, n_samples (B,) int32, carry with every ray's
    final rows in the caller's order).
    """
    global LOCK_STEPS
    b = positions.shape[0]
    state = initial_state(positions, directions, params)
    p0 = directions[:, 0]
    fixed = b % COMPACT_ROWS  # the last rays, never moved
    rows = None  # the bundle's rays in the caller's order; None: all
    out = None
    graph = None
    on_card = STEP_GRAPHS and positions.device.type == "cuda"
    last = params.ray_max_steps - 1
    n = 0
    while n <= last:
        if on_card and graph is None and n > 0:
            graph = _StepGraph(state, p0, carry, params, integrator,
                               on_sample)
            state, p0, carry = graph.state, graph.p0, graph.carry
        for n in range(n, min(n + COMPACT_CHECK_STEPS, last + 1)):
            if graph is not None and n < last:
                graph.replay()
            else:
                state, sample = step(state, p0, n, params, integrator)
                on_sample(*sample, carry)
            LOCK_STEPS += 1
        n += 1
        m = state.alive.shape[0]
        body = m - fixed
        alive_body, alive = (int(v) for v in torch.stack(
            [state.alive[:body].sum(), state.alive.sum()]).tolist())
        if alive == 0:
            break
        if alive >= COMPACT_SHARE * m:
            continue
        # every live ray of the body, then its first finished ones up to a
        # multiple of COMPACT_ROWS, in order; then the fixed rays
        pad = -alive_body % COMPACT_ROWS
        if alive_body + pad == body:
            continue
        dead = ~state.alive[:body]
        keep = state.alive[:body] | (dead & (torch.cumsum(dead, 0) <= pad))
        kept = keep.nonzero().squeeze(1)
        index = torch.cat([kept, torch.arange(body, m,
                                              device=kept.device)])
        drop = (~keep).nonzero().squeeze(1)
        if out is None:
            rows = torch.arange(b, device=kept.device)
            out = {k: torch.empty_like(v) for k, v in _final(state, carry)}
        dropped = rows.index_select(0, drop)
        for key, value in _final(state, carry):
            out[key].index_copy_(0, dropped, value.index_select(0, drop))
        rows = rows.index_select(0, index)
        state = _gather_state(state, index)
        p0 = p0.index_select(0, index)
        carry = {k: v.index_select(0, index) for k, v in carry.items()}
        graph = None
    if out is None:
        return state.flag, state.n_samples, carry
    for key, value in _final(state, carry):
        out[key].index_copy_(0, rows, value)
    flag, n_samples = out.pop("flag"), out.pop("n_samples")
    return flag, n_samples, out


def segment_carries(positions, directions, params: GeodesicParams,
                    integrator: str, window: int):
    """Sweep the whole integration, keeping only the state that enters
    each window of ``window`` steps (JAX segment_carries): the
    polarized transfer consumes samples far end first and replays one
    window at a time from these (``replay_window``).

    Windows after the one in which the last ray dies are left out: from
    there every step leaves the state as it is and stores no sample, as
    the masked steps past ray_max_steps do.

    Returns (starts, flag, n_samples), starts[k] the state entering step
    k * window.
    """
    state = initial_state(positions, directions, params)
    p0 = directions[:, 0]
    starts = []
    n_seg = -(-params.ray_max_steps // window)
    for k in range(n_seg):
        if not bool(state.alive.any()):
            break
        starts.append(state)
        for n in range(k * window, min((k + 1) * window,
                                       params.ray_max_steps)):
            state, _ = step(state, p0, n, params, integrator)
    return starts, state.flag, state.n_samples


def replay_window(start: RayState, p0, params: GeodesicParams,
                  integrator: str, k: int, window: int) -> list:
    """Re-integrate window k from its entering state; returns its Samples
    in step order, bit for bit those of the forward sweep. Steps past
    ray_max_steps are left out (JAX masked_step)."""
    samples = []
    state = start
    for n in range(k * window, min((k + 1) * window, params.ray_max_steps)):
        state, sample = step(state, p0, n, params, integrator)
        samples.append(sample)
    return samples
