"""PyTorch port: the parts of the polarized transfer against the JAX
package: Bessel K, the polarized thermal coefficients, the transport
matrix, the tetrad rows, the coherency bookkeeping, the camera-frame
Stokes extraction, the matter coupling in every regime, and the windowed
replay of the geodesic sweep.

Each function gets the same inputs on both sides, made with a seeded
numpy generator. float64 is held at rtol 1e-12 (relative to each array's
largest value where the test says so); float32 at the tolerance each
test states.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blacklight_tpu.models import synchrotron as jsyn
from blacklight_tpu.ops import connection as jconn
from blacklight_tpu.ops import tetrad as jtet
from blacklight_tpu.transfer import polarized as jpol
from blacklight_tpu.transfer import polarized_coupling as jpc
from blacklight_tpu_torch import RayIntegrator, interop
from blacklight_tpu_torch.models import synchrotron
from blacklight_tpu_torch.ops import connection, geodesic, tetrad
from blacklight_tpu_torch.transfer import polarized, polarized_coupling

from test_polarized_scalar import _random_coeffs
from test_torch_synchrotron import (
    SPIN,
    STATE_KEYS,
    _close,
    _inputs,
    _jax_state,
    _plasma,
    _torch,
    _torch_state,
)

torch.set_num_threads(2)


def _t(a, precision="float64"):
    return _torch(a, precision)


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_bessel_k(precision):
    """The series (x <= 3) and CF2 / asymptotic (x > 3) branches and the
    e^x-scaled triple. float32: 1e-5 (the asymptotic series is the JAX
    package's own form, so both sides agree far below its 1e-3 error)."""
    x = np.concatenate([np.geomspace(1e-6, 3.0, 40),
                        np.linspace(3.0, 100.0, 60)])
    jd = jnp.float64 if precision == "float64" else jnp.float32
    rtol = 1e-12 if precision == "float64" else 1e-5
    ours = synchrotron._bessel_k012_scaled(_t(x, precision))
    ref = jsyn._bessel_k012_scaled(jnp.asarray(x, jd))
    for name, a, b in zip(("k0s", "k1s", "k2s"), ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   err_msg=name)
    if precision == "float64":
        xk = x[x < 600.0]
        for order in range(3):
            np.testing.assert_allclose(
                synchrotron._bessel_k(order, _t(xk)).numpy(),
                np.asarray(jsyn._bessel_k(order, jnp.asarray(xk))),
                rtol=1e-12, err_msg=f"K{order}")


def _cells():
    """The sampled cells of test_torch_synchrotron plus cold cells
    (theta_e below THETA_E_ZERO), hot cells and wavevectors along and
    across the field; zero-field cells are among them."""
    pos, samples, kcov = _inputs(n=1200, seed=11)
    n = pos.shape[0]
    samples["pgas"][: n // 6] *= 1e-6          # cold
    samples["pgas"][n // 6: n // 3] *= 1e3     # hot
    return pos, samples, kcov


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_thermal_coefficients_polarized(precision):
    """j, alpha and rho in I, Q and V on cold, hot, field-aligned and
    field-free cells, two frequencies. float32: 2e-5 relative to each
    coefficient's largest value (exp(-x^(1/3)) and the rho fit's powers
    turn an ulp of x into a few ulps)."""
    pos, samples, kcov = _cells()
    plasma = _plasma(True)
    state = _jax_state(pos, samples, plasma, "float64")
    n = pos.shape[0]
    # field-aligned and field-perpendicular wavevectors for a few cells
    b = np.asarray(state["bcon"])
    kcov = kcov.copy()
    kcov[n - 20:, 1:] = b[n - 20:, 1:]
    sin_b, cos_b, sin2_b, u_dot_k = jsyn.pitch_angle(
        jnp.asarray(pos), jnp.asarray(kcov), state, SPIN)
    freqs = np.array([2.3e11, 8.6e11])
    nu_cgs = -np.asarray(u_dot_k)[:, None] * freqs[None, :] * 1.05
    nu0 = float(freqs[0])
    assert np.any(np.asarray(state["theta_e"]) < jsyn.THETA_E_ZERO)
    assert np.any(np.asarray(state["theta_e"]) > 10.0)
    ours = synchrotron.thermal_coefficients(
        _t(nu_cgs, precision), nu0, _torch_state(state, precision),
        _t(sin_b, precision), interop.plasma_params_from_jax(plasma),
        cos_theta_b=_t(cos_b, precision), sin2_theta_b=_t(sin2_b, precision),
        polarized=True)
    jd = jnp.float64 if precision == "float64" else jnp.float32
    jstate = {k: jnp.asarray(np.asarray(state[k]), jd) for k in STATE_KEYS}
    ref = jsyn.thermal_coefficients(
        jnp.asarray(nu_cgs, jd), nu0, jstate, jnp.asarray(sin_b, jd),
        jnp.asarray(cos_b, jd), jnp.asarray(sin2_b, jd), plasma,
        polarized=True)
    assert set(ours) == set(ref)
    rtol = 1e-12 if precision == "float64" else 2e-5
    for key in ref:
        _close(ours[key].numpy(), np.asarray(ref[key]), rtol, err_msg=key)
        assert float(torch.nan_to_num(ours[key]).abs().max()) > 0.0, key
    # the unpolarized call keeps its values
    j, alpha = synchrotron.thermal_coefficients(
        _t(nu_cgs, precision), nu0, _torch_state(state, precision),
        _t(sin_b, precision), interop.plasma_params_from_jax(plasma))
    assert torch.equal(torch.nan_to_num(j), torch.nan_to_num(ours["j_i"]))
    assert torch.equal(torch.nan_to_num(alpha),
                       torch.nan_to_num(ours["alpha_i"]))


def _points(seed, n=256):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-12.0, 12.0, (n, 3))
    x[:, 2] += np.where(np.abs(x[:, 2]) < 1.5, 3.0, 0.0)
    return x, rng


@pytest.mark.parametrize("flat", [False, True])
def test_transport_matrix_c(flat):
    x, rng = _points(7)
    k = rng.normal(size=(x.shape[0], 4))
    ours = connection.transport_matrix_c(
        *(_t(x[:, i]) for i in range(3)), *(_t(k[:, i]) for i in range(4)),
        0.9375, 1.0, flat=flat)
    ref = jconn.transport_matrix_c(
        *(jnp.asarray(x[:, i]) for i in range(3)),
        *(jnp.asarray(k[:, i]) for i in range(4)), 0.9375, 1.0, flat=flat)
    for m in range(4):
        for n in range(4):
            np.testing.assert_allclose(ours[m][n].numpy(),
                                       np.asarray(ref[m][n]), rtol=1e-12,
                                       atol=1e-15, err_msg=f"A[{m}][{n}]")
    if flat:
        assert all(not bool(v.any()) for row in ours for v in row)


@pytest.mark.parametrize("with_ucov", [False, True])
def test_tetrad_rows_c(with_ucov):
    x, rng = _points(8)
    n = x.shape[0]
    r, f, l_lower = (np.asarray(v) for v in jpol.geometry.ks_scalars(
        jnp.asarray(x), 0.6, 1.0))
    ucon = np.concatenate([np.full((n, 1), 1.3), rng.normal(0, 0.3, (n, 3))],
                          axis=1)
    kcov = np.concatenate([-np.ones((n, 1)), rng.normal(0, 1.0, (n, 3))],
                          axis=1)
    kcon = rng.normal(0, 1.0, (n, 4))
    up = rng.normal(0, 1.0, (n, 4))
    ucov = rng.normal(0, 1.0, (n, 4))

    def comps(a, conv):
        return tuple(conv(a[:, m]) for m in range(4))

    extra_t = {"ucov": comps(ucov, _t)} if with_ucov else {}
    extra_j = {"ucov": comps(ucov, jnp.asarray)} if with_ucov else {}
    ours = tetrad.tetrad_rows_c(
        comps(ucon, _t), comps(kcon, _t), comps(kcov, _t), comps(up, _t),
        _t(f), tuple(_t(l_lower[:, i]) for i in range(3)), **extra_t)
    ref = jtet.tetrad_rows_c(
        comps(ucon, jnp.asarray), comps(kcon, jnp.asarray),
        comps(kcov, jnp.asarray), comps(up, jnp.asarray), jnp.asarray(f),
        tuple(jnp.asarray(l_lower[:, i]) for i in range(3)), **extra_j)
    for name, a, b in zip(("t1", "t2", "e1_cov", "e2_cov"), ours, ref):
        for m in range(4):
            _close(a[m].numpy(), np.asarray(b[m]), 1e-12,
                   err_msg=f"{name}[{m}]")


def _coherency(rng, shape):
    re = tuple(rng.normal(size=shape) for _ in range(10))
    im = tuple(rng.normal(size=shape) for _ in range(6))
    return re, im


def test_coherency_bookkeeping():
    """_transport_c, _stokes_from_n and _n_from_stokes on (B, F)
    components with per-ray (B, 1) matrices, rows and steps."""
    rng = np.random.default_rng(3)
    b, nf = 64, 2
    re, im = _coherency(rng, (b, nf))
    base_re, base_im = _coherency(rng, (b, nf))
    a_mat = rng.normal(size=(4, 4, b, 1))
    dl = rng.normal(size=(b, 1))
    ours = polarized._transport_c(
        [[_t(a_mat[m][n]) for n in range(4)] for m in range(4)],
        tuple(map(_t, re)), tuple(map(_t, im)), tuple(map(_t, base_re)),
        tuple(map(_t, base_im)), _t(dl))
    ref = jpol._transport_c(
        [[jnp.asarray(a_mat[m][n]) for n in range(4)] for m in range(4)],
        tuple(map(jnp.asarray, re)), tuple(map(jnp.asarray, im)),
        tuple(map(jnp.asarray, base_re)), tuple(map(jnp.asarray, base_im)),
        jnp.asarray(dl))
    for part_o, part_r in zip(ours, ref):
        for a, c in zip(part_o, part_r):
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-12,
                                       atol=1e-12)

    e1, e2 = rng.normal(size=(4, b, 1)), rng.normal(size=(4, b, 1))
    ours = polarized._stokes_from_n(list(map(_t, e1)), list(map(_t, e2)),
                                    tuple(map(_t, re)), tuple(map(_t, im)))
    ref = jpol._stokes_from_n(list(map(jnp.asarray, e1)),
                              list(map(jnp.asarray, e2)),
                              tuple(map(jnp.asarray, re)),
                              tuple(map(jnp.asarray, im)))
    for a, c in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-12,
                                   atol=1e-12)

    s = rng.normal(size=(4, b, nf))
    ours = polarized._n_from_stokes(list(map(_t, e1)), list(map(_t, e2)),
                                    *map(_t, s))
    ref = jpol._n_from_stokes(list(map(jnp.asarray, e1)),
                              list(map(jnp.asarray, e2)),
                              *map(jnp.asarray, s))
    for part_o, part_r in zip(ours, ref):
        for a, c in zip(part_o, part_r):
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-12,
                                       atol=1e-12)


@pytest.mark.parametrize("flat", [False, True])
def test_camera_stokes(fixtures_dir, flat):
    """The camera tetrad of each pixel and the nu^3 scale, on the JAX
    package's own camera (carried across by interop) and random final
    coherency components, two frequencies."""
    from blacklight_tpu import read_config as jax_read_config
    from blacklight_tpu.camera import make_camera as jax_make_camera
    cfg = jax_read_config(str(fixtures_dir / "golden_polarized_rk4_32.input"))
    cfg.camera_resolution = 8
    cfg.ray_flat = flat
    spin = 0.5
    geom, rays, _ = jax_make_camera(cfg, bh_m=1.0, bh_a=spin,
                                    dtype=jnp.float64)
    b = rays.positions.shape[0]
    freqs = np.array([2.3e11, 4.6e11])
    rng = np.random.default_rng(9)
    nn_re, nn_im = rng.normal(size=(b, 2, 10)), rng.normal(size=(b, 2, 6))
    log_js = jsyn.log_j_scale(freqs[0])
    pos, dirs = np.asarray(rays.positions), np.asarray(rays.directions)
    ours = polarized.camera_stokes(
        _t(nn_re), _t(nn_im), _t(pos), _t(dirs), spin, 1.0, flat, _t(freqs),
        _t(geom.u_con), _t(geom.u_cov), _t(geom.vert_con_c), log_js)
    ref = jpol.camera_stokes(
        jnp.asarray(nn_re), jnp.asarray(nn_im), jnp.asarray(pos),
        jnp.asarray(dirs), spin, 1.0, flat, jnp.asarray(freqs),
        geom.u_con, geom.u_cov, geom.vert_con_c, log_js)
    for name, a, c in zip("IQUV", ours, ref):
        _close(a.numpy(), np.asarray(c), 1e-12, err_msg=name)


@pytest.mark.parametrize("regime",
                         ["free", "simple", "rotate", "absorb", "full",
                          "thick"])
@pytest.mark.parametrize("rotation_split", [False, True])
@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_couple_matter_c(regime, rotation_split, precision):
    """Every regime of the coupling ladder (the draws of
    tests/test_polarized_scalar.py). float32: 1e-5 relative to the
    largest Stokes value (sinh/cosh and exp of O(1) optical depths)."""
    rng = np.random.default_rng(42)
    n = 256
    c = _random_coeffs(rng, n, regime)
    ss = rng.normal(size=(n, 4))
    ss[:, 0] = np.abs(ss[:, 0]) + 0.1
    dl = rng.uniform(0.01, 1.0, n)
    names = ("j_i", "j_q", "j_v", "alpha_i", "alpha_q", "alpha_v", "rho_q",
             "rho_v")
    jd = jnp.float64 if precision == "float64" else jnp.float32
    ours = polarized_coupling.couple_matter_c(
        *(_t(ss[:, i], precision) for i in range(4)),
        *(_t(c[k], precision) for k in names), _t(dl, precision),
        rotation_split)
    ref = jpc.couple_matter_c(
        *(jnp.asarray(ss[:, i], jd) for i in range(4)),
        *(jnp.asarray(c[k], jd) for k in names), jnp.asarray(dl, jd),
        rotation_split)
    rtol = 1e-12 if precision == "float64" else 1e-5
    for i, (a, b) in enumerate(zip(ours, ref)):
        _close(a.numpy(), np.asarray(b), rtol, err_msg=f"s{i}")


@pytest.mark.parametrize("integrator", ["rk4", "dp"])
def test_replay_reproduces_forward_sweep(integrator):
    """Replaying each window from segment_carries gives the forward
    sweep's samples bit for bit, in a window that does not divide
    ray_max_steps, and the sweep's flags and counts are trace_reference's."""
    spin = 0.9
    params = geodesic.GeodesicParams(
        integrator=RayIntegrator[integrator], bh_m=1.0, bh_a=spin,
        ray_flat=False, ray_step=0.05, ray_max_steps=170,
        r_terminate=1.005 * geodesic.horizon_radius(1.0, spin),
        camera_r=30.0, r_horizon=geodesic.horizon_radius(1.0, spin),
        ray_tol_abs=1e-8, ray_tol_rel=1e-8, ray_max_retries=20)
    rng = np.random.default_rng(2)
    b = 32
    th = rng.uniform(0.3, 2.8, b)
    ph = rng.uniform(0, 2 * np.pi, b)
    r = 30.0
    pos = np.stack([np.zeros(b), r * np.sin(th) * np.cos(ph),
                    r * np.sin(th) * np.sin(ph), r * np.cos(th)], -1)
    aim = rng.normal(0.0, 4.0, (b, 3))
    p = pos[:, 1:] - aim  # traced backwards from the camera
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    dirs = np.concatenate([-np.ones((b, 1)), p], axis=1)
    positions, directions = _t(pos), _t(dirs)

    forward = []
    flag, n_samp = geodesic.trace_reference(
        positions, directions, params, integrator,
        lambda *s: forward.append(geodesic.Sample(*s)))
    window = 17
    starts, flag_w, n_w = geodesic.segment_carries(
        positions, directions, params, integrator, window)
    assert torch.equal(flag, flag_w) and torch.equal(n_samp, n_w)
    assert 1 < len(starts) <= -(-params.ray_max_steps // window)
    replayed = []
    for k in range(len(starts)):
        replayed += geodesic.replay_window(starts[k], directions[:, 0],
                                           params, integrator, k, window)
    assert len(replayed) >= len(forward)
    for a, c in zip(replayed, forward):
        assert torch.equal(a.valid, c.valid)
        v = c.valid
        assert torch.equal(a.h[v], c.h[v])
        for m in range(4):
            assert torch.equal(a.x[m][v], c.x[m][v])
            assert torch.equal(a.k[m][v], c.k[m][v])
    # steps past the forward loop's end store no sample
    assert not any(bool(s.valid.any()) for s in replayed[len(forward):])
    assert int(n_samp.sum()) == sum(int(s.valid.sum()) for s in forward)
