"""PyTorch port: Kerr-Schild geometry against the JAX package, float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blacklight_tpu.ops import geometry as jgeo
from blacklight_tpu_torch.ops import geometry as tgeo

torch.set_num_threads(2)

RTOL = 1e-12
SPIN, MASS = 0.9, 1.0


def _points(seed, n=256):
    """n random events outside the horizon and momenta, float64."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(2.5, 60.0, n)
    th = rng.uniform(0.05, np.pi - 0.05, n)
    ph = rng.uniform(0.0, 2.0 * np.pi, n)
    x = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                  r * np.cos(th)], axis=-1)
    p = rng.normal(size=(n, 4))
    p[:, 0] = -np.abs(p[:, 0]) - 0.5
    return x, p


def _t(a):
    return torch.tensor(a, dtype=torch.float64)


def _close(ours, ref):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=RTOL,
                               atol=1e-14)


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("with_distance", [False, True])
def test_geodesic_rhs_c(flat, with_distance):
    x, p = _points(0)
    args_j = [jnp.asarray(a) for a in (x[:, 0], x[:, 1], x[:, 2], p[:, 0],
                                       p[:, 1], p[:, 2], p[:, 3])]
    args_t = [_t(a) for a in (x[:, 0], x[:, 1], x[:, 2], p[:, 0], p[:, 1],
                              p[:, 2], p[:, 3])]
    ref = jgeo.geodesic_rhs_c(*args_j, SPIN, MASS, flat=flat,
                              with_distance=with_distance)
    ours = tgeo.geodesic_rhs_c(*args_t, SPIN, MASS, flat=flat,
                               with_distance=with_distance)
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        _close(o.numpy(), r)


@pytest.mark.parametrize("flat", [False, True])
def test_renormalize_factor_c(flat):
    x, p = _points(1)
    cols = (x[:, 0], x[:, 1], x[:, 2], p[:, 0], p[:, 1], p[:, 2], p[:, 3])
    ref = jgeo.renormalize_factor_c(*[jnp.asarray(c) for c in cols], SPIN,
                                    MASS, flat=flat)
    ours = tgeo.renormalize_factor_c(*[_t(c) for c in cols], SPIN, MASS,
                                     flat=flat)
    _close(ours.numpy(), ref)


def test_radius_and_metrics():
    x, _ = _points(2)
    _close(tgeo.radius(_t(x), SPIN).numpy(), jgeo.radius(jnp.asarray(x), SPIN))
    for fn_t, fn_j in ((tgeo.gcov, jgeo.gcov), (tgeo.gcon, jgeo.gcon)):
        for flat in (False, True):
            _close(fn_t(_t(x), SPIN, MASS, flat=flat).numpy(),
                   fn_j(jnp.asarray(x), SPIN, MASS, flat=flat))


def test_null_momentum_helpers():
    x, p = _points(3)
    rng = np.random.default_rng(4)
    p_spatial = rng.normal(size=(x.shape[0], 3))
    g_cov_j = jgeo.gcov(jnp.asarray(x), SPIN, MASS)
    g_cov_t = tgeo.gcov(_t(x), SPIN, MASS)
    _close(tgeo.null_momentum_time_component(g_cov_t, _t(p_spatial)).numpy(),
           jgeo.null_momentum_time_component(g_cov_j, jnp.asarray(p_spatial)))
    g_con_j = jgeo.gcon(jnp.asarray(x), SPIN, MASS)
    g_con_t = tgeo.gcon(_t(x), SPIN, MASS)
    _close(tgeo.renormalize_null_momentum(g_con_t, _t(p)).numpy(),
           jgeo.renormalize_null_momentum(g_con_j, jnp.asarray(p)))
