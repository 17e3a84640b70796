"""PyTorch port: the fused formula kernel.

The plain PyTorch version (render_formula_reference) is held against the
JAX package's Pallas kernel in interpret mode and against its XLA scan
path, on identical rays carried across with ``interop``. The CUDA kernel
is held against the plain version on the card by
``test_torch_formula_kernel_cuda.py``, which imports no jax so that it runs
on a GPU machine without JAX.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blacklight_tpu import pipeline as jpipeline
from blacklight_tpu.camera import make_camera as jax_make_camera
from blacklight_tpu.constants import RayIntegrator
from blacklight_tpu.models import formula as jformula
from blacklight_tpu.ops import geodesic as jgeodesic
from blacklight_tpu.ops.pallas_formula import render_formula as jax_render
from blacklight_tpu.transfer.unpolarized import (
    ImageOptions, integrate_unpolarized)
from blacklight_tpu.utils.config import parse_config
from blacklight_tpu_torch import interop
from blacklight_tpu_torch.ops import formula_kernel as fk

from test_adaptive import CONFIG

torch.set_num_threads(2)

CSRC = pathlib.Path(fk.__file__).resolve().parent.parent / "csrc"
TORCH_DTYPE = {"float32": torch.float32, "float64": torch.float64}


def _setup(tmp_path, integrator, res, precision, **overrides):
    """JAX camera, params and the same inputs for the port."""
    cfg = parse_config(CONFIG.format(out=str(tmp_path / "o.npz"), res=res,
                                     max_level=0, num_regions=0, regions=""))
    cfg.ray_integrator = RayIntegrator(integrator)
    cfg.precision = precision
    for k, v in overrides.items():
        setattr(cfg, k, v)
    bh_m, bh_a, mass_msun = jpipeline.bh_mass_spin(cfg)
    jdtype = jnp.float32 if precision == "float32" else jnp.float64
    geom, rays, freqs = jax_make_camera(cfg, bh_m=bh_m, bh_a=bh_a,
                                        dtype=jdtype)
    params = jpipeline.geodesic_params_from_config(cfg, bh_m, bh_a)
    fparams = jformula.formula_params_from_config(cfg)
    trays = interop.camera_rays_from_numpy(
        rays.positions, rays.directions, rays.momentum_factors,
        device="cpu", dtype=TORCH_DTYPE[precision])
    return dict(cfg=cfg, geom=geom, rays=rays, freqs=freqs, params=params,
                fparams=fparams, mass_msun=mass_msun, trays=trays,
                nu=float(np.asarray(freqs)[0]),
                camera_x=np.asarray(geom.cam_x),
                log_j_scale=float(jformula.formula_log_j_scale(fparams)))


def _port_render(s, integrator, fallback_nan):
    t = s["trays"]
    i_nu, flags, n_samp = fk.render_formula(
        t.positions, t.directions, t.momentum_factors, s["nu"],
        interop.geodesic_params_from_jax(s["params"]),
        interop.formula_params_from_jax(s["fparams"]), s["mass_msun"],
        s["camera_x"], s["log_j_scale"], fallback_nan=fallback_nan,
        integrator=integrator)
    assert i_nu.shape == (t.positions.shape[0], 1)
    assert flags.dtype == torch.bool and n_samp.dtype == torch.int32
    return i_nu[:, 0].numpy(), flags.numpy(), n_samp.numpy()


@pytest.mark.parametrize("integrator,fallback_nan", [
    ("dp", True), ("dp", False), ("rk4", True), ("rk2", True)])
def test_reference_matches_pallas_interpret(tmp_path, integrator,
                                            fallback_nan):
    """Plain float32 version against the Pallas kernel (interpret mode),
    with the assertions and tolerance of test_pallas_kernel.py:59-64."""
    dp_opts = dict(ray_max_steps=800, ray_tol_abs=1e-6, ray_tol_rel=1e-6,
                   ray_max_retries=20)
    s = _setup(tmp_path, integrator, 8, "float32",
               **(dp_opts if integrator == "dp" else
                  dict(ray_max_steps=600)))
    i_ref, flags_ref, nsamp_ref = jax_render(
        s["rays"].positions, s["rays"].directions, s["rays"].momentum_factors,
        s["nu"], s["params"], s["fparams"], s["mass_msun"], s["camera_x"],
        s["log_j_scale"], fallback_nan=fallback_nan, integrator=integrator,
        interpret=True)
    i_ref = np.asarray(i_ref)
    i_port, flags, nsamp = _port_render(s, integrator, fallback_nan)

    assert np.array_equal(np.isnan(i_port), np.isnan(i_ref))
    assert np.array_equal(flags, np.asarray(flags_ref))
    assert np.array_equal(nsamp, np.asarray(nsamp_ref))
    scale = np.nanmax(np.abs(i_ref))
    np.testing.assert_allclose(np.nan_to_num(i_port), np.nan_to_num(i_ref),
                               atol=1e-4 * scale)


def test_reference_rk4_float64_matches_scan(tmp_path):
    """Plain float64 rk4 against the XLA scan path (integrate_unpolarized)
    at the repository's rk4 parity tolerance, rtol 1e-8."""
    s = _setup(tmp_path, "rk4", 16, "float64")
    rays, fparams, freqs = s["rays"], s["fparams"], s["freqs"]

    def coeff_fn(pos, kcov):
        j, a, _, bad = jformula.formula_coefficients(
            pos, kcov, rays.momentum_factors, freqs, fparams, s["geom"].cam_x)
        return j, a, bad

    img = integrate_unpolarized(
        rays.positions, rays.directions, rays.momentum_factors, freqs,
        params=s["params"], coeff_fn=coeff_fn,
        opts=ImageOptions(fallback_nan=s["cfg"].fallback_nan),
        mass_msun=s["mass_msun"], camera_x=s["geom"].cam_x, early_exit=True,
        log_j_scale=s["log_j_scale"])
    i_ref = np.asarray(img["I_nu"][:, 0])
    i_port, flags, nsamp = _port_render(s, "rk4", s["cfg"].fallback_nan)

    assert np.isfinite(i_ref).any() and np.nanmax(i_ref) > 0.0
    assert np.array_equal(np.isnan(i_port), np.isnan(i_ref))
    assert np.array_equal(flags, np.asarray(img["_flags"]))
    assert np.array_equal(nsamp, np.asarray(img["_n_samples"]))
    np.testing.assert_allclose(i_port, i_ref, rtol=1e-8)


def _eval_literal(token):
    """A C double literal or a quotient of two ('35.0 / 384.0')."""
    num, _, den = token.partition("/")
    return float(num) / float(den) if den else float(num)


def _header_text():
    return "\n".join(p.read_text() for p in sorted(CSRC.glob("*.cuh")))


def test_header_dp_tableau_matches_jax():
    consts = {}
    for m in re.finditer(r"constexpr double (DP_\w+)(?:\[\d+\])*\s*=\s*(.*?);",
                         _header_text(), re.S):
        body = re.sub(r"[{}\s]", "", m.group(2))
        consts[m.group(1)] = np.array(
            [_eval_literal(tok) for tok in body.split(",") if tok])
    expected = {
        "DP_A": np.asarray(jgeodesic._DP_A).ravel(),
        "DP_B5": jgeodesic._DP_B5, "DP_B4": jgeodesic._DP_B4,
        "DP_B4M": jgeodesic._DP_B4M,
        "DP_ERR_POWER": [jgeodesic._DP_ERR_POWER],
        "DP_ERR_FACTOR": [jgeodesic._DP_ERR_FACTOR],
        "DP_MIN_FACTOR": [jgeodesic._DP_MIN_FACTOR],
        "DP_MAX_FACTOR": [jgeodesic._DP_MAX_FACTOR],
    }
    assert set(consts) == set(expected)
    for name, value in expected.items():
        np.testing.assert_allclose(consts[name], np.asarray(value),
                                   rtol=1e-15, atol=1e-15, err_msg=name)
    # the port's own Python copy of the tableau agrees too
    from blacklight_tpu_torch.ops import geodesic as tgeo
    for i, row in enumerate(tgeo.DP_A):
        np.testing.assert_allclose(row, jgeodesic._DP_A[i, :len(row)],
                                   rtol=1e-15)
        assert not np.any(jgeodesic._DP_A[i, len(row):])
    for ours, ref in ((tgeo.DP_B5, jgeodesic._DP_B5),
                      (tgeo.DP_B4, jgeodesic._DP_B4),
                      (tgeo.DP_B4M, jgeodesic._DP_B4M)):
        np.testing.assert_allclose(ours, ref, rtol=1e-15)


def test_header_param_enum_matches_wrapper():
    m = re.search(r"enum FormulaParam : int \{(.*?)\};", _header_text(), re.S)
    body = re.sub(r"//[^\n]*", "", m.group(1))
    names = [tok.strip() for tok in body.split(",") if tok.strip()]
    assert names == [f"P_{n}" for n in fk.PARAM_NAMES] + ["P_COUNT"]


def test_kernel_params_vector(tmp_path):
    s = _setup(tmp_path, "dp", 8, "float64", ray_tol_abs=1e-8,
               ray_tol_rel=1e-8, ray_max_retries=20)
    vec = fk.kernel_params(interop.geodesic_params_from_jax(s["params"]),
                           interop.formula_params_from_jax(s["fparams"]),
                           s["nu"], s["mass_msun"], s["camera_x"],
                           s["log_j_scale"], True)
    assert len(vec) == len(fk.PARAM_NAMES)
    at = dict(zip(fk.PARAM_NAMES, vec))
    # x_unit / nu and the image scale are float64 host scalars: cn0/nup^2
    # alone (~1e-41) would underflow float32
    assert at["I_SCALE"] == pytest.approx(
        np.exp(s["log_j_scale"] + 3.0 * np.log(s["nu"])), rel=1e-15)
    assert at["EJ"] == 1.0 and at["EJ_IS_INT"] == 1.0
    assert at["EA"] == 0.5 and at["EA_IS_INT"] == 0.0
    assert at["MAX_STEPS"] == s["params"].ray_max_steps


def test_wrapper_validates_rays(tmp_path):
    s = _setup(tmp_path, "rk4", 4, "float64", ray_max_steps=5)
    t = s["trays"]
    args = (s["nu"], interop.geodesic_params_from_jax(s["params"]),
            interop.formula_params_from_jax(s["fparams"]), s["mass_msun"],
            s["camera_x"], s["log_j_scale"])
    with pytest.raises(ValueError):
        fk.render_formula(t.positions[:, :3], t.directions,
                          t.momentum_factors, *args)
    with pytest.raises(TypeError):
        fk.render_formula(t.positions.float(), t.directions,
                          t.momentum_factors, *args)
    with pytest.raises(ValueError):
        fk.render_formula(t.positions.t().contiguous().t(), t.directions,
                          t.momentum_factors, *args)
    with pytest.raises(ValueError):
        fk.render_formula(t.positions, t.directions, t.momentum_factors,
                          *args, integrator="euler")
    # a CPU tensor runs the plain version and launches nothing
    before = fk.LAUNCHES
    fk.render_formula(t.positions, t.directions, t.momentum_factors, *args)
    assert fk.LAUNCHES == before
