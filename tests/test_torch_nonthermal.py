"""PyTorch port: the power-law and kappa electron populations (ROADMAP
B.2) against the JAX package.

The host constants (``hypergeometric``, ``powerlaw_constants``,
``kappa_constants`` in each kappa bracket, polarized or not) at rtol
1e-14; ``all_coefficients`` on seeded fluid states with degenerate cells
(sin theta_B = 0 and 1, cos theta_B = 0, no field, zero and negative
frequencies): float64 with equal NaN and inf sets at rtol 1e-12, float32
against the JAX package's float32 forms at FLOAT32_RTOL; and
``pipeline.run(device="cpu")`` and the CLI at 16^2 (8^2 polarized), rk4,
float64, against the JAX package's ``render_simulation_image``: power
law, kappa, the mixture unpolarized and polarized (the kernel route's
plain versions) and kappa with image_tau (the scan route), at the
goldens' tolerances (tests/test_simulation_e2e.py:88-114).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from blacklight_tpu import pipeline_simulation as jax_sim
from blacklight_tpu.models import synchrotron as jsyn
from blacklight_tpu.utils.config import parse_config as jax_parse_config
from blacklight_tpu.utils.errors import BlacklightError as JaxBlacklightError
from blacklight_tpu_torch import (BlacklightError, cli,
                                  parse_config, pipeline)
from blacklight_tpu_torch.constants import Physics, PlasmaModel
from blacklight_tpu_torch.models import synchrotron as syn

torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
TORCH_DTYPE = {"float32": torch.float32, "float64": torch.float64}
KEYS = ("j_i", "j_q", "j_v", "alpha_i", "alpha_q", "alpha_v", "rho_q",
        "rho_v")
# The JAX package's float32 forms against the port's: both round each
# operation in float32, but XLA's and torch's pow, exp and log differ by an
# ulp or two, which the fractional powers of xx (up to |e| = 2.5) and the
# bridge's ratio carry to a few 1e-6; relative to each coefficient, with a
# floor of FLOAT32_RTOL times its largest |value| for entries that cancel.
FLOAT32_RTOL = 2e-5


def _plasma(power_frac, kappa_frac, kappa=4.0, w=2.0, p=3.0):
    kwargs = dict(mu=0.5, ne_ni=1.0, model=PlasmaModel.ti_te_beta,
                  rat_low=1.0, rat_high=10.0, power_frac=power_frac,
                  power_p=p, gamma_min=10.0, gamma_max=1e4,
                  kappa_frac=kappa_frac, kappa=kappa, w=w)
    ours = syn.PlasmaParams(**kwargs)
    kwargs["model"] = jsyn.PlasmaModel.ti_te_beta
    return ours, jsyn.PlasmaParams(**kwargs)


def _assert_same_constants(ours: dict, ref: dict):
    assert set(ours) == set(ref)
    for key, value in ref.items():
        if isinstance(value, dict):
            _assert_same_constants(ours[key], value)
        elif isinstance(value, tuple):
            np.testing.assert_allclose(ours[key], value, rtol=1e-14,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(ours[key], float(value), rtol=1e-14,
                                       atol=0.0, err_msg=key)


@pytest.mark.parametrize("args", [(3.5, 4.0, 5.5, -8.0),
                                  (4.0 - 1 / 3, 5.0, 4.0 + 2 / 3, -0.5),
                                  (2.2, 0.7, 1.9, -20.0)])
def test_hypergeometric_matches_jax(args):
    assert syn.hypergeometric(*args) == pytest.approx(
        jsyn.hypergeometric(*args), rel=1e-14)


@pytest.mark.parametrize("p", [2.5, 3.0, 3.5])
def test_powerlaw_constants_match_jax(p):
    ours, ref = _plasma(0.3, 0.0, p=p)
    _assert_same_constants(syn.powerlaw_constants(ours),
                           jsyn.powerlaw_constants(ref))


# one kappa in each bracket of the rotativities' interpolation
@pytest.mark.parametrize("kappa", [3.75, 4.25, 5.0])
@pytest.mark.parametrize("polarized", [False, True])
def test_kappa_constants_match_jax(kappa, polarized):
    ours, ref = _plasma(0.0, 0.2, kappa=kappa, w=0.7)
    got = syn.kappa_constants(ours, polarized=polarized)
    _assert_same_constants(got, jsyn.kappa_constants(ref,
                                                     polarized=polarized))
    # the reference's quirk: no kappa absorption without polarization
    assert (got["aa_high_i"] == 0.0) != polarized


def _fluid(rng, n=600):
    """Seeded fluid states and pitch angles with degenerate cells: sin
    theta_B = 0 and 1, no field, a cold cell. Returns the state (numpy),
    sin, cos and sin^2 of theta_B, and (n, 2) fluid-frame frequencies
    with a zero and a negative one."""
    theta_e = 10.0 ** rng.uniform(-3.0, 2.5, n)
    state = {"n_e_cgs": 10.0 ** rng.uniform(2.0, 7.0, n),
             "bb_cgs": 10.0 ** rng.uniform(-1.0, 2.5, n),
             "theta_e": theta_e,
             "kb_tt_e_cgs": theta_e * Physics.m_e * Physics.c ** 2}
    cos_b = rng.uniform(-1.0, 1.0, n)
    cos_b[::37] = 1.0  # sin theta_B = 0
    cos_b[1::41] = 0.0  # sin theta_B = 1
    cos_b[2::43] = -1.0
    state["bb_cgs"][3::47] = 0.0  # no field
    sin2 = 1.0 - cos_b * cos_b
    sin_b = np.sqrt(sin2)
    nu = 10.0 ** rng.uniform(9.0, 13.0, (n, 2))
    nu[5::53, 0] = 0.0
    nu[6::59, 1] *= -1.0
    return state, sin_b, cos_b, sin2, nu


CASES = {"power": (0.3, 0.0), "kappa": (0.0, 0.2), "mix": (0.3, 0.2),
         "nonthermal_only": (0.6, 0.4)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("polarized", [False, True])
@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_all_coefficients_match_jax(case, polarized, precision):
    import jax.numpy as jnp
    ours_p, ref_p = _plasma(*CASES[case], kappa=4.25)
    state, sin_b, cos_b, sin2, nu = _fluid(np.random.default_rng(5))
    dtype = np.dtype(precision)
    t = {k: torch.tensor(v.astype(dtype)) for k, v in state.items()}
    j = {k: jnp.asarray(v.astype(dtype)) for k, v in state.items()}
    args_t = [torch.tensor(a.astype(dtype)) for a in (nu, sin_b, cos_b, sin2)]
    args_j = [jnp.asarray(a.astype(dtype)) for a in (nu, sin_b, cos_b, sin2)]
    nu0 = 2.3e11
    ours = syn.all_coefficients(
        args_t[0], nu0, t, args_t[1], ours_p, cos_theta_b=args_t[2],
        sin2_theta_b=args_t[3], polarized=polarized)
    pl, kp = jsyn.powerlaw_constants(ref_p) if ref_p.power_frac else None, \
        jsyn.kappa_constants(ref_p, polarized) if ref_p.kappa_frac else None
    ref = jsyn.all_coefficients(args_j[0], nu0, j, args_j[1], args_j[2],
                                args_j[3], ref_p, polarized, pl_consts=pl,
                                kp_consts=kp)
    if not polarized:
        ours = dict(zip(("j_i", "alpha_i"), ours))
    assert set(ours) == set(ref) == set(KEYS if polarized
                                        else ("j_i", "alpha_i"))
    finite_somewhere = False
    for key in ours:
        a, b = ours[key].numpy(), np.asarray(ref[key])
        assert a.dtype == dtype and a.shape == b.shape == nu.shape, key
        if precision == "float64":
            for test in (np.isnan, np.isposinf, np.isneginf):
                np.testing.assert_array_equal(test(a), test(b), err_msg=key)
            rtol, floor = 1e-12, 0.0
        else:
            # the float32 forms form no NaN primal where the JAX package
            # forms none
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b),
                                          err_msg=key)
            rtol = FLOAT32_RTOL
            floor = rtol * float(np.nanmax(np.abs(b[np.isfinite(b)])))
        ok = np.isfinite(b)
        finite_somewhere |= bool((ok & (b != 0.0)).any())
        np.testing.assert_allclose(a[ok], b[ok], rtol=rtol, atol=floor,
                                   err_msg=key)
    assert finite_somewhere


# ---- the pipeline ----------------------------------------------------------

def _config_text(out, name, res=16, **overrides):
    """``name`` on mock_small.athdf at ``res``^2 with 300 steps of 0.03
    and ``overrides``."""
    text = (FIXTURES / name).read_text()
    settings = {"simulation_file": FIXTURES / "mock_small.athdf",
                "output_file": out, "camera_resolution": res,
                "ray_step": 0.03, "ray_max_steps": 300, **overrides}
    for key, value in settings.items():
        line = f"{key} = {value}"
        text, n = re.subn(rf"^{key}\s*=.*$", line, text, flags=re.M)
        if n == 0:
            text += line + "\n"
    return text


# name -> (input, resolution, overrides, the planes compared)
RUNS = {
    "power": ("golden_plasma_pow_rk4_32.input", 16, {}, ("I_nu",)),
    "kappa": ("golden_plasma_kap_rk4_32.input", 16, {}, ("I_nu",)),
    "mix": ("golden_plasma_mix_rk4_32.input", 16, {}, ("I_nu",)),
    "mix_polarized": ("golden_plasma_mix_pol_rk4_32.input", 8, {},
                      ("I_nu", "Q_nu", "U_nu", "V_nu")),
    "kappa_tau": ("golden_plasma_kap_rk4_32.input", 16,
                  {"image_tau": "true", "image_emission": "true"},
                  ("I_nu", "tau", "emission")),
}
# tests/test_simulation_e2e.py:104-114: relative to |gold| plus 1e-8 of
# I's peak
POLARIZED_RTOL = {"I_nu": 1e-7, "Q_nu": 1e-3, "U_nu": 1e-3, "V_nu": 1e-3}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_run_matches_jax(tmp_path, case):
    name, res, overrides, keys = RUNS[case]
    text = _config_text(tmp_path / "torch.npz", name, res=res, **overrides)
    cfg = parse_config(text)
    assert cfg.plasma_power_frac or cfg.plasma_kappa_frac
    ref, *_ = jax_sim.render_simulation_image(jax_parse_config(text))
    arrays = pipeline.run(cfg, quiet=True, device="cpu")
    saved = np.load(tmp_path / "torch.npz")
    i_scale = np.nanmax(np.abs(np.asarray(ref["I_nu"])))
    assert i_scale > 0.0
    for key in keys:
        b = np.asarray(ref[key])[:, 0].reshape(res, res)
        for a in (np.asarray(arrays[key]), saved[key]):
            a = a.reshape(res, res) if a.ndim == 2 else a[0].reshape(res,
                                                                     res)
            assert np.array_equal(np.isnan(a), np.isnan(b)), key
            if case == "mix_polarized":
                rel = np.abs(a - b) / (np.abs(b) + i_scale * 1e-8)
                assert np.nanmax(rel) < POLARIZED_RTOL[key], (key,
                                                              np.nanmax(rel))
            else:
                np.testing.assert_allclose(a, b, rtol=1e-8,
                                           atol=1e-14 * np.nanmax(np.abs(b)),
                                           err_msg=key)


def test_routes_of_the_populations(tmp_path):
    """Light alone takes the kernel route, a plane the scan route, with
    any population."""
    from blacklight_tpu_torch import pipeline_simulation
    for name, overrides, route in (
            ("golden_plasma_mix_rk4_32.input", {}, "kernel"),
            ("golden_plasma_mix_pol_rk4_32.input", {}, "kernel"),
            ("golden_plasma_kap_rk4_32.input", {"image_tau": "true"}, "scan")):
        cfg = parse_config(_config_text(tmp_path / "x.npz", name, res=4,
                                        **overrides))
        render_fn, *_ = pipeline_simulation.make_simulation_renderer(
            cfg, device="cpu")
        assert render_fn.route == route, name


def test_cli_renders_the_mixture(tmp_path, capsys):
    inp = tmp_path / "mix.input"
    inp.write_text(_config_text(tmp_path / "cli.npz",
                                "golden_plasma_mix_rk4_32.input", res=4,
                                ray_max_steps=200))
    assert cli.main(["--device", "cpu", str(inp)]) == 0
    assert "Calculation completed." in capsys.readouterr().out
    image = np.load(tmp_path / "cli.npz")["I_nu"]
    ref, *_ = jax_sim.render_simulation_image(jax_parse_config(
        inp.read_text()))
    np.testing.assert_allclose(image.reshape(16),
                               np.asarray(ref["I_nu"])[:, 0], rtol=1e-8)


def test_code_kappa_mixture_reads_its_slot_as_jax(tmp_path):
    """The mixture with code_kappa electrons on mock_small.athdf, which has
    no "kappa" variable: the port's loader raises the JAX package's error
    (tests/test_torch_code_kappa.py renders the mixture with the slot)."""
    text = _config_text(tmp_path / "x.npz", "golden_plasma_mix_rk4_32.input",
                        res=4, plasma_model="code_kappa",
                        simulation_kappa_name="kappa")
    with pytest.raises(JaxBlacklightError) as jax_err:
        jax_sim.render_simulation_image(jax_parse_config(text))
    with pytest.raises(BlacklightError) as err:
        pipeline.run(parse_config(text), quiet=True, device="cpu")
    assert str(err.value) == str(jax_err.value) == (
        'Unable to locate "kappa" slice of "prim" in data file.')
    assert not (tmp_path / "x.npz").exists()


# ---- the kernels' launch constants -----------------------------------------

CSRC = pathlib.Path(syn.__file__).resolve().parent.parent / "csrc"


def test_mixture_param_order_matches_header():
    """MIX_PARAM_NAMES is the enum MixtureParam of
    csrc/simulation_params.cuh, in order."""
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    header = (CSRC / "simulation_params.cuh").read_text()
    enum = re.search(r"enum MixtureParam : int \{(.*?)\};", header,
                     re.S).group(1)
    names = [n.strip()[2:] for n in re.sub(r"//[^\n]*", "", enum).split(",")
             if n.strip()]
    assert names[-1] == "COUNT"
    assert tuple(names[:-1]) == sk.MIX_PARAM_NAMES


@pytest.mark.parametrize("polarized", [False, True])
def test_mixture_params_fold_in_float64(polarized):
    """Each constant as the plain version's expressions fold it: the
    population constants, the exponents and products of Python floats,
    each bridge's exponent with its -1 / x, the bracket blend."""
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    plasma, _ = _plasma(0.3, 0.2, kappa=4.25, w=0.7, p=3.5)
    values = dict(zip(sk.MIX_PARAM_NAMES,
                      sk.mixture_params(plasma, polarized)))
    pl = syn.powerlaw_constants(plasma)
    kp = syn.kappa_constants(plasma, polarized=polarized)
    assert values["THERMAL_ON"] == values["POWER_ON"] \
        == values["KAPPA_ON"] == 1.0
    assert values["KA"] == Physics.e * Physics.e / (Physics.m_e * Physics.c)
    assert values["PL_J_EXP"] == -(3.5 - 1.0) / 2.0
    assert values["PL_A_EXP"] == -(3.5 + 2.0) / 2.0
    assert values["PL_FRAC_RHO"] == 0.3 * pl["rho"]
    assert values["PL_E3_EXP"] == 3.5 / 2.0 - 1.0
    assert values["PL_RHO_V"] == pl["rho_v"] and values["PL_JJ"] == pl["jj"]
    assert values["KP_NEG_FRAC"] == -0.2 and values["KP_TWO_FRAC"] == 0.4
    assert values["KP_J_EXP"] == -(4.25 - 2.0) / 2.0
    assert values["KP_AA_HIGH_I"] == kp["aa_high_i"]
    assert (values["KP_AA_HIGH_I"] != 0.0) == polarized
    for c, key in (("JI", "jj_x_i"), ("AV", "aa_x_v")):
        assert values[f"KP_X_{c}"] == kp[key]
        assert values[f"KP_NX_{c}"] == -1.0 / kp[key]
    assert values["KP_RHO_FRAC"] == kp["rho_frac"] == 0.5
    assert values["KP_RHO_1M_FRAC"] == 1.0 - kp["rho_frac"]
    assert values["KP_QH_E"] == kp["rho_q_high"]["e"]
    assert (values["KP_VL_A"], values["KP_VL_B"]) == kp["rho_v_low"]
    # a population left out is all zeros, its flag off
    thermal_kappa, _ = _plasma(0.0, 0.2)
    values = dict(zip(sk.MIX_PARAM_NAMES,
                      sk.mixture_params(thermal_kappa, polarized)))
    assert values["POWER_ON"] == 0.0 and values["PL_JJ"] == 0.0
    assert values["KAPPA_ON"] == 1.0


@pytest.mark.parametrize("mode_one", [True, False])
def test_launch_consts_of_a_mixture(mode_one):
    """SimMixLaunchConsts: the launch constants, then the mixture's
    rounded once to the rays' type; the mixture's kernels of many blocks
    and its phase kernels take the bucket of MAX_FREQUENCIES for one
    frequency too."""
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    plasma, _ = _plasma(0.3, 0.2)
    mix = sk.mixture_params(plasma, polarized=False)
    values = [1.0] * len(sk.PARAM_NAMES)
    bucket = sk.frequency_bucket(1, one=mode_one)
    assert bucket == (1 if mode_one else sk.MAX_FREQUENCIES)
    for dtype in (torch.float32, torch.float64):
        out = sk.launch_consts(values, [2.3e11], [1.5], dtype, mix, bucket)
        n = len(sk.PARAM_NAMES) + 2 * bucket
        assert out.size == n + len(sk.MIX_PARAM_NAMES)
        np.testing.assert_array_equal(
            out[n:], np.asarray(mix).astype(out.dtype))
        assert out[len(sk.PARAM_NAMES)] == np.asarray(2.3e11, out.dtype)
        assert out[len(sk.PARAM_NAMES) + bucket] == 1.5
    sizes = sk.host_consts_sizes(mixture=True)
    thermal = sk.host_consts_sizes()
    for key, size in sizes.items():
        item = 4 if key[0] == torch.float32 else 8
        assert size == thermal[key] + item * len(sk.MIX_PARAM_NAMES)


def test_polarized_params_carry_the_mixture():
    """The polarized derive kernel's float64 vector: PARAM_NAMES, then for
    a mixture its constants with the polarized kappa absorption."""
    from blacklight_tpu_torch import pipeline_simulation
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    for name, mixture in (("golden_plasma_mix_pol_rk4_32.input", True),
                          ("golden_polarized_rk4_32.input", False)):
        cfg = parse_config(_config_text("/tmp/x.npz", name, res=4))
        render_fn, *_ = pipeline_simulation.make_simulation_renderer(
            cfg, device="cpu")
        freqs, params, sp, grid, mass, camera_x, _ = render_fn.kernel_args
        vector = pk.kernel_params(params, sp, float(freqs[0]), mass,
                                  camera_x, False)
        assert len(vector) == len(pk.PARAM_NAMES) + (
            len(sk.MIX_PARAM_NAMES) if mixture else 0)
        if mixture:
            assert vector[len(pk.PARAM_NAMES):] == sk.mixture_params(
                sp.plasma, polarized=True)
