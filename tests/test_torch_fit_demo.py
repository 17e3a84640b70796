"""PyTorch port: gradients of the differentiable formula renderers against
finite differences, and the inverse-rendering demo
(``python -m blacklight_tpu_torch.fit_demo``) on the CPU.

The renderers' gradients are held against JAX's in
``test_torch_formula_fit.py``; here against finite differences through the
port's own renderer, as tests/test_gradients.py holds the JAX kernel.
"""

import re

import numpy as np
import pytest
import torch

from blacklight_tpu_torch import BlacklightError, fit_demo
from blacklight_tpu_torch.ops import formula_fit

from test_torch_formula_fit import FIT_PARAMS, _fit_case, _values

torch.set_num_threads(2)


def test_fit_renderers_match_finite_differences(tmp_path):
    """Each gradient against central finite differences through the port's
    renderer itself, in float32, at the JAX tests' step (1e-3 of the value)
    and tolerances: the vjp renderer's cn0 at rtol 1e-3
    (tests/test_gradients.py:108), the fit renderer's cn0, r0 and h at
    rtol 5e-3 (:156-157). One frequency and no absorption, as in those
    tests: with absorption, float32 rounding of the transfer sum moves a
    16-pixel flux by ~1e-6 between the two points, ~1e-3 of their
    difference (the tangents with absorption are held to reverse mode in
    float64 and to JAX in test_torch_formula_fit.py)."""
    s, _, _, rays, port_args = _fit_case(
        tmp_path, formula_a=0.0, image_num_frequencies=1)
    values = _values(s)
    fit = formula_fit.make_formula_fit_renderer(
        *port_args, fallback_nan=False, integrator="rk4",
        fit_params=FIT_PARAMS)
    vjp = formula_fit.make_formula_vjp_renderer(
        *port_args, fallback_nan=False, integrator="rk4")

    def flux(render, vals, grad=False):
        """Total flux in float64 and, with grad, d flux / d vals."""
        theta = {p: torch.tensor(v, dtype=torch.float32, requires_grad=grad)
                 for p, v in vals.items()}
        with torch.set_grad_enabled(grad):
            if render is vjp:
                total = render(theta["cn0"], *rays)[0].double().sum()
            else:
                total = render(theta, *rays)[0].double().sum()
        if grad:
            total.backward()
            return {p: t.grad.item() for p, t in theta.items()}
        return total.item()

    for render, vals, rtol in ((vjp, {"cn0": values["cn0"]}, 1e-3),
                               (fit, values, 5e-3)):
        grad = flux(render, vals, grad=True)
        for p, v in vals.items():
            hi = float(np.float32(v * (1.0 + 1e-3)))
            lo = float(np.float32(v * (1.0 - 1e-3)))
            fd = (flux(render, dict(vals, **{p: hi}))
                  - flux(render, dict(vals, **{p: lo}))) / (hi - lo)
            assert grad[p] != 0.0, p
            np.testing.assert_allclose(grad[p], fd, rtol=rtol, err_msg=p)


def test_fit_demo_runs_and_loss_falls(capsys):
    """The demo at 4^2 for 3 Adam iterations on the CPU: it runs to its
    verdict line, and the loss of the last iteration is below the first's
    (3 iterations are too few to converge, so the verdict is not held)."""
    code = fit_demo.main(["--device", "cpu", "--resolution", "4",
                          "--iterations", "3"])
    out = capsys.readouterr().out
    assert code in (0, 1)
    assert ("FIT OK" if code == 0 else "FIT DID NOT CONVERGE") in out
    losses = [float(v) for v in re.findall(r"loss = (\S+)", out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[1] < losses[0]


def test_fit_demo_needs_a_gpu_for_cuda(monkeypatch):
    """The default device is the card; without one the demo raises rather
    than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BlacklightError, match="cuda"):
        fit_demo.main([])
