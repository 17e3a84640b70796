"""PyTorch port: the 32^2 formula goldens through pipeline.run on the CPU,
at the tolerances of test_formula_e2e.py (reference-binary outputs)."""

import numpy as np
import pytest
import torch

from blacklight_tpu import read_config
from blacklight_tpu_torch import pipeline

pytestmark = pytest.mark.slow

torch.set_num_threads(2)


def _render(fixtures_dir, tmp_path, name):
    cfg = read_config(str(fixtures_dir / f"{name}.input"))
    cfg.output_file = str(tmp_path / f"{name}.npz")
    arrays = pipeline.run(cfg, quiet=True, device="cpu")
    gold = np.load(fixtures_dir / f"{name}.npz")["I_nu"]
    return arrays["I_nu"], gold


@pytest.mark.parametrize("name", ["golden_formula_cam_rk4_32",
                                  "golden_formula_rk2_32"])
def test_rk_exact_parity(fixtures_dir, tmp_path, name):
    ours, gold = _render(fixtures_dir, tmp_path, name)
    np.testing.assert_allclose(ours, gold, rtol=1e-7)


def test_dp_quadrature_parity(fixtures_dir, tmp_path):
    ours, gold = _render(fixtures_dir, tmp_path, "golden_formula_32")
    rel = np.abs(ours - gold) / (np.abs(gold) + gold.max() * 1e-8)
    assert np.nanmax(rel) < 5e-3
    assert np.nanmean(rel) < 1e-3
