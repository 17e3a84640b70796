"""blacklight_tpu_torch: the PyTorch / CUDA port of blacklight_tpu.

Three slices, each config -> camera -> one fused hand-written CUDA kernel
on an NVIDIA GPU (its plain PyTorch version on the CPU) -> npz/npy/raw:
the formula model (``ops/formula_kernel.py``), the simulation model on
Athena++ snapshots (``ops/simulation_kernel.py``) and its full-Stokes
polarized transfer (``ops/polarized_kernel.py``). The JAX package ``blacklight_tpu`` is the reference; this package
keeps its own copies of the jax-free modules it needs (``constants``,
``output``, ``utils/config``, ``utils/errors``, ``utils/colors``) and
imports nothing of the JAX package, nor jax.
"""

__version__ = "0.1.0"

from blacklight_tpu_torch.constants import RayIntegrator
from blacklight_tpu_torch.utils.config import Config, parse_config, read_config
from blacklight_tpu_torch.utils.errors import BlacklightError

__all__ = ["BlacklightError", "Config", "RayIntegrator", "parse_config",
           "read_config", "__version__"]
