"""blacklight_tpu_torch: the PyTorch / CUDA port of blacklight_tpu.

The formula-model main path (config -> camera -> fused geodesic +
formula coefficients + unpolarized transfer -> npz) runs through one
hand-written CUDA kernel on an NVIDIA GPU (``ops/formula_kernel.py``,
``csrc/formula_kernel.cuh``) and through its plain PyTorch version on the
CPU. The JAX package ``blacklight_tpu`` is the reference; its jax-free
modules (config parsing, constants, output writing) are shared, not
copied. Importing this package never loads jax.
"""

__version__ = "0.1.0"

from blacklight_tpu.constants import RayIntegrator
from blacklight_tpu.utils.config import Config, read_config

__all__ = ["Config", "RayIntegrator", "read_config", "__version__"]
