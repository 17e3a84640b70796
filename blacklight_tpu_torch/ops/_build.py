"""Build and load the CUDA kernels of this package.

Each ``csrc/*.cu`` is compiled with ``nvcc`` to an object, one process per
source and all of them at once, and the objects are linked into one shared
library with a plain C interface,
``build/kernels/libblacklight_tpu_torch_<hash>.so`` at the repository
root, on first use; the hash covers the sources, the headers and the
flags, so an edit rebuilds and an unchanged tree loads the library it
built before. The library is loaded with ctypes. No PyTorch headers are
compiled, which keeps a build to seconds.

nvcc's ``-Xptxas -v`` report (registers, spills per kernel) is kept beside
the library as ``<name>.ptxas.txt``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# Multiply-add contraction per source; a source not listed contracts.
# The formula units with rk4 and rk2 (formula_kernel.cu, one frequency;
# formula_kernel_multi.cu, several; formula_kernel_tangent.cu, with
# tangents) do not: chaotic photon-ring rays amplify a one-ulp difference
# to 1e-7 in I_nu, and without contraction each operation rounds as the
# plain PyTorch version's does, which keeps float64 intensities and
# tangents within rtol 1e-9 of it and float32 inside the statistical gate.
# The formula dp units contract: dp agrees statistically either way, and
# contraction makes it 4-6 % faster on an H100 (PERF.md). Neither
# simulation unit contracts: in float32 the grid's trilinear kinks make
# dp's image depend on its exact step sequence at the 1e-3 level, so dp
# holds the statistical gate only when it rounds as the plain version
# does (PERF.md). No polarized unit contracts either, for the same
# reason. The phase kernel of phased dispatch
# (simulation_phase.cu) must round as simulation_kernel.cu does: a phased
# image is held to the monolithic one bit for bit. The units of many mesh
# blocks (simulation_blocks*.cu, simulation_phase_blocks.cu,
# polarized_derive_blocks.cu), of one FMKS block (simulation_fmks*.cu,
# simulation_mixture_fmks.cu, simulation_phase*_fmks.cu,
# polarized_derive_fmks*.cu), of CKS grids (simulation_cks*.cu,
# simulation_mixture_cks.cu, simulation_phase*_cks.cu,
# polarized_derive_cks*.cu) and of the mixture of populations
# (simulation_mixture*.cu, simulation_phase_mixture*.cu,
# polarized_derive_mixture*.cu) follow their thermal units.
CONTRACT = {"formula_kernel.cu": False, "formula_kernel_dp.cu": True,
            "formula_kernel_multi.cu": False,
            "formula_kernel_multi_dp.cu": True,
            "formula_kernel_tangent.cu": False,
            "formula_kernel_tangent_dp.cu": True,
            "simulation_kernel.cu": False,
            "simulation_kernel_dp.cu": False, "simulation_phase.cu": False,
            "simulation_blocks.cu": False, "simulation_blocks_dp.cu": False,
            "simulation_phase_blocks.cu": False,
            "simulation_mixture.cu": False, "simulation_mixture_dp.cu": False,
            "simulation_mixture_blocks.cu": False,
            "simulation_mixture_blocks_dp.cu": False,
            "simulation_phase_mixture.cu": False,
            "simulation_phase_mixture_blocks.cu": False,
            "simulation_fmks.cu": False, "simulation_fmks_dp.cu": False,
            "simulation_mixture_fmks.cu": False,
            "simulation_phase_fmks.cu": False,
            "simulation_phase_mixture_fmks.cu": False,
            "polarized_trace.cu": False, "polarized_derive.cu": False,
            "polarized_derive_f64.cu": False,
            "polarized_derive_blocks.cu": False, "polarized_chain.cu": False,
            "polarized_derive_mixture.cu": False,
            "polarized_derive_mixture_f64.cu": False,
            "polarized_derive_mixture_blocks.cu": False,
            "polarized_derive_fmks.cu": False,
            "polarized_derive_fmks_f64.cu": False,
            "simulation_cks.cu": False, "simulation_cks_dp.cu": False,
            "simulation_mixture_cks.cu": False,
            "simulation_phase_cks.cu": False,
            "simulation_phase_mixture_cks.cu": False,
            "polarized_derive_cks.cu": False,
            "polarized_derive_cks_f64.cu": False}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; raises if none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _compile_flags(source: pathlib.Path) -> tuple:
    fmad = "true" if CONTRACT.get(source.name, True) else "false"
    return (*NVCC_FLAGS, f"-fmad={fmad}")


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256()
    for path in sources():
        digest.update(" ".join(_compile_flags(path)).encode())
    for path in sources() + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libblacklight_tpu_torch_{digest.hexdigest()[:16]}.so"


def _nvcc_all(cmds: list) -> list:
    """Run the nvcc commands concurrently; their outputs, in order. Raises
    if any fails (after every process has ended)."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return outputs


def build() -> pathlib.Path:
    """Compile csrc/*.cu and link the library unless it already exists;
    returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [os.path.join(tmp, f"{src.stem}.o") for src in sources()]
        report = _nvcc_all([
            [nvcc, *_compile_flags(src), "-I", str(CSRC), "-c", "-o", obj,
             str(src)] for src, obj in zip(sources(), objects)])
        lib = os.path.join(tmp, out.name)
        _nvcc_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objects]])
        out.with_suffix(".ptxas.txt").write_text("".join(report))
        os.replace(lib, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build if needed and load; the caller declares the C interface it
    uses."""
    return ctypes.CDLL(str(build()))


def ptxas_report() -> str:
    """nvcc's -Xptxas -v output for the current library ('' if the
    library was not built by this tree)."""
    report = library_path().with_suffix(".ptxas.txt")
    return report.read_text() if report.exists() else ""
