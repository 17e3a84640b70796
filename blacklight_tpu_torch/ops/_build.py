"""Build and load the CUDA kernels of this package.

Each ``csrc/*.cu`` is compiled with ``nvcc`` to an object and the objects
are linked into one shared library with a plain C interface,
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
# formula_kernel.cu (rk4, rk2) does not: chaotic photon-ring rays amplify
# a one-ulp difference to 1e-7 in I_nu, and without contraction each
# operation rounds as the plain PyTorch version's does, which keeps
# float64 within rtol 1e-9 of it and float32 inside the statistical gate.
# formula_kernel_dp.cu contracts: dp agrees statistically either way, and
# contraction makes it 4-6 % faster on an H100 (PERF.md).
CONTRACT = {"formula_kernel.cu": False}


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


def _nvcc(cmd: list) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> pathlib.Path:
    """Compile csrc/*.cu and link the library unless it already exists;
    returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects, report = [], []
        for src in sources():
            obj = os.path.join(tmp, f"{src.stem}.o")
            report.append(_nvcc([nvcc, *_compile_flags(src), "-I", str(CSRC),
                                 "-c", "-o", obj, str(src)]))
            objects.append(obj)
        lib = os.path.join(tmp, out.name)
        _nvcc([nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objects])
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
