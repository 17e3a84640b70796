"""Where the FP64 instructions of the port's kernels come from.

    python3 scripts/sass_fp64_lines.py [--kernel SUBSTRING] [UNIT.cu ...]

compiles each csrc unit (default: every one) to a cubin with the flags
blacklight_tpu_torch/ops/_build.py builds the library with, plus
-lineinfo, disassembles it with nvdisasm and prints one JSON line per
kernel whose mangled name contains SUBSTRING: its FP64 instructions
(DADD, DMUL, DFMA as "arith"; every other D* or F64 operation, such as
compares, min/max and conversions, as "other"), each with the source
line, and the lines it was inlined at, that it comes from. The counts
are chip_smoke.py phase 2's fp64_sass; -lineinfo adds line tables and
leaves the code as it is. Needs the CUDA toolkit (nvcc, nvdisasm,
cu++filt); no card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARITH = ("DADD", "DMUL", "DFMA")


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not pathlib.Path(path).exists():
        raise RuntimeError(f"{name} not found")
    return path


def _demangle(names: list) -> dict:
    out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    return dict(zip(names, out.splitlines()))


def fp64_lines(sass: str) -> dict:
    """{mangled kernel: [(opcode, kind, location), ...]} from nvdisasm's
    output with line information."""
    kernels, name, where = {}, None, None
    for line in sass.splitlines():
        m = re.match(r"\s*\.section\s+\.text\.([^,\s]+)", line)
        if m:
            name, where = m.group(1), None
            kernels[name] = []
            continue
        m = re.match(r"\s*//## (.*)", line)
        if m:
            where = m.group(1).replace(str(ROOT) + "/", "")
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                      line)
        if name is None or not m:
            continue
        op = m.group(1)
        if op.split(".")[0] in ARITH:
            kernels[name].append((op, "arith", where))
        elif op.startswith("D") or "F64" in op:
            kernels[name].append((op, "other", where))
    return kernels


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("units", nargs="*")
    parser.add_argument("--kernel", default="")
    opts = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from blacklight_tpu_torch.ops import _build
    units = ([_build.CSRC / u for u in opts.units] if opts.units
             else _build.sources())
    nvcc, nvdisasm = _build.find_nvcc(), _tool("nvdisasm")
    with tempfile.TemporaryDirectory() as tmp:
        cubins = [pathlib.Path(tmp) / f"{u.stem}.cubin" for u in units]
        _build._nvcc_all([
            [nvcc, *_build._compile_flags(u), "-lineinfo", "-I",
             str(_build.CSRC), "-cubin", "-o", str(c), str(u)]
            for u, c in zip(units, cubins)])
        for unit, cubin in zip(units, cubins):
            sass = subprocess.run([nvdisasm, "-c", "-gi", str(cubin)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            kernels = {k: v for k, v in fp64_lines(sass).items()
                       if opts.kernel in k}
            names = _demangle(list(kernels)) if kernels else {}
            for mangled, ops in kernels.items():
                print(json.dumps({
                    "unit": unit.name, "kernel": names[mangled],
                    "arith": sum(k == "arith" for _, k, _ in ops),
                    "other": sum(k == "other" for _, k, _ in ops),
                    "instructions": [{"op": op, "kind": kind, "at": where}
                                     for op, kind, where in ops]}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
