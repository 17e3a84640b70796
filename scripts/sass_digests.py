"""Digests of each kernel's SASS in a tree's built library, and their
comparison with a stored set.

    python3 scripts/sass_digests.py [--root TREE] [--out FILE]
    python3 scripts/sass_digests.py --compare FILE [--root TREE]
    python3 scripts/sass_digests.py --diff OTHER_TREE --kernel SUBSTRING

builds TREE's library (default: this checkout) with TREE's own
blacklight_tpu_torch/ops/_build.py, disassembles it with ``cuobjdump
-sass`` and takes, per kernel (mangled name), the SHA-256 of its
instructions' text (opcode and operands, without addresses or
encodings). Two builds whose digests agree compiled the kernel to the
same SASS instruction for instruction. The polarized chain kernels
(UNSTABLE) come out otherwise from one build of the same sources to the
next (two builds of commit 47f4c16 on the H100 machine differed in
14,081 lines of their SASS, ``--diff``), so a comparison reports them
and does not hold them. --out writes {"nvcc": ..., "kernels": {name:
digest}} as JSON; --compare prints, for each kernel of FILE, whether
this build's SASS is the same; --diff prints the unified diff of the
SASS of each kernel whose name holds SUBSTRING between OTHER_TREE's
build and this one. Needs the CUDA toolkit (nvcc, cuobjdump); no card.

scripts/thermal_sass.json holds the digests of the thermal kernels as
built before the power-law and kappa populations were added (commit
47f4c16, nvcc of the H100 machine), which chip_smoke.py phase 2 holds
every such kernel to.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Kernels whose SASS differs between builds of the same sources.
UNSTABLE = ("polarized_chain_kernel",)
REFERENCE = ROOT / "scripts" / "thermal_sass.json"
INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not pathlib.Path(path).exists():
        raise RuntimeError(f"{name} not found")
    return path


def nvcc_version() -> str:
    out = subprocess.run([_tool("nvcc"), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def bodies(sass: str) -> dict:
    """{mangled kernel: its instructions' text} from cuobjdump -sass
    output; a name met twice (the same instantiation in two objects) holds
    both bodies in order, each after a "--" line."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, []).append("--")
            continue
        m = INSTRUCTION.search(line)
        if name is not None and m:
            out[name].append(" ".join(m.group(1).split()))
    return out


def digests(sass: str) -> dict:
    """{mangled kernel: SHA-256 of its instructions} (bodies)."""
    return {k: hashlib.sha256("\n".join(v).encode()).hexdigest()
            for k, v in bodies(sass).items()}


def library_sass(root: pathlib.Path) -> str:
    """cuobjdump -sass of TREE's library, built with its own _build."""
    spec = importlib.util.spec_from_file_location(
        f"_build_{abs(hash(str(root)))}",
        root / "blacklight_tpu_torch" / "ops" / "_build.py")
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    lib = build.build()
    return subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout


def compare(current: dict, reference: dict) -> dict:
    """The kernels of ``reference`` against this build's (each {name:
    digest}): how many compiled to the same SASS, which of the UNSTABLE
    ones did not (reported, not held), which others did not, and which
    are missing."""
    same = [k for k, v in reference.items() if current.get(k) == v]
    missing = sorted(k for k in reference if k not in current)
    other = sorted(k for k, v in reference.items()
                   if k in current and current[k] != v)
    unstable = [k for k in other if any(u in k for u in UNSTABLE)]
    return {"same": len(same), "unstable_changed": unstable,
            "different": [k for k in other if k not in unstable],
            "missing": missing}


def record(sass: str) -> dict:
    """The --out record of a build's cuobjdump -sass."""
    return {"nvcc": nvcc_version(), "kernels": digests(sass)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("--out", default=None)
    parser.add_argument("--compare", default=None)
    parser.add_argument("--diff", default=None)
    parser.add_argument("--kernel", default="")
    opts = parser.parse_args(argv)
    sass = library_sass(pathlib.Path(opts.root).resolve())
    if opts.diff:
        import difflib
        ours = bodies(sass)
        theirs = bodies(library_sass(pathlib.Path(opts.diff).resolve()))
        for name in sorted(set(ours) | set(theirs)):
            if opts.kernel in name:
                print("\n".join(difflib.unified_diff(
                    theirs.get(name, []), ours.get(name, []),
                    f"{opts.diff}:{name}", f"{opts.root}:{name}",
                    lineterm="", n=2)))
        return 0
    current = record(sass)
    if opts.out:
        pathlib.Path(opts.out).write_text(json.dumps(current, indent=1,
                                                     sort_keys=True) + "\n")
    if opts.compare:
        reference = json.loads(pathlib.Path(opts.compare).read_text())
        print(json.dumps({"nvcc": current["nvcc"],
                          "reference_nvcc": reference["nvcc"],
                          **compare(current["kernels"],
                                    reference["kernels"])}))
    else:
        print(json.dumps({"nvcc": current["nvcc"],
                          "kernels": len(current["kernels"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
