"""Copies of a tree whose float simulation kernels ask for another launch
bound, for ``scripts/formula_kernel_ab.py sweep``:

    python3 scripts/simulation_variants.py --tree DIR --out DIR2 blocks=K

makes DIR2 a copy of DIR in which every float instantiation of the
monolithic and the phase kernel asks for K blocks of SIM_THREADS per SM
(SimBlocks in csrc/simulation_kernel.cuh). The copy leaves out the
tree's build outputs. No card needed.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import shutil
import sys

KERNEL_CUH = pathlib.Path("blacklight_tpu_torch") / "csrc" / \
    "simulation_kernel.cuh"
IGNORE = shutil.ignore_patterns("build", "chip_archive", ".git",
                                "__pycache__", "*.so")
SIM_BLOCKS = r"constexpr int SimBlocks =[^;]*;"


def with_blocks(text: str, blocks: int) -> str:
    """simulation_kernel.cuh's text with SimBlocks set to ``blocks`` for
    float and 1 for double."""
    out, n = re.subn(SIM_BLOCKS, f"constexpr int SimBlocks = sizeof(T) == 4 "
                     f"? {int(blocks)} : 1;", text)
    if n != 1:
        raise RuntimeError(f"{KERNEL_CUH}: no single SimBlocks definition")
    return out


def make(tree: pathlib.Path, out: pathlib.Path, variant: str) -> None:
    kind, _, value = variant.partition("=")
    if kind != "blocks" or not value.isdigit():
        raise ValueError(f"unknown variant {variant!r}")
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(tree, out, ignore=IGNORE)
    path = out / KERNEL_CUH
    path.write_text(with_blocks(path.read_text(), int(value)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("variant")
    opts = parser.parse_args(argv)
    make(pathlib.Path(opts.tree).resolve(), pathlib.Path(opts.out).resolve(),
         opts.variant)
    return 0


if __name__ == "__main__":
    sys.exit(main())
