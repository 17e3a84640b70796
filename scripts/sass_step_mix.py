"""Static instruction mix of the port's kernels' step loops, from the SASS.

    python3 scripts/sass_step_mix.py [--root TREE] [--kernel SUBSTRING] \
        [--same-as OTHER_TREE] [UNIT.cu ...]

compiles each csrc unit of TREE (default: this checkout; every unit
unless named) to a cubin with the flags TREE's
blacklight_tpu_torch/ops/_build.py builds its library with, plus
-lineinfo (line tables only: the code is the library's), disassembles it
with ``nvdisasm -gi`` and prints one JSON line per kernel whose mangled
name contains SUBSTRING: its instruction count, the instruction mix of
its step loop, taken as the backward branch that spans the most
instructions (the loop over a ray's steps, or in a kernel whose lanes
or warps fetch rays, the loop over their rays), the mix of that loop's
per-step path: the loop without the instructions that come from the
code a lane runs once per ray or on a rejected step, the bodies of
PER_RAY_FUNCTIONS (by the source lines each instruction was inlined
from), and the mix of the part of that path that comes from the sample
functor (PER_SAMPLE_FUNCTIONS: what a step runs when it stores a
sample). Classes: FP32 arithmetic (FADD, FMUL, FFMA, FMNMX), FP32 compare
and select, MUFU (and among them the division and square root sequences:
one FCHK or MUFU.RCP64H per division, one MUFU.RSQ or MUFU.RSQ64H per
square root), FP64, conversions, integer, moves, branches and calls,
local, global, shared and constant memory, and the rest. Subroutines
placed after the kernel's exit (the division and square root slow paths,
which a step reaches only on rare inputs) lie outside the loop. The
counts are static: an instruction counts once whether a step runs it
every time, rarely (a branch not taken) or never. With --same-as, each
kernel's line also compares it with OTHER_TREE's build of the same unit:
whether the SASS is the same instruction for instruction (same_sass),
and whether it holds the same opcodes, each as many times, in another
order or with other registers (same_opcodes). Needs the CUDA toolkit
(nvcc, nvdisasm, cu++filt); no card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
CLASSES = (
    ("fp32_arith", r"F(ADD|MUL|FMA|MNMX)(32I)?$"),
    ("fp32_compare_select", r"F(SETP|SEL|SET|CHK)$"),
    ("mufu", r"MUFU$"),
    ("fp64", r"D(ADD|MUL|FMA|SETP|MNMX|SET)$"),
    ("conversion", r"(F2F|F2I|I2F|I2FP|F2FP|FRND)$"),
    ("integer", r"(IADD3|IMAD|ISETP|LOP3|SHF|LEA|IABS|IMNMX|POPC|FLO|BREV|"
                r"SGXT|IADD|LOP|SHL|SHR|BMSK|IDP|VIADD|VIMNMX)(32I)?$"),
    ("move", r"(MOV|SEL|PRMT|S2R|CS2R|S2UR|R2UR|P2R|R2P|PLOP3|U\w+)(32I)?$"),
    ("branch", r"(BRA|BRX|JMP|CALL|RET|EXIT|BSSY|BSYNC|WARPSYNC|BREAK|BPT|"
               r"YIELD|KILL|NANOSLEEP)$"),
    ("local_memory", r"(LDL|STL)$"),
    ("global_memory", r"(LDG|STG|LD|ST|ATOM|ATOMG|RED)$"),
    ("shared_memory", r"(LDS|STS|LDSM)$"),
    ("constant_memory", r"(LDC)$"),
    ("warp", r"(SHFL|VOTE|VOTEU|MATCH|BAR)$"),
    ("nop", r"NOP$"),
)
# The functions (and lambdas) whose code a lane of the formula kernel runs
# once per ray, or on a rejected dp step (start_geometry), by source file:
# a ray's start, the write of its outputs and the fetch of the next. (A
# simulation kernel's thread traces one ray: its per-ray code lies outside
# the step loop.)
PER_RAY_FUNCTIONS = {
    "formula_kernel.cuh": ("start_geometry", "reset", "start_ray",
                           "finish_ray", "take_rays"),
    "trace.cuh": ("init_ray_state",),
}
# The sample functors, whose code a step runs when it stores a sample: the
# per-sample part of the per-step path.
PER_SAMPLE_FUNCTIONS = {
    "formula_kernel.cuh": ("operator()",),
    "simulation_kernel.cuh": ("operator()",),
}
INSTRUCTION = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);")
LOCATION = re.compile(r'"([^"]+)", line (\d+)')


def _build_module(root: pathlib.Path):
    """TREE's ops/_build.py, loaded from its file."""
    path = root / "blacklight_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location(f"_build_{abs(hash(root))}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not pathlib.Path(path).exists():
        raise RuntimeError(f"{name} not found")
    return path


def functions(sass: str) -> dict:
    """{mangled name: [(address, opcode, operands, chain), ...]} from
    ``nvdisasm -c -gi`` output. chain: the (file name, line) pairs an
    instruction comes from, innermost first, then each line it was inlined
    at. Branch targets are rewritten from labels to hex addresses."""
    out, name = {}, None
    labels, pending = {}, []
    chain, in_chain = (), False
    for line in sass.splitlines():
        m = re.match(r"\s*\.section\s+\.text\.([^,\s]+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            labels[name] = {}
            chain, in_chain = (), False
            continue
        if name is None:
            continue
        if line.lstrip().startswith("//##"):
            if not in_chain:
                chain = ()
            chain += tuple((pathlib.PurePath(f).name, int(n))
                           for f, n in LOCATION.findall(line))
            in_chain = True
            continue
        m = re.match(r"(\.L\w+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSTRUCTION.search(line)
        if m:
            in_chain = False
            addr = int(m.group(1), 16)
            for label in pending:
                labels[name][label] = addr
            pending = []
            out[name].append((addr, m.group(2), m.group(3).strip(), chain))
    for name, code in out.items():
        out[name] = [(addr, op, re.sub(
            r"`\((\.L\w+)\)",
            lambda m: hex(labels[name].get(m.group(1), -1)), args), chain)
            for addr, op, args, chain in code]
    return out


def step_loop(code: list) -> list:
    """The instructions of the backward branch that spans the most."""
    best = (0, 0, -1)
    for i, (addr, op, args, *_) in enumerate(code):
        if not op.startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)", args)
        if not m:
            continue
        target = int(m.group(1), 16)
        if target < addr:
            first = next(j for j, c in enumerate(code) if c[0] >= target)
            if i - first > best[2] - best[1]:
                best = (0, first, i)
    return code[best[1]:best[2] + 1]


def _bodies(text: str, name: str):
    """(first line, last line) of each definition of function or lambda
    ``name`` in source ``text``."""
    pattern = re.compile(r"\b%s\s*(?:=\s*\[[^\]]*\]\s*)?\([^;{}]*\)\s*"
                         r"(?:const\s*)?\{" % re.escape(name))
    for m in pattern.finditer(text):
        depth = 0
        for end in range(m.end() - 1, len(text)):
            depth += {"{": 1, "}": -1}.get(text[end], 0)
            if depth == 0:
                break
        yield (text.count("\n", 0, m.start()) + 1,
               text.count("\n", 0, end) + 1)


def per_ray_lines(root: pathlib.Path, functions=None) -> set:
    """{(file name, line)} of the bodies of ``functions`` (by source file;
    PER_RAY_FUNCTIONS unless given) in TREE's csrc (what a tree does not
    define is not there)."""
    csrc = root / "blacklight_tpu_torch" / "csrc"
    lines = set()
    for file, names in (functions or PER_RAY_FUNCTIONS).items():
        text = (csrc / file).read_text()
        for name in names:
            for first, last in _bodies(text, name):
                lines.update((file, n) for n in range(first, last + 1))
    return lines


def per_step(loop: list, per_ray: set) -> list:
    """The instructions of a step loop that no per-ray line leads to."""
    return [c for c in loop if not any(at in per_ray for at in c[3])]


def mix(code: list) -> dict:
    counts = {name: 0 for name, _ in CLASSES}
    counts["other"] = 0
    counts["division_sequences"] = counts["sqrt_sequences"] = 0
    for _, op, *_ in code:
        base = op.split(".")[0]
        for name, pattern in CLASSES:
            if re.match(pattern, base):
                counts[name] += 1
                break
        else:
            counts["other"] += 1
        if base == "FCHK" or op.startswith("MUFU.RCP64H"):
            counts["division_sequences"] += 1
        if op.startswith("MUFU.RSQ"):
            counts["sqrt_sequences"] += 1
    counts["total"] = len(code)
    return counts


def per_sample_lines(root: pathlib.Path) -> set:
    """{(file name, line)} of the bodies of PER_SAMPLE_FUNCTIONS in TREE's
    csrc."""
    return per_ray_lines(root, PER_SAMPLE_FUNCTIONS)


def loop_mixes(code: list, per_ray: set, per_sample=frozenset()) -> dict:
    """The mixes of a kernel's step loop, of its per-step path and of the
    part of that path that the sample functor's lines lead to
    (``per_sample``)."""
    loop = step_loop(code)
    step = per_step(loop, per_ray)
    return {"step_loop": mix(loop), "per_step": mix(step),
            "per_sample": mix([c for c in step
                               if any(at in per_sample for at in c[3])])}


def disassemble(root: pathlib.Path, units: list, tmp: pathlib.Path) -> dict:
    """{unit name: {mangled kernel: [(address, opcode, operands, chain)]}}
    of TREE's units, built with TREE's flags and -lineinfo."""
    build = _build_module(root)
    names = units or [u.name for u in build.sources()]
    cubins = [tmp / f"{root.name}_{pathlib.Path(u).stem}.cubin" for u in names]
    build._nvcc_all([
        [build.find_nvcc(), *build._compile_flags(build.CSRC / u), "-lineinfo",
         "-I", str(build.CSRC), "-cubin", "-o", str(c), str(build.CSRC / u)]
        for u, c in zip(names, cubins)])
    nvdisasm = _tool("nvdisasm")
    return {u: functions(subprocess.run([nvdisasm, "-c", "-gi", str(c)],
                                        capture_output=True, text=True,
                                        check=True).stdout)
            for u, c in zip(names, cubins)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("units", nargs="*")
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("--kernel", default="")
    parser.add_argument("--same-as", default=None)
    opts = parser.parse_args(argv)
    root = pathlib.Path(opts.root).resolve()
    per_ray, per_sample = per_ray_lines(root), per_sample_lines(root)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        ours = disassemble(root, opts.units, tmp)
        other = None
        if opts.same_as:
            (tmp / "other").mkdir()
            other = disassemble(pathlib.Path(opts.same_as).resolve(),
                                list(ours), tmp / "other")
    names = [k for unit in ours.values() for k in unit if opts.kernel in k
             and "_kernel" in k]
    out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    readable = dict(zip(names, out.splitlines()))
    for unit, kernels in ours.items():
        for mangled, code in kernels.items():
            if mangled not in readable:
                continue
            line = {"unit": unit, "kernel": readable[mangled],
                    "mangled": mangled, "instructions": len(code),
                    **loop_mixes(code, per_ray, per_sample)}
            if other is not None:
                theirs = other.get(unit, {}).get(mangled) or []
                line["same_sass"] = [c[1:3] for c in theirs] \
                    == [c[1:3] for c in code]
                line["same_opcodes"] = sorted(c[1] for c in theirs) \
                    == sorted(c[1] for c in code)
                line["other_instructions"] = len(theirs)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
