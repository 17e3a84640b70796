"""Compare two trees' formula kernels (blacklight_tpu_torch
ops/formula_kernel.render_formula) on one NVIDIA GPU: time and output, in
turns, on the same rays.

    python3 scripts/formula_kernel_ab.py compare --parent DIR [--change DIR]

runs a worker process per tree in the order parent, change, change,
parent (each tree builds its own kernels into DIR/build/kernels) and
times, at 1024^2 on golden_formula_32.input (chip_smoke.py's formula
cells): K1.1 dp float32 (phase 5's cell), K1.1 rk4 and rk2 float32, dp
float64 in camera order and in spatial_order's 256-ray tiles, K1.3 at
three frequencies (phase 10's), K1.4 with tangents for cn0, r0 and h
(phase 11's) and both at once (three frequencies and three tangents, the
larger frequency bucket with tangents). It then holds the change's
outputs (I_nu, every dI/dp, flags, n_samples) to the parent's: bit for
bit for rk4 and rk2 at 1024^2 and for rk4 and rk2 in float32 and
float64, at one frequency and at three with the three tangents (h = 0.4,
formula_a = 1e5), at 256^2; by the statistical gate of bench.py:181-186
for dp. The simulation kernel, which
shares the geodesic step's code, is held bit for bit too: chip_smoke.py
phase 7's 1024^2 cell in rk4 float32 and float64 and dp float32. It prints one JSON line per
worker and a last line with the times, the change over the parent per
cell (and whether every run of the change was below every run of the
parent), and per cell and tree its ray-steps (the sum of n_samples), its
128-ray block efficiency in camera order and in 8 x 4 tiles (n_samples as
the proxy; chip_smoke.py warp_efficiency), the static instructions of its
kernel's step loop and of the loop's per-step path
(scripts/sass_step_mix.py) and the issue estimate the latter gives
(chip_smoke.py ISSUE_LANES_PER_SM); it exits non-zero if an output
differs.

    python3 scripts/formula_kernel_ab.py worker --tree DIR --out DIR2 \\
        [--times-only] [--cells k11,k13_tangents,...] [--reps N]

is one worker: each cell (warm-up, then best of ``--reps``), outputs
saved under DIR2, then (unless ``--times-only``) the step loops'
instruction mixes and issue estimates and the 256^2 cases. Workers on
copies of one tree that differ in one constant, run in turns, time that
constant's choices. The worker runs the tree's package on the rays this
checkout's chip_smoke.py makes, so both trees get the same inputs.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The kernel instantiation each cell launches (chip_smoke.py's labels) and
# the units that hold them.
CELL_KERNELS = {"k11": "formula_kernel<float, dp, NF=1>",
                "k11_rk4": "formula_kernel<float, rk4, NF=1>",
                "k11_rk2": "formula_kernel<float, rk2, NF=1>",
                "k11_f64": "formula_kernel<double, dp, NF=1>",
                "k11_f64_spatial": "formula_kernel<double, dp, NF=1>",
                "k13": "formula_kernel<float, dp, NF=4>",
                "k14": "formula_kernel<float, dp, NF=1, tangents>",
                "k13_tangents": "formula_kernel<float, dp, NF=4, tangents>"}
CELLS = tuple(CELL_KERNELS)
# Rays per tile of the spatial_order of k11_f64_spatial
# (pipeline.FORMULA_ORDER_BLOCK).
SPATIAL_BLOCK = 256
STEP_UNITS = ("formula_kernel.cu", "formula_kernel_dp.cu",
              "formula_kernel_multi_dp.cu", "formula_kernel_tangent_dp.cu")
EXACT_CASES = tuple((integrator, precision, full)
                    for integrator in ("rk4", "rk2")
                    for precision in ("float32", "float64")
                    for full in (False, True))
EXACT_RES = 256
# The simulation kernel shares the geodesic step's code (csrc/trace.cuh,
# kerr.cuh): chip_smoke.py phase 7's cell in these types and integrators,
# held bit for bit between the trees.
SIM_CASES = (("float32", "rk4"), ("float64", "rk4"), ("float32", "dp"))


def _smoke():
    """This checkout's chip_smoke.py, loaded from its file (a worker's
    sys.path starts at the tree under test)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _step_loops(cs, tree: pathlib.Path) -> dict:
    """Static instruction mixes of the step loop and its per-step path
    (scripts/sass_step_mix.py) of the tree's formula kernels, by
    chip_smoke.py kernel label."""
    spec = importlib.util.spec_from_file_location(
        "sass_step_mix", ROOT / "scripts" / "sass_step_mix.py")
    mix = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mix)
    per_ray = mix.per_ray_lines(tree)
    with tempfile.TemporaryDirectory() as tmp:
        sass = mix.disassemble(tree, list(STEP_UNITS), pathlib.Path(tmp))
    return {cs._kernel_label(name): mix.loop_mixes(code, per_ray)
            for unit in sass.values() for name, code in unit.items()
            if "formula_kernel" in name}


def _cell(cs, name):
    """Renderer arguments and keywords of a timed cell."""
    if name in ("k11", "k13", "k14"):
        return cs._formula_cell(name)[1:]
    if name == "k13_tangents":
        _, args, kwargs = cs._formula_cell("k14")
        multi = cs._formula_cell("k13")[1]
        return (*args[:3], multi[3], *args[4:]), kwargs
    overrides = dict(camera_resolution=1024, precision="float32",
                     ray_integrator="dp")
    if name in ("k11_rk4", "k11_rk2"):
        overrides["ray_integrator"] = name[-3:]
    else:
        overrides["precision"] = "float64"
    args, kwargs = cs._renderer(cs._config("golden_formula_32.input",
                                           **overrides))
    if name == "k11_f64_spatial":
        from blacklight_tpu_torch.ops.simulation_kernel import spatial_order
        order = spatial_order(args[0], block=SPATIAL_BLOCK)
        args = (*(t[order].contiguous() for t in args[:3]), *args[3:])
    return args, kwargs


def _exact_case(cs, integrator, precision, full):
    """Renderer arguments of a bit-for-bit case at EXACT_RES^2: one
    frequency, or three with tangents for cn0, r0 and h."""
    overrides = dict(camera_resolution=EXACT_RES, ray_integrator=integrator,
                     precision=precision)
    if full:
        overrides.update(formula_h=cs.FIT_H, formula_a=cs.CHECK_A,
                         **cs.MULTI_FREQUENCIES)
    args, kwargs = cs._renderer(cs._config("golden_formula_32.input",
                                           **overrides))
    if full:
        kwargs["diff_values"] = cs._fit_values(args[5])
    return args, kwargs


def _save(out, path: pathlib.Path) -> None:
    import torch
    fields = {"I_nu": out[0], "flags": out[1], "n_samples": out[2]}
    if len(out) == 4:
        fields["dI"] = torch.stack(out[3])
    torch.save({k: v.cpu() for k, v in fields.items()}, path)


def worker(opts) -> dict:
    tree = pathlib.Path(opts.tree).resolve()
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    import torch
    cs = _smoke()
    from blacklight_tpu_torch.ops import formula_kernel as fk
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU")
    out_dir = pathlib.Path(opts.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    result = {"tree": str(tree), "label": opts.label, "card": cs.smi(
        cs.SMI_QUERY), "clocks_max": cs.smi(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"])}
    cells = opts.cells.split(",") if opts.cells else CELLS
    runs = {}
    for name in cells:
        args, kwargs = _cell(cs, name)
        out = fk.render_formula(*args, **kwargs)  # also the warm-up
        _save(out, out_dir / f"{name}.pt")
        result[f"{name}_ray_steps"] = int(out[2].long().sum())
        result[f"{name}_block_efficiency_128"] = _block_efficiency(
            cs, out[2].cpu(), launched=name == "k11_f64_spatial")
        runs[f"{name}_main"] = [
            cs._timed(fk.render_formula, *args, **kwargs)[1] * 1e3
            for _ in range(opts.reps)]
        del args, kwargs, out
        torch.cuda.empty_cache()
    result["runs_ms"] = runs
    result.update({f"{k}_ms": min(v) for k, v in runs.items()})
    if not opts.times_only:
        loops = _step_loops(cs, tree)
        clock_hz = float(cs.smi(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                 "--format=csv,noheader,nounits"])) * 1e6
        result["step_loops"] = loops
        for name in cells:
            mixes = loops[CELL_KERNELS[name]]
            instr = mixes["per_step"]["total"]
            result[f"{name}_step_instructions"] = instr
            result[f"{name}_loop_instructions"] = mixes["step_loop"]["total"]
            result[f"{name}_issue_estimate_ms"] = (
                instr * result[f"{name}_ray_steps"]
                / (cs.N_SMS * cs.ISSUE_LANES_PER_SM * clock_hz) * 1e3)
        for case in EXACT_CASES:
            args, kwargs = _exact_case(cs, *case)
            _save(fk.render_formula(*args, **kwargs),
                  out_dir / "case_{}_{}_{}.pt".format(*case))
        from blacklight_tpu_torch.ops import simulation_kernel as sk
        grids = {}
        for precision, integrator in SIM_CASES:
            if precision not in grids:
                grids[precision] = cs.full_width_snapshot(
                    getattr(torch, precision))
            args, kwargs = cs._sim_args(cs._sim_config(
                camera_resolution=1024, precision=precision,
                ray_integrator=integrator, ray_max_steps=2000),
                grids[precision])
            _save(sk.render_simulation(*args, **kwargs),
                  out_dir / f"sim_{precision}_{integrator}.pt")
        grids.clear()
    print(json.dumps(result), flush=True)
    (out_dir / "result.json").write_text(json.dumps(result))
    return result


def _block_efficiency(cs, n_samples, launched=False) -> dict:
    """128-ray block efficiency of a 1024^2 cell in camera order and in 8
    x 4 tiles, n_samples standing in for a ray's steps; of the order the
    rays were launched in if they are not in camera order (``launched``)."""
    import numpy as np
    ns = n_samples.numpy()
    if launched:
        return {"launch": cs.warp_efficiency(ns, np.arange(ns.size), 128)}
    res = int(round(ns.size ** 0.5))
    tiles = np.arange(ns.size).reshape(res // 4, 4, res // 8, 8).transpose(
        0, 2, 1, 3).reshape(-1)
    return {"camera": cs.warp_efficiency(ns, np.arange(ns.size), 128),
            "tiles_8x4": cs.warp_efficiency(ns, tiles, 128)}


def compare(opts) -> int:
    import torch
    cs = _smoke()
    parent = pathlib.Path(opts.parent).resolve()
    change = pathlib.Path(opts.change).resolve()
    script = pathlib.Path(__file__).resolve()
    turns = (("parent", parent), ("change", change), ("change", change),
             ("parent", parent))
    results = []
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, tree) in enumerate(turns):
            out = pathlib.Path(tmp) / f"{i}_{label}"
            cmd = [sys.executable, str(script), "worker", "--tree", str(tree),
                   "--out", str(out), "--label", label,
                   "--reps", str(opts.reps)]
            if i >= 2:
                cmd.append("--times-only")
            subprocess.run(cmd, check=True)
            results.append(json.loads((out / "result.json").read_text()))
        a_dir = pathlib.Path(tmp) / "0_parent"
        b_dir = pathlib.Path(tmp) / "1_change"
        identical, gates, ok = {}, {}, True
        names = (list(CELLS) + ["case_{}_{}_{}".format(*c) for c in EXACT_CASES]
                 + [f"sim_{p}_{i}" for p, i in SIM_CASES])
        for name in names:
            a = torch.load(a_dir / f"{name}.pt")
            b = torch.load(b_dir / f"{name}.pt")
            same = {k: cs._same_bits(a[k], b[k]) for k in a}
            identical[name] = same
            if "dp" in name or name in ("k11", "k11_f64", "k11_f64_spatial",
                                        "k13", "k14", "k13_tangents"):
                ours = [b["I_nu"].numpy(), *(b["dI"].numpy() if "dI" in b
                                             else [])]
                ref = [a["I_nu"].numpy(), *(a["dI"].numpy() if "dI" in a
                                            else [])]
                gate = cs.gate_outputs(ours, ref)
                gates[name] = gate
                ok = ok and gate["ok"]
            else:
                ok = ok and all(same.values())
    summary.update(identical=identical, dp_gates=gates, ok=ok,
                   card=results[0]["card"], clocks_max=results[0]["clocks_max"])
    for key in results[1]:
        if (not key.endswith("_ms") or key == "runs_ms"
                or key.endswith("issue_estimate_ms")):
            continue
        c = min(r[key] for r in results if r["label"] == "change")
        if key in results[0]:
            p = min(r[key] for r in results if r["label"] == "parent")
            summary[key] = {"parent_ms": p, "change_ms": c,
                            "change_over_parent": c / p,
                            "change_runs_below_parent": max(
                                v for r in results if r["label"] == "change"
                                for v in r["runs_ms"][key[:-3]]) < min(
                                v for r in results if r["label"] == "parent"
                                for v in r["runs_ms"][key[:-3]])}
        else:
            summary[key] = {"change_ms": c}
    for name in CELLS:
        for key in ("ray_steps", "block_efficiency_128", "step_instructions",
                    "loop_instructions", "issue_estimate_ms"):
            summary[f"{name}_{key}"] = {r["label"]: r.get(f"{name}_{key}")
                                        for r in results[:2]}
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="mode", required=True)
    w = sub.add_parser("worker")
    w.add_argument("--tree", required=True)
    w.add_argument("--out", required=True)
    w.add_argument("--label", default="")
    w.add_argument("--reps", type=int, default=3)
    w.add_argument("--times-only", action="store_true")
    w.add_argument("--cells", default="")
    c = sub.add_parser("compare")
    c.add_argument("--parent", required=True)
    c.add_argument("--change", default=str(ROOT))
    c.add_argument("--reps", type=int, default=3)
    opts = parser.parse_args(argv)
    if opts.mode == "worker":
        worker(opts)
        return 0
    return compare(opts)


if __name__ == "__main__":
    sys.exit(main())
