"""Compare two trees' formula and simulation kernels (blacklight_tpu_torch
ops/formula_kernel.render_formula, ops/simulation_kernel.render_simulation
and render_simulation_phased) on one NVIDIA GPU: time and output, in
turns, on the same rays.

    python3 scripts/formula_kernel_ab.py compare --parent DIR [--change DIR] \
        [--cells k11,sim_rk4_spatial,...]

runs a worker process per tree in the order parent, change, change,
parent (each tree builds its own kernels into DIR/build/kernels) and
times, at 1024^2 on golden_formula_32.input (chip_smoke.py's formula
cells): K1.1 dp float32 (phase 5's cell), K1.1 rk4 and rk2 float32, dp
float64 in camera order and in spatial_order's 256-ray tiles, K1.3 at
three frequencies (phase 10's), K1.4 with tangents for cn0, r0 and h
(phase 11's) and both at once (three frequencies and three tangents, the
larger frequency bucket with tangents); and on chip_smoke.py phase 7's
simulation cell (the 288 x 128 x 128 snapshot, 1024^2, 2000 steps): rk4
float32 in camera order and in spatial_order's 256-ray tiles (the order
pipeline.run launches), and in spatial_order rk2 and dp float32, rk4 at
three frequencies (the larger frequency bucket), rk4 float64 and the
phased route (render_simulation_phased) at 512 and at 1000 steps a
phase. It then holds the change's
outputs (I_nu, every dI/dp, flags, n_samples) to the parent's: bit for
bit for rk4 and rk2 at 1024^2 and for rk4 and rk2 in float32 and
float64, at one frequency and at three with the three tangents (h = 0.4,
formula_a = 1e5), at 256^2; by the statistical gate of bench.py:181-186
for dp. The simulation kernel is held bit for bit (I_nu, flags,
n_samples): every timed simulation cell, and phase 7's cell in camera
order in rk4, rk2 and dp, float32 and float64, at one and at three
frequencies; so are the polarized route's outputs on phase 9's cell
(render_polarized in spatial_order), and within each tree the phased
route's image is held to the monolithic kernel's. It prints one JSON line per
worker and a last line with the times, the change over the parent per
cell (and whether every run of the change was below every run of the
parent), and per cell and tree its ray-steps (the sum of n_samples), its
128-ray block efficiency in camera order and in 8 x 4 tiles, or in the
order it was launched in (n_samples as the proxy; chip_smoke.py
warp_efficiency), and for a simulation cell its warp efficiency too, the
static instructions of its kernel's step loop, of the loop's per-step
path and of the part of that path the sample functor leads to
(scripts/sass_step_mix.py) and the issue estimate the per-step path
gives (chip_smoke.py ISSUE_LANES_PER_SM); it exits non-zero if an output
differs.

    python3 scripts/formula_kernel_ab.py worker --tree DIR --out DIR2 \\
        [--times-only] [--cells k11,k13_tangents,...] [--reps N]

is one worker: each cell (warm-up, then best of ``--reps``), outputs
saved under DIR2, then (unless ``--times-only``) the step loops'
instruction mixes and issue estimates and the exact cases. The worker
runs the tree's package on the rays this checkout's chip_smoke.py makes,
so both trees get the same inputs.

    python3 scripts/formula_kernel_ab.py sweep --trees DIR1,DIR2,... \
        --cells sim_rk4_spatial,... [--rounds N] [--reps N]

times copies of one tree that differ in one choice (a launch bound,
scripts/simulation_variants.py): workers with ``--times-only`` in turns, DIR1 .. DIRn then
DIRn .. DIR1, ``--rounds`` times, and a last line with each cell's runs
and best time per tree and its best over the first tree's.
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
# Simulation cells: chip_smoke.py phase 7's configuration at 1024^2,
# (precision, integrator, frequencies, order, phase steps); order
# "spatial" is spatial_order in KERNEL_ORDER_BLOCK tiles, as pipeline.run
# launches; phase steps None for the monolithic kernel.
SIM_CELLS = {
    "sim_rk4": ("float32", "rk4", 1, "camera", None),
    "sim_rk4_spatial": ("float32", "rk4", 1, "spatial", None),
    "sim_rk2_spatial": ("float32", "rk2", 1, "spatial", None),
    "sim_dp_spatial": ("float32", "dp", 1, "spatial", None),
    "sim_rk4_3nu_spatial": ("float32", "rk4", 3, "spatial", None),
    "sim_rk4_f64_spatial": ("float64", "rk4", 1, "spatial", None),
    "sim_phased": ("float32", "rk4", 1, "spatial", 512),
    "sim_phased_1000": ("float32", "rk4", 1, "spatial", 1000),
}
for _name, (_p, _i, _nf, _, _steps) in SIM_CELLS.items():
    CELL_KERNELS[_name] = (
        f"simulation_kernel<{'float' if _p == 'float32' else 'double'}, "
        f"{_i}, NF={1 if _nf == 1 else 16}>" if _steps is None else
        f"simulation_phase_kernel<float, {_i}, NF=1>")
# chip_smoke.py phase 14's cells (MESH_CELLS: mesh blocks and the nearest
# cell), rk4 float32 in spatial_order: timed only (--times-only; a tree
# from before the port took mesh blocks cannot run them).
MESH_CELLS = {"sim_mb_uniform_spatial": ("mb_uniform", "blocks"),
              "sim_mb_amr_spatial": ("mb_amr", "interblock"),
              "sim_nearest_spatial": ("nearest", "blocks")}
for _name, (_, _mode) in MESH_CELLS.items():
    CELL_KERNELS[_name] = f"simulation_mode_kernel<float, rk4, NF=1, {_mode}>"
CELLS = tuple(CELL_KERNELS)
# Rays per tile of the spatial_order of k11_f64_spatial
# (pipeline.FORMULA_ORDER_BLOCK).
SPATIAL_BLOCK = 256
STEP_UNITS = ("formula_kernel.cu", "formula_kernel_dp.cu",
              "formula_kernel_multi_dp.cu", "formula_kernel_tangent_dp.cu",
              "simulation_kernel.cu", "simulation_kernel_dp.cu",
              "simulation_phase.cu")
EXACT_CASES = tuple((integrator, precision, full)
                    for integrator in ("rk4", "rk2")
                    for precision in ("float32", "float64")
                    for full in (False, True))
EXACT_RES = 256
# chip_smoke.py phase 7's cell in camera order in these types,
# integrators and frequency counts, held bit for bit between the trees.
SIM_CASES = tuple((precision, integrator, nf)
                  for precision in ("float32", "float64")
                  for integrator in ("rk4", "rk2", "dp") for nf in (1, 3))


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
    per_ray, per_sample = mix.per_ray_lines(tree), mix.per_sample_lines(tree)
    with tempfile.TemporaryDirectory() as tmp:
        sass = mix.disassemble(tree, list(STEP_UNITS), pathlib.Path(tmp))
    return {cs._kernel_label(name): mix.loop_mixes(code, per_ray, per_sample)
            for unit in sass.values() for name, code in unit.items()
            if "formula_kernel" in name or "simulation" in name}


def _sim_cell(cs, name, grids):
    """The renderer, its arguments and keywords of a simulation cell, and
    the launch order (None for camera order); ``grids`` caches the
    snapshot per precision."""
    import torch
    from blacklight_tpu_torch import pipeline_simulation as ps
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    precision, integrator, nf, order, steps = SIM_CELLS[name]
    if precision not in grids:
        grids[precision] = cs.full_width_snapshot(getattr(torch, precision))
    extra = cs.MULTI_FREQUENCIES if nf == 3 else {}
    args, kwargs = cs._sim_args(cs._sim_config(
        camera_resolution=1024, precision=precision,
        ray_integrator=integrator, ray_max_steps=2000, **extra),
        grids[precision])
    perm = None
    if order == "spatial":
        perm = sk.spatial_order(args[0], block=ps.KERNEL_ORDER_BLOCK)
        args = (*(t[perm].contiguous() for t in args[:3]), *args[3:])
    if steps is None:
        return sk.render_simulation, args, kwargs, perm
    kwargs = dict(kwargs, block=ps.KERNEL_ORDER_BLOCK, phase_steps=steps)
    return sk.render_simulation_phased, args, kwargs, perm


def _mesh_cell(cs, name, grids):
    """A MESH_CELLS cell as _sim_cell gives one; ``grids`` caches its
    snapshot by layout."""
    import torch
    from blacklight_tpu_torch import pipeline_simulation as ps
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    cell = MESH_CELLS[name][0]
    layout = cs.MESH_CELLS[cell][0]
    if layout not in grids:
        grids[layout] = cs.mesh_grid(layout, torch.float32)
    args, kwargs = cs._sim_args(cs._mesh_cell_config(cell, "float32"),
                                grids[layout])
    perm = sk.spatial_order(args[0], block=ps.KERNEL_ORDER_BLOCK)
    args = (*(t[perm].contiguous() for t in args[:3]), *args[3:])
    return sk.render_simulation, args, kwargs, perm


def _cell(cs, name, grids):
    """The renderer, its arguments and keywords of a timed cell, and the
    permutation of the camera's rays it launches (None: camera order)."""
    from blacklight_tpu_torch.ops import formula_kernel as fk
    if name in SIM_CELLS:
        return _sim_cell(cs, name, grids)
    if name in MESH_CELLS:
        return _mesh_cell(cs, name, grids)
    if name in ("k11", "k13", "k14"):
        return (fk.render_formula, *cs._formula_cell(name)[1:], None)
    if name == "k13_tangents":
        _, args, kwargs = cs._formula_cell("k14")
        multi = cs._formula_cell("k13")[1]
        return fk.render_formula, (*args[:3], multi[3], *args[4:]), kwargs, \
            None
    overrides = dict(camera_resolution=1024, precision="float32",
                     ray_integrator="dp")
    if name in ("k11_rk4", "k11_rk2"):
        overrides["ray_integrator"] = name[-3:]
    else:
        overrides["precision"] = "float64"
    args, kwargs = cs._renderer(cs._config("golden_formula_32.input",
                                           **overrides))
    order = None
    if name == "k11_f64_spatial":
        from blacklight_tpu_torch.ops.simulation_kernel import spatial_order
        order = spatial_order(args[0], block=SPATIAL_BLOCK)
        args = (*(t[order].contiguous() for t in args[:3]), *args[3:])
    return fk.render_formula, args, kwargs, order


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


def _polarized(cs, grids):
    """render_polarized's outputs on chip_smoke.py phase 9's cell, in
    spatial_order as pipeline.run launches it."""
    import torch
    from blacklight_tpu_torch import pipeline_simulation as ps
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    if "float32" not in grids:
        grids["float32"] = cs.full_width_snapshot(torch.float32)
    args, kwargs, _ = cs._pol_args(cs._pol_config(
        camera_resolution=1024, precision="float32", ray_integrator="rk4",
        ray_max_steps=2000), grids["float32"])
    order = sk.spatial_order(args[0], block=ps.KERNEL_ORDER_BLOCK)
    args = (*(t[order].contiguous() for t in args[:3]), *args[3:])
    out = pk.render_polarized(*args, **kwargs)
    return {f"out{i}": t.cpu() for i, t in enumerate(out)
            if isinstance(t, torch.Tensor)}


def worker(opts) -> dict:
    tree = pathlib.Path(opts.tree).resolve()
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    import torch
    cs = _smoke()
    import numpy as np
    from blacklight_tpu_torch.ops import formula_kernel as fk
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU")
    out_dir = pathlib.Path(opts.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    result = {"tree": str(tree), "label": opts.label, "card": cs.smi(
        cs.SMI_QUERY), "clocks_max": cs.smi(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"])}
    cells = opts.cells.split(",") if opts.cells else CELLS
    runs, grids, mono = {}, {}, {}
    for name in cells:
        fn, args, kwargs, order = _cell(cs, name, grids)
        out = fn(*args, **kwargs)  # also the warm-up
        _save(out, out_dir / f"{name}.pt")
        result[f"{name}_ray_steps"] = int(out[2].long().sum())
        result[f"{name}_block_efficiency_128"] = _block_efficiency(
            cs, out[2].cpu(), launched=order is not None)
        if name in SIM_CELLS or name in MESH_CELLS:
            ns = out[2].cpu().numpy()
            result[f"{name}_warp_efficiency"] = cs.warp_efficiency(
                ns, np.arange(ns.size))
            if name == "sim_rk4_spatial":
                mono = {k: v.cpu() for k, v in zip(("I_nu", "flags",
                                                    "n_samples"), out)}
            elif name.startswith("sim_phased") and mono:
                result[f"{name}_identical_to_monolithic"] = all(
                    cs._same_bits(mono[k], v.cpu()) for k, v in zip(
                        ("I_nu", "flags", "n_samples"), out))
        runs[f"{name}_main"] = [cs._timed(fn, *args, **kwargs)[1] * 1e3
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
            result[f"{name}_sample_instructions"] = \
                mixes["per_sample"]["total"]
            result[f"{name}_loop_instructions"] = mixes["step_loop"]["total"]
            result[f"{name}_issue_estimate_ms"] = (
                instr * result[f"{name}_ray_steps"]
                / (cs.N_SMS * cs.ISSUE_LANES_PER_SM * clock_hz) * 1e3)
        for case in EXACT_CASES:
            args, kwargs = _exact_case(cs, *case)
            _save(fk.render_formula(*args, **kwargs),
                  out_dir / "case_{}_{}_{}.pt".format(*case))
        from blacklight_tpu_torch.ops import simulation_kernel as sk
        for precision, integrator, nf in SIM_CASES:
            if precision not in grids:
                grids[precision] = cs.full_width_snapshot(
                    getattr(torch, precision))
            extra = cs.MULTI_FREQUENCIES if nf == 3 else {}
            args, kwargs = cs._sim_args(cs._sim_config(
                camera_resolution=1024, precision=precision,
                ray_integrator=integrator, ray_max_steps=2000, **extra),
                grids[precision])
            _save(sk.render_simulation(*args, **kwargs),
                  out_dir / f"sim_{precision}_{integrator}_{nf}.pt")
            del args, kwargs
        torch.save(_polarized(cs, grids), out_dir / "polarized.pt")
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
    cells = opts.cells.split(",") if opts.cells else list(CELLS)
    results = []
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, tree) in enumerate(turns):
            out = pathlib.Path(tmp) / f"{i}_{label}"
            cmd = [sys.executable, str(script), "worker", "--tree", str(tree),
                   "--out", str(out), "--label", label,
                   "--reps", str(opts.reps), "--cells", ",".join(cells)]
            if i >= 2:
                cmd.append("--times-only")
            subprocess.run(cmd, check=True)
            results.append(json.loads((out / "result.json").read_text()))
        a_dir = pathlib.Path(tmp) / "0_parent"
        b_dir = pathlib.Path(tmp) / "1_change"
        identical, gates, ok = {}, {}, True
        names = (cells + ["case_{}_{}_{}".format(*c) for c in EXACT_CASES]
                 + ["sim_{}_{}_{}".format(*c) for c in SIM_CASES]
                 + ["polarized"])
        for name in names:
            a = torch.load(a_dir / f"{name}.pt")
            b = torch.load(b_dir / f"{name}.pt")
            same = {k: cs._same_bits(a[k], b[k]) for k in a}
            identical[name] = same
            if name.startswith(("sim", "polarized")):
                ok = ok and all(same.values())
            elif "dp" in name or name in ("k11", "k11_f64", "k11_f64_spatial",
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
    for name in cells:
        for key in ("ray_steps", "block_efficiency_128", "warp_efficiency",
                    "identical_to_monolithic", "step_instructions",
                    "sample_instructions", "loop_instructions",
                    "issue_estimate_ms"):
            summary[f"{name}_{key}"] = {r["label"]: r.get(f"{name}_{key}")
                                        for r in results[:2]}
        if results[1].get(f"{name}_identical_to_monolithic") is False:
            ok = False
    summary["ok"] = ok
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


def sweep(opts) -> int:
    """Workers with --times-only on each tree in turns, forwards then
    backwards, ``rounds`` times; the runs and best time per cell and tree."""
    trees = [pathlib.Path(t).resolve() for t in opts.trees.split(",")]
    script = pathlib.Path(__file__).resolve()
    order = (list(enumerate(trees)) + list(enumerate(trees))[::-1]) \
        * opts.rounds
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for turn, (i, tree) in enumerate(order):
            out = pathlib.Path(tmp) / f"{turn}_{i}"
            subprocess.run([sys.executable, str(script), "worker", "--tree",
                            str(tree), "--out", str(out), "--label", str(i),
                            "--reps", str(opts.reps), "--times-only",
                            "--cells", opts.cells], check=True)
            result = json.loads((out / "result.json").read_text())
            for key, values in result["runs_ms"].items():
                runs.setdefault(key, {}).setdefault(tree.name, []).extend(
                    values)
            card = result["card"]
    summary = {"card": card, "trees": [t.name for t in trees], "cells": {}}
    for key, per_tree in runs.items():
        best = {name: min(v) for name, v in per_tree.items()}
        first = best[trees[0].name]
        summary["cells"][key] = {"runs_ms": per_tree, "best_ms": best,
                                 "over_first": {k: v / first
                                                for k, v in best.items()}}
    print(json.dumps(summary), flush=True)
    return 0


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
    c.add_argument("--cells", default="")
    sw = sub.add_parser("sweep")
    sw.add_argument("--trees", required=True)
    sw.add_argument("--cells", required=True)
    sw.add_argument("--rounds", type=int, default=1)
    sw.add_argument("--reps", type=int, default=3)
    opts = parser.parse_args(argv)
    if opts.mode == "worker":
        worker(opts)
        return 0
    if opts.mode == "sweep":
        return sweep(opts)
    return compare(opts)


if __name__ == "__main__":
    sys.exit(main())
