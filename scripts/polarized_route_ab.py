"""Compare two trees' polarized routes (blacklight_tpu_torch
ops/polarized_kernel.render_polarized) on one NVIDIA GPU: time and
output, in turns, on the same rays.

    python3 scripts/polarized_route_ab.py compare --parent DIR [--change DIR]

runs a worker process per tree in the order parent, change, change,
parent (each tree builds its own kernels into DIR/build/kernels), then
holds the change's outputs to the parent's bit for bit: nn_re, nn_im,
flags, n_samples and bad at 1024^2 float32 rk4 (chip_smoke.py phase 9's
cell, 2000 steps, the 288 x 128 x 128 snapshot) in spatial_order and in
camera order, and at chip_smoke.py phase 3's 64^2 polarized cases (rk4
float64; dp float32; rk2 float32 with image_rotation_split and two
frequencies), and reports each tree's device idle share. It prints one
JSON line per worker and a last line with the comparison; it exits
non-zero if any output differs.

    python3 scripts/polarized_route_ab.py worker --tree DIR --out DIR2 \
        [--times-only]

is one worker: the 1024^2 cell in both orders (warm-up, then best of
``--reps`` in turns), outputs saved under DIR2, then (unless
``--times-only``) the 64^2 cases and a torch.profiler trace of
pipeline.run on the 1024^2 cell (device idle share and kernel time by
name). The worker runs the tree's
package on the cell's configuration, snapshot and rays as this
checkout's chip_smoke.py makes them, so both trees get the same inputs.
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
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("nn_re", "nn_im", "flags", "n_samples", "bad")
CASES = (("rk4", "float64", False, 1), ("dp", "float32", False, 1),
         ("rk2", "float32", True, 2))


def _smoke():
    """This checkout's chip_smoke.py, loaded from its file (a worker's
    sys.path starts at the tree under test)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _save(out, path: pathlib.Path) -> None:
    import torch
    torch.save({k: v.cpu() for k, v in zip(FIELDS, out)}, path)


def worker(opts) -> dict:
    tree = pathlib.Path(opts.tree).resolve()
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    import torch
    cs = _smoke()
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU")
    out_dir = pathlib.Path(opts.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    result = {"tree": str(tree), "label": opts.label, "card": _card()}

    t0 = time.perf_counter()
    grid = cs.full_width_snapshot(torch.float32)
    cfg = cs._pol_full_config("float32", "rk4")
    args, kwargs, _ = cs._pol_args(cfg, grid)
    result["setup_s"] = time.perf_counter() - t0
    bundles = {"spatial_order": cs._spatial(args), "camera_order": args}
    best = dict.fromkeys(bundles, float("inf"))
    runs = {k: [] for k in bundles}
    outs = {}
    for name, bundle in bundles.items():
        outs[name] = pk.render_polarized(*bundle, **kwargs)  # warm up
    for _ in range(opts.reps):
        for name, bundle in bundles.items():
            outs[name], t = cs._timed(pk.render_polarized, *bundle,
                                      **kwargs)
            runs[name].append(t * 1e3)
            best[name] = min(best[name], t * 1e3)
    for name, out in outs.items():
        _save(out, out_dir / f"full_{name}.pt")
    result.update({f"{k}_ms": v for k, v in best.items()},
                  runs_ms=runs,
                  mean_n_samples=float(outs["camera_order"][3].float().mean()),
                  peak_memory_bytes=torch.cuda.max_memory_allocated())

    if not opts.times_only:
        for integrator, precision, split, nf in CASES:
            case_args, case_kwargs, _ = cs._pol_args(
                cs._pol_case_config(integrator, precision, split, nf))
            _save(pk.render_polarized(*case_args, **case_kwargs),
                  out_dir / f"case_{integrator}_{precision}_{nf}.pt")

        cfg.output_file = str(out_dir / "run.npz")
        result["profile"] = cs.profile_run(cfg, grid)
    print(json.dumps(result), flush=True)
    (out_dir / "result.json").write_text(json.dumps(result))
    return result


def compare(opts) -> int:
    import torch
    cs = _smoke()
    parent = pathlib.Path(opts.parent).resolve()
    change = pathlib.Path(opts.change).resolve()
    script = pathlib.Path(__file__).resolve()
    turns = (("parent", parent), ("change", change), ("change", change),
             ("parent", parent))
    results = []
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
        same = {}
        names = [f"full_{o}" for o in ("spatial_order", "camera_order")] + [
            f"case_{i}_{p}_{nf}" for i, p, _, nf in CASES]
        for name in names:
            a = torch.load(pathlib.Path(tmp) / "0_parent" / f"{name}.pt")
            b = torch.load(pathlib.Path(tmp) / "1_change" / f"{name}.pt")
            same[name] = {k: cs._same_bits(a[k], b[k]) for k in FIELDS}
    ok = all(all(v.values()) for v in same.values())
    summary = {"identical": same, "ok": ok}
    for r in results[:2]:
        summary[r["label"]] = {
            "peak_memory_bytes": r["peak_memory_bytes"],
            "device_idle_share": r["profile"]["device_idle_share"]}
    for order in ("spatial_order", "camera_order"):
        p = min(r[f"{order}_ms"] for r in results if r["label"] == "parent")
        c = min(r[f"{order}_ms"] for r in results if r["label"] == "change")
        summary[order] = {"parent_ms": p, "change_ms": c,
                          "change_over_parent": c / p}
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
