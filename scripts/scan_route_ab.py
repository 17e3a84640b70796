"""Time and profile the scan route (blacklight_tpu_torch
transfer/unpolarized.integrate_unpolarized) of two trees on one NVIDIA
GPU, in turns, on chip_smoke.py phase 15's main path.

    python3 scripts/scan_route_ab.py compare --parent DIR [--change DIR]

runs a worker process per tree in the order parent, change, change,
parent. Each worker runs phase 15's cell through pipeline.run: 1024^2,
float32 rk4, 2000 steps, every auxiliary plane, on the 288 x 128 x 128
snapshot that chip_smoke.py builds on the card (its
``full_width_snapshot`` and ``_aux_full_config``, loaded from this
checkout, so both trees get the same inputs). It prints one JSON line per
worker (seconds, steps, ms a step, peak device memory, the card's name
and power limit) and a last line comparing the trees' planes (equal
bits, or the largest relative difference) and times. It exits non-zero
if a plane's NaN set or the flags or sample counts differ.

    python3 scripts/scan_route_ab.py worker --tree DIR --out DIR2 \
        [--label L] [--profile]

is one worker. With ``--profile`` it also runs the cell under
torch.profiler over two windows of PROFILE_STEPS steps, from step 0 and
from PROFILE_LATE, after a warm call, and reports per step of each
window: CUDA kernels launched, host syncs (cudaStreamSynchronize,
cudaDeviceSynchronize, device-to-host copies), the device's busy and
idle share, and host time, device time and kernels by stage: the
geodesic step (``geodesic.step``), the grid sample and fluid state
(``simulation_kernel.fluid_sample``), the coefficients
(``simulation_kernel.sample_coefficients`` without its fluid sample), the
cell values (``simulation_kernel.cell_values``) and the rest of the
per-sample update (the planes). The stages are torch.profiler
record_function ranges put around those functions in the worker; the
device time of a stage is that of the kernels that start inside its range
on the device's timeline.
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
PROFILE_STEPS = 24
PROFILE_LATE = 1200
STAGES = ("geodesic", "fluid_sample", "coefficients", "cell_values")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


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


def _wrap(module, name, label, record_function):
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)

    setattr(module, name, wrapped)
    return fn


def stage_profile(events: list, steps: int) -> dict:
    """Per step of a profiled window, from its chrome-trace events:
    kernels, launches and host syncs, the device's busy share over the
    window, and host ms, device ms and kernels by stage."""
    host = {s: [] for s in STAGES}
    device = {s: [] for s in STAGES}
    kernels, launches, syncs, copies_d2h = [], 0, 0, 0
    t_lo, t_hi = float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        t_lo, t_hi = min(t_lo, ts), max(t_hi, ts + dur)
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation" and name in host:
            host[name].append((ts, ts + dur))
        elif cat == "gpu_user_annotation" and name in device:
            device[name].append((ts, ts + dur))
        elif cat == "kernel":
            kernels.append((ts, ts + dur))
        elif cat == "cuda_runtime":
            if name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
                launches += 1
            elif name in SYNC_CALLS:
                syncs += 1
        elif cat == "gpu_memcpy" and "DtoH" in name:
            copies_d2h += 1
    busy, end = 0.0, float("-inf")
    for a, b in sorted(kernels):
        if b > end:
            busy += b - max(a, end)
            end = b
    span = t_hi - t_lo

    def union_ms(spans):
        total, end = 0.0, float("-inf")
        for a, b in sorted(spans):
            if b > end:
                total += b - max(a, end)
                end = b
        return total / 1e3

    def inside(spans):
        spans = sorted(spans)
        count, ms = 0, 0.0
        for a, b in kernels:
            lo, hi = 0, len(spans)
            while lo < hi:
                mid = (lo + hi) // 2
                if spans[mid][0] <= a:
                    lo = mid + 1
                else:
                    hi = mid
            if lo and a < spans[lo - 1][1]:
                count += 1
                ms += (b - a) / 1e3
        return count, ms

    stages = {}
    for s in STAGES:
        count, ms = inside(device[s])
        stages[s] = {"host_ms_per_step": union_ms(host[s]) / steps,
                     "device_kernel_ms_per_step": ms / steps,
                     "kernels_per_step": count / steps}
    # the coefficients' range holds the fluid sample's only where the
    # coefficients formed it (the fluid sample is shared with the cells)
    return {
        "steps": steps,
        "kernels_per_step": len(kernels) / steps,
        "launch_calls_per_step": launches / steps,
        "host_syncs_per_step": syncs / steps,
        "device_to_host_copies_per_step": copies_d2h / steps,
        "window_ms_per_step": span / 1e3 / steps,
        "device_busy_ms_per_step": busy / 1e3 / steps,
        "device_idle_share": 1.0 - busy / span if span > 0 else None,
        "stages": stages,
    }


def _run(cs, pipeline, geodesic, cfg, grid, windows=()):
    """pipeline.run of ``cfg`` counting lock steps (eager steps and, in a
    tree whose loop replays steps from a CUDA graph, replays; a capture is
    not a step); with ``windows`` ((first step, profiler), ...) each
    profiler runs over PROFILE_STEPS steps from its first."""
    import torch
    steps = [0]
    starts = {first: prof for first, prof in windows}
    stops = {first + PROFILE_STEPS: prof for first, prof in windows}
    graph = getattr(geodesic, "_StepGraph", None)
    capturing = [False]

    def tick():
        n = steps[0]
        if n in stops:
            torch.cuda.synchronize()
            stops[n].stop()
        if n in starts:
            torch.cuda.synchronize()
            starts[n].start()
        steps[0] += 1

    step = geodesic.step

    def counted(*args, **kwargs):
        if not capturing[0]:
            tick()
        return step(*args, **kwargs)

    patched = [(geodesic, "step", step)]
    geodesic.step = counted
    if graph is not None:
        init, replay = graph.__init__, graph.replay

        def captured(self, *args, **kwargs):
            capturing[0] = True
            try:
                init(self, *args, **kwargs)
            finally:
                capturing[0] = False

        def replayed(self):
            tick()
            replay(self)

        patched += [(graph, "__init__", init), (graph, "replay", replay)]
        graph.__init__, graph.replay = captured, replayed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arrays = pipeline.run(cfg, quiet=True, device="cuda", grid=grid)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        for owner, name, fn in patched:
            setattr(owner, name, fn)
    return arrays, seconds, steps[0]


def worker(opts) -> dict:
    tree = pathlib.Path(opts.tree).resolve()
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    import numpy as np
    import torch
    cs = _smoke()
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.ops import geodesic
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU")
    out_dir = pathlib.Path(opts.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    result = {"tree": str(tree), "label": opts.label, "card": _card()}
    grid = cs.full_width_snapshot(torch.float32)
    with tempfile.TemporaryDirectory() as tmp:
        warm = cs._aux_full_config(
            output_file=str(pathlib.Path(tmp) / "warm.npz"),
            camera_resolution=64, ray_max_steps=cs.AUX_WARM_STEPS)
        pipeline.run(warm, quiet=True, device="cuda", grid=grid)
        cfg = cs._aux_full_config(output_file=str(pathlib.Path(tmp) /
                                                  "aux.npz"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        arrays, seconds, steps = _run(cs, pipeline, geodesic, cfg, grid)
        result.update(seconds=seconds, steps=steps,
                      ms_per_step=seconds / steps * 1e3,
                      peak_device_bytes=torch.cuda.max_memory_allocated()
                      - base)
        np.savez(out_dir / f"{opts.label}.npz",
                 **{k: v for k, v in arrays.items()
                    if isinstance(v, np.ndarray)})
        if opts.profile:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            originals = [(geodesic, "step", _wrap(geodesic, "step",
                                                  "geodesic",
                                                  record_function)),
                         (sk, "fluid_sample", _wrap(sk, "fluid_sample",
                                                    "fluid_sample",
                                                    record_function)),
                         (sk, "sample_coefficients",
                          _wrap(sk, "sample_coefficients", "coefficients",
                                record_function)),
                         (sk, "cell_values", _wrap(sk, "cell_values",
                                                   "cell_values",
                                                   record_function))]
            acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
            profs = {first: profile(activities=acts)
                     for first in (0, PROFILE_LATE)}
            try:
                _, run_s, _ = _run(cs, pipeline, geodesic, cfg, grid,
                                   windows=tuple(profs.items()))
            finally:
                for module, name, fn in originals:
                    setattr(module, name, fn)
            result["profiled_run_s"] = run_s
            for first, prof in profs.items():
                trace = pathlib.Path(tmp) / f"trace_{first}.json"
                prof.export_chrome_trace(str(trace))
                events = json.loads(trace.read_text())["traceEvents"]
                result[f"profile_from_step_{first}"] = stage_profile(
                    events, PROFILE_STEPS)
    print(json.dumps(result), flush=True)
    (out_dir / f"{opts.label}.json").write_text(json.dumps(result))
    return result


def compare(opts) -> int:
    import numpy as np
    change = pathlib.Path(opts.change).resolve()
    parent = pathlib.Path(opts.parent).resolve()
    out = pathlib.Path(tempfile.mkdtemp(prefix="scan_ab_"))
    order = (("parent", parent), ("change", change), ("change2", change),
             ("parent2", parent))
    results = {}
    for label, tree in order:
        cmd = [sys.executable, str(ROOT / "scripts" / "scan_route_ab.py"),
               "worker", "--tree", str(tree), "--out", str(out),
               "--label", label]
        if opts.profile and label in ("parent", "change"):
            cmd.append("--profile")
        subprocess.run(cmd, check=True)
        results[label] = json.loads((out / f"{label}.json").read_text())
    a, b = np.load(out / "parent.npz"), np.load(out / "change.npz")
    planes, ok = {}, True
    for key in sorted(a.files):
        x, y = a[key], b[key]
        if np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
            planes[key] = {"equal": True}
            continue
        same_nan = bool(np.array_equal(np.isnan(x), np.isnan(y))) \
            if x.dtype.kind == "f" else False
        with np.errstate(invalid="ignore", divide="ignore"):
            rel = np.abs(x - y) / np.abs(x)
        planes[key] = {"equal": False, "same_nan": same_nan,
                       "max_rel": float(np.nanmax(rel))
                       if x.dtype.kind == "f" else None}
        ok = ok and same_nan and key not in ("_flags", "_n_samples")
    print(json.dumps({
        "compare": "scan route, chip_smoke.py phase 15's cell",
        "seconds": {k: r["seconds"] for k, r in results.items()},
        "ms_per_step": {k: r["ms_per_step"] for k, r in results.items()},
        "steps": {k: r["steps"] for k, r in results.items()},
        "peak_device_bytes": {k: r["peak_device_bytes"]
                              for k, r in results.items()},
        "planes": planes, "ok": ok}), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("compare")
    c.add_argument("--parent", required=True)
    c.add_argument("--change", default=str(ROOT))
    c.add_argument("--profile", action="store_true",
                   help="profile the first parent and change workers")
    w = sub.add_parser("worker")
    w.add_argument("--tree", required=True)
    w.add_argument("--out", required=True)
    w.add_argument("--label", default="run")
    w.add_argument("--profile", action="store_true")
    opts = parser.parse_args(argv)
    if opts.cmd == "worker":
        worker(opts)
        return 0
    return compare(opts)


if __name__ == "__main__":
    sys.exit(main())
