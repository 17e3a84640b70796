"""Smoke run of the PyTorch / CUDA port (blacklight_tpu_torch) on one
NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no final line):

1. device: the card's name and power limit (nvidia-smi);
2. build: compile csrc/*.cu with nvcc (one process per source, all at
   once), report registers, spills and the FP64 instructions of each
   kernel instantiation;
3. formula kernel against its plain PyTorch version on the card, 128^2
   camera, identical rays: dp float32/float64, rk4 float64, rk2 float32;
4. the 32^2 formula goldens through pipeline.run(cfg, device="cuda") at
   the tolerances of tests/test_formula_e2e.py;
5. the formula main path at full width: golden_formula_32.input at
   1024^2, dp, float32 through pipeline.run, counting kernel launches;
   then kernel times (rays/s) at 1024^2 in float32 and float64, and the
   plain version's in float32;
6. simulation kernel against its plain version, 128^2 camera on
   golden_sim_rk4_32.input with mock_small.athdf, identical rays: rk4
   float64, rk2 float32, dp float32/float64;
7. the 32^2 simulation goldens through pipeline.run(cfg, device="cuda"),
   reading the .athdf file, at the tolerances of
   tests/test_simulation_e2e.py;
8. the simulation main path at full width: a 288 x 128 x 128 (r, theta,
   phi) SKS snapshot (the grid of the EHT GRMHD image library), 1024^2
   camera, rk4, 2000 steps, float32 through pipeline.run, counting kernel
   launches; then kernel times at 1024^2 in float32 rk4, float64 rk4 and
   float32 dp, and the plain version's in float32 rk4.

Every line but the last two is a JSON object with the measurements; then
come the card's name and power limit, and the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures"
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]
KERNEL_SOURCE = "blacklight_tpu_torch/csrc/formula_kernel.cuh"
KERNEL_REPLACES = "blacklight_tpu/ops/pallas_formula.py:192"
SIM_KERNEL_SOURCE = "blacklight_tpu_torch/csrc/simulation_kernel.cuh"
SIM_KERNEL_REPLACES = "blacklight_tpu/ops/pallas_simulation.py:795"
# the full-width snapshot: the EHT GRMHD image library's grid (EHT M87*
# Paper V) over mock_small.athdf's radii, as scripts/bench_simulation.py
# builds its mock
FULL_GRID = dict(n_r=288, n_th=128, n_ph=128, r_min=1.916, r_max=52.2,
                 pert_amp=0.1)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi(query) -> str:
    return subprocess.run(query, capture_output=True, text=True,
                          check=True).stdout.strip()


def rel_error(a, b):
    """|a - b| relative to |b| plus a floor of 1e-6 of the image maximum
    (bench.py:177-178), NaN where either is NaN."""
    import numpy as np
    return np.abs(a - b) / (np.abs(b) + np.nanmax(np.abs(b)) * 1e-6)


def statistical_gate(a, b) -> dict:
    """bench.py:181-186: identical NaN sets, fewer than 0.5% of pixels
    past 1e-3 relative, total flux within 1e-3."""
    import numpy as np
    rel = rel_error(a, b)
    frac = float(np.mean(np.nan_to_num(rel) > 1e-3))
    flux = float(abs(np.nansum(a) - np.nansum(b)) / abs(np.nansum(b)))
    same_nan = bool(np.array_equal(np.isnan(a), np.isnan(b)))
    return {"same_nan": same_nan, "frac_past_1e-3": frac, "flux_rel": flux,
            "max_rel": float(np.nanmax(rel)), "mean_rel": float(np.nanmean(rel)),
            "ok": same_nan and frac < 5e-3 and flux < 1e-3}


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "run needs an NVIDIA GPU")
    if not (ROOT / "blacklight_tpu_torch").is_dir():
        raise RuntimeError(f"{ROOT} holds no blacklight_tpu_torch package")
    sys.path.insert(0, str(ROOT))
    card = smi(SMI_QUERY)
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    return card


def _ptxas_table(report: str) -> dict:
    """Registers, stack and spills per kernel from nvcc -Xptxas -v."""
    table, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)'?", line)
        if m:
            name = _kernel_label(m.group(1))
            table.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            table[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            table[name]["registers"] = int(m.group(1))
    return {k: v for k, v in table.items() if v}


def _kernel_label(mangled: str) -> str:
    m = re.search(r"(formula|simulation)_kernelI([fd])Li(\d)E(?:Li(\d+)E)?",
                  mangled)
    if not m:
        return mangled
    kind, tp, integrator, nf = m.groups()
    args = ["float" if tp == "f" else "double", ("dp", "rk4", "rk2")[int(integrator)]]
    if nf:
        args.append(f"NF={nf}")
    return f"{kind}_kernel<{', '.join(args)}>"


def _sass_fp64(lib_path) -> dict:
    """FP64 instructions per kernel in the compiled SASS: arithmetic
    (DADD, DMUL, DFMA) and everything else that touches FP64 (compares,
    min/max, conversions)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(cuobjdump).exists():
        return {"not_measured": "cuobjdump not found"}
    sass = smi([cuobjdump, "-sass", str(lib_path)])
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _kernel_label(m.group(1))
            counts[name] = {"arith": 0, "other": 0}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                      line)
        if name is None or not m:
            continue
        op = m.group(1)
        if op.split(".")[0] in ("DADD", "DMUL", "DFMA"):
            counts[name]["arith"] += 1
        elif op.startswith("D") or "F64" in op:
            counts[name]["other"] += 1
    return counts


def phase_build():
    from blacklight_tpu_torch.ops import _build
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    t0 = time.perf_counter()
    path = _build.build()
    build_s = time.perf_counter() - t0
    fk._library()
    sk._library()
    emit("build", seconds=build_s, library=path.name,
         ptxas=_ptxas_table(_build.ptxas_report()), fp64_sass=_sass_fp64(path))


def _config(name, **overrides):
    from blacklight_tpu_torch import RayIntegrator, read_config
    cfg = read_config(str(FIXTURES / name))
    for key, value in overrides.items():
        if key == "ray_integrator":
            value = RayIntegrator(value)
        setattr(cfg, key, value)
    return cfg


def _renderer(cfg):
    """The port's renderer on the card plus the arguments that render the
    same rays with the plain version."""
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.models import formula as formula_model
    render_fn, geom, rays, freqs, mass_msun = pipeline.make_formula_renderer(
        cfg, device="cuda")
    fp = formula_model.formula_params_from_config(cfg)
    args = (rays.positions, rays.directions, rays.momentum_factors,
            float(freqs[0]), render_fn.geodesic_params, fp, mass_msun,
            geom.cam_x.tolist(), formula_model.formula_log_j_scale(fp))
    kwargs = dict(fallback_nan=cfg.require("fallback_nan"),
                  integrator=cfg.require("ray_integrator").value)
    return args, kwargs


def _timed(fn, *args, **kwargs):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_kernel_vs_plain():
    import numpy as np
    import torch
    from blacklight_tpu_torch.ops import formula_kernel as fk
    cases = [("dp", "float32"), ("dp", "float64"), ("rk4", "float64"),
             ("rk2", "float32")]
    for integrator, precision in cases:
        cfg = _config("golden_formula_32.input", camera_resolution=128,
                      ray_integrator=integrator, precision=precision)
        args, kwargs = _renderer(cfg)
        (ik, fk_, nk), t_k = _timed(fk.render_formula, *args, **kwargs)
        (ip, fp_, np_), t_p = _timed(fk.render_formula_reference, *args,
                                     **kwargs)
        a, b = ik[:, 0].cpu().numpy(), ip[:, 0].cpu().numpy()
        gate = statistical_gate(a, b)
        result = dict(integrator=integrator, precision=precision,
                      rays=a.size, kernel_s=t_k, plain_s=t_p,
                      max_n_samples=int(np_.max()), **gate)
        if integrator != "dp" and precision == "float64":
            exact = (bool(np.array_equal(np.isnan(a), np.isnan(b)))
                     and torch.equal(fk_.cpu(), fp_.cpu())
                     and torch.equal(nk.cpu(), np_.cpu()))
            close = bool(np.allclose(a, b, rtol=1e-9, atol=0.0,
                                     equal_nan=True))
            result.update(gate="exact flags/n_samples/NaN, rtol 1e-9",
                          ok=exact and close)
        else:
            result["gate"] = "statistical (bench.py:181-186)"
        emit("kernel_vs_plain", **result)
        if not result["ok"]:
            raise RuntimeError(f"kernel disagrees with plain: {result}")


def phase_goldens(tmp: pathlib.Path):
    import numpy as np
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.ops import formula_kernel as fk
    for name, exact in (("golden_formula_cam_rk4_32", True),
                        ("golden_formula_rk2_32", True),
                        ("golden_formula_32", False)):
        cfg = _config(f"{name}.input", output_file=str(tmp / f"{name}.npz"))
        before = fk.LAUNCHES
        arrays = pipeline.run(cfg, quiet=True, device="cuda")
        launched = fk.LAUNCHES - before
        ours = arrays["I_nu"]
        gold = np.load(FIXTURES / f"{name}.npz")["I_nu"]
        rel = np.abs(ours - gold) / (np.abs(gold) + gold.max() * 1e-8)
        if exact:
            ok = bool(np.allclose(ours, gold, rtol=1e-7, atol=0.0))
            gate = "rtol 1e-7"
        else:
            ok = bool(np.nanmax(rel) < 5e-3 and np.nanmean(rel) < 1e-3)
            gate = "max rel < 5e-3, mean rel < 1e-3"
        ok = ok and launched > 0
        emit("golden", name=name, gate=gate, launches=launched,
             max_rel=float(np.nanmax(rel)), mean_rel=float(np.nanmean(rel)),
             ok=ok)
        if not ok:
            raise RuntimeError(f"golden {name} failed")


def warp_efficiency(n_samples, order) -> float:
    """Share of lane-steps doing work when rays run 32 to a warp in
    ``order`` and a warp lasts as long as its longest ray, with n_samples
    standing in for a ray's step count."""
    lanes = n_samples[order].reshape(-1, 32).astype("int64")
    return float(lanes.sum() / (32 * lanes.max(axis=1).sum()))


def phase_full_width(tmp: pathlib.Path, card: str) -> dict:
    import numpy as np
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.ops import formula_kernel as fk

    res = 1024
    cfg = _config("golden_formula_32.input", camera_resolution=res,
                  precision="float32", ray_integrator="dp",
                  output_file=str(tmp / "full_width.npz"))
    fk.LAUNCHES = 0
    t0 = time.perf_counter()
    arrays = pipeline.run(cfg, quiet=True, device="cuda")
    run_s = time.perf_counter() - t0
    launches = fk.LAUNCHES
    image = arrays["I_nu"]
    if image.shape != (res, res) or not np.isfinite(np.nanmax(image)):
        raise RuntimeError("full-width image is not finite or has the wrong "
                           "shape")
    if launches == 0:
        raise RuntimeError("the main path launched no formula kernel")
    emit("main_path", resolution=res, precision="float32", integrator="dp",
         seconds=run_s, launches=launches, nan_pixels=int(np.isnan(image).sum()),
         max_I_nu=float(np.nanmax(image)))

    timings = {}
    for precision in ("float32", "float64"):
        cfg.precision = precision
        (args, kwargs), t_setup = _timed(_renderer, cfg)
        # the plain version runs in float32 only: float64 took 107 s more
        # and adds nothing to the kernel's check
        timings[precision] = time_kernel(
            "timing", fk.render_formula,
            fk.render_formula_reference if precision == "float32" else None,
            args, kwargs, res, card, precision=precision, integrator="dp",
            camera_setup_s=t_setup)
    f32 = timings["float32"]
    return {"name": "formula_kernel", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
            "launches": launches, "max_abs_err": f32["max_abs_err"],
            "ms": f32["kernel_ms"], "plain_ms": f32["plain_ms"]}


def time_kernel(phase, kernel, plain, args, kwargs, res, card, **fields):
    """Warm best of 3 of ``kernel`` on a res^2 ray bundle and, unless
    ``plain`` is None, one run of its plain version on the same rays held
    to the statistical gate; emits the timing line and returns the
    numbers the kernels line needs."""
    import numpy as np
    kernel(*args, **kwargs)  # warm up
    times = []
    for _ in range(3):
        (ik, _, nk), t = _timed(kernel, *args, **kwargs)
        times.append(t)
    t_kernel, n = min(times), res * res
    out = {"kernel_ms": t_kernel * 1e3, "plain_ms": None, "max_abs_err": None}
    extra = {}
    if plain is not None:
        (ip, _, _), t_plain = _timed(plain, *args, **kwargs)
        gate = {}
        for f in range(ik.shape[1]):
            a, b = ik[:, f].cpu().numpy(), ip[:, f].cpu().numpy()
            gate = statistical_gate(a, b)
            if not gate["ok"]:
                raise RuntimeError(f"{kernel.__name__} disagrees with plain "
                                   f"at {res}^2 {fields}: {gate}")
            both = np.isfinite(a) & np.isfinite(b)
            err = float(np.max(np.abs(a[both] - b[both])))
            out["max_abs_err"] = max(out["max_abs_err"] or 0.0, err)
        out["plain_ms"] = t_plain * 1e3
        extra = dict(plain_rays_per_s=n / t_plain,
                     gate="statistical (bench.py:181-186)", **gate)
    ns = nk.cpu().numpy()
    # 8 x 4 pixel tiles, 32 rays each, in place of 32 pixels of one row
    tiles = np.arange(n).reshape(res // 4, 4, res // 8, 8).transpose(
        0, 2, 1, 3).reshape(-1)
    emit(phase, resolution=res, card=card, **fields, kernel_s_runs=times,
         kernel_ms=out["kernel_ms"], plain_ms=out["plain_ms"],
         kernel_rays_per_s=n / t_kernel, max_abs_err=out["max_abs_err"],
         mean_n_samples=float(ns.mean()), max_n_samples=int(ns.max()),
         warp_efficiency_rows=warp_efficiency(ns, np.arange(n)),
         warp_efficiency_8x4_tiles=warp_efficiency(ns, tiles),
         clocks_power=smi(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                           "temperature.gpu", "--format=csv,noheader"]),
         **extra)
    return out


def _sim_config(name="golden_sim_rk4_32.input", **overrides):
    return _config(name, simulation_file=str(FIXTURES / "mock_small.athdf"),
                   **overrides)


def _sim_args(cfg, grid=None):
    """The simulation renderer's rays and kernel arguments on the card."""
    from blacklight_tpu_torch.pipeline_simulation import (
        make_simulation_renderer)
    render_fn, geom, rays, freqs, mass_msun = make_simulation_renderer(
        cfg, device="cuda", grid=grid)
    args = (rays.positions, rays.directions, rays.momentum_factors,
            *render_fn.kernel_args)
    return args, {"integrator": cfg.require("ray_integrator").value}


def phase_sim_kernel_vs_plain():
    import numpy as np
    import torch
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    for integrator, precision in (("rk4", "float64"), ("rk2", "float32"),
                                  ("dp", "float32"), ("dp", "float64")):
        cfg = _sim_config(camera_resolution=128, ray_integrator=integrator,
                          precision=precision)
        args, kwargs = _sim_args(cfg)
        (ik, fk_, nk), t_k = _timed(sk.render_simulation, *args, **kwargs)
        (ip, fp_, np_), t_p = _timed(sk.render_simulation_reference, *args,
                                     **kwargs)
        a, b = ik[:, 0].cpu().numpy(), ip[:, 0].cpu().numpy()
        gate = statistical_gate(a, b)
        result = dict(integrator=integrator, precision=precision,
                      rays=a.size, kernel_s=t_k, plain_s=t_p,
                      max_n_samples=int(np_.max()), **gate)
        if integrator != "dp" and precision == "float64":
            exact = (bool(np.array_equal(np.isnan(a), np.isnan(b)))
                     and torch.equal(fk_.cpu(), fp_.cpu())
                     and torch.equal(nk.cpu(), np_.cpu()))
            close = bool(np.allclose(a, b, rtol=1e-7, atol=0.0,
                                     equal_nan=True))
            result.update(gate="exact flags/n_samples/NaN, max rel 1e-7",
                          ok=exact and close)
        else:
            result["gate"] = "statistical (bench.py:181-186)"
        emit("sim_kernel_vs_plain", **result)
        if not result["ok"]:
            raise RuntimeError(f"simulation kernel disagrees with plain: "
                               f"{result}")


def phase_sim_goldens(tmp: pathlib.Path):
    import numpy as np
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    for name, exact in (("golden_sim_rk4_32", True), ("golden_sim_32", False)):
        cfg = _sim_config(f"{name}.input",
                          output_file=str(tmp / f"{name}.npz"))
        before = sk.LAUNCHES
        arrays = pipeline.run(cfg, quiet=True, device="cuda")
        launched = sk.LAUNCHES - before
        ours = arrays["I_nu"]
        gold = np.load(FIXTURES / f"{name}.npz")["I_nu"]
        rel = np.abs(ours - gold) / (np.abs(gold) + gold.max() * 1e-8)
        if exact:
            ok = bool(np.allclose(ours, gold, rtol=1e-8, atol=0.0))
            gate = "rtol 1e-8"
        else:
            ok = bool(np.nanmax(rel) < 6e-2 and np.nanmean(rel) < 5e-3)
            gate = "max rel < 6e-2, mean rel < 5e-3"
        ok = ok and launched > 0
        emit("sim_golden", name=name, gate=gate, launches=launched,
             max_rel=float(np.nanmax(rel)), mean_rel=float(np.nanmean(rel)),
             ok=ok)
        if not ok:
            raise RuntimeError(f"golden {name} failed")


def full_width_snapshot(dtype):
    """FULL_GRID from scripts/generate_mock_simulation.make_fields on the
    card, as an Athena++ file would hold it (float32 values and
    coordinates; the coordinates then in ``dtype``), through the function
    that load_athdf ends in. The card's Python has no h5py to write the
    file."""
    import numpy as np
    import torch
    from blacklight_tpu_torch.grid.athena import (
        PRIMITIVE_NAMES,
        simulation_grid,
    )
    sys.path.insert(0, str(ROOT / "scripts"))
    import generate_mock_simulation as mock
    fields = mock.make_fields(dict(mock.DEFAULTS, **FULL_GRID))
    names = ["rho", "press", "vel1", "vel2", "vel3", "Bcc1", "Bcc2", "Bcc3"]
    prim = np.stack([fields[k] for k in ("rho", "pgas", "uur", "uuth", "uuph",
                                         "bbr", "bbth", "bbph")])
    rows = [np.asarray(fields[k], np.float32)[None]
            for k in ("rf", "r", "thf", "th", "phf", "ph")]
    return simulation_grid(
        prim[:, None].astype(np.float32), *rows,
        {key: names.index(var) for key, var in PRIMITIVE_NAMES.items()}, 0.0,
        device=torch.device("cuda", torch.cuda.current_device()), dtype=dtype)


def phase_sim_full_width(tmp: pathlib.Path, card: str) -> dict:
    import numpy as np
    import torch
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import simulation_kernel as sk

    res = 1024
    t0 = time.perf_counter()
    grids = {"float32": full_width_snapshot(torch.float32)}
    t_grid = time.perf_counter() - t0
    cfg = _sim_config(camera_resolution=res, precision="float32",
                      ray_integrator="rk4", ray_max_steps=2000,
                      output_file=str(tmp / "sim_full_width.npz"))
    fk.LAUNCHES = sk.LAUNCHES = 0
    t0 = time.perf_counter()
    arrays = pipeline.run(cfg, quiet=True, device="cuda",
                          grid=grids["float32"])
    run_s = time.perf_counter() - t0
    launches = sk.LAUNCHES
    image = arrays["I_nu"]
    if image.shape != (res, res) or not np.isfinite(np.nanmax(image)):
        raise RuntimeError("full-width simulation image is not finite or has "
                           "the wrong shape")
    if launches == 0:
        raise RuntimeError("the simulation main path launched no simulation "
                           "kernel")
    nvar, _, n_k, n_j, n_i = grids["float32"].prim.shape
    emit("sim_main_path", resolution=res, grid=[n_i, n_j, n_k],
         grid_mb=grids["float32"].prim.numel() * 4 / 1e6, precision="float32",
         integrator="rk4", max_steps=2000, snapshot_build_s=t_grid,
         seconds=run_s, launches=launches,
         nan_pixels=int(np.isnan(image).sum()),
         max_I_nu=float(np.nanmax(image)),
         npz_written=(tmp / "sim_full_width.npz").exists())

    timings = {}
    for precision, integrator in (("float32", "rk4"), ("float64", "rk4"),
                                  ("float32", "dp")):
        if precision not in grids:
            grids[precision] = full_width_snapshot(torch.float64)
        cfg = _sim_config(camera_resolution=res, precision=precision,
                          ray_integrator=integrator, ray_max_steps=2000)
        (args, kwargs), t_setup = _timed(_sim_args, cfg, grids[precision])
        plain = sk.render_simulation_reference \
            if (precision, integrator) == ("float32", "rk4") else None
        timings[precision, integrator] = time_kernel(
            "sim_timing", sk.render_simulation, plain, args, kwargs, res,
            card, precision=precision, integrator=integrator,
            camera_setup_s=t_setup)
    f32 = timings["float32", "rk4"]
    return {"name": "simulation_kernel", "route": "cuda",
            "source": SIM_KERNEL_SOURCE, "replaces": SIM_KERNEL_REPLACES,
            "launches": launches, "max_abs_err": f32["max_abs_err"],
            "ms": f32["kernel_ms"], "plain_ms": f32["plain_ms"]}


def main() -> int:
    card = phase_device()
    import torch
    phase_build()
    with tempfile.TemporaryDirectory(dir=ROOT / "build" / "kernels") as tmp:
        tmp = pathlib.Path(tmp)
        phase_kernel_vs_plain()
        phase_goldens(tmp)
        formula = phase_full_width(tmp, card)
        phase_sim_kernel_vs_plain()
        phase_sim_goldens(tmp)
        simulation = phase_sim_full_width(tmp, card)
    print(json.dumps({"kernels": [formula, simulation]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
